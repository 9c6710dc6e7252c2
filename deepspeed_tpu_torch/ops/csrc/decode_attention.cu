// K2 (single-token decode attention with the fused cache write) and K6
// (the same over a paged KV pool), for Hopper, on bf16 / fp16 / fp32
// caches and on int8-KV caches, plus their int8 x int8 mode.
//
// Replace two Pallas kernels of the JAX package:
//   K2  deepspeed_tpu/ops/transformer/decode_attention.py
//       decode_attention / _decode_kernel  (float and int8-KV caches, the
//       fused write, the int8-matmul mode and the sliding window)
//   K6  deepspeed_tpu/ops/transformer/paged_attention.py
//       paged_decode_attention  (its body runs _decode_kernel unchanged)
// One query row per head attends to cache positions pos < lengths[b] --
// with a sliding window (window > 0; GPT-Neo's local layers) only to
// lengths[b] - window <= pos < lengths[b].  No row below the window or at
// or past lengths[b] is read (and, for K6, no table entry for one), so a
// windowed step reads O(window) rows, as the JAX kernel's index maps pin
// the blocks below the window to its first block.  K2 reads the S-major
// cache [B, S_max, KVH*D]; K6 reads one layer of the page pool
// [num_pages, page, KVH*D] through the block table pages[B, n_virt]
// (attention_common.cuh PagedRows).  The kernel body is one template
// over that row map, and its tiles and lane schedule depend only on
// virtual positions (lengths, window), so K6
// over the pool is bitwise equal to K2 over the gathered view pool[pages].
// With new_k / new_v given, the kernel first writes this step's row at
// virtual position max(lengths[b] - 1, 0) in place -- the zero-length
// clamp of the JAX kernel; through the table for K6 -- and then attends
// over the cache that now holds it, which is the unfused JAX order (write,
// then attend).  The fresh row lies inside any window of at least one
// position.
//
// int8-KV (the cache type C = int8_t): payloads int8 with fp32 scales
// [.., S_max, KVH] per (position, kv head), read through the same row map
// with KVH elements per position.  The k-scale multiplies each score, the
// v-scale each probability before the PV product (the running sum takes
// the raw probability), as the JAX kernel applies them to its score and
// probability tiles.  The fused write quantizes the fresh row in the block
// that owns it: s = max|x| / 127, safe = s == 0 ? 1 : s, payload
// rintf(x / safe) clamped to +-127, scale safe.  The JAX fused kernel
// substitutes the dequantized fresh row into the step's own scores instead
// of reading it back: the same values up to fp32 rounding.
//
// What bounds it on an H100: bytes.  Each step reads 2 * lengths[b] * KVH
// * D cache elements per layer and does ~4 flops per element (about one
// flop per byte in bf16), far below the card's flop-per-byte ridge, and
// the main path has one query head per kv head, so there is no tile for
// the tensor cores.  At decode's short rows the latency of the loads
// matters as much as the bandwidth.  The design keeps bytes in flight:
//
// * A block owns the live positions of one batch row and HPB kv heads
//   and walks them in tiles of TP positions whose K and V rows fill 8 KB
//   (at HPB = 1: TP = 32 at bf16 D 64, 16 at bf16 D 128, 64 / 32 for
//   int8).  With one query head per kv head (the main path) the host
//   gives a block HPB = 2 heads wherever the launch still has four
//   blocks an SM: a position's two rows are one run of the cache, its two
//   int8 scales one 8-byte copy instead of two 4-byte ones, and the table
//   read and the block's set-up serve both heads; each head gets 2
//   warps (heads_per_block in ops/transformer/decode_attention.py picks
//   HPB from shapes alone: nothing is read from the device).  A ring of
//   kStages tiles in shared memory is
//   filled by cp.async (16 bytes a thread, .cg), kStages - 1 tiles ahead
//   of the one being scored, so a block pays one memory latency per
//   kStages - 1 tiles instead of one per iteration.  The int8 scales of
//   a tile come with it (cp.async of 4 * HPB bytes a position).
//   K6 reads each position's table entry once, in one thread, a tile
//   ahead of its rows, into a ring of row offsets in shared memory: no
//   lane waits on a table load in front of a row, and the lanes that copy
//   a row find its address with one load.  The ring is small (three 8 KB
//   tiles) to leave room for four blocks an SM.
//   The fused write comes before the block loads a tile; cp.async reads
//   through the generic proxy, so the block barrier after the write
//   orders it.
// * Scoring from shared memory: a row of one kv head is split over LPR
//   lanes of E elements each (16 bytes: 8 bf16, 16 int8; fewer where G
//   query heads would need too many registers; a score sums four partial
//   dot products), so a warp scores 32 / LPR rows at once from 128
//   contiguous bytes a quarter warp, and a score is a log2(LPR)-level
//   shuffle sum.  Every lane group
//   keeps an online softmax (max, sum, its E output columns) per query
//   head in registers, updated once per group of up to 16 / G of its
//   rows of a tile and rescaled only when the maximum grows, with scores
//   in the exp2 domain (q carries scale * log2 e); lane groups, then the
//   4 warps, merge at the end, in a fixed order (no atomics: bitwise
//   repeatable).  A state with no live position merges as (m = kNegInf,
//   l = 0), so a zero-length row comes out as 0.  int8 payloads become
//   floats exactly by the 2^23 mantissa trick (a byte permute and a
//   subtract, no I2F).
//
// The int8 x int8 mode (decode_i8mm_kernel; unfused, as in JAX) quantizes
// q per head and, per head and KV block, the probabilities folded with the
// v-scales, and computes both products on integers (__dp4a, exact).  That
// rounding of P depends on the blocking and the block order, so this
// kernel walks the positions in the JAX kernel's blocks (block_k positions,
// min(512, S_max) for K2 and the page for K6), in order: a block's scores
// go to shared memory, one warp per head turns them into the block's
// softmax update and quantized P, and all threads sum P.V.  With a window
// it starts at the block holding lengths[b] - window (the JAX kernel skips
// every block wholly below it) and leaves that block's rows below the
// window out of every loop (JAX masks them to P = 0).
#include <type_traits>

#include "attention_common.cuh"

namespace dstt {

// decode_kernel (K2 / K6, float and int8-KV)
constexpr int kTileWarps = 4;
constexpr int kTileThreads = 32 * kTileWarps;
constexpr int kStages = 3;         // tiles in the shared-memory ring
constexpr int kTileBytes = 8192;   // the K and V rows of one tile
constexpr float kLog2e = 1.4426950408889634f;

// positions of one tile: its K and V rows of HPB kv heads fill kTileBytes
template <typename C, int D, int HPB>
__host__ __device__ constexpr int tile_positions() {
  return kTileBytes / (2 * HPB * D * (int)sizeof(C));
}

// decode_i8mm_kernel (the int8 x int8 mode)
constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kMaxBlockK = 512;  // the int8 x int8 mode's longest KV block

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
// 4 or 8 bytes (aligned to their size), through L1
template <int N>
__device__ __forceinline__ void cp_async_bytes(void* smem, const void* gmem) {
  static_assert(N == 4 || N == 8, "4 or 8 bytes");
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem), "n"(N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W 32-bit words of shared memory at p (aligned to 4 * W bytes)
template <int W>
__device__ __forceinline__ void lds_words(const unsigned char* p,
                                          uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    static_assert(W == 1, "1, 2 or 4 words");
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// the elements of C packed in W words, as floats (exact)
template <typename C, int W>
__device__ __forceinline__ void unpack(const uint32_t (&w)[W],
                                       float (&f)[W * 4 / sizeof(C)]) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(C) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(C) == 1) {
      // byte b ^ 0x80 is b + 128; as the low mantissa bits of 2^23 it is
      // the float 2^23 + b + 128
      const uint32_t x = w[i] ^ 0x80808080u;
      f[4 * i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)) -
                 8388736.f;
      f[4 * i + 1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)) -
                     8388736.f;
      f[4 * i + 2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)) -
                     8388736.f;
      f[4 * i + 3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)) -
                     8388736.f;
    } else if constexpr (std::is_same<C, __nv_bfloat16>::value) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
      const float2 v = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
}

// A lane's E elements (at most 16 bytes) of the row at `row` in shared
// memory, from element part * E, as floats
template <typename C, int E>
__device__ __forceinline__ void lds_slice(const unsigned char* row, int part,
                                          float (&f)[E]) {
  constexpr int W = E * (int)sizeof(C) / 4;
  uint32_t w[W];
  lds_words<W>(row + part * E * (int)sizeof(C), w);
  unpack<C, W>(w, f);
}

// One block per (group of HPB kv heads, batch row).  HPB = 2 (G = 1 only)
// gives each head WPH = 2 warps and loads a position's 2 rows, and 2
// int8 scales, as one run.  Rows: where position t of batch
// row b starts (StridedRows for K2's [B, S_max, KVH*D] cache, PagedRows
// for K6), a multiple of KVH * D elements; the int8-KV scales (KVH per
// position) of that position start at the same offset / D.  S_max: the
// positions a row can hold (n_virt * page for K6).  T: q / out / new row
// type; C: the cache type, T or int8_t.  Four blocks an SM bound the
// registers at 128; G >= 4 (q and outputs of 4 or 8 heads) takes two,
// 255 registers, rather than spill.
template <typename T, typename C, int D, int G, int HPB, typename Rows>
__global__ void __launch_bounds__(kTileThreads, G >= 4 ? 2 : 4)
decode_kernel(const T* __restrict__ q, C* k_cache, C* v_cache, float* k_scale,
              float* v_scale, const int* __restrict__ lengths,
              const T* __restrict__ new_k, const T* __restrict__ new_v,
              T* __restrict__ out, int KVH, int S_max, int window, Rows rows,
              float scale) {
  constexpr bool kInt8 = sizeof(C) == 1;
  constexpr int ES = sizeof(C);
  constexpr int TP = tile_positions<C, D, HPB>();
  constexpr int RB = D * ES;         // bytes of one row of one kv head
  constexpr int PB = HPB * RB;       // a position's rows of the block
  constexpr int CPP = PB / 16;       // their 16-byte chunks
  constexpr int WPH = kTileWarps / HPB;  // warps per head
  // elements per lane when scoring: 16 bytes, or 32 / G elements so that
  // q and the output columns of G heads keep to 64 registers (32-byte
  // lanes cost more registers than they save instructions on an H100)
  constexpr int E = (16 / ES) < (32 / G) ? 16 / ES : 32 / G;
  constexpr int LPR = D / E;       // lanes per row
  constexpr int SLOTS = 32 / LPR;  // rows a warp scores at once
  constexpr int U = TP / (WPH * SLOTS);  // rows of a tile per lane
  // rows scored per softmax update: G * UG scores stay in registers
  constexpr int UG = U < 16 / G ? U : (16 / G > 0 ? 16 / G : 1);
  static_assert(HPB == 1 || (HPB == 2 && G == 1), "2 heads a block at G = 1");
  static_assert(U % UG == 0, "row groups");
  // the loads: a pass of the block copies kTileThreads / CPP positions
  // of K and of V, 16 bytes a thread
  constexpr int PASS = kTileThreads / CPP;
  static_assert(TP % PASS == 0 && 2 * TP <= kTileThreads, "load map");
  static_assert(LPR <= 32 && U * WPH * SLOTS == TP, "lane map");
  // the warps' merge states reuse the ring at the end
  constexpr int kMergeBytes = kTileWarps * G * (D + 2) * 4;
  constexpr int kRingBytes = kStages * kTileBytes > kMergeBytes
                                 ? kStages * kTileBytes : kMergeBytes;

  // the ring: tile n in stage n % kStages, K rows then V rows (position
  // major, a position's HPB heads side by side, as in the cache); the
  // int8 scales of a stage (K then V, HPB a position); K6's row offsets
  // (rows.at) of the positions of tile n, in slot n % kStages until tile
  // n is issued
  __shared__ __align__(16) unsigned char ring[kRingBytes];
  __shared__ __align__(16) float sc[kInt8 ? kStages * 2 * TP * HPB : 1];
  __shared__ long long offs[Rows::kPaged ? kStages * TP : 1];

  const int kvh0 = blockIdx.x * HPB, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int head = warp / WPH, ws = warp % WPH;  // this warp's head
  const int H = KVH * G;
  // this lane's slice of each query head, pre-scaled (exp2 domain),
  // loaded first: it does not wait for lengths[b]
  const int part = lane % LPR, slot = lane / LPR;
  float qv[G][E];
  const T* qb = q + ((long long)b * H + (kvh0 + head) * G) * D;
  const float qscale = scale * kLog2e;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qv[g][e] = to_f(qb[g * D + part * E + e]) * qscale;

  // caches and scales are written below and read back: no __restrict__,
  // no read-only loads on them
  C* kb = k_cache + kvh0 * D;
  C* vb = v_cache + kvh0 * D;
  // the live positions [start, end): the window's, or all
  const int end = min(max(lengths[b], 0), S_max);
  const int start = window > 0 ? max(end - window, 0) : 0;
  const int nt = (end - start + TP - 1) / TP;

  if (new_k != nullptr) {
    const int w = min(max(lengths[b] - 1, 0), S_max - 1);
    const long long wo = rows.at(b, w);
    const T* nk = new_k + ((long long)b * KVH + kvh0) * D;
    const T* nv = new_v + ((long long)b * KVH + kvh0) * D;
    if constexpr (kInt8) {
      // 2 * HPB rows (K and V of each head), one a warp at a time
      constexpr int DPL = D / 32;
      for (int t = warp; t < 2 * HPB; t += kTileWarps) {
        const int h = t / 2;
        const T* src = (t % 2 == 0 ? nk : nv) + h * D;
        C* dst = (t % 2 == 0 ? kb : vb) + wo + h * D;
        float x[DPL], amax = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          x[j] = to_f(src[lane * DPL + j]);
          amax = fmaxf(amax, fabsf(x[j]));
        }
        const float s = warp_max(amax) / 127.0f;
        const float safe = s == 0.f ? 1.f : s;
#pragma unroll
        for (int j = 0; j < DPL; ++j) dst[lane * DPL + j] = quant_i8(x[j], safe);
        if (lane == 0)
          (t % 2 == 0 ? k_scale : v_scale)[(unsigned long long)wo / D + kvh0 +
                                           h] = safe;
      }
    } else {
      for (int d = tid; d < HPB * D; d += kTileThreads) {
        kb[wo + d] = nk[d];
        vb[wo + d] = nv[d];
      }
    }
    // the block's global writes are visible to all its threads (and their
    // cp.async reads) after this
    __syncthreads();
  }

  // Loads of tile n: thread tid copies chunk tid % CPP of positions
  // tid / CPP + i * PASS of K and of V; thread tid < 2 * TP the HPB
  // k-scales (tid < TP) or v-scales of position tid % TP.  K2 computes a
  // position's offset; K6 finds it in `offs`, where one thread per
  // position put it after its one table read.
  const int r0 = tid / CPP, cpart = tid % CPP;
  auto issue = [&](int n) {
    const int t0 = start + n * TP;
    unsigned char* st = ring + (n % kStages) * kTileBytes;
    const long long* of = offs + (n % kStages) * TP;
    auto row_at = [&](int r) {
      return Rows::kPaged ? of[r] : rows.at(b, t0 + r);
    };
#pragma unroll
    for (int i = 0; i < TP / PASS; ++i) {
      const int r = r0 + i * PASS;
      if (t0 + r < end) {
        const long long off = row_at(r) + cpart * (16 / ES);
        cp_async16(st + r * PB + cpart * 16, kb + off);
        cp_async16(st + (TP + r) * PB + cpart * 16, vb + off);
      }
    }
    if constexpr (kInt8) {
      const int r = tid % TP;
      if (tid < 2 * TP && t0 + r < end) {
        const float* src = (tid < TP ? k_scale : v_scale) +
                           (unsigned long long)row_at(r) / D + kvh0;
        cp_async_bytes<4 * HPB>(sc + ((n % kStages) * 2 * TP + tid) * HPB,
                                src);
      }
    }
  };

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // K6: the row offsets of tiles 0 .. kStages - 1 (table reads in
  // parallel, the only ones on the block's critical path); then fill the
  // ring with tiles 0 .. kStages - 2.
  // K6's thread tid < TP then walks its position of tiles kStages,
  // kStages + 1, ... with a cursor (no division by the page size per tile)
  typename Rows::Cursor cur{};
  if constexpr (Rows::kPaged) {
    if (tid < TP) {
#pragma unroll
      for (int n = 0; n < kStages; ++n) {
        const int pos = start + n * TP + tid;
        if (pos < end) offs[n * TP + tid] = rows.at(b, pos);
      }
    }
    cur = rows.cursor(start + kStages * TP + tid, TP);
    __syncthreads();
  }
#pragma unroll
  for (int n = 0; n < kStages - 1; ++n) {
    if (n < nt) issue(n);
    cp_async_commit();
  }

  for (int n = 0; n < nt; ++n) {
    cp_async_wait<kStages - 2>();  // tile n has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage n - 1 is free
    if (n + kStages - 1 < nt) issue(n + kStages - 1);
    cp_async_commit();
    // K6: the row offsets of tile n + kStages go into tile n's slot (its
    // rows are issued); the table read waits behind this tile's scoring
    const int fpos = start + (n + kStages) * TP + tid;
    const bool fetch = Rows::kPaged && tid < TP && fpos < end;
    int key = 0;
    if constexpr (Rows::kPaged) {
      if (fetch) key = rows.key_at(b, cur);
    }

    const unsigned char* st = ring + (n % kStages) * kTileBytes + head * RB;
    const float* scs = sc + (n % kStages) * 2 * TP * HPB + head;
    const int t0 = start + n * TP;
#pragma unroll
    for (int u0 = 0; u0 < U; u0 += UG) {
      float s[G][UG];
      bool valid[UG];
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        const int r = (ws * U + u0 + u) * SLOTS + slot;
        valid[u] = t0 + r < end;
        float kf[E];
        lds_slice<C, E>(st + r * PB, part, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {  // four partial sums: short chains
          float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < E; ++e) d[e % 4] = fmaf(qv[g][e], kf[e], d[e % 4]);
          s[g][u] = (d[0] + d[1]) + (d[2] + d[3]);
        }
      }
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int u = 0; u < UG; ++u)
            s[g][u] += __shfl_xor_sync(0xffffffffu, s[g][u], off);

#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < UG; ++u) {
          float x = s[g][u];
          if constexpr (kInt8)
            x *= scs[((ws * U + u0 + u) * SLOTS + slot) * HPB];
          s[g][u] = valid[u] ? x : kNegInf;
          mx = fmaxf(mx, s[g][u]);
        }
        // rescale only when the maximum grows: otherwise the factor is
        // exp2(0) = 1 exactly, so skipping it changes no bit
        if (mx > m[g]) {
          const float corr = exp2f(m[g] - mx);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= corr;
          m[g] = mx;
        }
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < UG; ++u) {
          s[g][u] = valid[u] ? exp2f(s[g][u] - mx) : 0.f;
          psum += s[g][u];
        }
        l[g] += psum;
      }
#pragma unroll
      for (int u = 0; u < UG; ++u) {
        if (valid[u]) {  // a row past the run holds stale or no data
          const int r = (ws * U + u0 + u) * SLOTS + slot;
          float vf[E];
          lds_slice<C, E>(st + (TP + r) * PB, part, vf);
          float vsc = 1.f;
          if constexpr (kInt8) vsc = scs[(TP + r) * HPB];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pv = kInt8 ? s[g][u] * vsc : s[g][u];
#pragma unroll
            for (int e = 0; e < E; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
          }
        }
      }
    }
    if constexpr (Rows::kPaged) {
      if (fetch) offs[(n % kStages) * TP + tid] = rows.at_cursor(key, cur);
      rows.advance(cur);
    }
  }

  // merge the lane groups of each warp (lanes part, part + LPR, ...)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mx = fmaxf(m[g], mo);
      const float ca = exp2f(m[g] - mx), cb = exp2f(mo - mx);
      l[g] = l[g] * ca + lo_ * cb;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * ca + ao * cb;
      }
      m[g] = mx;
    }
  }

  // each warp's state into the ring (every tile is consumed), then each
  // head's WPH states merge in warp order
  cp_async_wait<0>();
  __syncthreads();
  float* st_acc = reinterpret_cast<float*>(ring);  // [warp][G][D]
  float* st_ml = st_acc + kTileWarps * G * D;     // [warp][G][m, l]
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < E; ++e)
        st_acc[(warp * G + g) * D + part * E + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      st_ml[(warp * G + g) * 2] = m[g];
      st_ml[(warp * G + g) * 2 + 1] = l[g];
    }
  }
  __syncthreads();
  T* ob = out + ((long long)b * H + kvh0 * G) * D;
  for (int i = tid; i < HPB * G * D; i += kTileThreads) {
    const int h = i / (G * D), g = i / D % G, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = h * WPH; w < (h + 1) * WPH; ++w)
      mx = fmaxf(mx, st_ml[(w * G + g) * 2]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = h * WPH; w < (h + 1) * WPH; ++w) {
      const float c = exp2f(st_ml[(w * G + g) * 2] - mx);
      lsum = fmaf(st_ml[(w * G + g) * 2 + 1], c, lsum);
      o = fmaf(st_acc[(w * G + g) * D + d], c, o);
    }
    ob[i] = from_f<T>(o / (lsum == 0.f ? 1.f : lsum));
  }
}

// The int8 x int8 decode (JAX decode_int8_matmuls) over int8-KV caches:
// blocks of block_k positions in order.  Per block: scores = the integer
// dot of q_i8 and k_i8 times (qs * scale) times the k-scale; per head the
// block's max updates the running max m, p = exp(s - m), the running sum
// takes p, and pv = p * v-scale is quantized as rintf(pv / rsafe) with
// rmax = max(pv) / 127 (rsafe = rmax, or 1 where rmax is 0); the integer
// P.V of that times rmax joins acc * exp(m_old - m).  Integer sums are
// exact in any order, so the only order-dependent float sum is each
// block's sum of p (a lane-strided partial sum, then the warp tree).
template <typename T, int D, int G, typename Rows>
__global__ void __launch_bounds__(kDecThreads)
decode_i8mm_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_cache,
                   const int8_t* __restrict__ v_cache,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int KVH, int S_max, int block_k, int window, Rows rows,
                   Rows srows, float scale) {
  constexpr int W = D / 4;                 // int32 words per row of one head
  constexpr int R = kDecThreads / W;       // position groups of the PV sum
  static_assert(D % 32 == 0 && kDecThreads % W == 0, "head dim");
  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = KVH * G;
  __shared__ __align__(16) int8_t q8[G][D];  // q quantized per head
  __shared__ float qsc[G];                   // its scale times `scale`
  __shared__ float sc[G][kMaxBlockK];        // scores, then P * v-scale
  __shared__ int pq[G][kMaxBlockK];          // P quantized
  __shared__ int oi[G][D];                   // the block's integer P.V
  __shared__ float acc[G][D];
  __shared__ float m_s[G], l_s[G], corr_s[G], rmax_s[G];
  const int len = min(max(lengths[b], 0), S_max);
  // the window's first position (may be negative), and the first block
  // that reaches it
  const int lo = window > 0 ? len - window : 0;
  const int first = max(lo, 0) / block_k * block_k;

  if (warp < G) {  // warp g quantizes head g of q
    constexpr int DPL = D / 32;
    const T* qh = q + ((long long)b * H + kvh * G + warp) * D + lane * DPL;
    float x[DPL], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      x[j] = to_f(qh[j]);
      amax = fmaxf(amax, fabsf(x[j]));
    }
    float qs = warp_max(amax) / 127.0f;
    qs = qs == 0.f ? 1.f : qs;
#pragma unroll
    for (int j = 0; j < DPL; ++j) q8[warp][lane * DPL + j] = quant_i8(x[j], qs);
    if (lane == 0) {
      qsc[warp] = qs * scale;
      m_s[warp] = kNegInf;
      l_s[warp] = 0.f;
    }
  }
  for (int i = tid; i < G * D; i += kDecThreads) acc[i / D][i % D] = 0.f;
  __syncthreads();

  const int8_t* kb = k_cache + kvh * D;
  const int8_t* vb = v_cache + kvh * D;
  for (int t0 = first; t0 < len; t0 += block_k) {
    const int n = min(block_k, len - t0);
    // the block's rows below the window take no part: every loop below
    // starts at t_lo (their P is 0 in JAX, so no sum, max or product
    // changes)
    const int t_lo = max(lo - t0, 0);
    // scores, one position per thread: the row's D bytes as int4 loads
    for (int t = t_lo + tid; t < n; t += kDecThreads) {
      const int4* kr = reinterpret_cast<const int4*>(kb + rows.at(b, t0 + t));
      int kw[W];
#pragma unroll
      for (int w = 0; w < W / 4; ++w) {
        const int4 x = kr[w];
        kw[4 * w] = x.x;
        kw[4 * w + 1] = x.y;
        kw[4 * w + 2] = x.z;
        kw[4 * w + 3] = x.w;
      }
      const float ks = k_scale[srows.at(b, t0 + t) + kvh];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int* qw = reinterpret_cast<const int*>(q8[g]);
        int dot = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) dot = __dp4a(kw[w], qw[w], dot);
        sc[g][t] = (float)dot * qsc[g] * ks;
      }
    }
    for (int i = tid; i < G * D; i += kDecThreads) oi[i / D][i % D] = 0;
    __syncthreads();

    if (warp < G) {  // warp g: head g's softmax update and quantized P
      const int g = warp;
      float mx = kNegInf;
      for (int t = t_lo + lane; t < n; t += 32) mx = fmaxf(mx, sc[g][t]);
      const float m_new = fmaxf(m_s[g], warp_max(mx));
      float psum = 0.f, pmax = 0.f;
      for (int t = t_lo + lane; t < n; t += 32) {
        const float p = expf(sc[g][t] - m_new);
        psum += p;
        const float pv = p * v_scale[srows.at(b, t0 + t) + kvh];
        sc[g][t] = pv;
        pmax = fmaxf(pmax, pv);
      }
      psum = warp_sum(psum);
      const float rmax = warp_max(pmax) / 127.0f;
      const float rsafe = rmax == 0.f ? 1.f : rmax;
      for (int t = t_lo + lane; t < n; t += 32)
        pq[g][t] = quant_i8(sc[g][t], rsafe);
      if (lane == 0) {
        const float corr = expf(m_s[g] - m_new);
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
        corr_s[g] = corr;
        rmax_s[g] = rmax;
      }
    }
    __syncthreads();

    {  // P.V on integers: thread (r, word) sums positions r, r + R, ...
      const int word = tid % W, r = tid / W;
      int o[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) o[g][i] = 0;
      for (int t = t_lo + r; t < n; t += R) {
        const int vw = reinterpret_cast<const int*>(
            vb + rows.at(b, t0 + t))[word];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int p = pq[g][t];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            o[g][i] += p * (int)(int8_t)(vw >> (8 * i));
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int i = 0; i < 4; ++i) atomicAdd(&oi[g][4 * word + i], o[g][i]);
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += kDecThreads) {
      const int g = i / D, d = i % D;
      acc[g][d] = acc[g][d] * corr_s[g] + (float)oi[g][d] * rmax_s[g];
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * H + kvh * G) * D;
  for (int i = tid; i < G * D; i += kDecThreads) {
    const int g = i / D, d = i % D;
    ob[i] = from_f<T>(acc[g][d] / (l_s[g] == 0.f ? 1.f : l_s[g]));
  }
}

// decode_kernel over grid (KVH / hpb, B); hpb 2 only for G = 1
template <typename T, typename C, int HD, typename Rows>
int launch_decode(const void* q, void* k, void* v, void* ks, void* vs,
                  const void* lengths, const void* new_k, const void* new_v,
                  void* out, int B, int H, int KVH, int S_max, int window,
                  int hpb, Rows rows, float scale, cudaStream_t stream) {
  const dim3 grid(KVH / hpb, B);
#define DSTT_DECODE_G(GG, HH)                                                  \
  decode_kernel<T, C, HD, GG, HH, Rows><<<grid, kTileThreads, 0, stream>>>(    \
      (const T*)q, (C*)k, (C*)v, (float*)ks, (float*)vs, (const int*)lengths,  \
      (const T*)new_k, (const T*)new_v, (T*)out, KVH, S_max, window, rows,     \
      scale);                                                                  \
  break
  switch (H / KVH * 8 + hpb) {
    case 8 + 1: DSTT_DECODE_G(1, 1);
    case 8 + 2: DSTT_DECODE_G(1, 2);
    case 16 + 1: DSTT_DECODE_G(2, 1);
    case 32 + 1: DSTT_DECODE_G(4, 1);
    case 64 + 1: DSTT_DECODE_G(8, 1);
    default: return cudaErrorInvalidValue;
  }
#undef DSTT_DECODE_G
  return cudaSuccess;
}

template <typename T, int HD, typename Rows>
int launch_decode_i8mm(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* lengths,
                       void* out, int B, int H, int KVH, int S_max,
                       int block_k, int window, Rows rows, Rows srows,
                       float scale, cudaStream_t stream) {
  const dim3 grid(KVH, B);
#define DSTT_I8MM_G(GG)                                                        \
  decode_i8mm_kernel<T, HD, GG, Rows><<<grid, kDecThreads, 0, stream>>>(      \
      (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks,       \
      (const float*)vs, (const int*)lengths, (T*)out, KVH, S_max, block_k,     \
      window, rows, srows, scale)
  switch (H / KVH) {
    case 1: DSTT_I8MM_G(1); break;
    case 2: DSTT_I8MM_G(2); break;
    case 4: DSTT_I8MM_G(4); break;
    case 8: DSTT_I8MM_G(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef DSTT_I8MM_G
  return cudaSuccess;
}

}  // namespace dstt

// q [B, H, D] and out [B, H, D] contiguous; k_cache / v_cache one layer's
// contiguous [B, S_max, KVH*D], 16-byte aligned, in q's dtype -- or int8
// with k_scale / v_scale that layer's contiguous fp32 [B, S_max, KVH]
// (both null for a float cache); lengths [B] int32 on the device, counting
// this step's token; new_k / new_v [B, KVH, D] contiguous in q's dtype, or
// both null for the unfused call; window the sliding window's positions,
// <= 0 for none; hpb the kv heads of one block (1, or 2 dividing KVH at G
// = 1; int8 scales then aligned to 8 bytes).  G = H / KVH must be 1, 2, 4
// or 8.  Returns the launch's error, or cudaGetLastError().
extern "C" int dstt_decode_attention(const void* q, void* k_cache,
                                     void* v_cache, void* k_scale,
                                     void* v_scale, const void* lengths,
                                     const void* new_k, const void* new_v,
                                     void* out, int dtype, int B, int H,
                                     int KVH, int D, int S_max, int window,
                                     int hpb, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if (hpb < 1 || KVH % hpb != 0) return cudaErrorInvalidValue;
  if ((new_k == nullptr) != (new_v == nullptr)) return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::StridedRows rows{(long long)S_max * KVH * D, (long long)KVH * D};
#define DSTT_DECODE_LAUNCH(T, HD)                                              \
  {                                                                            \
    const int e = k_scale != nullptr                                           \
        ? dstt::launch_decode<T, int8_t, HD>(                                  \
              q, k_cache, v_cache, k_scale, v_scale, lengths, new_k, new_v,    \
              out, B, H, KVH, S_max, window, hpb, rows, scale,         \
              (cudaStream_t)stream)                                            \
        : dstt::launch_decode<T, T, HD>(                                       \
              q, k_cache, v_cache, k_scale, v_scale, lengths, new_k, new_v,    \
              out, B, H, KVH, S_max, window, hpb, rows, scale,         \
              (cudaStream_t)stream);                                           \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_DECODE_LAUNCH);
#undef DSTT_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

// K6.  k_pool / v_pool: one layer of the page pool, contiguous
// [num_pages, page, KVH*D], 16-byte aligned, in q's dtype -- or int8 with
// k_scale / v_scale that layer's fp32 [num_pages, page, KVH] (both null
// for a float pool); pages [B, n_virt] int32 on the device (dead lanes
// point at the trash page 0); lengths, new_k / new_v, q, out, window and
// hpb as for dstt_decode_attention.  page is any positive size.  Returns the launch's error, or
// cudaGetLastError().
extern "C" int dstt_paged_decode_attention(
    const void* q, void* k_pool, void* v_pool, void* k_scale, void* v_scale,
    const void* lengths, const void* pages, const void* new_k,
    const void* new_v, void* out, int dtype, int B, int H, int KVH, int D,
    int page, int n_virt, int window, int hpb, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0)
    return cudaErrorInvalidValue;
  if (hpb < 1 || KVH % hpb != 0) return cudaErrorInvalidValue;
  if ((new_k == nullptr) != (new_v == nullptr)) return cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
#define DSTT_PAGED_DECODE_LAUNCH(T, HD)                                        \
  {                                                                            \
    const int e = k_scale != nullptr                                           \
        ? dstt::launch_decode<T, int8_t, HD>(                                  \
              q, k_pool, v_pool, k_scale, v_scale, lengths, new_k, new_v, out, \
              B, H, KVH, page * n_virt, window, hpb, rows, scale,      \
              (cudaStream_t)stream)                                            \
        : dstt::launch_decode<T, T, HD>(                                       \
              q, k_pool, v_pool, k_scale, v_scale, lengths, new_k, new_v, out, \
              B, H, KVH, page * n_virt, window, hpb, rows, scale,      \
              (cudaStream_t)stream);                                           \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_PAGED_DECODE_LAUNCH);
#undef DSTT_PAGED_DECODE_LAUNCH
  return (int)cudaGetLastError();
}

// Positions of one decode_kernel tile: the K and V rows of hpb kv heads
// of D elements of cache_bytes each fill kTileBytes (for the card tests'
// lengths at tile edges).
extern "C" int dstt_decode_tile_positions(int cache_bytes, int D, int hpb) {
  return dstt::kTileBytes / (2 * hpb * D * cache_bytes);
}

// K2's int8 x int8 mode: int8 caches and fp32 scales as for
// dstt_decode_attention (required), no fused write; block_k the KV block
// of P's quantization, 1 .. 512 (the JAX kernel's min(block_k, S_max));
// window as for dstt_decode_attention.
extern "C" int dstt_decode_attention_i8mm(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths, void* out,
    int dtype, int B, int H, int KVH, int D, int S_max, int block_k,
    int window, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > dstt::kMaxBlockK) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::StridedRows rows{(long long)S_max * KVH * D, (long long)KVH * D};
  const dstt::StridedRows srows{(long long)S_max * KVH, (long long)KVH};
#define DSTT_I8MM_LAUNCH(T, HD)                                                \
  {                                                                            \
    const int e = dstt::launch_decode_i8mm<T, HD>(                             \
        q, k_cache, v_cache, k_scale, v_scale, lengths, out, B, H, KVH, S_max, \
        block_k, window, rows, srows, scale, (cudaStream_t)stream);            \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_I8MM_LAUNCH);
#undef DSTT_I8MM_LAUNCH
  return (int)cudaGetLastError();
}

// K6's int8 x int8 mode: the pool, scales and table as for
// dstt_paged_decode_attention (int8, scales required), no fused write;
// block_k the KV block of P's quantization in virtual positions, 1 .. 512
// (the page, as the JAX paged kernel; a windowed layer's gathered-view
// route takes min(512, page * n_virt)); window as for
// dstt_decode_attention.
extern "C" int dstt_paged_decode_attention_i8mm(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* pages, void* out, int dtype, int B, int H, int KVH, int D,
    int page, int n_virt, int block_k, int window, float scale,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0)
    return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > dstt::kMaxBlockK) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
  const dstt::PagedRows srows{(const int*)pages, n_virt, page, (long long)KVH};
#define DSTT_PAGED_I8MM_LAUNCH(T, HD)                                          \
  {                                                                            \
    const int e = dstt::launch_decode_i8mm<T, HD>(                             \
        q, k_pool, v_pool, k_scale, v_scale, lengths, out, B, H, KVH,          \
        page * n_virt, block_k, window, rows, srows, scale,                    \
        (cudaStream_t)stream);                                                 \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_PAGED_I8MM_LAUNCH);
#undef DSTT_PAGED_I8MM_LAUNCH
  return (int)cudaGetLastError();
}
