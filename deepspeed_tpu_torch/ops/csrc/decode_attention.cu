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
// min(512, S_max) for K2 and the page for K6), in order, and quantizes a
// block's P whole.  With a window it starts at the block holding
// lengths[b] - window (the JAX kernel skips every block wholly below it)
// and leaves that block's rows below the window out of every tile (JAX
// masks them to P = 0).  It is bound by bytes too (about 2 integer
// operations a byte), so it keeps decode_kernel's shape: 4 warps, the
// same ring of 8 KB tiles, 2 kv heads a block by the same rule, K6's
// table read once per position a tile ahead.  A tile holds a block's K
// rows or its V rows: the ring takes a block's K tiles, then its V tiles,
// then the next block's K tiles, so the loads run ahead of the block's
// softmax and across blocks, while the block's scores and P stay in
// shared memory (decode_i8mm_kernel's own note has the phases).
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

// decode_i8mm_kernel (the int8 x int8 mode): decode_kernel's warps and
// ring, a tile holding the K or the V rows of its positions
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

// decode_i8mm_kernel's shared memory, all dynamic, in bytes from its base:
// the ring of kStages tiles (a tile: the K or the V rows of TP positions
// of HPB kv heads, kTileBytes), the k-scales of each stage, two slots of
// the blocks' integer P.V sums, q quantized, the warps' partial maxima /
// sums, q's scales; then per KV block of bkp positions (block_k rounded up
// to a quad): two slots of v-scales (and of K6's pool rows), the block's
// scores (then P * v-scale) and its quantized P.
template <int D, int G, int HPB, bool kPaged>
struct MmSmem {
  static constexpr int kHG = HPB * G;               // query heads of a block
  static constexpr int kTP = kTileBytes / (HPB * D);  // positions of a tile
  static constexpr int kKs = kStages * kTileBytes;    // [kStages][TP * HPB]
  static constexpr int kOi = kKs + kStages * kTP * HPB * 4;  // [2][HG * D]
  static constexpr int kQ8 = kOi + 2 * kHG * D * 4;          // [HG][D]
  static constexpr int kPart = kQ8 + kHG * D;      // [3][kTileWarps][HG]
  static constexpr int kQs = kPart + 3 * kTileWarps * kHG * 4;  // [HG]
  static constexpr int kBlock = kQs + (kHG * 4 + 15) / 16 * 16;
  __host__ __device__ static constexpr int bytes(int bkp) {
    return kBlock + bkp * (8 * HPB + (kPaged ? 8 : 0) + 5 * kHG);
  }
};

// A place in decode_i8mm_kernel's stream of tiles: tile i (K, or V when
// v) of the KV block starting at t0 whose live positions are [a, e); par
// the block's parity (its slots of the two-slot arrays).
struct MmWalk {
  int t0, a, e, i;
  bool v;
  int par;
  __device__ __forceinline__ bool live() const { return a < e; }
};

// a[i] for a runtime i, from registers
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float x = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) x = i == k ? a[k] : x;
  return x;
}
// The int8 x int8 decode (JAX decode_int8_matmuls) over int8-KV caches:
// blocks of block_k positions in order.  Per block: scores = the integer
// dot of q_i8 and k_i8 times (qs * scale) times the k-scale; per head the
// block's max updates the running max m, p = exp(s - m), the running sum
// takes p, and pv = p * v-scale is quantized as rintf(pv / rsafe) with
// rmax = max(pv) / 127 (rsafe = rmax, or 1 where rmax is 0); the integer
// P.V of that times rmax joins acc * exp(m_old - m).  Integer sums are
// exact in any order, so the only order-dependent float sum is each
// block's sum of p: lane partial sums, the warp's xor tree, then the 4
// warps in order.
//
// The stream of tiles.  A block's live positions [a, e) are cut into
// tiles of TP positions from a (the last one shorter; a block of fewer
// positions is one short tile); the ring takes block j's K tiles (each
// with its positions' k-scales, and their v-scales into a per-block
// array), then block j's V tiles, then block j + 1's K tiles, and so on,
// kStages - 1 tiles ahead of the one consumed: the copies run across the
// phases of a block and across blocks.  A warp owns positions [w * PW,
// (w + 1) * PW) of every tile, K or V, so it quantizes the P it reads
// itself; the block's scores, P * v-scale and quantized P (`sc`, `pq`)
// stay in shared memory for the whole block.  Per block:
//   K tiles: a row over LPR lanes of 16 bytes, four __dp4a and a
//     log2(LPR) shuffle sum; each lane keeps the max of its scores;
//   the warps' maxima, a barrier, the block max; p, p * v-scale, the
//     warps' sums of p and maxima of p * v-scale (all lanes);
//   V tiles (after the first one's ring barrier, which also publishes
//     those sums): every thread merges the 4 warps in order (the same
//     bits in every thread, so each keeps the running m / l itself), the
//     warp quantizes its P (zero-padded to a quad), then a lane sums C
//     columns of one head over quads of 4 positions: a 4 x 4 byte
//     transpose of 4 rows and one __dp4a per column against the quad's
//     packed P;
//   the lanes of a (head, columns) slice add up (xor shuffles, where a
//     slice has more than one lane) and atomicAdd their sums into `oi`
//     (integers: exact in any order); the owner of each output folds
//     them into its accumulator after the next barrier (acc * corr + oi *
//     rmax, no contraction, the reference's rounding), so the merge costs
//     no barrier of its own.
//
// Occupancy: 2 kv heads a block (K6-i8mm's launch of 1,536 blocks at B 96)
// run 6 blocks an SM within 80 registers, no spill (unbounded it takes
// 104 and 4 blocks: 0.0462 against 0.0417 ms a call on an H100, both in
// one run); one head a block keeps 4 (K2-i8mm's 512 blocks fill the card
// once anyway, and the tighter bound made it slower: 0.0093 against
// 0.0083); G >= 4 takes 2, as decode_kernel.
template <typename T, int D, int G, int HPB, typename Rows>
__global__ void __launch_bounds__(kTileThreads,
                                  G >= 4 ? 2 : (HPB == 2 ? 6 : 4))
decode_i8mm_kernel(const T* __restrict__ q, const int8_t* __restrict__ k_cache,
                   const int8_t* __restrict__ v_cache,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ lengths, T* __restrict__ out,
                   int KVH, int S_max, int block_k, int window, Rows rows,
                   float scale) {
  using Smem = MmSmem<D, G, HPB, Rows::kPaged>;
  constexpr int HG = Smem::kHG, TP = Smem::kTP;
  constexpr int PB = HPB * D;                 // bytes of a position's rows
  constexpr int CPP = PB / 16;                // their 16-byte chunks
  constexpr int PASS = kTileThreads / CPP;    // positions of a load pass
  constexpr int PW = TP / kTileWarps;         // a warp's positions of a tile
  constexpr int RW = PW * HPB;                // ... and their rows
  constexpr int LPR = D / 16, SLOTS = 32 / LPR;  // scoring lanes
  // P.V: a lane sums C columns of one head (G * C integers), the fewest
  // that let a warp's lanes cover a row's HPB heads at once (narrower
  // slices than 16 bytes: fewer registers, and no lanes to add up at the
  // block's end; measured faster)
  constexpr int C = HPB * D / 32 > 4 ? HPB * D / 32 : 4;
  constexpr int CS = D / C;                   // column slices of a row
  constexpr int QPP = 32 / (HPB * CS);        // quads a warp takes at once
  constexpr int NQ = PW / 4;                  // a warp's quads of a tile
  constexpr int NOWN = (HG * D + kTileThreads - 1) / kTileThreads;
  static_assert(HPB == 1 || (HPB == 2 && G == 1), "2 heads a block at G = 1");
  static_assert(TP % PASS == 0 && TP <= kTileThreads, "load map");
  static_assert(RW % SLOTS == 0 && SLOTS % HPB == 0, "score map");
  static_assert(PW % 4 == 0 && QPP >= 1 && NQ % QPP == 0, "P.V map");

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* ksr = reinterpret_cast<float*>(smem + Smem::kKs);
  int* oi = reinterpret_cast<int*>(smem + Smem::kOi);
  int8_t* q8 = reinterpret_cast<int8_t*>(smem + Smem::kQ8);
  float* wmax = reinterpret_cast<float*>(smem + Smem::kPart);  // [warp][HG]
  float* wsum = wmax + kTileWarps * HG;
  float* wpmax = wsum + kTileWarps * HG;
  float* qsc = reinterpret_cast<float*>(smem + Smem::kQs);
  const int bkp = (block_k + 3) & ~3;
  float* vsb = reinterpret_cast<float*>(smem + Smem::kBlock);
  int* prow = reinterpret_cast<int*>(vsb + 2 * bkp * HPB);
  float* sc = reinterpret_cast<float*>(prow + (Rows::kPaged ? 2 * bkp : 0));
  int8_t* pq = reinterpret_cast<int8_t*>(sc + HG * bkp);

  const int kvh0 = blockIdx.x * HPB, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = KVH * G;
  // q quantized per head (max|q| / 127, 1 where 0), warp w taking heads
  // w, w + 4 of the block's HG
  for (int hg = warp; hg < HG; hg += kTileWarps) {
    constexpr int DPL = D / 32;
    const T* qh = q + ((long long)b * H + kvh0 * G + hg) * D + lane * DPL;
    float x[DPL], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      x[j] = to_f(qh[j]);
      amax = fmaxf(amax, fabsf(x[j]));
    }
    float qs = warp_max(amax) / 127.0f;
    qs = qs == 0.f ? 1.f : qs;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      q8[hg * D + lane * DPL + j] = quant_i8(x[j], qs);
    if (lane == 0) qsc[hg] = qs * scale;
  }
  for (int i = tid; i < 2 * HG * D; i += kTileThreads) oi[i] = 0;

  const int len = min(max(lengths[b], 0), S_max);
  // the window's first position, and the block holding it
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int first = start / block_k * block_k;
  const MmWalk w0{first, start, min(first + block_k, len), 0, false, 0};
  auto next_block = [&](MmWalk& w) {  // its K tiles
    w = {w.t0 + block_k, w.t0 + block_k, min(w.t0 + 2 * block_k, len), 0,
         false, w.par ^ 1};
  };
  auto walk_next = [&](MmWalk& w) {
    if (w.a + (w.i + 1) * TP < w.e) {
      ++w.i;
    } else if (!w.v) {
      w.i = 0;
      w.v = true;
    } else {
      next_block(w);
    }
  };
  // element offset of position u of w's block (K6: its pool row, read
  // once from the table into `prow`)
  auto row_off = [&](const MmWalk& w, int u) -> long long {
    if constexpr (Rows::kPaged)
      return (long long)prow[w.par * bkp + u] * rows.row;
    else
      return rows.at(b, w.a + u);
  };

  // Loads of the tile at w into stage n % kStages: thread tid copies chunk
  // tid % CPP of positions tid / CPP + k * PASS; a K tile's thread tid <
  // its positions also the HPB k-scales (into the stage's) and v-scales
  // (into the block's) of position tid.
  const int r0 = tid / CPP, cpart = tid % CPP;
  const int8_t* kb = k_cache + kvh0 * D;
  const int8_t* vb = v_cache + kvh0 * D;
  auto issue = [&](const MmWalk& w, int n) {
    const int u0 = w.i * TP, np = min(TP, w.e - w.a - u0);
    unsigned char* st = ring + (n % kStages) * kTileBytes;
    const int8_t* src = w.v ? vb : kb;
#pragma unroll
    for (int k = 0; k < TP / PASS; ++k) {
      const int r = r0 + k * PASS;
      if (r < np)
        cp_async16(st + r * PB + cpart * 16,
                   src + row_off(w, u0 + r) + cpart * 16);
    }
    if (!w.v && tid < np) {
      const unsigned long long so =
          (unsigned long long)row_off(w, u0 + tid) / D + kvh0;
      cp_async_bytes<4 * HPB>(ksr + ((n % kStages) * TP + tid) * HPB,
                              k_scale + so);
      cp_async_bytes<4 * HPB>(vsb + (w.par * bkp + u0 + tid) * HPB,
                              v_scale + so);
    }
  };

  // K6: thread tid < TP reads the table entry of its position of each K
  // tile once, while the tile before it is consumed, with two cursors (no
  // division per tile): tc at its position in the next K tile, bc at its
  // position in the next block's first.  Positions past the block's live
  // ones read nothing.
  typename Rows::Cursor tc{}, bc{};
  if constexpr (Rows::kPaged) {
    tc = rows.cursor(start + tid, TP);
    bc = rows.cursor(first + block_k + tid, block_k);
  }
  auto fetches = [&](const MmWalk& w) {
    return w.live() && !w.v && tid < TP && w.a + w.i * TP + tid < w.e;
  };
  auto fetch_key = [&](const MmWalk& w) {
    int key = 0;
    if constexpr (Rows::kPaged) {
      if (fetches(w)) key = rows.key_at(b, tc);
    }
    return key;
  };
  auto fetch_store = [&](const MmWalk& w, int key) {
    if constexpr (Rows::kPaged) {
      if (!w.live() || w.v) return;
      if (fetches(w))
        prow[w.par * bkp + w.i * TP + tid] = rows.pool_row(key, tc);
      if (w.a + (w.i + 1) * TP < w.e) {
        rows.advance(tc);
      } else {
        tc.vpg = bc.vpg;
        tc.inp = bc.inp;
        rows.advance(bc);
      }
    }
  };
  if constexpr (Rows::kPaged) {  // the K tiles among the first kStages
    MmWalk w = w0;
#pragma unroll
    for (int m = 0; m < kStages; ++m) {
      fetch_store(w, fetch_key(w));
      walk_next(w);
    }
  }
  __syncthreads();  // q8, qsc, oi and the first rows

  // scoring: lane (slot, part) scores rows warp * RW + p * SLOTS + slot
  // (head hs = slot % HPB) from bytes part * 16 of the row
  const int part = lane % LPR, slot = lane / LPR, hs = slot % HPB;
  uint32_t qw[G][4];
  float qsr[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lds_words<4>(reinterpret_cast<const unsigned char*>(q8) +
                     (hs * G + g) * D + part * 16, qw[g]);
    qsr[g] = qsc[hs * G + g];
  }
  // P.V: lane (qg, hv, cs) sums columns cs * C .. of head hv over quads
  const int cs = lane % CS, hv = lane / CS % HPB, qg = lane / (CS * HPB);

  MmWalk iw = w0;  // the next tile to issue
#pragma unroll
  for (int m = 0; m < kStages - 1; ++m) {
    if (iw.live()) {
      issue(iw, m);
      walk_next(iw);
    }
    cp_async_commit();
  }
  int n = 0;  // the stream index of the tile consumed next
  auto step = [&]() {
    cp_async_wait<kStages - 2>();  // tile n has landed (this thread's part)
    __syncthreads();               // ... everyone's; stage n - 1 is free
    if (iw.live()) {
      issue(iw, n + kStages - 1);
      walk_next(iw);
    }
    cp_async_commit();
  };

  float m_run[HG], l_run[HG], pc[HG], pr[HG], acc[NOWN];
#pragma unroll
  for (int hg = 0; hg < HG; ++hg) {
    m_run[hg] = kNegInf;
    l_run[hg] = 0.f;
    pc[hg] = pr[hg] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < NOWN; ++k) acc[k] = 0.f;
  // the previous block's P.V sums into acc, after a barrier that follows
  // its atomics; its slot of oi is zeroed for the block after next
  bool pending = false;
  int ppar = 0;
  auto merge = [&]() {
#pragma unroll
    for (int k = 0; k < NOWN; ++k) {
      const int i = tid + k * kTileThreads;
      if (i < HG * D) {
        int* o = oi + ppar * HG * D + i;
        const float s = (float)*o;
        *o = 0;
        acc[k] = __fadd_rn(__fmul_rn(acc[k], pick(pc, i / D)),
                           __fmul_rn(s, pick(pr, i / D)));
      }
    }
    pending = false;
  };

  for (MmWalk cw = w0; cw.live();) {
    const int nl = cw.e - cw.a;            // the block's live positions
    const int nt = (nl + TP - 1) / TP;     // its K tiles, and V tiles
    const int items = nt * PW;             // a warp's positions of them
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = kNegInf;
    for (int i = 0; i < nt; ++i, ++n) {  // scores
      step();
      if (pending) merge();
      const int key = fetch_key(iw);
      const unsigned char* st = ring + (n % kStages) * kTileBytes;
      const float* ks = ksr + (n % kStages) * TP * HPB;
      const int np = min(TP, nl - i * TP);
#pragma unroll
      for (int p = 0; p < RW / SLOTS; ++p) {
        if (warp * PW + p * SLOTS / HPB >= np) break;  // warp-uniform
        const int r = warp * RW + p * SLOTS + slot;   // row of the tile
        uint32_t kw[4];
        lds_words<4>(st + r * D + part * 16, kw);
        int dot[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          dot[g] = __dp4a((int)kw[0], (int)qw[g][0], 0);
          dot[g] = __dp4a((int)kw[1], (int)qw[g][1], dot[g]);
          dot[g] = __dp4a((int)kw[2], (int)qw[g][2], dot[g]);
          dot[g] = __dp4a((int)kw[3], (int)qw[g][3], dot[g]);
        }
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < G; ++g)
            dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        const int pl = r / HPB;  // the row's position in the tile
        if (pl < np) {
          const float ksc = ks[r];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float s = (float)dot[g] * qsr[g] * ksc;
            mx[g] = fmaxf(mx[g], s);
            if (g % LPR == part) sc[(hs * G + g) * bkp + i * TP + pl] = s;
          }
        }
      }
      fetch_store(iw, key);
    }
    // the block's max: the warps' maxima
#pragma unroll
    for (int hh = 0; hh < HPB; ++hh)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float v = warp_max(hs == hh ? mx[g] : kNegInf);
        if (lane == 0) wmax[warp * HG + hh * G + g] = v;
      }
    __syncthreads();
    float m_new[HG];
#pragma unroll
    for (int hg = 0; hg < HG; ++hg) {
      float mb = wmax[hg];
#pragma unroll
      for (int w = 1; w < kTileWarps; ++w) mb = fmaxf(mb, wmax[w * HG + hg]);
      m_new[hg] = fmaxf(m_run[hg], mb);
    }
    // p and p * v-scale of the warp's positions; the warp's sum of p and
    // max of p * v-scale
#pragma unroll
    for (int hg = 0; hg < HG; ++hg) {
      float ps = 0.f, pm = 0.f;
      float* sh = sc + hg * bkp;
      for (int e = lane; e < items; e += 32) {
        const int u = e / PW * TP + warp * PW + e % PW;
        if (u < nl) {
          const float p = expf(sh[u] - m_new[hg]);
          const float pv = p * vsb[(cw.par * bkp + u) * HPB + hg / G];
          ps += p;
          sh[u] = pv;
          pm = fmaxf(pm, pv);
        }
      }
      ps = warp_sum(ps);
      pm = warp_max(pm);
      if (lane == 0) {
        wsum[warp * HG + hg] = ps;
        wpmax[warp * HG + hg] = pm;
      }
    }

    int o[G][C];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < C; ++c) o[g][c] = 0;
    for (int i = 0; i < nt; ++i, ++n) {  // P.V
      step();
      const int key = fetch_key(iw);
      if (i == 0) {
        // the block's softmax update (the 4 warps in order, in every
        // thread) and its P quantized whole, zero-padded to a quad
        float rs[HG];
#pragma unroll
        for (int hg = 0; hg < HG; ++hg) {
          float ps = wsum[hg], pm = wpmax[hg];
#pragma unroll
          for (int w = 1; w < kTileWarps; ++w) {
            ps += wsum[w * HG + hg];
            pm = fmaxf(pm, wpmax[w * HG + hg]);
          }
          const float rmax = pm / 127.0f;
          rs[hg] = rmax == 0.f ? 1.f : rmax;
          const float corr = expf(m_run[hg] - m_new[hg]);
          l_run[hg] = __fadd_rn(__fmul_rn(l_run[hg], corr), ps);
          m_run[hg] = m_new[hg];
          pc[hg] = corr;
          pr[hg] = rmax;
        }
        const int nl4 = (nl + 3) & ~3;
#pragma unroll
        for (int hg = 0; hg < HG; ++hg)
          for (int e = lane; e < items; e += 32) {
            const int u = e / PW * TP + warp * PW + e % PW;
            if (u < nl4)
              pq[hg * bkp + u] =
                  u < nl ? quant_i8(sc[hg * bkp + u], rs[hg]) : (int8_t)0;
          }
        __syncwarp();
      }
      const unsigned char* st = ring + (n % kStages) * kTileBytes;
      const int np = min(TP, nl - i * TP);
#pragma unroll
      for (int p = 0; p < NQ / QPP; ++p) {
        const int pl0 = warp * PW + (p * QPP + qg) * 4;  // the quad's first
        if (pl0 < np) {
          // rows past the live ones hold stale bytes: their P is 0
          uint32_t w[4][C / 4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            lds_words<C / 4>(st + ((pl0 + k) * HPB + hv) * D + cs * C, w[k]);
          int pw[G];
#pragma unroll
          for (int g = 0; g < G; ++g)
            pw[g] = *reinterpret_cast<const int*>(pq + (hv * G + g) * bkp +
                                                   i * TP + pl0);
#pragma unroll
          for (int j = 0; j < C / 4; ++j) {
            // column c of the 4 rows as one word (byte k: row k)
            const uint32_t lo01 = __byte_perm(w[0][j], w[1][j], 0x5140);
            const uint32_t hi01 = __byte_perm(w[0][j], w[1][j], 0x7362);
            const uint32_t lo23 = __byte_perm(w[2][j], w[3][j], 0x5140);
            const uint32_t hi23 = __byte_perm(w[2][j], w[3][j], 0x7362);
            const int col[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                                (int)__byte_perm(lo01, lo23, 0x7632),
                                (int)__byte_perm(hi01, hi23, 0x5410),
                                (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                o[g][4 * j + c] = __dp4a(col[c], pw[g], o[g][4 * j + c]);
          }
        }
      }
      fetch_store(iw, key);
    }
    // the slice's lanes add up; the block's sums into its slot of oi
#pragma unroll
    for (int off = HPB * CS; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < C; ++c)
          o[g][c] += __shfl_xor_sync(0xffffffffu, o[g][c], off);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c % QPP == qg)
          atomicAdd(oi + (cw.par * HG + hv * G + g) * D + cs * C + c, o[g][c]);
    pending = true;
    ppar = cw.par;
    next_block(cw);
  }

  cp_async_wait<0>();
  __syncthreads();
  if (pending) merge();
  T* ob = out + ((long long)b * H + kvh0 * G) * D;
#pragma unroll
  for (int k = 0; k < NOWN; ++k) {
    const int i = tid + k * kTileThreads;
    if (i < HG * D) {
      const float l = pick(l_run, i / D);
      ob[i] = from_f<T>(acc[k] / (l == 0.f ? 1.f : l));
    }
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

// decode_i8mm_kernel over grid (KVH / hpb, B); hpb 2 only for G = 1
template <typename T, int HD, typename Rows>
int launch_decode_i8mm(const void* q, const void* k, const void* v,
                       const void* ks, const void* vs, const void* lengths,
                       void* out, int B, int H, int KVH, int S_max,
                       int block_k, int window, int hpb, Rows rows,
                       float scale, cudaStream_t stream) {
  const dim3 grid(KVH / hpb, B);
  const int bkp = (block_k + 3) & ~3;
#define DSTT_I8MM_G(GG, HH)                                                    \
  {                                                                            \
    auto kernel = decode_i8mm_kernel<T, HD, GG, HH, Rows>;                     \
    const int smem = MmSmem<HD, GG, HH, Rows::kPaged>::bytes(bkp);             \
    if (smem > 48 * 1024)                                                      \
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,\
                           smem);                                              \
    kernel<<<grid, kTileThreads, smem, stream>>>(                              \
        (const T*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks,     \
        (const float*)vs, (const int*)lengths, (T*)out, KVH, S_max, block_k,   \
        window, rows, scale);                                                  \
  }                                                                            \
  break
  switch (H / KVH * 8 + hpb) {
    case 8 + 1: DSTT_I8MM_G(1, 1);
    case 8 + 2: DSTT_I8MM_G(1, 2);
    case 16 + 1: DSTT_I8MM_G(2, 1);
    case 32 + 1: DSTT_I8MM_G(4, 1);
    case 64 + 1: DSTT_I8MM_G(8, 1);
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
// window and hpb as for dstt_decode_attention.
extern "C" int dstt_decode_attention_i8mm(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* lengths, void* out,
    int dtype, int B, int H, int KVH, int D, int S_max, int block_k,
    int window, int hpb, float scale, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || S_max <= 0) return cudaErrorInvalidValue;
  if (hpb < 1 || KVH % hpb != 0) return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > dstt::kMaxBlockK) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::StridedRows rows{(long long)S_max * KVH * D, (long long)KVH * D};
#define DSTT_I8MM_LAUNCH(T, HD)                                                \
  {                                                                            \
    const int e = dstt::launch_decode_i8mm<T, HD>(                             \
        q, k_cache, v_cache, k_scale, v_scale, lengths, out, B, H, KVH, S_max, \
        block_k, window, hpb, rows, scale, (cudaStream_t)stream);              \
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
// route takes min(512, page * n_virt)); window and hpb as for
// dstt_decode_attention.
extern "C" int dstt_paged_decode_attention_i8mm(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* lengths,
    const void* pages, void* out, int dtype, int B, int H, int KVH, int D,
    int page, int n_virt, int block_k, int window, int hpb, float scale,
    void* stream) {
  if (KVH <= 0 || H % KVH != 0 || page <= 0 || n_virt <= 0)
    return cudaErrorInvalidValue;
  if (hpb < 1 || KVH % hpb != 0) return cudaErrorInvalidValue;
  if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
  if (block_k <= 0 || block_k > dstt::kMaxBlockK) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dstt::PagedRows rows{(const int*)pages, n_virt, page,
                             (long long)KVH * D};
#define DSTT_PAGED_I8MM_LAUNCH(T, HD)                                          \
  {                                                                            \
    const int e = dstt::launch_decode_i8mm<T, HD>(                             \
        q, k_pool, v_pool, k_scale, v_scale, lengths, out, B, H, KVH,          \
        page * n_virt, block_k, window, hpb, rows, scale,                      \
        (cudaStream_t)stream);                                                 \
    if (e != cudaSuccess) return e;                                            \
  }
  DSTT_DISPATCH(dtype, D, DSTT_PAGED_I8MM_LAUNCH);
#undef DSTT_PAGED_I8MM_LAUNCH
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a decode_i8mm_kernel launch (D 64 / 128, G =
// H / KVH, hpb, paged 1 for K6, block_k), or 0 for no instantiation.
extern "C" int dstt_decode_i8mm_smem(int D, int G, int hpb, int paged,
                                     int block_k) {
  const int bkp = (block_k + 3) & ~3;
#define DSTT_I8MM_SMEM(HD)                                                     \
  switch (G * 8 + hpb) {                                                       \
    case 8 + 1: return paged ? dstt::MmSmem<HD, 1, 1, true>::bytes(bkp)        \
                             : dstt::MmSmem<HD, 1, 1, false>::bytes(bkp);      \
    case 8 + 2: return paged ? dstt::MmSmem<HD, 1, 2, true>::bytes(bkp)        \
                             : dstt::MmSmem<HD, 1, 2, false>::bytes(bkp);      \
    case 16 + 1: return paged ? dstt::MmSmem<HD, 2, 1, true>::bytes(bkp)       \
                              : dstt::MmSmem<HD, 2, 1, false>::bytes(bkp);     \
    case 32 + 1: return paged ? dstt::MmSmem<HD, 4, 1, true>::bytes(bkp)       \
                              : dstt::MmSmem<HD, 4, 1, false>::bytes(bkp);     \
    case 64 + 1: return paged ? dstt::MmSmem<HD, 8, 1, true>::bytes(bkp)       \
                              : dstt::MmSmem<HD, 8, 1, false>::bytes(bkp);     \
    default: return 0;                                                         \
  }
  if (D == 64) DSTT_I8MM_SMEM(64);
  if (D == 128) DSTT_I8MM_SMEM(128);
#undef DSTT_I8MM_SMEM
  return 0;
}
