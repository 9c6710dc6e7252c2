#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``deepspeed_tpu_torch``) on one GPU.

Run from the root of a checkout:  ``python3 chip_smoke.py``

1. builds the attention kernels from ``deepspeed_tpu_torch/ops/csrc`` with
   ``nvcc`` for sm_90a (one compiler process per source, started together);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes OPT-1.3B's serving and training paths give it (bf16 at atol =
   rtol = 2e-2, the output's bf16 rounding, except the backward kernels,
   see ``BWD_BF16_REL``; fp32 at 1e-4, summation order), and times
   kernel, plain version and ``F.scaled_dot_product_attention`` (forward,
   or its backward for K4 / K5: a yardstick the port never calls) by
   their device time in ``torch.profiler``'s kernel records, beside the
   card's bound;
3. drives the port's serving path — ``init_inference(opt_model("opt-1.3b"))``
   with seeded random weights, then ``generate`` — once with one-pass
   prefill (a) and once with chunked prefill (b), counting each kernel's
   launches in each run, and checks the outputs against the plain path on
   the card; run (a) goes once more under ``torch.profiler``, and a
   ``profile`` line gives its device busy time, idle share and device time
   by kernel group (trace in ``build/profiles/generate_trace.json``);
4. drives the port's continuous-batching server on the same weights:
   run (d), ``engine.serve(paged=True)`` — 96 slots over a page pool at
   0.75 of the worst case — answers 192 mixed requests through K7
   (admission prefill) and K6 (decode), with exact launch counts, then the
   same requests on monolithic slot lanes (K3 / K2) must give every
   request the same tokens; a decode window with all 96 slots live goes
   once more under ``torch.profiler`` (a ``profile`` line, trace in
   ``build/profiles/serving_trace.json``); run (e) serves 24 requests
   behind one 512-token system prompt and must reuse its pages 23 times
   with outputs equal to the same requests without prefix sharing;
5. drives the port's training path (c) — ``initialize(opt_model(
   "opt-1.3b", max_seq_len=2048))`` with bf16, AdamW and clipping, then
   ``train_batch`` on one seeded [2, 2048] batch, 2 warm-up and 5 timed
   steps — counting 24 K1, 24 K4 and 24 K5 launches per step, checking that
   the loss is finite and falls, and profiling one more step; then holds
   the kernel path's loss and gradients against the dense attention's on a
   2-layer cut of the same widths (cosine per parameter);
6. holds K8 (block-sparse attention) and its LSE against its plain
   version at the shape every layer of run (f) gives it — q/k/v [1, 8192,
   32, 64], the BigBird layout of ``docs/tutorials/long-context.md``,
   causal — and at blocks 16 / 32 / 128, a ragged S of 1040 at block 16,
   head dim 128, a layout per head, a key-padding mask and an empty
   block-row (exactly 0, LSE -1e30), each launched twice and bitwise the
   same; all timed in bf16 beside their bounds, plain versions and SDPA
   with the layout expanded to an [S, S] mask (its ``library_ms``); a
   ``ptxas_sparse`` line gives registers, spills and shared memory of
   every K8 instantiation (``wgmma_sparse_fwd_kernel`` for bf16 / fp16,
   the FMA ``block_sparse_fwd_kernel`` for fp32);
7. drives block-sparse long-context training (f) — ``initialize(opt_model(
   "opt-1.3b", max_seq_len=8192, sparse_attention=BigBird...))`` with
   remat, bf16, AdamW and clipping, 2 warm-up and 3 timed ``train_batch``
   steps on one seeded [1, 8192] batch — counting 48 K8 launches per step
   (forward and remat's recompute, 24 layers) and no other attention
   kernel, checking that the loss is finite and falls, and profiling one
   more step (``build/profiles/sparse_train_trace.json``); then holds K8
   plus the gather backward against dense attention masked by the same
   layout on a 2-layer cut at seq 2048 (cosine per parameter);
8. holds the int8 modes against their plain versions at the shapes of
   runs (g) and (h): K2-int8 (fused, one all-zero fresh row stored as
   payload 0 with scale 1.0, and unfused) and K2-i8mm on run (a)'s cache
   [24, 16, 320, 2048] int8, K3-int8 at run (b)'s shape, K6-int8 (fused)
   and K6-i8mm on run (d)'s pool [24, 433, 64, 2048] int8, K7-int8 at
   the admission shape; fused writes leave payloads and scales bitwise
   the plain quantize-and-write, and K6-int8 / K6-i8mm / K7-int8 are
   bitwise K2-int8 / K2-i8mm (block = page) / K3-int8 over the gathered
   view; their ``library_ms`` is SDPA over the cache dequantized to bf16
   beforehand;
9. drives int8 serving — ``init_inference(..., quant={"enabled": True,
   "bits": 8, "per_channel": True, "kv_cache": True})`` with run (a)'s
   weights quantized from fp32: run (g) generates at run (a)'s shape
   (K1, K2-int8), run (b)'s (K3-int8, K2-int8) and run (a)'s with
   ``decode_int8_matmuls`` (K2-i8mm); run (h) serves run (d)'s requests
   on an int8 pool (K7-int8, K6-int8) and on int8 lanes (K3-int8,
   K2-int8), every request's tokens equal, and (h-i8mm) 24 of them with
   K6-i8mm; each with exact launch counts, its kernel-path logits
   against the plain path on the card (``plain_kernels``), weight, KV
   and peak bytes against the bf16 runs', and the share of greedy tokens
   that agree with them (reported); run (g) goes once more under the
   profiler (``profile`` "g", ``build/profiles/int8_generate_trace.json``);
10. holds K2's sliding-window mode against its plain version at the
   shape of run (i) — cache [24, 16, 384, 2048] (16 heads of 128), window
   256, lengths 0 to 384 — fused, unfused, int8-KV fused and int8×int8,
   and K6-window (unfused and fused), K6-int8-window and K6-i8mm-window
   at run (j)'s pool [24, 129, 64, 2048] against theirs and BITWISE
   against K2-window over the gathered view; timed against the bound of
   the window's live rows only, the plain version and SDPA over the
   window's rows gathered beforehand;
11. drives GPT-Neo-1.3B (``gpt_neo_model("gpt-neo-1.3b")``: the published
   widths, layers alternating global / local with a 256-position band,
   seeded random bf16 weights): run (i) generates batch 16 × prompt 320
   (longer than the window) × 64 new tokens with one-pass prefill (K1 on
   the 12 global layers, the dense band on the 12 local ones; K2 and
   K2-window decode) and at prompt 512 with ``prefill_chunk_size=128``
   (K3 on global chunks, dense on local ones), then with an int8 KV cache
   (K2-int8 / K2-int8-window) and ``decode_int8_matmuls`` (K2-i8mm /
   K2-i8mm-window), each with exact launch counts per kernel and mode and
   its kernel-path logits against the plain path (cosine ≥ 0.999); a
   ``profile`` line "i"; run (j) serves 32 greedy requests (prompts 288
   to 448, 16 to 64 new tokens) on a page pool of 16 slots (K7 on global
   chunks, the gathered dense band on local ones, K6 and K6-window decode)
   with every request equal to its monolithic-lane twin, and a few of
   them on an int8 pool (K6-int8-window) and with ``decode_int8_matmuls``
   (K6-i8mm-window);
12. holds K1, K2, K3, K6 and K7 against their plain versions, timed, at
   Llama-7B's width (32 heads of 128 over 32 layers) and drives Llama-7B
   (``llama_model("llama-7b")``: its published widths and depth, rope,
   RMSNorm, SwiGLU, seeded random bf16 weights): run (k) generates 16 ×
   prompt 256 × 64 new tokens in one pass (K1, K2) on the decode graphs
   and on an eager engine (tokens bitwise), with ``profile`` lines "k"
   and "k_graph" and a ``llama_elementwise`` line (device ms of rope,
   RMSNorm and SwiGLU), then prompt 512 in 128-token chunks (K3, K2);
   run (l) serves run (d)'s first 64 requests on a 32-slot page pool (K7,
   K6) and on an eager engine, with ``profile`` lines "l" and "l_graph",
   then on monolithic lanes (K3, K2), every request equal, the first 4
   also through solo ``generate()``; run (k-gqa) takes a 2-layer cut with
   8 kv heads (G = 4) through ``generate()`` and a paged server, its
   kernel-path tokens equal to the plain path's on fp32 weights; each
   with exact launches and kernel-path logits against the plain path
   (cosine ≥ 0.999);
13. drives speculative serving, run (m) — the JAX bench's
   ``serving_spec_bench`` point at 16 slots and ``spec_k`` 4: OPT-1.3B
   with run (a)'s weights, 32 greedy requests on slot lanes of 384 —
   plain (K3, K2), with a self-draft (``spec_draft_model="self"``: K2 in
   the draft's 5 steps a round, K3 in the verify at B = 16, C = 5 and in
   both prefills), the same over a worst-case page pool (K7 in the verify
   and the target's prefill) and with a seeded random opt-125m draft; each
   with exact launches, useful tokens/s, the accept rate, tokens per
   round, the draft's share, time between tokens at p50 / p99 from the
   requests' token streams, bf16 agreement with the plain server, peak
   memory, warm-up seconds and graph pool bytes; the self-draft server
   again on eager programs (every token equal); the first 8 requests on
   an fp32 copy of the weights (every speculative server equal to the
   plain one); a profiled window of 3 rounds on the graphs (``profile``
   "m_graph"); and K3 / K7 at the verify shape against their plain
   versions, timed (``KV_SHAPE``, dead rows included);
14. drives the request lifecycle, run (n), on run (d)'s engine, requests
   and outputs: (n-overload) run (d)'s server with a queue of 48 that
   blocks the submitting thread (``queue_policy="block"``) and a breaker
   at 3 consecutive failures — every 12th request already past its
   deadline (16 shed, none holding a slot), each with index 5 mod 24
   cancelled at its first token event (8), one ``raise`` injected at the
   40th decode dispatch (``serving.pre_decode_dispatch``) that the
   breaker absorbs (the requests in flight end ``ABORTED``, the pool is
   allocated and the decode block captured again: 2 captures) — every
   completed request bitwise run (d)'s, exact launches, every cancelled
   or aborted stream ended with its status; (n-preempt) run (d)'s first
   96 requests, admitted without a prefill budget, stepped until 32 hold
   partial tokens and 16 have ended,
   ``preempt(dir, drain_budget_s=0)`` (a manifest-valid snapshot) and
   ``restore()`` + ``drain()`` on a fresh server — those that ended
   before, or never started, bitwise run (d)'s, the resumed ones' token
   agreement reported — then 16 of run (m)'s requests on an fp32 copy on
   run (m)'s lanes, and (n-spec) run (m)'s self-draft server on 8,
   preempted mid-speculation: every output equal to the uninterrupted
   plain server's, every snapshotted token list a prefix of its output;
   with the seconds of ``preempt()`` and ``restore()``, the first token
   after the restore and the tokens prefilled again;
15. drives checkpointing, run (c-ckpt): run (c)'s model and batch shape
   with the ``fault`` block on (sha256 manifests, ``keep_last_n`` 1) — 2
   steps, ``save_checkpoint`` (15.8 GB of fp32 masters and Adam moments,
   written one tensor at a time), 2 more steps; then a fresh engine from
   another seed, with the tag's files evicted from the page cache,
   ``load_checkpoint`` takes the verified newest tag and the same 2 steps:
   losses and digests of the parameters and both moments bitwise the
   unbroken run's, 24 K1 / K4 / K5 launches a step; the tag
   (``init_inference(config={"checkpoint": ...})``), the resumed weights
   (``set_params``) and a ``save_16bit_model`` safetensors export each
   generate run (a)'s shape with bitwise the same tokens and run (a)'s
   launches; a ``ckpt`` line gives bytes, files, seconds and GB/s of the
   save (write, manifest checksum, fsync + publish) and the load (verify,
   read, copy to the card), the host's peak RSS growth of each, and the
   export's bytes and seconds; it needs 32 GB free under ``build/``;
16. prints the card, a ``kernels`` JSON line and, last, the result line.

Generation and serving run on the captured decode programs (CUDA graphs,
``enable_cuda_graph``'s default) after ``warmup()`` / ``srv.warmup()``,
whose seconds each run's record prints; the launch counts are the eager
launches plus each graph's captured launches times its replays, so every
gate keeps its meaning.  Runs (a), (d) and (h) also run on an eager
engine over the same weights (``enable_cuda_graph=False``): every token
must be bitwise equal, and a ``graphs_vs_eager`` line gives tokens/s and
the profiled window's idle share both ways for them and Llama's runs (k)
and (l) (profile lines "a", "d", "h", "k", "l" eager, "a_graph",
"d_graph", "h_graph", "k_graph", "l_graph" on the graphs).

K1 / K3 / K7 on bf16 / fp16 run one tensor-core template (``wgmma`` over
TMA tiles; a ``ptxas_flash_fwd`` line gives registers, spills and dynamic
shared memory of every instantiation, as ``ptxas_flash_bwd`` does for K4 /
K5); K1 is timed at run (c)'s shape at head dim 64 and 128.  K7 and
K7-int8 are also held bitwise against K3 over the gathered view at pages of
8 and 24 rows (a key tile filled from several TMA boxes) and at GPT-Neo's
16 heads of 128 (``K7_EXTRA``), and K3 / K7, float and int8, give the same
bits when every row past all queries' causal limits holds NaN as when it
holds 0 (``NAN_TAIL``).

K2 / K6 in every float and int8-KV mode, window or not, run one
template (``decode_kernel``: a ring of cp.async tiles in shared memory,
one block per batch row and one or two kv heads), and their int8 x int8
modes another (``decode_i8mm_kernel``: the same ring, taking a KV block's
K tiles, then its V tiles); their rows are timed per wrapper call (the
one kernel a call launches, over the calls), and a ``ptxas_decode`` line
gives registers, spills and shared memory of every instantiation of
both.

The profiled runs (``profile`` lines) are held to the launch counters:
a trace must record as many of the port's kernels as the wrappers counted
in the same run, or it is taken again (the profiler has dropped records
on an H100).

K6 and K7 are also held bitwise against K2 / K3 over the gathered view
``pool[layer][pages]`` (the same schedules over other addresses), and
their ``library_ms`` is ``F.scaled_dot_product_attention`` over that view
gathered beforehand: no one PyTorch call reads through a block table.
The int8 x int8 modes are held to max|err| <= 1e-2 * max|want|
(``I8MM_REL``): integer products are exact on both sides, but one exp
ulp can flip one rounding of P.

It exits non-zero, with no result line, when there is no CUDA device, when
the package is missing, or when any phase fails.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core bf16
              "float32": 67e12,    # fp32 outside the tensor cores
              "int8": 1979e12}     # dense tensor-core int8 (TOP/s)
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the LSE is an fp32 result on both sides (summation order apart), and
# every gradient of K4 / K5 goes through exp(s - lse)
LSE_TOL = TOL["float32"]
DEV = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = "opt-1.3b"
# kernel checks at the shapes OPT-1.3B's serving path gives each kernel
K1_SHAPE = dict(B=16, S=256, H=32, D=64)
K2_SHAPE = dict(L=24, B=16, S_max=320, H=32, D=64,
                lengths=[1, 320, 17, 64, 100, 255, 256, 200, 5, 8, 33, 128,
                         300, 150, 2, 77])
K3_SHAPE = dict(L=24, B=16, C=128, S_max=512, H=32, D=64,
                starts=[0, 128, 256, 384] * 4)
# K6 at run (d)'s pool [L, pages, page, H*D] with 96 slots over 6 virtual
# pages each: lengths 0 (a dead lane on the trash page) to 384, a
# shuffled block table; K7 at the admission shape (B = 1) and B = 8, page
# sizes 64 and 16 over a pool of the same bytes, starts 0 to 256
K6_SHAPE = dict(L=24, pages=433, page=64, B=96, H=32, D=64, n_virt=6)
K7_SHAPE = dict(L=24, C=128, H=32, D=64, virt=384,
                cases=((64, [128]), (64, [0, 37, 73, 110, 146, 183, 219, 256]),
                       (16, [128]), (16, [0, 37, 73, 110, 146, 183, 219, 256])))
# untimed K7 / K7-int8 cases held bitwise against K3 over the gathered
# view: pages of 8 and 24 rows (neither is a 64-row tile, so the tensor-core
# kernel fills a key tile from 8 boxes of 8 rows), at run (d)'s widths and
# at GPT-Neo's global layers' (16 heads of 128, run (j)'s 512 positions)
K7_EXTRA = (dict(H=32, D=64, virt=384, page=8, starts=[128]),
            dict(H=32, D=64, virt=384, page=24,
                 starts=[0, 37, 73, 110, 146, 183, 219, 256]),
            dict(H=16, D=128, virt=512, page=64, starts=[128, 384]),
            dict(H=16, D=128, virt=512, page=24, starts=[0, 130, 257, 384]))
# K3 / K7 with every cache or pool row past all queries' causal limits
# poisoned (NaN; int8 payloads 127 under NaN scales): run (b)'s chunk shape
# over 576 positions (9 tiles of 64, 24 pages of 24, 72 of 8)
NAN_TAIL = dict(B=16, C=128, S_max=576, H=32, D=64,
                starts=[0, 128, 256, 384] * 4, pages=(64, 24, 8))
LIBRARY_NOTE = ("F.scaled_dot_product_attention over the view gathered "
                "through the block table beforehand (gather excluded)")
# the two main-path runs: one-pass prefill (a) and chunked prefill (b)
RUN_A = dict(batch=16, prompt=256, new=64)
RUN_B = dict(batch=16, prompt=512, new=16, chunk=128)
# continuous-batching serving (d): the JAX bench's serving_paged point
# (bench.py serving_paged, bf16: its int8 weights and int8 KV are not
# ported) — 192 greedy requests, numpy seed 0, prompts and new tokens
# drawn from these sets, 96 slots over a pool of 0.75 x the worst case
RUN_D = dict(requests=192, seed=0, prompts=(64, 96, 128, 192, 256),
             new=(16, 32, 64, 128))
SERVE_D = dict(paged=True, page_size=64, max_cache_len=384,
               prefill_chunk=128, prefill_token_budget=256, decode_block=8,
               num_slots=96, num_pages=int(0.75 * 96 * 6) + 1)
# GPT-Neo-1.3B (gpt_neo_model's published widths: 16 heads of 128, layers
# alternating global / local, a 256-position band): run (i), generation at
# batch 16, prompt 320 (past the window) and 64 new tokens, one pass and
# chunked at prompt 512, then short int8-KV and int8 x int8 runs; run (j),
# 32 greedy requests on a 16-slot page pool (numpy seed 0, prompts and new
# tokens uniform in these ranges), then 8 of them on int8 pools
GPT_NEO = "gpt-neo-1.3b"
WINDOW = 256
RUN_I = dict(batch=16, prompt=320, new=64)
RUN_I_CHUNKED = dict(batch=16, prompt=512, new=64, chunk=128)
RUN_I_INT8 = dict(batch=16, prompt=320, new=16)
RUN_J = dict(requests=32, seed=0, prompts=(288, 448), new=(16, 64),
             int8_requests=8)
SERVE_J = dict(paged=True, page_size=64, max_cache_len=512,
               prefill_chunk=128, prefill_token_budget=256, decode_block=8,
               num_slots=16)
# K2-window at run (i)'s cache (required_cache_len(320, 64) = 384
# positions), lengths below, at and past the window and a zero-length
# row; timed at run (i)'s mid-decode length; K6-window at run (j)'s pool
# (16 slots x 8 pages of 64 + the trash page), timed at lengths 288..498
K1I_SHAPE = dict(B=16, S=320, H=16, D=128)    # run (i)'s global prefill
K2W_SHAPE = dict(L=24, B=16, S_max=384, H=16, D=128,
                 lengths=[0, 1, 100, 255, 256, 257, 300, 321, 330, 340, 350,
                          360, 370, 380, 383, 384],
                 timed=[352] * 16)
K6W_SHAPE = dict(L=24, pages=129, page=64, B=16, H=16, D=128, n_virt=8,
                 lengths=[0, 1, 100, 255, 256, 257, 300, 320, 350, 384,
                          400, 420, 450, 480, 500, 512],
                 timed=[288 + 14 * i for i in range(16)])
WINDOW_LIBRARY_NOTE = ("F.scaled_dot_product_attention over the window's "
                       "rows gathered beforehand (gather excluded)")
# Llama-7B (llama_model's published widths: hidden 4096, 32 layers, 32
# heads of 128, SwiGLU ffn 11008, rope, RMSNorm, vocab 32000, an untied
# head; seeded random bf16 weights): run (k), generation at run (a)'s
# shape (one pass: K1, K2) and run (b)'s (prompt 512 in 128-token chunks:
# K3, K2); run (l), run (d)'s first 64 requests on 32 slots over a pool of
# 0.75 of the worst case, as run (d) sizes its own (K7, K6), then on
# monolithic lanes (K3, K2); run (k-gqa), a cut that is not a published
# config: 2 layers with 8 kv heads (G = 4 at 128-wide heads)
LLAMA = "llama-7b"
RUN_K = dict(batch=16, prompt=256, new=64)
RUN_K_CHUNKED = dict(batch=16, prompt=512, new=16, chunk=128)
RUN_L = dict(requests=64, solo=4)
SERVE_L = dict(SERVE_D, num_slots=32, num_pages=int(0.75 * 32 * 6) + 1)
RUN_K_GQA = dict(num_kv_heads=8, num_layers=2, batch=16, prompt=256, new=16,
                 requests=8)
# K1 / K2 / K3 / K6 / K7 at runs (k) and (l)'s shapes: K2 over run (k)'s
# cache (required_cache_len(256, 64) = 320), K3 over its chunked twin's
# (required_cache_len(512, 16, 128) = 528), K6 over run (l)'s pool with
# 32 slots, K7 at the admission shape and B = 8 over a pool of its bytes
K1K_SHAPE = dict(B=16, S=256, H=32, D=128)
K2K_SHAPE = dict(K2_SHAPE, L=32, D=128)
K3K_SHAPE = dict(K3_SHAPE, L=32, S_max=528, D=128)
K6L_SHAPE = dict(K6_SHAPE, L=32, pages=SERVE_L["num_pages"], B=32, D=128)
K7L_SHAPE = dict(K7_SHAPE, L=32, D=128,
                 cases=tuple(c for c in K7_SHAPE["cases"] if c[0] == 64))
# speculative serving (m): the JAX bench's serving_spec_bench point
# (bench.py:1123-1169) at 16 slots and spec_k 4 — OPT-1.3B bf16, 32 greedy
# requests (numpy seed 0; prompts and new tokens drawn from these sets),
# slot lanes of 384, chunk 128, budget 256, block 8 — served plain, with
# a self-draft on lanes and over a worst-case page pool (page 64), and
# with a seeded random opt-125m draft (the accept rate's floor); the
# first 8 requests again on an fp32 copy of the weights, where every
# speculative server must equal the plain one token for token
RUN_M = dict(requests=32, seed=0, prompts=(64, 96, 128, 192),
             new=(64, 96, 128), fp32_requests=8, draft="opt-125m")
SERVE_M = dict(max_cache_len=384, prefill_chunk=128,
               prefill_token_budget=256, decode_block=8, num_slots=16)
SPEC_M = dict(speculative=True, spec_k=4, spec_draft_model="self")
# K3 / K7 at run (m)'s verify shape: q [16, 5, 32, 64] (16 slots, a window
# of spec_k + 1) over its lanes [24, 16, 384, 2048] and over its pool
# [24, 97, 64, 2048] (16 slots x 6 pages + the trash page), starts spread
# over the lane up to its end, a quarter of the rows dead (start 384 - 5,
# as spec_verify clamps it; on the pool their table rows on the trash page)
KV_SHAPE = dict(L=24, B=16, C=5, S_max=384, H=32, D=64, page=64, dead=4)
# decode blocks traced with all 96 slots live (profile line "d"), and
# speculative rounds with run (m)'s 16 slots live (profile line "m_graph")
PROFILE_D_STEPS = 3
PROFILE_M_ROUNDS = 3
# the request lifecycle (n), on run (d)'s engine, requests and outputs:
# (n-overload) SERVE_D with a queue of 48 that blocks the submitting
# thread and a breaker at 3 failures; every 12th request already past its
# deadline (16 shed), each request with index 5 mod 24 cancelled at its
# first token event (8), one dispatch failure injected at the 40th decode
# dispatch and absorbed.  (n-preempt) run (d)'s first 96 requests on
# SERVE_D without its prefill budget (with two chunks a step, run (d)'s
# traffic never has more than 16 requests partial at once), stepped until
# 32 hold partial tokens and 16 have ended, preempted at once and restored
# on a fresh server; then 16 of run (m)'s requests on an fp32 copy of the
# weights on run (m)'s lanes, preempted with 8 partial and restored.
# (n-spec) run (m)'s self-draft server on the fp32 copy's first 8
# requests, preempted mid-speculation with 4 partial and restored
RUN_N = dict(queue=48, shed_every=12, cancel_every=24, cancel_at=5,
             fail_at=40, breaker=3, preempt_requests=96, partial=32,
             finished=16, fp32_requests=16, fp32_partial=8, spec_requests=8,
             spec_partial=4)
SERVE_N = dict(SERVE_D, max_queue_depth=RUN_N["queue"], queue_policy="block",
               breaker_threshold=RUN_N["breaker"])
SERVE_N_PREEMPT = dict(SERVE_D, prefill_token_budget=0)
# shared prefix (e): bench.py's 24 requests behind one 512-token prompt
RUN_E = dict(system=512, tails=24, tail=16, new=32, seed=1)
SERVE_E = dict(paged=True, page_size=64, max_cache_len=768,
               prefill_chunk=128, prefill_token_budget=256, decode_block=8,
               num_slots=8)
# int8 serving: per-channel int8 weights (quantized from run (a)'s weights
# in fp32) and an int8 KV cache, the JAX bench's serving_paged settings
# (bench.py:968-972).  Run (g): generation at run (a)'s and run (b)'s
# shapes, and run (a)'s with decode_int8_matmuls; run (h): run (d)'s
# requests and server on the int8 engine, with its monolithic twin; run
# (h-i8mm): run (d)'s first 24 requests with decode_int8_matmuls, paged
QUANT = {"enabled": True, "bits": 8, "per_channel": True, "kv_cache": True}
RUN_H_I8MM = dict(requests=24)
INT8_LIBRARY_NOTE = ("F.scaled_dot_product_attention over the int8 cache "
                     "dequantized to bf16 beforehand (dequantization "
                     "excluded)")
# the int8 x int8 decode against its plain version: integer products are
# exact on both sides, but one exp ulp can flip one rounding of P, which
# moves that row by about rmax * |v|: max|err| <= 1e-2 * max|want|
I8MM_REL = 1e-2
# the KV block at which ptxas_decode gives decode_i8mm_kernel's dynamic
# shared memory (its per-block arrays grow with block_k; 512 is the most)
I8MM_SMEM_BLOCK = 512
# the training path (c): OPT-1.3B at seq 2048, micro batch 2, and the
# shapes its attention kernels (K1 with LSE, K4, K5) see in every layer
RUN_C = dict(micro=2, seq=2048, loss_chunks=8, warmup=2, steps=5, seed=6,
             trace="train_trace.json")
KB_SHAPE = dict(B=2, S=2048, H=32, D=64)
# K1 / K4 / K5 also at GPT-Neo-1.3B's global layers' shape (16 heads of
# 128, the scale in the kernels), held and timed like run (c)'s
KB_D128_SHAPE = dict(B=2, S=2048, H=16, D=128)
TRAIN_CONFIG = {"train_micro_batch_size_per_gpu": RUN_C["micro"],
                "gradient_accumulation_steps": 1,
                "optimizer": {"type": "AdamW",
                              "params": {"lr": 9.65e-6, "weight_decay": 0.0}},
                "bf16": {"enabled": True},
                "gradient_clipping": 1.0,
                "zero_optimization": {"stage": 0},
                "seed": 0}
# run (c-ckpt): run (c)'s model, config and batch shape with the fault
# block on (sha256 manifests, retention of 1 tag): 2 steps, save, 2 more
# steps; then a fresh engine from another seed resumes from the newest
# valid tag and takes the same 2 steps, bitwise; then the tag, the resumed
# weights (set_params) and a safetensors export serve run (a)'s shape
RUN_CKPT = dict(before=2, after=2, seed=7, fresh_seed=1,
                min_free_bytes=32e9)
TRAIN_CKPT_CONFIG = {**TRAIN_CONFIG,
                     "fault": {"enabled": True, "keep_last_n": 1}}
CKPT_DIR = os.path.join(ROOT, "build", "ckpt")
# K4 / K5 in bf16 against the fp32 plain backward of the same bf16 inputs:
# both sum in fp32, then the kernel rounds each gradient to bf16, which is
# off by at most half an ulp (2^-8 of the value, <= 2^-8 of the largest
# |gradient|); the bar is twice that, for the fp32 summation order and for
# the bf16 rounding of P and dS before the second products (as JAX rounds
# them: random-signed errors of 2^-9 of each term, far below the bar)
BWD_BF16_REL = 2.0 ** -7
# gradient check, kernel path vs dense attention, on a 2-layer cut
GRAD_CHECK = dict(layers=2, batch=2, seq=2048, loss_rel=1e-2, cosine=0.99)
# block-sparse long-context training (f): the JAX package's long-context
# story (docs/tutorials/long-context.md) — OPT-1.3B at seq 8192 made
# block-sparse with the tutorial's BigBird layout; remat (nothing_saveable),
# the loss in 32 sequence chunks, micro batch 1, otherwise run (c)'s config
BIGBIRD = dict(num_heads=32, block=64, num_random_blocks=3,
               num_sliding_window_blocks=3, num_global_blocks=1)
RUN_F = dict(micro=1, seq=8192, loss_chunks=32, warmup=2, steps=3, seed=12,
             trace="sparse_train_trace.json")
TRAIN_F_CONFIG = {**TRAIN_CONFIG,
                  "train_micro_batch_size_per_gpu": RUN_F["micro"]}
# K8 at run (f)'s attention shape, and the variants: blocks 16, 32 and
# 128, a ragged S (not a multiple of the 64-row tiles) at block 16, head
# dim 128, a layout per head, a key-padding mask, a hand-made layout with
# an empty block-row
K8_SHAPE = dict(B=1, S=8192, H=32, D=64)
K8_VARIANTS = (
    dict(tag="block 16", B=2, S=1024, H=32, D=64, block=16, causal=True),
    dict(tag="ragged S 1040, block 16", B=2, S=1040, H=32, D=64, block=16,
         causal=True),
    dict(tag="block 32", B=2, S=1024, H=32, D=64, block=32, causal=True),
    dict(tag="block 128", B=2, S=1024, H=32, D=64, block=128, causal=True),
    dict(tag="head dim 128", B=1, S=2048, H=16, D=128, block=64,
         causal=True),
    dict(tag="layout per head (Fixed, 4 global patterns)", B=1, S=2048,
         H=32, D=64, block=64, causal=True, per_head=True),
    dict(tag="non-causal, key padding (row 1: tail block padded)", B=2,
         S=1024, H=32, D=64, block=64, causal=False, padded=True),
    dict(tag="empty block-row (exactly 0)", B=1, S=1024, H=32, D=64,
         block=64, causal=False, empty_row=3),
)
# the sparse gradient check: K8 + the gather backward against dense
# attention masked by the same layout (at seq 8192 the dense scores would
# take 8.6 GB per layer), on a 2-layer cut
SPARSE_GRAD_CHECK = dict(layers=2, batch=2, seq=2048, loss_rel=1e-2,
                         cosine=0.99)


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_all(tag, kernel_name, kernel_fn, plain_fn, library_fn, iters):
    """Device time per call (``torch.profiler`` kernel records) of the
    kernel, of its plain version and of the library call, plus the
    kernel's wall time per call with the wrapper (``call_ms``, CUDA events
    around back-to-back calls: where it exceeds ``kernel_ms`` the host
    cannot keep the card fed).  ``kernel_ms`` is the time per launch of
    the kernels named like ``kernel_name``; for K2 / K6 (None:
    ``decode_kernel``, or ``decode_i8mm_kernel``) the time per wrapper
    call: every call launches that one kernel and nothing else, checked
    on the trace, so the mean of its launches is the time of a call,
    whatever records the profiler drops."""
    from deepspeed_tpu_torch.profiling.trace import device_ms_per_call
    trace = os.path.join(ROOT, "build", "profiles", f"chip_smoke_{tag}.json")
    return {
        "kernel_ms": device_ms_per_call(
            kernel_fn, iters, trace, name=kernel_name or "decode_kernel",
            alone=kernel_name in (None, "decode_i8mm_kernel")),
        "call_ms": cuda_time(kernel_fn, iters),
        "plain_ms": device_ms_per_call(plain_fn, max(iters // 10, 2), trace),
        "library_ms": device_ms_per_call(library_fn, iters, trace),
    }


def cuda_time(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops > t_mem
                                     else "bytes")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_close(name, got, want, dtype, tol=None):
    import torch
    tol = TOL[dtype] if tol is None else tol
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), atol=tol, rtol=tol)
    err = max_err(got, want)
    if not ok:
        fail(f"{name} ({dtype}) disagrees with its plain version: "
             f"max_abs_err={err} (atol=rtol={tol})")
    return err


def check_lse(name, got, want, dtype):
    """K1's LSE is fp32 on both sides, from the same inputs, whatever the
    inputs' dtype: it is held to the fp32 bar in every dtype."""
    return check_close(name, got, want, dtype, tol=LSE_TOL)


# --------------------------------------------------------------------- #
# Kernels against their plain versions, at main-path shapes
# --------------------------------------------------------------------- #
def check_flash(dtype, timed, shape=None):
    """K1 against its plain version at ``shape`` (run (a)'s, or run (i)'s
    head dim 128 untimed)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    B, S, H, D = ((shape or K1_SHAPE)[x] for x in "BSHD")
    g = torch.Generator(device=DEV).manual_seed(1)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=DEV, dtype=dt)
               for _ in range(3))
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                              scale=1 / math.sqrt(D))
    err = check_close("K1 flash_attention", out, want, dtype)
    lse_err = check_lse("K1 flash_attention lse", lse, want_lse, dtype)
    rec = {"kernel": "K1 flash_attention", "dtype": dtype,
           "shape": [B, S, H, D], "causal": True, "max_abs_err": err,
           "tol": TOL[dtype], "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL}
    if timed:
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        rec.update(time_all(
            "k1", "flash_fwd_kernel",
            lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: fa.flash_attention_plain(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   is_causal=True), 50))
        pairs = B * H * S * (S + 1) // 2
        nbytes = 4 * q.numel() * q.element_size()  # q, k, v read; out written
        rec["bound_ms"], rec["bound_by"] = bound(4 * D * pairs, nbytes, dtype)
    emit(rec)
    return rec


def check_decode(dtype, timed, shape=None):
    """K2 (fused write) against its plain version at ``shape`` (run (a)'s
    cache, or run (k)'s)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    shape = shape or K2_SHAPE
    L, B, S_max, H, D = (shape[x] for x in ("L", "B", "S_max", "H", "D"))
    layer = L // 4
    g = torch.Generator(device=DEV).manual_seed(2)
    dt = getattr(torch, dtype)
    kc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    vc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    q = torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
    nk = torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
    nv = torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
    lengths = torch.tensor(shape["lengths"], dtype=torch.int32, device=DEV)
    k1, v1 = kc.clone(), vc.clone()
    out, _, _ = da.decode_attention(q, k1, v1, lengths, layer=layer,
                                    new_k=nk, new_v=nv)
    torch.cuda.synchronize()
    k2, v2 = kc.clone(), vc.clone()
    want = da.decode_attention_plain(q, k2[layer], v2[layer], lengths,
                                     new_k=nk, new_v=nv)
    err = check_close("K2 decode_attention", out, want, dtype)
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        fail(f"K2 decode_attention ({dtype}): written caches differ from "
             f"the plain write")
    unfused = da.decode_attention(q, k1, v1, lengths, layer=layer)
    check_close("K2 decode_attention (unfused)", unfused, want, dtype)
    del k2, v2
    rec = {"kernel": "K2 decode_attention", "dtype": dtype,
           "cache": [L, B, S_max, H * D], "fused_write": True,
           "lengths": lengths.tolist(), "max_abs_err": err,
           "tol": TOL[dtype], "cache_rows_bitwise_equal": True}
    if timed:
        it = iter(range(10 ** 9))

        def run_kernel():       # one layer per call, as decode walks them
            da.decode_attention(q, k1, v1, lengths, layer=next(it) % L,
                                new_k=nk, new_v=nv)

        def run_plain():
            li = next(it) % L
            da.decode_attention_plain(q, k1[li], v1[li], lengths,
                                      new_k=nk, new_v=nv)

        heads = [(k1[li].view(B, S_max, H, D).transpose(1, 2).contiguous(),
                  v1[li].view(B, S_max, H, D).transpose(1, 2).contiguous())
                 for li in range(L)]
        live = (torch.arange(S_max, device=DEV)[None]
                < lengths[:, None].long())[:, None, None, :]
        qh = q[:, :, None, :]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        rec.update(time_all("k2", None, run_kernel, run_plain,
                            run_library, 240))
        del heads
        n_live = int(lengths.sum())
        es = q.element_size()
        # each row's last live position is this step's fresh row
        nbytes = (2 * (n_live - B) * H * D * es    # older K and V rows read
                  + 2 * 2 * nk.numel() * es         # new rows read + written
                  + 2 * q.numel() * es              # q read, out written
                  + lengths.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * n_live, nbytes,
                                                 dtype)
    emit(rec)
    return rec


def check_chunk(dtype, timed, shape=None):
    """K3 against its plain version at ``shape`` (run (b)'s chunks, or run
    (k)'s chunked twin's)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    shape = shape or K3_SHAPE
    L, B, C, S_max, H, D = (shape[x]
                            for x in ("L", "B", "C", "S_max", "H", "D"))
    layer = L // 3
    g = torch.Generator(device=DEV).manual_seed(3)
    dt = getattr(torch, dtype)
    kc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    vc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
    starts = torch.tensor(shape["starts"], dtype=torch.int32, device=DEV)
    out = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer)
    torch.cuda.synchronize()
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts)
    err = check_close("K3 chunk_prefill_attention", out, want, dtype)
    rec = {"kernel": "K3 chunk_prefill_attention", "dtype": dtype,
           "q": [B, C, H, D], "cache": [L, B, S_max, H * D],
           "starts": starts.tolist(), "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        it = iter(range(10 ** 9))
        qh = q.transpose(1, 2).contiguous()
        qpos = starts[:, None].long() + torch.arange(C, device=DEV)[None]
        live = (torch.arange(S_max, device=DEV)[None, None]
                <= qpos[..., None])[:, None]               # [B, 1, C, S_max]
        heads = [(kc[li].view(B, S_max, H, D).transpose(1, 2).contiguous(),
                  vc[li].view(B, S_max, H, D).transpose(1, 2).contiguous())
                 for li in range(L)]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        def run_kernel():
            da.chunk_prefill_attention(q, kc, vc, starts, layer=next(it) % L)

        def run_plain():
            li = next(it) % L
            da.chunk_prefill_attention_plain(q, kc[li], vc[li], starts)

        rec.update(time_all("k3", "flash_fwd_kernel", run_kernel, run_plain,
                            run_library, 96))
        del heads
        pairs = int(qpos.sum()) + B * C      # keys pos <= qpos, per row
        es = q.element_size()
        nbytes = (2 * int((starts.long() + C).sum()) * H * D * es  # K/V rows
                  + 2 * q.numel() * es + starts.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * pairs, nbytes,
                                                 dtype)
    emit(rec)
    return rec


def paged_table(B, n_virt, n_pages, spans, page, seed):
    """A shuffled block table [B, n_virt] int32 on the card: row b maps
    ceil(spans[b] / page) distinct pool pages in random order, the rest of
    its entries (all of a 0-span row's) the trash page 0."""
    import torch
    perm = (1 + torch.randperm(n_pages - 1, generator=torch.Generator()
                               .manual_seed(seed))).tolist()
    table = torch.zeros(B, n_virt, dtype=torch.int32)
    for b, n in enumerate(spans):
        k = -(-n // page)
        table[b, :k] = torch.tensor(perm[:k], dtype=torch.int32)
        perm = perm[k:]
    return table.to(DEV)


def heads_view(x, H, D):
    """[B, S, H*D] -> the [B, H, S, D] copy SDPA reads."""
    B, S, _ = x.shape
    return x.view(B, S, H, D).transpose(1, 2).contiguous()


def check_paged_decode(dtype, timed, shape=None):
    """K6 at ``shape``'s pool (run (d)'s, or run (l)'s) with the fused
    write: against its plain version, and bitwise against K2 over the
    gathered view."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    L, NP, page, B, H, D, nv = ((shape or K6_SHAPE)[x] for x in (
        "L", "pages", "page", "B", "H", "D", "n_virt"))
    layer = L // 4
    g = torch.Generator(device=DEV).manual_seed(9)
    dt = getattr(torch, dtype)
    kp = torch.randn(L, NP, page, H * D, generator=g, device=DEV, dtype=dt)
    vp = torch.randn(L, NP, page, H * D, generator=g, device=DEV, dtype=dt)
    q, nk, nw = (torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
                 for _ in range(3))
    spans = [nv * page * i // (B - 1) for i in range(B)]     # 0 .. 384
    lengths = torch.tensor(spans, dtype=torch.int32, device=DEV)
    table = paged_table(B, nv, NP, spans, page, seed=10)
    gk, gv = pa.gather_pages(kp[layer], table), pa.gather_pages(vp[layer],
                                                                 table)
    k1, v1 = kp.clone(), vp.clone()
    out, _, _ = pa.paged_decode_attention(q, k1, v1, lengths, table,
                                          layer=layer, new_k=nk, new_v=nw)
    torch.cuda.synchronize()
    k2, v2 = kp.clone(), vp.clone()
    want = pa.paged_decode_attention_plain(q, k2[layer], v2[layer], lengths,
                                           table, new_k=nk, new_v=nw)
    err = check_close("K6 paged_decode_attention", out, want, dtype)
    if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
        fail(f"K6 paged_decode_attention ({dtype}): written pools differ "
             f"from the plain write")
    del k2, v2, want
    mono, _, _ = da.decode_attention(q, gk.clone(), gv.clone(), lengths,
                                     new_k=nk, new_v=nw)
    if not torch.equal(out, mono):
        fail(f"K6 ({dtype}) is not bitwise equal to K2 over the gathered "
             f"view: max diff {max_err(out, mono)}")
    unfused = pa.paged_decode_attention(q, k1, v1, lengths, table,
                                        layer=layer)
    check_close("K6 paged_decode_attention (unfused)", unfused,
                da.decode_attention_plain(q, pa.gather_pages(k1[layer], table),
                                          pa.gather_pages(v1[layer], table),
                                          lengths), dtype)
    rec = {"kernel": "K6 paged_decode_attention", "dtype": dtype,
           "pool": [L, NP, page, H * D], "table": [B, nv],
           "lengths": [min(spans), max(spans)], "fused_write": True,
           "max_abs_err": err, "tol": TOL[dtype],
           "bitwise_equal_to_k2_over_gathered_view": True,
           "pool_rows_bitwise_equal": True}
    if timed:
        it = iter(range(10 ** 9))

        def run_kernel():       # one layer per call, as decode walks them
            pa.paged_decode_attention(q, k1, v1, lengths, table,
                                      layer=next(it) % L, new_k=nk, new_v=nw)

        def run_plain():
            li = next(it) % L
            pa.paged_decode_attention_plain(q, k1[li], v1[li], lengths, table,
                                            new_k=nk, new_v=nw)

        heads = [(heads_view(pa.gather_pages(k1[li], table), H, D),
                  heads_view(pa.gather_pages(v1[li], table), H, D))
                 for li in range(L)]
        live = (torch.arange(nv * page, device=DEV)[None]
                < lengths[:, None].long())[:, None, None, :]
        qh = q[:, :, None, :]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        rec.update(time_all("k6", None, run_kernel, run_plain,
                            run_library, 240))
        rec["library"] = LIBRARY_NOTE
        del heads
        n_live = sum(spans)
        fresh = sum(1 for n in spans if n > 0)
        es = q.element_size()
        # each live row's last position is this step's fresh row; every
        # row (the dead lane's into the trash page) writes one
        nbytes = (2 * (n_live - fresh) * H * D * es  # older K and V rows
                  + 2 * 2 * nk.numel() * es           # new rows read + written
                  + 2 * q.numel() * es                # q read, out written
                  + lengths.numel() * 4 + table.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * n_live, nbytes,
                                                 dtype)
    emit(rec)
    del kp, vp, k1, v1, gk, gv
    torch.cuda.empty_cache()
    return rec


def check_paged_chunk(dtype, timed, shape=None, pool=None,
                      extra=K7_EXTRA):
    """K7 at ``shape``'s cases (run (d)'s: the admission shape, B = 1, and
    B = 8, page sizes 64 and 16) over a pool of ``pool``'s bytes (run
    (d)'s pool, or run (l)'s), then the ``extra`` cases: against its plain
    version, and bitwise against K3 over the gathered view; timed at the
    admission shape with 64-row pages."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    shape, pool = shape or K7_SHAPE, pool or K6_SHAPE
    L, C, H, D, virt = (shape[x] for x in ("L", "C", "H", "D", "virt"))
    layer = L // 3
    dt = getattr(torch, dtype)
    g = torch.Generator(device=DEV).manual_seed(11)
    cases, timed_rec = [], None
    for page in sorted({pg for pg, _ in shape["cases"]}, reverse=True):
        NP = pool["pages"] * pool["page"] // page          # the pool's bytes
        kp = torch.randn(L, NP, page, H * D, generator=g, device=DEV,
                         dtype=dt)
        vp = torch.randn(L, NP, page, H * D, generator=g, device=DEV,
                         dtype=dt)
        for pg, starts in shape["cases"]:
            if pg != page:
                continue
            B = len(starts)
            q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
            st = torch.tensor(starts, dtype=torch.int32, device=DEV)
            table = paged_table(B, virt // page, NP, [s + C for s in starts],
                                page, seed=page + B)
            out = pa.paged_chunk_prefill_attention(q, kp, vp, st, table,
                                                   layer=layer)
            torch.cuda.synchronize()
            want = pa.paged_chunk_prefill_attention_plain(
                q, kp[layer], vp[layer], st, table)
            tag = f"K7 paged_chunk_prefill_attention (page {page}, B {B})"
            err = check_close(tag, out, want, dtype)
            mono = da.chunk_prefill_attention(
                q, pa.gather_pages(kp[layer], table),
                pa.gather_pages(vp[layer], table), st)
            if not torch.equal(out, mono):
                fail(f"{tag} ({dtype}) is not bitwise equal to K3 over the "
                     f"gathered view: max diff {max_err(out, mono)}")
            cases.append({"page": page, "q": [B, C, H, D], "starts": starts,
                          "max_abs_err": err})
            if not (timed and B == 1 and page == 64):
                continue
            rec = {"max_abs_err": err}
            it = iter(range(10 ** 9))

            def run_kernel():
                pa.paged_chunk_prefill_attention(q, kp, vp, st, table,
                                                 layer=next(it) % L)

            def run_plain():
                li = next(it) % L
                pa.paged_chunk_prefill_attention_plain(q, kp[li], vp[li], st,
                                                       table)

            heads = [(heads_view(pa.gather_pages(kp[li], table), H, D),
                      heads_view(pa.gather_pages(vp[li], table), H, D))
                     for li in range(L)]
            qpos = st[:, None].long() + torch.arange(C, device=DEV)[None]
            live = (torch.arange(virt, device=DEV)[None, None]
                    <= qpos[..., None])[:, None]
            qh = q.transpose(1, 2).contiguous()

            def run_library():
                kh, vh = heads[next(it) % L]
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

            rec.update(time_all("k7", "flash_fwd_kernel", run_kernel,
                                run_plain, run_library, 96))
            del heads
            pairs = int(qpos.sum()) + B * C
            es = q.element_size()
            nbytes = (2 * int((st.long() + C).sum()) * H * D * es
                      + 2 * q.numel() * es + st.numel() * 4
                      + table.numel() * 4)
            rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * pairs,
                                                     nbytes, dtype)
            timed_rec = rec
        del kp, vp
        torch.cuda.empty_cache()
    for i, case in enumerate(extra):
        cases.append(k7_extra_case(dtype, g, int8=False, seed=50 + i, **case))
    torch.cuda.empty_cache()
    rec = {"kernel": "K7 paged_chunk_prefill_attention", "dtype": dtype,
           "pool_bytes_like": [L, pool["pages"], pool["page"], H * D],
           "cases": cases, "max_abs_err": max(c["max_abs_err"]
                                              for c in cases),
           "tol": TOL[dtype], "bitwise_equal_to_k3_over_gathered_view": True}
    if timed_rec is not None:
        rec.update({k: v for k, v in timed_rec.items()
                    if k != "max_abs_err"})
        rec.update(timed_shape=[1, C, H, D], timed_page=64,
                   library=LIBRARY_NOTE)
    emit(rec)
    return rec


def k7_extra_case(dtype, g, H, D, virt, page, starts, int8, seed):
    """One untimed K7 case (float or int8-KV pool, two layers, one row
    per start over its own pages): against its plain version and bitwise
    against K3 over the gathered view."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    C, B, n_virt, layer = K7_SHAPE["C"], len(starts), -(-virt // page), 1
    NP = 1 + B * n_virt
    dt = getattr(torch, dtype)
    if int8:
        bufs = int8_pair(g, 2, NP, page, KVH=H, D=D)
    else:
        bufs = [torch.randn(2, NP, page, H * D, generator=g, device=DEV,
                            dtype=dt) for _ in range(2)] + [None, None]
    q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
    st = torch.tensor(starts, dtype=torch.int32, device=DEV)
    table = paged_table(B, n_virt, NP, [s + C for s in starts], page, seed)
    lay = [None if t is None else t[layer] for t in bufs]
    out = pa.paged_chunk_prefill_attention(q, bufs[0], bufs[1], st, table,
                                           layer=layer, k_scale=bufs[2],
                                           v_scale=bufs[3])
    torch.cuda.synchronize()
    want = pa.paged_chunk_prefill_attention_plain(q, lay[0], lay[1], st,
                                                  table, k_scale=lay[2],
                                                  v_scale=lay[3])
    tag = (f"K7{'-int8' if int8 else ''} paged_chunk_prefill_attention "
           f"(page {page}, B {B}, {H} heads of {D})")
    err = check_close(tag, out, want, dtype)
    views = [None if t is None else pa.gather_pages(t, table) for t in lay]
    mono = da.chunk_prefill_attention(q, views[0], views[1], st,
                                      k_scale=views[2], v_scale=views[3])
    if not torch.equal(out, mono):
        fail(f"{tag} ({dtype}) is not bitwise equal to K3 over the gathered "
             f"view: max diff {max_err(out, mono)}")
    return {"page": page, "q": [B, C, H, D], "starts": starts,
            "max_abs_err": err}


def check_verify(dtype, timed):
    """K3 over run (m)'s lanes and K7 over its pool at the verify shape
    (``KV_SHAPE``: dead rows at the lane's end, their table rows on the
    trash page) against their plain versions, K7 bitwise K3 over the
    gathered view; timed (kernel, plain, SDPA over the same rows with a
    per-row causal offset mask, the bound of the rows the kernels read)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    L, B, C, S_max, H, D, page = (KV_SHAPE[x] for x in (
        "L", "B", "C", "S_max", "H", "D", "page"))
    layer, n_virt = L // 3, S_max // page
    dt = getattr(torch, dtype)
    g = torch.Generator(device=DEV).manual_seed(17)
    live = [0, 1, 63, 64, 130, 200, 255, 256, 300, 333, 370, S_max - C]
    starts = torch.tensor(live + [S_max - C] * KV_SHAPE["dead"],
                          dtype=torch.int32, device=DEV)
    q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
    kc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    vc = torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
    n_pages = 1 + B * n_virt
    kp = torch.randn(L, n_pages, page, H * D, generator=g, device=DEV,
                     dtype=dt)
    vp = torch.randn(L, n_pages, page, H * D, generator=g, device=DEV,
                     dtype=dt)
    table = paged_table(B, n_virt, n_pages, [S_max] * len(live)
                        + [0] * KV_SHAPE["dead"], page, seed=B)
    out = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer)
    torch.cuda.synchronize()
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts)
    k3 = {"kernel": "K3 chunk_prefill_attention at the verify shape",
          "dtype": dtype, "q": [B, C, H, D], "cache": [L, B, S_max, H * D],
          "starts": starts.tolist(),
          "max_abs_err": check_close("K3 at the verify shape", out, want,
                                     dtype), "tol": TOL[dtype]}
    out = pa.paged_chunk_prefill_attention(q, kp, vp, starts, table,
                                           layer=layer)
    torch.cuda.synchronize()
    want = pa.paged_chunk_prefill_attention_plain(q, kp[layer], vp[layer],
                                                  starts, table)
    k7 = {"kernel": "K7 paged_chunk_prefill_attention at the verify shape",
          "dtype": dtype, "q": [B, C, H, D], "pool": [L, n_pages, page,
                                                      H * D],
          "table": [B, n_virt], "dead_rows_on_trash_page": KV_SHAPE["dead"],
          "max_abs_err": check_close("K7 at the verify shape", out, want,
                                     dtype), "tol": TOL[dtype]}
    mono = da.chunk_prefill_attention(q, pa.gather_pages(kp[layer], table),
                                      pa.gather_pages(vp[layer], table),
                                      starts)
    if not torch.equal(out, mono):
        fail(f"K7 at the verify shape ({dtype}) is not bitwise equal to K3 "
             f"over the gathered view: max diff {max_err(out, mono)}")
    if timed:
        qh = q.transpose(1, 2).contiguous()
        qpos = starts[:, None].long() + torch.arange(C, device=DEV)[None]
        mask = (torch.arange(S_max, device=DEV)[None, None]
                <= qpos[..., None])[:, None]          # [B, 1, C, S_max]
        pairs = int(qpos.sum()) + B * C
        es = q.element_size()
        nbytes = (2 * int((starts.long() + C).sum()) * H * D * es
                  + 2 * q.numel() * es + starts.numel() * 4)

        def time_one(tag, kernel, plain, bufs, view, nbytes):
            it = iter(range(10 ** 9))
            heads = [tuple(heads_view(view(kv[li]), H, D) for kv in bufs)
                     for li in range(L)]

            def run_library():
                kh, vh = heads[next(it) % L]
                F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

            rec = time_all(tag, "flash_fwd_kernel",
                           lambda: kernel(next(it) % L),
                           lambda: plain(next(it) % L), run_library, 96)
            rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * pairs,
                                                     nbytes, dtype)
            return rec

        k3.update(time_one(
            "k3v",
            lambda li: da.chunk_prefill_attention(q, kc, vc, starts,
                                                  layer=li),
            lambda li: da.chunk_prefill_attention_plain(q, kc[li], vc[li],
                                                        starts),
            (kc, vc), lambda x: x, nbytes))
        k7.update(time_one(
            "k7v",
            lambda li: pa.paged_chunk_prefill_attention(q, kp, vp, starts,
                                                        table, layer=li),
            lambda li: pa.paged_chunk_prefill_attention_plain(
                q, kp[li], vp[li], starts, table),
            (kp, vp), lambda x: pa.gather_pages(x, table),
            nbytes + table.numel() * 4))
        k3["library"] = ("F.scaled_dot_product_attention over the same rows "
                         "with a per-row causal offset mask")
        k7["library"] = k3["library"] + (" (the view gathered through the "
                                          "block table beforehand)")
    emit(k3)
    emit(k7)
    del kc, vc, kp, vp
    torch.cuda.empty_cache()
    return k3, k7


def check_nan_tail(dtype):
    """K3 and K7, float and int8-KV: a cache (pool) whose rows past every
    query's causal limit hold NaN (int8: payload 127, scale NaN) gives
    finite outputs bitwise equal to the same cache with those rows 0, and
    K7 over pools of each page size in ``NAN_TAIL`` stays bitwise K3."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    B, C, S, H, D = (NAN_TAIL[x] for x in ("B", "C", "S_max", "H", "D"))
    dt = getattr(torch, dtype)
    g = torch.Generator(device=DEV).manual_seed(41)
    starts = torch.tensor(NAN_TAIL["starts"], dtype=torch.int32, device=DEV)
    live = torch.arange(S, device=DEV)[None] < starts[:, None] + C
    q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
    rec = {"kernel": "K3 / K7 rows past the causal limit", "dtype": dtype,
           "q": [B, C, H, D], "cache": [B, S, H * D],
           "pages": list(NAN_TAIL["pages"])}
    for int8 in (False, True):
        if int8:
            bufs = int8_pair(g, B, S, KVH=H, D=D)
        else:
            bufs = [torch.randn(B, S, H * D, generator=g, device=DEV,
                                dtype=dt) for _ in range(2)] + [None, None]
        poison = (127 if int8 else float("nan"), float("nan"))
        tails = []
        for fill in (poison, (0, 0.0)):
            tails.append([None if t is None else torch.where(
                live[..., None], t, torch.full_like(t, fill[i >= 2]))
                for i, t in enumerate(bufs)])
        mode = "int8" if int8 else "float"
        outs = [da.chunk_prefill_attention(q, t[0], t[1], starts,
                                           k_scale=t[2], v_scale=t[3])
                for t in tails]
        torch.cuda.synchronize()
        if not (bool(torch.isfinite(outs[0]).all())
                and torch.equal(outs[0], outs[1])):
            fail(f"K3 ({mode}, {dtype}): a NaN tail past the causal limit "
                 f"changed the output (max diff "
                 f"{max_err(outs[0], outs[1])})")
        for page in NAN_TAIL["pages"]:
            n_virt = S // page
            NP = 1 + B * n_virt
            perm = 1 + torch.randperm(NP - 1, generator=torch.Generator()
                                      .manual_seed(page))
            table = perm.view(B, n_virt).to(device=DEV, dtype=torch.int32)
            pouts = []
            for views, fill in zip(tails, (poison, (0, 0.0))):
                pools = []
                for i, t in enumerate(views):
                    if t is None:
                        pools.append(None)
                        continue
                    pool = torch.full((1, NP, page, t.shape[-1]),
                                      fill[i >= 2], dtype=t.dtype, device=DEV)
                    pool[0][table.long()] = t.view(B, n_virt, page, -1)
                    pools.append(pool)
                pouts.append(pa.paged_chunk_prefill_attention(
                    q, pools[0], pools[1], starts, table, layer=0,
                    k_scale=pools[2], v_scale=pools[3]))
                del pools
            torch.cuda.synchronize()
            if not (bool(torch.isfinite(pouts[0]).all())
                    and torch.equal(pouts[0], pouts[1])
                    and torch.equal(pouts[0], outs[0])):
                fail(f"K7 ({mode}, page {page}, {dtype}): a NaN tail past "
                     f"the causal limit changed the output, or K7 is not "
                     f"K3 over the same rows (max diffs "
                     f"{max_err(pouts[0], pouts[1])}, "
                     f"{max_err(pouts[0], outs[0])})")
        rec[f"{mode}_bitwise_equal_to_zero_tail"] = True
    emit(rec)
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------- #
# The int8 modes of K2 / K3 / K6 / K7 against their plain versions
# --------------------------------------------------------------------- #
def int8_pair(g, *lead, KVH, D):
    """An int8-KV cache on the card: k and v payloads [*lead, KVH*D]
    uniform in [-127, 127] and positive fp32 scales [*lead, KVH] in
    [0.001, 0.021)."""
    import torch
    pay = [torch.randint(-127, 128, (*lead, KVH * D), generator=g, device=DEV,
                         dtype=torch.int8) for _ in range(2)]
    scales = [0.001 + 0.02 * torch.rand(*lead, KVH, generator=g, device=DEV)
              for _ in range(2)]
    return pay + scales


def tensor_bytes(tensors):
    """Bytes of the tensors of a dict (a cache, a pool) or a module."""
    import torch
    if isinstance(tensors, torch.nn.Module):
        tensors = {**dict(tensors.named_parameters()),
                   **dict(tensors.named_buffers())}
    return sum(t.numel() * t.element_size() for t in tensors.values()
               if isinstance(t, torch.Tensor))


def dequant_heads(cache, scales, dtype):
    """An int8 cache layer [B, S, KVH*D] with scales [B, S, KVH] as the
    [B, KVH, S, D] ``dtype`` copy SDPA reads (MHA: KVH = H)."""
    B, S, KVH = scales.shape
    x = cache.view(B, S, KVH, -1).float() * scales[..., None]
    return x.to(dtype).transpose(1, 2).contiguous()


def int8_bytes(rows, H, D, KVH):
    """Bytes of ``rows`` int8-KV positions of K and V: payload and scales."""
    return 2 * rows * (H * D + 4 * KVH)


def check_equal_bufs(tag, got, want):
    import torch
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"{tag}: written payloads / scales differ from the plain "
             f"quantize-and-write")


def check_decode_int8(dtype, timed):
    """K2's int8-KV mode at run (g)'s cache [24, 16, 320, 2048] int8 with a
    layer index, fused (one fresh row all zero: payload 0, scale 1.0) and
    unfused, and K2's int8 x int8 mode on the same cache (one KV block of
    min(512, 320) positions); against the plain versions, the fused write
    bitwise the plain quantize-and-write."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    L, B, S_max, H, D = (K2_SHAPE[x] for x in ("L", "B", "S_max", "H", "D"))
    layer = L // 4
    g = torch.Generator(device=DEV).manual_seed(21)
    dt = getattr(torch, dtype)
    bufs = int8_pair(g, L, B, S_max, KVH=H, D=D)
    q, nk, nv = (torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
                 for _ in range(3))
    zero = B // 3                                 # its fresh k row is 0
    nk[zero] = 0
    lengths = torch.tensor(K2_SHAPE["lengths"], dtype=torch.int32,
                           device=DEV)
    a = [t.clone() for t in bufs]
    out = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                              k_scale=a[2], v_scale=a[3], new_k=nk,
                              new_v=nv)[0]
    torch.cuda.synchronize()
    b = [t.clone() for t in bufs]
    want = da.decode_attention_plain(q, b[0][layer], b[1][layer], lengths,
                                     new_k=nk, new_v=nv, k_scale=b[2][layer],
                                     v_scale=b[3][layer])
    err = check_close("K2-int8 decode_attention", out, want, dtype)
    check_equal_bufs(f"K2-int8 ({dtype})", a, b)
    w = int(lengths[zero]) - 1
    if a[0][layer, zero, w].any() \
            or not bool((a[2][layer, zero, w] == 1).all()):
        fail(f"K2-int8 ({dtype}): an all-zero fresh row was not stored as "
             f"payload 0 with scale 1.0")
    del b, want, bufs
    unfused = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                                  k_scale=a[2], v_scale=a[3])
    check_close("K2-int8 decode_attention (unfused)", unfused,
                da.decode_attention_plain(q, a[0][layer], a[1][layer],
                                          lengths, k_scale=a[2][layer],
                                          v_scale=a[3][layer]), dtype)
    bk = min(512, S_max)
    mm = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                             k_scale=a[2], v_scale=a[3], int8_matmuls=True)
    torch.cuda.synchronize()
    mm_err = check_rel(f"K2-i8mm decode_attention ({dtype})", mm,
                       da.decode_attention_i8mm_plain(
                           q, a[0][layer], a[1][layer], lengths, a[2][layer],
                           a[3][layer], block_k=bk), I8MM_REL)
    shape = {"cache": [L, B, S_max, H * D], "cache_dtype": "int8",
             "scales": [L, B, S_max, H], "lengths": lengths.tolist()}
    rec = {"kernel": "K2-int8 decode_attention", "dtype": dtype, **shape,
           "fused_write": True, "max_abs_err": err, "tol": TOL[dtype],
           "cache_rows_and_scales_bitwise_equal": True,
           "zero_row_scale": 1.0}
    rec_mm = {"kernel": "K2-i8mm decode_attention", "dtype": dtype, **shape,
              "int8_matmuls": True, "block_k": bk, "max_abs_err": mm_err,
              "tol": f"{I8MM_REL} * max|want|"}
    if timed:
        it = iter(range(10 ** 9))
        heads = [(dequant_heads(a[0][li], a[2][li], dt),
                  dequant_heads(a[1][li], a[3][li], dt)) for li in range(L)]
        live = (torch.arange(S_max, device=DEV)[None]
                < lengths[:, None].long())[:, None, None, :]
        qh = q[:, :, None, :]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        def run_kernel():       # one layer per call, as decode walks them
            li = next(it) % L
            da.decode_attention(q, a[0], a[1], lengths, layer=li,
                                k_scale=a[2], v_scale=a[3], new_k=nk,
                                new_v=nv)

        def run_plain():
            li = next(it) % L
            da.decode_attention_plain(q, a[0][li], a[1][li], lengths,
                                      new_k=nk, new_v=nv, k_scale=a[2][li],
                                      v_scale=a[3][li])

        def run_mm():
            li = next(it) % L
            da.decode_attention(q, a[0], a[1], lengths, layer=li,
                                k_scale=a[2], v_scale=a[3],
                                int8_matmuls=True)

        def run_mm_plain():
            li = next(it) % L
            da.decode_attention_i8mm_plain(q, a[0][li], a[1][li], lengths,
                                           a[2][li], a[3][li], block_k=bk)

        rec.update(time_all("k2_int8", None, run_kernel,
                            run_plain, run_library, 240))
        rec_mm.update(time_all("k2_i8mm", "decode_i8mm_kernel", run_mm,
                               run_mm_plain, run_library, 240))
        rec["library"] = rec_mm["library"] = INT8_LIBRARY_NOTE
        del heads
        n_live = int(lengths.sum())
        es = q.element_size()
        io = 2 * q.numel() * es + lengths.numel() * 4     # q read, out written
        # fused: each row's last live position is this step's fresh row,
        # read in q's dtype and written as payload + scale
        nbytes = (int8_bytes(n_live - B, H, D, H) + 2 * nk.numel() * es
                  + int8_bytes(B, H, D, H) + io)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * n_live, nbytes,
                                                 dtype)
        rec_mm["bound_ms"], rec_mm["bound_by"] = bound(
            4 * H * D * n_live, int8_bytes(n_live, H, D, H) + io, "int8")
    emit(rec)
    emit(rec_mm)
    del a
    torch.cuda.empty_cache()
    return rec, rec_mm


def check_chunk_int8(dtype, timed):
    """K3's int8-KV mode at run (g)'s chunked-prefill shape: q
    [16, 128, 32, 64] over [24, 16, 512, 2048] int8."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    L, B, C, S_max, H, D = (K3_SHAPE[x]
                            for x in ("L", "B", "C", "S_max", "H", "D"))
    layer = L // 3
    g = torch.Generator(device=DEV).manual_seed(23)
    dt = getattr(torch, dtype)
    kc, vc, ks, vs = int8_pair(g, L, B, S_max, KVH=H, D=D)
    q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
    starts = torch.tensor(K3_SHAPE["starts"], dtype=torch.int32, device=DEV)
    out = da.chunk_prefill_attention(q, kc, vc, starts, layer=layer,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = da.chunk_prefill_attention_plain(q, kc[layer], vc[layer], starts,
                                            k_scale=ks[layer],
                                            v_scale=vs[layer])
    err = check_close("K3-int8 chunk_prefill_attention", out, want, dtype)
    rec = {"kernel": "K3-int8 chunk_prefill_attention", "dtype": dtype,
           "q": [B, C, H, D], "cache": [L, B, S_max, H * D],
           "cache_dtype": "int8", "starts": starts.tolist(),
           "max_abs_err": err, "tol": TOL[dtype]}
    if timed:
        it = iter(range(10 ** 9))
        qh = q.transpose(1, 2).contiguous()
        qpos = starts[:, None].long() + torch.arange(C, device=DEV)[None]
        live = (torch.arange(S_max, device=DEV)[None, None]
                <= qpos[..., None])[:, None]
        heads = [(dequant_heads(kc[li], ks[li], dt),
                  dequant_heads(vc[li], vs[li], dt)) for li in range(L)]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        def run_kernel():
            da.chunk_prefill_attention(q, kc, vc, starts, layer=next(it) % L,
                                       k_scale=ks, v_scale=vs)

        def run_plain():
            li = next(it) % L
            da.chunk_prefill_attention_plain(q, kc[li], vc[li], starts,
                                             k_scale=ks[li], v_scale=vs[li])

        rec.update(time_all("k3_int8", "flash_fwd_kernel", run_kernel,
                            run_plain, run_library, 96))
        rec["library"] = INT8_LIBRARY_NOTE
        del heads
        pairs = int(qpos.sum()) + B * C
        nbytes = (int8_bytes(int((starts.long() + C).sum()), H, D, H)
                  + 2 * q.numel() * q.element_size() + starts.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * pairs, nbytes,
                                                 dtype)
    emit(rec)
    del kc, vc, ks, vs
    torch.cuda.empty_cache()
    return rec


def check_paged_decode_int8(dtype, timed):
    """K6's int8-KV mode at run (h)'s pool [24, 433, 64, 2048] int8, B 96,
    fused: against its plain version (pools bitwise the plain write) and
    bitwise against K2-int8 over the gathered views; K6's int8 x int8 mode
    against its plain version and bitwise against K2-i8mm over the
    gathered views at block_k = page."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    L, NP, page, B, H, D, nv = (K6_SHAPE[x] for x in (
        "L", "pages", "page", "B", "H", "D", "n_virt"))
    layer = L // 4
    g = torch.Generator(device=DEV).manual_seed(29)
    dt = getattr(torch, dtype)
    bufs = int8_pair(g, L, NP, page, KVH=H, D=D)
    q, nk, nw = (torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
                 for _ in range(3))
    spans = [nv * page * i // (B - 1) for i in range(B)]     # 0 .. 384
    lengths = torch.tensor(spans, dtype=torch.int32, device=DEV)
    table = paged_table(B, nv, NP, spans, page, seed=30)
    views = [pa.gather_pages(t[layer], table) for t in bufs]
    a = [t.clone() for t in bufs]
    out = pa.paged_decode_attention(q, a[0], a[1], lengths, table,
                                    layer=layer, k_scale=a[2], v_scale=a[3],
                                    new_k=nk, new_v=nw)[0]
    torch.cuda.synchronize()
    b = [t.clone() for t in bufs]
    want = pa.paged_decode_attention_plain(
        q, b[0][layer], b[1][layer], lengths, table, new_k=nk, new_v=nw,
        k_scale=b[2][layer], v_scale=b[3][layer])
    err = check_close("K6-int8 paged_decode_attention", out, want, dtype)
    check_equal_bufs(f"K6-int8 ({dtype})", a, b)
    del b, want, bufs
    mono = da.decode_attention(q, *views[:2], lengths, k_scale=views[2],
                               v_scale=views[3], new_k=nk, new_v=nw)[0]
    if not torch.equal(out, mono):
        fail(f"K6-int8 ({dtype}) is not bitwise equal to K2-int8 over the "
             f"gathered view: max diff {max_err(out, mono)}")
    del views, mono
    mm = pa.paged_decode_attention(q, a[0], a[1], lengths, table,
                                   layer=layer, k_scale=a[2], v_scale=a[3],
                                   int8_matmuls=True)
    torch.cuda.synchronize()
    mm_err = check_rel(f"K6-i8mm paged_decode_attention ({dtype})", mm,
                       pa.paged_decode_attention_i8mm_plain(
                           q, a[0][layer], a[1][layer], lengths, table,
                           a[2][layer], a[3][layer]), I8MM_REL)
    views = [pa.gather_pages(t[layer], table) for t in a]
    mono = da.decode_attention(q, *views[:2], lengths, k_scale=views[2],
                               v_scale=views[3], int8_matmuls=True,
                               block_k=page)
    if not torch.equal(mm, mono):
        fail(f"K6-i8mm ({dtype}) is not bitwise equal to K2-i8mm over the "
             f"gathered view at block_k = page: max diff "
             f"{max_err(mm, mono)}")
    del views, mono
    shape = {"pool": [L, NP, page, H * D], "cache_dtype": "int8",
             "table": [B, nv], "lengths": [min(spans), max(spans)]}
    rec = {"kernel": "K6-int8 paged_decode_attention", "dtype": dtype,
           **shape, "fused_write": True, "max_abs_err": err,
           "tol": TOL[dtype], "bitwise_equal_to_k2_int8_over_gathered_view":
           True, "pool_rows_and_scales_bitwise_equal": True}
    rec_mm = {"kernel": "K6-i8mm paged_decode_attention", "dtype": dtype,
              **shape, "int8_matmuls": True, "block_k": page,
              "max_abs_err": mm_err, "tol": f"{I8MM_REL} * max|want|",
              "bitwise_equal_to_k2_i8mm_over_gathered_view": True}
    if timed:
        it = iter(range(10 ** 9))
        heads = [(dequant_heads(pa.gather_pages(a[0][li], table),
                                pa.gather_pages(a[2][li], table), dt),
                  dequant_heads(pa.gather_pages(a[1][li], table),
                                pa.gather_pages(a[3][li], table), dt))
                 for li in range(L)]
        live = (torch.arange(nv * page, device=DEV)[None]
                < lengths[:, None].long())[:, None, None, :]
        qh = q[:, :, None, :]

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        def run_kernel():
            pa.paged_decode_attention(q, a[0], a[1], lengths, table,
                                      layer=next(it) % L, k_scale=a[2],
                                      v_scale=a[3], new_k=nk, new_v=nw)

        def run_plain():
            li = next(it) % L
            pa.paged_decode_attention_plain(
                q, a[0][li], a[1][li], lengths, table, new_k=nk, new_v=nw,
                k_scale=a[2][li], v_scale=a[3][li])

        def run_mm():
            pa.paged_decode_attention(q, a[0], a[1], lengths, table,
                                      layer=next(it) % L, k_scale=a[2],
                                      v_scale=a[3], int8_matmuls=True)

        def run_mm_plain():
            li = next(it) % L
            pa.paged_decode_attention_i8mm_plain(q, a[0][li], a[1][li],
                                                 lengths, table, a[2][li],
                                                 a[3][li])

        rec.update(time_all("k6_int8", None, run_kernel,
                            run_plain, run_library, 240))
        rec_mm.update(time_all("k6_i8mm", "decode_i8mm_kernel", run_mm,
                               run_mm_plain, run_library, 240))
        rec["library"] = rec_mm["library"] = \
            INT8_LIBRARY_NOTE + "; " + LIBRARY_NOTE
        del heads
        n_live = sum(spans)
        fresh = sum(1 for n in spans if n > 0)
        es = q.element_size()
        io = (2 * q.numel() * es + lengths.numel() * 4
              + table.numel() * 4)
        # every row (the dead lane's into the trash page) writes one
        nbytes = (int8_bytes(n_live - fresh, H, D, H) + 2 * nk.numel() * es
                  + int8_bytes(B, H, D, H) + io)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * n_live, nbytes,
                                                 dtype)
        rec_mm["bound_ms"], rec_mm["bound_by"] = bound(
            4 * H * D * n_live, int8_bytes(n_live, H, D, H) + io, "int8")
    emit(rec)
    emit(rec_mm)
    del a
    torch.cuda.empty_cache()
    return rec, rec_mm


def check_paged_chunk_int8(dtype, timed):
    """K7's int8-KV mode at the admission shape (B = 1, start 128) and
    B = 8 over 64-row pages of a pool of run (h)'s bytes: against its
    plain version and bitwise against K3-int8 over the gathered views;
    timed at the admission shape."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    L, C, H, D, virt = (K7_SHAPE[x] for x in ("L", "C", "H", "D", "virt"))
    page, NP = K6_SHAPE["page"], K6_SHAPE["pages"]
    layer = L // 3
    dt = getattr(torch, dtype)
    g = torch.Generator(device=DEV).manual_seed(31)
    kp, vp, ks, vs = int8_pair(g, L, NP, page, KVH=H, D=D)
    cases, timed_rec = [], None
    for pg, starts in K7_SHAPE["cases"]:
        if pg != page:
            continue
        B = len(starts)
        q = torch.randn(B, C, H, D, generator=g, device=DEV, dtype=dt)
        st = torch.tensor(starts, dtype=torch.int32, device=DEV)
        table = paged_table(B, virt // page, NP, [s + C for s in starts],
                            page, seed=page + B + 1)
        out = pa.paged_chunk_prefill_attention(q, kp, vp, st, table,
                                               layer=layer, k_scale=ks,
                                               v_scale=vs)
        torch.cuda.synchronize()
        want = pa.paged_chunk_prefill_attention_plain(
            q, kp[layer], vp[layer], st, table, k_scale=ks[layer],
            v_scale=vs[layer])
        tag = f"K7-int8 paged_chunk_prefill_attention (B {B})"
        err = check_close(tag, out, want, dtype)
        views = [pa.gather_pages(t[layer], table) for t in (kp, vp, ks, vs)]
        mono = da.chunk_prefill_attention(q, *views[:2], st,
                                          k_scale=views[2], v_scale=views[3])
        if not torch.equal(out, mono):
            fail(f"{tag} ({dtype}) is not bitwise equal to K3-int8 over the "
                 f"gathered view: max diff {max_err(out, mono)}")
        cases.append({"page": page, "q": [B, C, H, D], "starts": starts,
                      "max_abs_err": err})
        if not (timed and B == 1):
            continue
        rec = {}
        it = iter(range(10 ** 9))

        def run_kernel():
            pa.paged_chunk_prefill_attention(q, kp, vp, st, table,
                                             layer=next(it) % L, k_scale=ks,
                                             v_scale=vs)

        def run_plain():
            li = next(it) % L
            pa.paged_chunk_prefill_attention_plain(
                q, kp[li], vp[li], st, table, k_scale=ks[li], v_scale=vs[li])

        heads = [(dequant_heads(pa.gather_pages(kp[li], table),
                                pa.gather_pages(ks[li], table), dt),
                  dequant_heads(pa.gather_pages(vp[li], table),
                                pa.gather_pages(vs[li], table), dt))
                 for li in range(L)]
        qpos = st[:, None].long() + torch.arange(C, device=DEV)[None]
        live = (torch.arange(virt, device=DEV)[None, None]
                <= qpos[..., None])[:, None]
        qh = q.transpose(1, 2).contiguous()

        def run_library():
            kh, vh = heads[next(it) % L]
            F.scaled_dot_product_attention(qh, kh, vh, attn_mask=live)

        rec.update(time_all("k7_int8", "flash_fwd_kernel", run_kernel,
                            run_plain, run_library, 96))
        del heads
        pairs = int(qpos.sum()) + B * C
        nbytes = (int8_bytes(int((st.long() + C).sum()), H, D, H)
                  + 2 * q.numel() * q.element_size() + st.numel() * 4
                  + table.numel() * 4)
        rec["bound_ms"], rec["bound_by"] = bound(4 * H * D * pairs, nbytes,
                                                 dtype)
        timed_rec = rec
    del kp, vp, ks, vs
    torch.cuda.empty_cache()
    for i, case in enumerate(K7_EXTRA):
        cases.append(k7_extra_case(dtype, g, int8=True, seed=60 + i, **case))
    rec = {"kernel": "K7-int8 paged_chunk_prefill_attention", "dtype": dtype,
           "pool": [L, NP, page, H * D], "cache_dtype": "int8",
           "cases": cases,
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "tol": TOL[dtype],
           "bitwise_equal_to_k3_int8_over_gathered_view": True}
    if timed_rec is not None:
        rec.update(timed_rec)
        rec.update(timed_shape=[1, C, H, D], timed_page=page,
                   library=INT8_LIBRARY_NOTE + "; " + LIBRARY_NOTE)
    emit(rec)
    torch.cuda.empty_cache()
    return rec


def check_rel(name, got, want, rel):
    """max |got - want| <= rel * max |want| (a bar scaled by the output's
    magnitude); returns the max abs error."""
    import torch
    err = max_err(got, want)
    top = float(want.float().abs().max())
    if not (bool(torch.isfinite(got).all()) and err <= rel * top):
        fail(f"{name} disagrees with its plain version: max_abs_err={err}, "
             f"bar {rel} * max|want| = {rel * top}")
    return err


def check_flash_bwd(dtype, timed, shape=KB_SHAPE):
    """K1 (with the LSE, as the training forward launches it), K4 and K5 at
    a training shape: causal, q/k/v/dO ``shape`` — run (c)'s
    [2, 2048, 32, 64] (the power-of-two scale folded into q as the autograd
    wrapper folds it), or GPT-Neo's global layers' [2, 2048, 16, 128]
    (``KB_D128_SHAPE``: the scale in the kernels).  Timed: K4, K5 and SDPA's
    whole backward in this call, their sum against SDPA's."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    B, S, H, D = (shape[x] for x in "BSHD")
    tag = "" if shape is KB_SHAPE else f" [{B}, {S}, {H}, {D}]"
    g = torch.Generator(device=DEV).manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.randn(B, S, H, D, generator=g, device=DEV,
                                 dtype=dt) for _ in range(4))
    sc = 1 / math.sqrt(D)
    if math.log2(sc).is_integer():
        q, sc = q * torch.tensor(sc, dtype=dt), 1.0
    out, lse = fa.launch_attention_kernel(q, k, v, True, sc, None, True)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, out, lse, dout, True, sc)
    torch.cuda.synchronize()
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True, scale=sc)
    k1_err = check_close(f"K1 flash_attention (training shape{tag})", out,
                         want, dtype)
    lse_err = check_lse(f"K1 flash_attention lse (training shape{tag})", lse,
                        want_lse, dtype)
    # the plain backward in fp32 from the same (16-bit) inputs
    ref = fa.flash_attention_bwd_plain(
        *(t.float() for t in (q, k, v, out)), lse, dout.float(), True, sc)
    errs = {}
    for name, got, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        label = f"K{4 if name == 'dq' else 5} {name} ({dtype}){tag}"
        errs[name] = (check_close(label, got, r, dtype) if dtype == "float32"
                      else check_rel(label, got, r, BWD_BF16_REL))
    del ref, want
    tol = TOL[dtype] if dtype == "float32" else f"{BWD_BF16_REL} * max|want|"
    recs = {
        "K1": {"kernel": "K1 flash_attention (training, with lse)",
               "dtype": dtype, "max_abs_err": k1_err, "tol": TOL[dtype],
               "lse_max_abs_err": lse_err, "lse_tol": LSE_TOL},
        "K4": {"kernel": "K4 flash_attention_dq", "dtype": dtype,
               "max_abs_err": errs["dq"], "tol": tol},
        "K5": {"kernel": "K5 flash_attention_dkv", "dtype": dtype,
               "max_abs_err": max(errs["dk"], errs["dv"]),
               "max_abs_err_dk": errs["dk"], "max_abs_err_dv": errs["dv"],
               "tol": tol},
    }
    for rec in recs.values():
        rec.update(shape=[B, S, H, D], causal=True, in_kernel_scale=sc)
    if timed:
        delta = fa._delta(out, dout)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                            scale=sc)
        doh = dout.transpose(1, 2).contiguous()

        def sdpa_backward():       # dq, dk and dv in one library call
            torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)

        def plain_backward():      # the plain version of K4 and K5 together
            fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, True, sc)

        suffix = "" if shape is KB_SHAPE else f"_d{D}"
        with torch.no_grad():
            recs["K1"].update(time_all(
                "k1_train" + suffix, "flash_fwd_kernel",
                lambda: fa.launch_attention_kernel(q, k, v, True, sc, None,
                                                   True),
                lambda: fa.flash_attention_plain(q, k, v, True, sc),
                lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, scale=sc), 20))
        recs["K4"].update(time_all(
            "k4" + suffix, "flash_bwd_dq_kernel",
            lambda: fa.flash_attention_dq(q, k, v, dout, lse, delta, True,
                                          sc),
            plain_backward, sdpa_backward, 20))
        recs["K5"].update(time_all(
            "k5" + suffix, "flash_bwd_dkv_kernel",
            lambda: fa.flash_attention_dkv(q, k, v, dout, lse, delta, True,
                                           sc),
            plain_backward, sdpa_backward, 20))
        pairs = B * H * S * (S + 1) // 2        # causal (q, k) pairs
        tensor = q.numel() * q.element_size()   # one [B, S, H, D] tensor
        rows = B * H * S * 4                    # one fp32 [B, H, S] row set
        # K1: q, k, v read, out and lse written; 2 products of 2D flops
        recs["K1"]["bound_ms"], recs["K1"]["bound_by"] = bound(
            4 * D * pairs, 4 * tensor + rows, dtype)
        # K4: q, k, v, dO, lse, delta read, dq written; S, dP, dQ
        recs["K4"]["bound_ms"], recs["K4"]["bound_by"] = bound(
            6 * D * pairs, 5 * tensor + 2 * rows, dtype)
        # K5: the same reads, dk and dv written; S, dP, dV, dK
        recs["K5"]["bound_ms"], recs["K5"]["bound_by"] = bound(
            8 * D * pairs, 6 * tensor + 2 * rows, dtype)
        for key, products in (("K1", 2), ("K4", 3), ("K5", 4)):
            recs[key]["tflops"] = (2 * products * D * pairs
                                   / recs[key]["kernel_ms"] / 1e9)
        # the pair computes what one SDPA backward call computes
        pair = recs["K4"]["kernel_ms"] + recs["K5"]["kernel_ms"]
        for key in ("K4", "K5"):
            recs[key].update(pair_ms=pair,
                             pair_over_library=pair / recs[key]["library_ms"])
    for rec in recs.values():
        emit(rec)
    return recs


PTXAS_KINDS = {"13__nv_bfloat16": "bf16", "6__half": "fp16", "f": "fp32"}


def bwd_kernel_of(mangled, smem_of):
    """(label, dynamic shared memory) of a K4 / K5 instantiation, or None."""
    import re
    k = re.search(r"\d((?:wgmma_)?flash_bwd_[a-z]+_kernel)I("
                  r"13__nv_bfloat16|6__half|f)Li(\d+)E", mangled)
    if not k:
        return None
    kind = PTXAS_KINDS[k.group(2)]
    return (f"{k.group(1)}<{kind}, {k.group(3)}>",
            smem_of(k.group(1), kind, int(k.group(3))))


def fwd_kernel_of(mangled, smem_of):
    """(label, dynamic shared memory) of a K1 / K3 / K7 instantiation
    (element type, int8-KV or not, head dim, row map), or None."""
    import re
    k = re.search(r"\d((?:wgmma_)?flash_fwd_kernel)I(13__nv_bfloat16|"
                  r"6__half|f)(a|f|S\d*_)Li(\d+)E", mangled)
    if not k:
        return None
    kind, int8 = PTXAS_KINDS[k.group(2)], k.group(3) == "a"
    rows = "PagedRows" if "PagedRows" in mangled else "StridedRows"
    cache = "int8" if int8 else kind
    return (f"{k.group(1)}<{kind}, {cache}, {k.group(4)}, {rows}>",
            smem_of(kind, int8, int(k.group(4))))


def decode_kernel_of(mangled, smem_of):
    """(label, dynamic shared memory) of a K2 / K6 ``decode_kernel``
    instantiation (element type, cache type, head dim, query heads per kv
    head, kv heads per block, row map; all its shared memory is static)
    or ``decode_i8mm_kernel`` instantiation (element type, head dim, G,
    HPB, row map; ``smem_of(D, G, HPB, paged)`` its dynamic shared
    memory), or None."""
    import re
    rows = "PagedRows" if "PagedRows" in mangled else "StridedRows"
    k = re.search(r"\d(decode_i8mm_kernel)I(13__nv_bfloat16|6__half|f)"
                  r"Li(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if k:
        D, G, hpb = (int(k.group(i)) for i in (3, 4, 5))
        return (f"decode_i8mm_kernel<{PTXAS_KINDS[k.group(2)]}, {D}, G={G}, "
                f"HPB={hpb}, {rows}>", smem_of(D, G, hpb, rows == "PagedRows"))
    k = re.search(r"\d(decode_kernel)I(13__nv_bfloat16|6__half|f)(a|f|S\d*_)"
                  r"Li(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if not k:
        return None
    kind = PTXAS_KINDS[k.group(2)]
    cache = "int8" if k.group(3) == "a" else kind
    return (f"decode_kernel<{kind}, {cache}, {k.group(4)}, G={k.group(5)}, "
            f"HPB={k.group(6)}, {rows}>", 0)


def sparse_kernel_of(mangled, smem_of):
    """(label, dynamic shared memory) of a K8 instantiation: the 16-bit
    ``wgmma_sparse_fwd_kernel<T, D, bias>`` or the fp32
    ``block_sparse_fwd_kernel<float, D, block>``, or None."""
    import re
    k = re.search(r"\d(wgmma_sparse_fwd_kernel)I(13__nv_bfloat16|6__half)"
                  r"Li(\d+)ELb([01])E", mangled)
    if k:
        kind, D = PTXAS_KINDS[k.group(2)], int(k.group(3))
        bias = "bias" if k.group(4) == "1" else "no bias"
        return f"{k.group(1)}<{kind}, {D}, {bias}>", smem_of(kind, D, 64)
    k = re.search(r"\d(block_sparse_fwd_kernel)IfLi(\d+)ELi(\d+)E", mangled)
    if not k:
        return None
    D, blk = int(k.group(2)), int(k.group(3))
    return f"{k.group(1)}<fp32, {D}, {blk}>", smem_of("fp32", D, blk)


def ptxas_report(log, smem_of, kernel_of=bwd_kernel_of):
    """Registers, spills and shared memory of each kernel in one library's
    ``-Xptxas -v`` output; ``kernel_of(mangled name, smem_of)`` names a
    kernel of interest and gives its dynamic shared memory (ptxas counts
    only the static part)."""
    import re
    recs, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = kernel_of(m.group(1), smem_of)
            cur = None
            if k:
                cur = {"kernel": k[0], "dynamic_smem_bytes": k[1]}
                recs.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(m.group(1)) if m else 0
    return recs


def bigbird(**over):
    from deepspeed_tpu_torch.ops.sparse_attention import BigBirdSparsityConfig
    return BigBirdSparsityConfig(**{**BIGBIRD, **over})


def live_pairs(layout, block, causal):
    """The (query, key) pairs a layout [H, nb, nb] (upper blocks dropped
    when causal) leaves live, per batch row: a full block per active
    block, a lower triangle with its diagonal per causal diagonal block."""
    import numpy as np
    layout = np.asarray(layout)
    n = int(layout.sum())
    if not causal:
        return n * block * block
    diag = int(np.trace(layout, axis1=1, axis2=2).sum())
    return (n - diag) * block * block + diag * block * (block + 1) // 2


def check_block_sparse_case(tag, dtype, B, S, H, D, block, causal, layout,
                            keep=None):
    """K8 (with its LSE) and its plain version on one layout, on seeded
    inputs: the output at the dtype's bar, the LSE at ``LSE_TOL``; twice
    launched, bitwise the same.  Returns ((q, k, v), tables, bias, kernel
    output, {"max_abs_err", "lse_max_abs_err"})."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    g = torch.Generator(device=DEV).manual_seed(S + H + D + block)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(B, S, H, D, generator=g, device=DEV, dtype=dt)
               for _ in range(3))
    tables = bs.device_tables(layout, H, causal, DEV, block)
    bias = None if keep is None else bs.padding_bias(keep, dt, DEV)
    out, lse = bs.block_sparse_attention_fwd(q, k, v, tables, D ** -0.5,
                                             causal, block, bias,
                                             with_lse=True)
    again, lse_again = bs.block_sparse_attention_fwd(
        q, k, v, tables, D ** -0.5, causal, block, bias, with_lse=True)
    torch.cuda.synchronize()
    if not (torch.equal(out, again) and torch.equal(lse, lse_again)):
        fail(f"{tag} ({dtype}): two launches differ")
    want, want_lse = bs.block_sparse_attention_plain(
        q, k, v, tables.idx, tables.counts, D ** -0.5, causal, block, bias,
        return_lse=True)
    errs = {"max_abs_err": check_close(tag, out, want, dtype),
            "lse_max_abs_err": check_lse(tag + " LSE", lse, want_lse,
                                         dtype)}
    return (q, k, v), tables, bias, (out, lse), errs


def k8_layout(var):
    """A K8_VARIANTS entry's layout (upper blocks dropped when causal) and
    its key-padding mask (or None)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import FixedSparsityConfig
    vB, vS, vH, vblock = (var[x] for x in ("B", "S", "H", "block"))
    if var.get("per_head"):
        lay = FixedSparsityConfig(
            num_heads=vH, block=vblock, num_local_blocks=4,
            different_layout_per_head=True,
            num_different_global_patterns=4,
            attention="unidirectional").make_layout(vS)
    else:
        lay = bigbird(num_heads=vH, block=vblock).make_layout(vS)
    lay = np.array(lay)
    if "empty_row" in var:
        lay[:, var["empty_row"]] = 0
    if var["causal"]:
        lay = np.tril(lay)
    keep = None
    if var.get("padded"):
        keep = torch.ones(vB, vS, device=DEV)
        keep[0, vS - 37:] = 0
        keep[1, vS - vblock:] = 0
    return lay, keep


def time_k8(tag, qkv, tables, bias, layout, block, causal, dtype):
    """K8, its plain version and SDPA over the layout expanded to a [S, S]
    mask (boolean; additive with a key bias) at one shape, beside the
    bound of the live pairs' products and of q, k, v, o, the bias and the
    table entries the launched kernel reads, moved once."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    q, k, v = qkv
    B, S, H, D = q.shape
    scale = D ** -0.5
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    same = bool((layout == layout[:1]).all())
    heads = layout[:1] if same else layout
    live = torch.from_numpy(np.kron(heads, np.ones((block, block),
                                                   np.int8)) > 0).to(DEV)
    if causal:
        live &= torch.ones(S, S, dtype=torch.bool, device=DEV).tril()
    mask = live[None]                                # [1, H | 1, S, S]
    if bias is not None:
        mask = torch.where(mask, (bias * scale)[:, None, None, :],
                           float("-inf")).to(q.dtype)
    with torch.no_grad():
        rec = time_all(
            tag, "sparse_fwd_kernel",
            lambda: bs.block_sparse_attention_fwd(q, k, v, tables, scale,
                                                  causal, block, bias),
            lambda: bs.block_sparse_attention_plain(
                q, k, v, tables.idx, tables.counts, scale, causal, block,
                bias),
            lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                   attn_mask=mask), 20)
    del live, mask, qh, kh, vh
    pairs = B * live_pairs(layout, block, causal)
    # q, k, v read and out written once, the bias read, and the table the
    # launched kernel walks: a count per row and the entries below it (the
    # 16-bit kernel's 64-row tiles, the fp32 kernel's layout rows)
    counts = tables.counts if dtype == "float32" else tables.tile_counts
    nbytes = 4 * q.numel() * q.element_size() + 4 * (
        counts.numel() + int(counts.sum())) + (
        0 if bias is None else bias.numel() * bias.element_size())
    rec["live_pairs"] = pairs
    rec["bound_ms"], rec["bound_by"] = bound(4 * D * pairs, nbytes, dtype)
    return rec


def check_block_sparse(dtype, timed):
    """K8 at run (f)'s attention shape — q/k/v [1, 8192, 32, 64], the
    tutorial BigBird layout, causal — and at the K8_VARIANTS, each with
    its LSE and repeated bitwise; timed in bf16 against its plain version,
    SDPA over the layout expanded to a [S, S] mask and the bound (every
    shape), and the gather backward of one layer (run (f)'s shape)."""
    import torch
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    B, S, H, D = (K8_SHAPE[x] for x in "BSHD")
    block = BIGBIRD["block"]
    layout = bs.cached_layout(bigbird(), S, causal=True)
    tag = "K8 block_sparse_attention"
    qkv, tables, _, _, errs = check_block_sparse_case(
        tag, dtype, B, S, H, D, block, True, layout)
    rec = {"kernel": tag, "dtype": dtype,
           "shape": [B, S, H, D], "block": block, "causal": True,
           "layout": "BigBird " + json.dumps(BIGBIRD),
           "active_blocks": int(layout[0].sum()),
           "max_active_per_row": int(tables.idx.shape[-1]),
           "max_tiles_per_q_tile": int(tables.tiles.shape[-1]),
           **errs, "tol": TOL[dtype], "lse_tol": LSE_TOL, "variants": []}
    for i, var in enumerate(K8_VARIANTS):
        vB, vS, vH, vD, vblock, vcausal = (var[x] for x in (
            "B", "S", "H", "D", "block", "causal"))
        lay, keep = k8_layout(var)
        vqkv, vtables, vbias, (vout, vlse), verrs = check_block_sparse_case(
            f"{tag} ({var['tag']})", dtype, vB, vS, vH, vD, vblock,
            vcausal, lay, keep)
        if "empty_row" in var:
            r = var["empty_row"] * vblock
            if not (bool((vout[:, r:r + vblock] == 0).all())
                    and bool((vlse[:, :, r:r + vblock] == -1e30).all())):
                fail(f"K8 ({dtype}): an empty block-row is not exactly 0 "
                     f"with LSE -1e30")
        vrec = {"case": var["tag"], "shape": [vB, vS, vH, vD],
                "block": vblock, **verrs}
        if timed:
            vrec.update(time_k8(f"k8_variant{i}", vqkv, vtables, vbias,
                                lay, vblock, vcausal, dtype))
        rec["variants"].append(vrec)
        del vqkv, vout, vlse
    if timed:
        q, k, v = qkv

        def run_gather_backward():   # what one layer's backward runs
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            o = bs.block_sparse_attention_plain(*leaves, tables.idx,
                                                tables.counts, D ** -0.5,
                                                True, block)
            torch.autograd.grad(o, leaves, q)

        rec.update(time_k8("k8", qkv, tables, None, layout, block, True,
                           dtype))
        from deepspeed_tpu_torch.profiling.trace import device_ms_per_call
        rec["gather_backward_ms"] = device_ms_per_call(
            run_gather_backward, 3,
            os.path.join(ROOT, "build", "profiles", "chip_smoke_k8_bwd.json"))
    emit(rec)
    del qkv
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------- #
# The sliding-window mode of K2 / K6 (GPT-Neo's local layers)
# --------------------------------------------------------------------- #
def window_rows(t, lengths, W, H, D):
    """The last ``W`` live rows of each batch row of one cache layer
    ``t [B, S, H*D]`` (or its scales ``[B, S, H]``; every length >= W) as
    the [B, H, W, D] (or [B, W, H]) copy SDPA reads."""
    import torch
    lo = [int(n) - W for n in lengths.tolist()]
    rows = torch.stack([t[b, s:s + W] for b, s in enumerate(lo)])
    if rows.shape[-1] == H:
        return rows
    return rows.view(len(lo), W, H, D).transpose(1, 2).contiguous()


def window_library(q, bufs, lengths, layers, W, H, D, dt, int8):
    """SDPA over each layer's window rows gathered (and for an int8 cache
    dequantized to ``dt``) beforehand, one layer per call."""
    import torch
    import torch.nn.functional as F
    heads = []
    for layer in layers:
        if int8:
            k, v = (window_rows(bufs[i](layer), lengths, W, H, D).float()
                    * window_rows(bufs[i + 2](layer), lengths, W, H,
                                  D).transpose(1, 2)[..., None]
                    for i in (0, 1))
            heads.append((k.to(dt).contiguous(), v.to(dt).contiguous()))
        else:
            heads.append(tuple(window_rows(bufs[i](layer), lengths, W, H, D)
                               for i in (0, 1)))
    qh = q[:, :, None, :]
    it = iter(range(10 ** 9))

    def run():
        kh, vh = heads[next(it) % len(heads)]
        F.scaled_dot_product_attention(qh, kh, vh)

    return run


def check_decode_window(dtype, timed):
    """K2's sliding-window mode at run (i)'s cache [24, 16, 384, 2048],
    window 256, lengths 0 to 384: fused, unfused, int8-KV fused and
    int8 x int8 (one KV block of min(512, 384)) against the plain versions
    (the fused writes bitwise the plain write); timed at run (i)'s
    mid-decode length 352 against the bound of the window's rows."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    L, B, S_max, H, D = (K2W_SHAPE[x] for x in ("L", "B", "S_max", "H", "D"))
    layer, W, bk = L // 3, WINDOW, min(512, S_max)
    g = torch.Generator(device=DEV).manual_seed(41)
    dt = getattr(torch, dtype)
    flt = [torch.randn(L, B, S_max, H * D, generator=g, device=DEV, dtype=dt)
           for _ in range(2)]
    i8 = int8_pair(g, L, B, S_max, KVH=H, D=D)
    q, nk, nv = (torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
                 for _ in range(3))
    lengths = torch.tensor(K2W_SHAPE["lengths"], dtype=torch.int32,
                           device=DEV)
    recs = {}

    def held(key, bufs, fused, i8mm=False):
        a = [t.clone() for t in bufs]
        b = [t.clone() for t in bufs]
        sa = dict(k_scale=a[2], v_scale=a[3]) if len(a) == 4 else {}
        sb = dict(k_scale=b[2][layer], v_scale=b[3][layer]) \
            if len(b) == 4 else {}
        kw = dict(new_k=nk, new_v=nv) if fused else {}
        if i8mm:
            out = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                                      window=W, int8_matmuls=True, **sa)
            want = da.decode_attention_i8mm_plain(
                q, b[0][layer], b[1][layer], lengths, sb["k_scale"],
                sb["v_scale"], block_k=bk, window=W)
            return check_rel(f"{key} ({dtype})", out, want, I8MM_REL)
        out = da.decode_attention(q, a[0], a[1], lengths, layer=layer,
                                  window=W, **sa, **kw)
        want = da.decode_attention_plain(q, b[0][layer], b[1][layer],
                                         lengths, window=W, **sb, **kw)
        err = check_close(key, out[0] if fused else out, want, dtype)
        if fused:
            check_equal_bufs(f"{key} ({dtype})", a, b)
        return err

    shape = {"cache": [L, B, S_max, H * D], "window": W,
             "lengths": lengths.tolist()}
    recs["K2-window"] = {"kernel": "K2-window decode_attention",
                         "dtype": dtype, **shape, "fused_write": True,
                         "max_abs_err": held("K2-window", flt, True),
                         "unfused_max_abs_err": held("K2-window (unfused)",
                                                     flt, False),
                         "tol": TOL[dtype], "cache_rows_bitwise_equal": True}
    recs["K2-window-int8"] = {
        "kernel": "K2-window-int8 decode_attention", "dtype": dtype, **shape,
        "cache_dtype": "int8", "fused_write": True,
        "max_abs_err": held("K2-window-int8", i8, True), "tol": TOL[dtype],
        "cache_rows_and_scales_bitwise_equal": True}
    recs["K2-window-i8mm"] = {
        "kernel": "K2-window-i8mm decode_attention", "dtype": dtype, **shape,
        "cache_dtype": "int8", "int8_matmuls": True, "block_k": bk,
        "max_abs_err": held("K2-window-i8mm", i8, False, i8mm=True),
        "tol": f"{I8MM_REL} * max|want|"}
    torch.cuda.synchronize()
    if timed:
        lt = torch.tensor(K2W_SHAPE["timed"], dtype=torch.int32, device=DEV)
        it = iter(range(10 ** 9))
        es = q.element_size()
        io = 2 * q.numel() * es + lt.numel() * 4     # q read, out written
        n_live = sum(min(int(n), W) for n in K2W_SHAPE["timed"])
        flops = 4 * H * D * n_live
        modes = (
            ("K2-window", flt, dict(new_k=nk, new_v=nv), None,
             # each row's last live position is this step's fresh row
             2 * (n_live - B) * H * D * es + 2 * 2 * nk.numel() * es + io,
             dtype),
            ("K2-window-int8", i8, dict(new_k=nk, new_v=nv), None,
             int8_bytes(n_live - B, H, D, H) + 2 * nk.numel() * es
             + int8_bytes(B, H, D, H) + io, dtype),
            ("K2-window-i8mm", i8, dict(int8_matmuls=True),
             "decode_i8mm_kernel", int8_bytes(n_live, H, D, H) + io, "int8"))
        for key, bufs, kw, kname, nbytes, peak in modes:
            sc = {} if len(bufs) == 2 else dict(k_scale=bufs[2],
                                                v_scale=bufs[3])

            def run_kernel(bufs=bufs, kw=kw, sc=sc):
                da.decode_attention(q, bufs[0], bufs[1], lt,
                                    layer=next(it) % L, window=W, **sc,
                                    **kw)

            def run_plain(bufs=bufs, kw=kw):
                li = next(it) % L
                ps = {} if len(bufs) == 2 else dict(k_scale=bufs[2][li],
                                                    v_scale=bufs[3][li])
                if "int8_matmuls" in kw:
                    da.decode_attention_i8mm_plain(
                        q, bufs[0][li], bufs[1][li], lt, ps["k_scale"],
                        ps["v_scale"], block_k=bk, window=W)
                else:
                    da.decode_attention_plain(q, bufs[0][li], bufs[1][li],
                                              lt, window=W, **ps, **kw)

            lib = window_library(
                q, [lambda li, i=i: bufs[i][li] for i in range(len(bufs))],
                lt, range(L), W, H, D, dt, len(bufs) == 4)
            recs[key].update(time_all(key.lower(), kname, run_kernel,
                                      run_plain, lib, 240))
            del lib
            recs[key]["timed_lengths"] = K2W_SHAPE["timed"]
            recs[key]["library"] = WINDOW_LIBRARY_NOTE + (
                "; dequantized to bf16 beforehand" if len(bufs) == 4 else "")
            recs[key]["bound_ms"], recs[key]["bound_by"] = bound(
                flops, nbytes, peak)
    for rec in recs.values():
        emit(rec)
    del flt, i8
    torch.cuda.empty_cache()
    return recs


def check_paged_decode_window(dtype, timed):
    """K6's sliding-window mode at run (j)'s pool [24, 129, 64, 2048], 16
    rows over a shuffled table, lengths 0 (a dead lane on the trash page)
    to 512: unfused (run (j)'s route) and fused on a float pool, unfused
    on an int8 pool, and int8 x int8 in the gathered view's KV blocks of
    min(512, 8 x 64), each against its plain version and BITWISE against
    K2-window over the gathered view; timed unfused at lengths 288..498."""
    import torch
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    L, NP, page, B, H, D, nv = (K6W_SHAPE[x] for x in (
        "L", "pages", "page", "B", "H", "D", "n_virt"))
    layer, W, bk = L // 4, WINDOW, min(512, nv * page)
    g = torch.Generator(device=DEV).manual_seed(43)
    dt = getattr(torch, dtype)
    flt = [torch.randn(L, NP, page, H * D, generator=g, device=DEV, dtype=dt)
           for _ in range(2)]
    i8 = int8_pair(g, L, NP, page, KVH=H, D=D)
    q, nk, nw = (torch.randn(B, H, D, generator=g, device=DEV, dtype=dt)
                 for _ in range(3))
    spans = K6W_SHAPE["lengths"]
    lengths = torch.tensor(spans, dtype=torch.int32, device=DEV)
    table = paged_table(B, nv, NP, spans, page, seed=44)
    recs = {}

    def held(key, bufs, fused=False, i8mm=False):
        a = [t.clone() for t in bufs]
        b = [t.clone() for t in bufs]
        views = [pa.gather_pages(t[layer], table) for t in bufs]
        sa = dict(k_scale=a[2], v_scale=a[3]) if len(a) == 4 else {}
        sb = dict(k_scale=b[2][layer], v_scale=b[3][layer]) \
            if len(b) == 4 else {}
        sv = dict(k_scale=views[2], v_scale=views[3]) if len(a) == 4 else {}
        kw = dict(new_k=nk, new_v=nw) if fused else {}
        if i8mm:
            kw = dict(int8_matmuls=True, block_k=bk)
        out = pa.paged_decode_attention(q, a[0], a[1], lengths, table,
                                        layer=layer, window=W, **sa, **kw)
        mono = da.decode_attention(q, views[0], views[1], lengths, window=W,
                                   **sv, **kw)
        if fused:
            out, mono = out[0], mono[0]
        if i8mm:
            err = check_rel(f"{key} ({dtype})", out,
                            pa.paged_decode_attention_i8mm_plain(
                                q, b[0][layer], b[1][layer], lengths, table,
                                sb["k_scale"], sb["v_scale"], block_k=bk,
                                window=W), I8MM_REL)
        else:
            err = check_close(key, out, pa.paged_decode_attention_plain(
                q, b[0][layer], b[1][layer], lengths, table, window=W,
                **sb, **kw), dtype)
            check_equal_bufs(f"{key} ({dtype})", a, b)
        if not torch.equal(out, mono):
            fail(f"{key} ({dtype}) is not bitwise equal to K2-window over "
                 f"the gathered view: max diff {max_err(out, mono)}")
        return err

    shape = {"pool": [L, NP, page, H * D], "table": [B, nv], "window": W,
             "lengths": spans}
    bit = {"bitwise_equal_to_k2_window_over_gathered_view": True}
    recs["K6-window"] = {"kernel": "K6-window paged_decode_attention",
                         "dtype": dtype, **shape, "fused_write": False,
                         "max_abs_err": held("K6-window", flt),
                         "fused_max_abs_err": held("K6-window (fused)", flt,
                                                   fused=True),
                         "tol": TOL[dtype], **bit}
    recs["K6-window-int8"] = {
        "kernel": "K6-window-int8 paged_decode_attention", "dtype": dtype,
        **shape, "cache_dtype": "int8", "fused_write": False,
        "max_abs_err": held("K6-window-int8", i8), "tol": TOL[dtype], **bit}
    recs["K6-window-i8mm"] = {
        "kernel": "K6-window-i8mm paged_decode_attention", "dtype": dtype,
        **shape, "cache_dtype": "int8", "int8_matmuls": True, "block_k": bk,
        "max_abs_err": held("K6-window-i8mm", i8, i8mm=True),
        "tol": f"{I8MM_REL} * max|want|", **bit}
    torch.cuda.synchronize()
    if timed:
        st = K6W_SHAPE["timed"]
        lt = torch.tensor(st, dtype=torch.int32, device=DEV)
        tt = paged_table(B, nv, NP, st, page, seed=45)
        it = iter(range(10 ** 9))
        es = q.element_size()
        # q read, out written, lengths, and the table entries of the
        # window's pages
        io = (2 * q.numel() * es + lt.numel() * 4
              + 4 * sum((n - 1) // page - max(n - W, 0) // page + 1
                        for n in st))
        n_live = sum(min(n, W) for n in st)
        flops = 4 * H * D * n_live
        modes = (("K6-window", flt, {}, None,
                  2 * n_live * H * D * es + io, dtype),
                 ("K6-window-int8", i8, {}, None,
                  int8_bytes(n_live, H, D, H) + io, dtype),
                 ("K6-window-i8mm", i8, dict(int8_matmuls=True, block_k=bk),
                  "decode_i8mm_kernel", int8_bytes(n_live, H, D, H) + io,
                  "int8"))
        for key, bufs, kw, kname, nbytes, peak in modes:
            sc = {} if len(bufs) == 2 else dict(k_scale=bufs[2],
                                                v_scale=bufs[3])

            def run_kernel(bufs=bufs, kw=kw, sc=sc):
                pa.paged_decode_attention(q, bufs[0], bufs[1], lt, tt,
                                          layer=next(it) % L, window=W,
                                          **sc, **kw)

            def run_plain(bufs=bufs, kw=kw):
                li = next(it) % L
                ps = {} if len(bufs) == 2 else dict(k_scale=bufs[2][li],
                                                    v_scale=bufs[3][li])
                if kw:
                    pa.paged_decode_attention_i8mm_plain(
                        q, bufs[0][li], bufs[1][li], lt, tt, ps["k_scale"],
                        ps["v_scale"], block_k=bk, window=W)
                else:
                    pa.paged_decode_attention_plain(
                        q, bufs[0][li], bufs[1][li], lt, tt, window=W, **ps)

            lib = window_library(
                q, [lambda li, i=i: pa.gather_pages(bufs[i][li], tt)
                    for i in range(len(bufs))],
                lt, range(L), W, H, D, dt, len(bufs) == 4)
            recs[key].update(time_all(key.lower(), kname, run_kernel,
                                      run_plain, lib, 240))
            del lib
            recs[key]["timed_lengths"] = st
            recs[key]["library"] = WINDOW_LIBRARY_NOTE + (
                "; dequantized to bf16 beforehand" if len(bufs) == 4 else "")
            recs[key]["bound_ms"], recs[key]["bound_by"] = bound(
                flops, nbytes, peak)
    for rec in recs.values():
        emit(rec)
    del flt, i8
    torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------------- #
# The main path: init_inference -> generate for OPT-1.3B
# --------------------------------------------------------------------- #
def counters():
    """Each kernel's launch count: ``{name: (wrapper, attribute)}``.  The
    int8-KV and int8 x int8 modes count apart from the float-cache mode of
    the same wrapper (``int8_launches``, ``i8mm_launches``), and each
    decode mode's sliding window apart from it (``window_launches``, ...:
    ``decode_attention_window``, ``decode_attention_window_int8``, ...)."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    out = {"flash_attention": (fa.flash_attention, "launches"),
           "flash_attention_dq": (fa.flash_attention_dq, "launches"),
           "flash_attention_dkv": (fa.flash_attention_dkv, "launches"),
           "block_sparse_attention_fwd": (bs.block_sparse_attention_fwd,
                                          "launches")}
    for name, fn in (("decode_attention", da.decode_attention),
                     ("chunk_prefill_attention", da.chunk_prefill_attention),
                     ("paged_decode_attention", pa.paged_decode_attention),
                     ("paged_chunk_prefill_attention",
                      pa.paged_chunk_prefill_attention)):
        out[name] = (fn, "launches")
        out[name + "_int8"] = (fn, "int8_launches")
        if hasattr(fn, "i8mm_launches"):
            out[name + "_i8mm"] = (fn, "i8mm_launches")
        if hasattr(fn, "window_launches"):
            out[name + "_window"] = (fn, "window_launches")
            out[name + "_window_int8"] = (fn, "window_int8_launches")
            out[name + "_window_i8mm"] = (fn, "window_i8mm_launches")
    return out


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def expect_only(expect):
    """Every launch count: ``expect``'s, and 0 for the kernels it does not
    name."""
    return {**{name: 0 for name in counters()}, **expect}


def cosine_rows(a, b):
    import torch
    a, b = a.float().flatten(1), b.float().flatten(1)
    return torch.nn.functional.cosine_similarity(a, b, dim=1)


def compare_logits(tag, got, want, gate=True):
    """Per-row cosine of two logits tensors, failing below 0.999 unless
    ``gate`` is False (a reported number)."""
    cos = cosine_rows(got, want)
    top1 = (got.float().argmax(-1) == want.float().argmax(-1)).float().mean()
    rec = {"check": tag, "min_cosine": float(cos.min()),
           "top1_agreement": float(top1), "gated": gate}
    emit(rec)
    if gate and not (float(cos.min()) >= 0.999):
        fail(f"{tag}: kernel-path logits cosine {float(cos.min())} < 0.999 "
             f"against the plain path")
    return rec


def run_generate(eng, ids, new, expect):
    import torch
    from deepspeed_tpu_torch.accelerator import get_accelerator
    accel = get_accelerator(eng.device)
    B, P = ids.shape
    torch.cuda.reset_peak_memory_stats(eng.device)
    reset_counts()
    accel.synchronize(eng.device)
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=new)
    accel.synchronize(eng.device)
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = accel.memory_snapshot(eng.device)["peak_bytes_in_use"]
    V = eng.module.config.vocab_size
    if tuple(out.shape) != (B, P + new):
        fail(f"generate returned {tuple(out.shape)}, expected {(B, P + new)}")
    if not torch.equal(out[:, :P], ids):
        fail("generate did not keep the prompt columns")
    if int(out.min()) < 0 or int(out.max()) >= V:
        fail("generate produced token ids outside the vocabulary")
    want = expect_only(expect)
    if counts != want:
        fail(f"generate: launches {counts}, the path needs {want}")
    return out, dt, counts, peak


def counted_events(fn, trace):
    """``kernel_events`` of ``fn``, held to the launch counters: a trace
    that records fewer of the port's kernels (``dstt::``) than the
    wrappers counted in the same call of ``fn`` is taken again, and
    after ``PROFILE_ATTEMPTS`` the most complete one is used, so a
    profile line's group times are whole only where its
    ``port_kernels_traced`` equals ``port_kernels_launched``.  Returns
    the events and those two counts."""
    from deepspeed_tpu_torch.profiling.trace import kernel_events

    def counted():
        reset_counts()
        fn()

    ks = kernel_events(counted, trace,
                       expected=lambda: sum(read_counts().values()))
    return ks, {"port_kernels_traced": sum("dstt::" in e["name"]
                                           for e in ks),
                "port_kernels_launched": sum(read_counts().values())}


def graphs_vs_eager(runs):
    """Runs (a), (d), (h), (k) and (l) with the captured decode programs
    and on eager engines, from this call: tokens/s and the profiled
    window's device idle share each way."""
    out = {}
    for run in ("a", "d", "h", "k", "l"):
        out[run] = {
            "tokens_per_s_graphs": runs[run]["tokens_per_s"],
            "tokens_per_s_eager": runs[run + "_eager"]["tokens_per_s"],
            "idle_share_graphs":
                runs[run + "_graph_profile"]["device_idle_share"],
            "idle_share_eager": runs[run + "_profile"]["device_idle_share"],
            "busy_ms_graphs": runs[run + "_graph_profile"]["device_busy_ms"],
            "busy_ms_eager": runs[run + "_profile"]["device_busy_ms"],
            "wall_ms_graphs": runs[run + "_graph_profile"]["wall_ms"],
            "wall_ms_eager": runs[run + "_profile"]["wall_ms"]}
    return out


def profile_run(eng, ids, new, tag="a", trace="generate_trace.json"):
    """The same generate() once more under ``torch.profiler`` (CUDA
    activity only): where its time goes on the card (profile line
    ``tag``, the trace in ``build/profiles/``)."""
    import torch
    from deepspeed_tpu_torch.profiling.trace import breakdown
    wall = {}

    def run():
        t0 = time.perf_counter()
        eng.generate(ids, max_new_tokens=new)
        torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t0

    trace = os.path.join(ROOT, "build", "profiles", trace)
    ks, held = counted_events(run, trace)
    rec = {"profile": tag, "cuda_graphs": eng._config.enable_cuda_graph,
           **breakdown(ks, wall["s"]), **held,
           "trace": os.path.relpath(trace, ROOT)}
    emit(rec)
    return rec


def main_path():
    """Drive init_inference -> generate twice with the captured decode
    graphs (``warmup()`` first), counting launches per run; run (a) also
    on an eager engine (tokens bitwise equal) and once more under the
    profiler each way; then hold the kernel path's logits against the
    plain path's."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import opt_model
    t0 = time.perf_counter()
    eng = init_inference(opt_model(MODEL), dtype="bfloat16", device=DEV)
    eng.init_params(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, V = eng.module.config.num_layers, eng.module.config.vocab_size
    g = torch.Generator(device=DEV).manual_seed(4)
    runs = {}

    # (a) one-pass prefill: "auto" declines to chunk (B * P <= 16384)
    B, P, new = RUN_A["batch"], RUN_A["prompt"], RUN_A["new"]
    ids_a = torch.randint(0, V, (B, P), generator=g, device=DEV)
    plan = eng.prefill_plan(B, P)
    if plan[0] != "one_pass":
        fail(f"run (a) should take one-pass prefill, plan says {plan}")
    expect_a = {"flash_attention": L, "decode_attention": L * (new - 1)}
    # warm-up: captures run (a)'s decode graphs (and warms cuBLAS and the
    # allocator through its eager prefill)
    warm = eng.warmup(P, new, batch_sizes=(B,))
    out_a, dt, cnt, peak = run_generate(eng, ids_a, new, expect_a)
    runs["a"] = {"run": "a", "route": "one_pass", "batch": B, "prompt": P,
                 "new_tokens": new, "seconds": dt,
                 "tokens_per_s": B * new / dt, "launches": cnt,
                 "peak_device_bytes": peak, "cuda_graphs": True,
                 "warmup_seconds": warm,
                 "graph_pool_bytes": graph_pool_bytes(eng),
                 "plan": plan[2], "init_seconds": init_s}
    emit(runs["a"])
    # the same run on an eager engine over the same weights: every token
    # bitwise the graphs' (its launches counted one by one)
    eng_e = eager_twin(eng)
    eng_e.generate(ids_a, max_new_tokens=4)   # warm-up
    out_e, dt, cnt, peak = run_generate(eng_e, ids_a, new, expect_a)
    runs["a_eager"] = {"run": "a_eager", "cuda_graphs": False,
                       "seconds": dt, "tokens_per_s": B * new / dt,
                       "launches": cnt, "peak_device_bytes": peak,
                       "tokens_equal_to_graphs": bool(torch.equal(out_e,
                                                                  out_a))}
    emit(runs["a_eager"])
    if not runs["a_eager"]["tokens_equal_to_graphs"]:
        fail("run (a): the eager engine's tokens differ from the captured "
             "decode graphs'")
    # the profile lines: "a" on the eager engine (as in earlier runs),
    # "a_graph" on the captured graphs
    runs["a_profile"] = profile_run(eng_e, ids_a, new)
    runs["a_graph_profile"] = profile_run(eng, ids_a, new, "a_graph",
                                          "generate_graph_trace.json")

    # (b) split (chunked) prefill over the same weights
    B, P, new, C = (RUN_B[x] for x in ("batch", "prompt", "new", "chunk"))
    eng_b = init_inference(eng.module, {"prefill_chunk_size": C},
                           dtype="bfloat16", device=DEV)
    ids_b = torch.randint(0, V, (B, P), generator=g, device=DEV)
    plan_b = eng_b.prefill_plan(B, P)
    if plan_b[:2] != ("chunked", C):
        fail(f"run (b) should take chunked prefill, plan says {plan_b}")
    warm = eng_b.warmup(P, new, batch_sizes=(B,))
    out_b, dt, cnt, peak = run_generate(eng_b, ids_b, new, {
        "decode_attention": L * (new - 1),
        "chunk_prefill_attention": L * (-(-P // C))})
    runs["b"] = {"run": "b", "route": "chunked", "chunk": C, "batch": B,
                 "prompt": P, "new_tokens": new, "seconds": dt,
                 "tokens_per_s": B * new / dt, "launches": cnt,
                 "peak_device_bytes": peak, "cuda_graphs": True,
                 "warmup_seconds": warm, "plan": plan_b[2]}
    emit(runs["b"])

    # the kernel path's logits against the plain path on the same card and
    # weights: a key-padding mask (all ones: plain causal attention) routes
    # every layer of the uncached forward to the dense reference attention
    m = eng.module
    with torch.no_grad():
        B, P = ids_a.shape
        cache = m.init_cache(B, P + 8, dtype=torch.bfloat16)
        last = torch.full((B,), P - 1, device=DEV)
        got, cache = m.decode(ids_a, cache, 0, logits_at=last, prefill=True)
        want = m.logits(ids_a, torch.ones_like(ids_a))[:, -1:]
        compare_logits("(a) prefill logits, K1 vs plain", got, want)
        nxt = got[:, 0].float().argmax(-1)
        got, cache = m.decode(nxt[:, None], cache, P)
        ids_next = torch.cat([ids_a, nxt[:, None]], 1)
        want = m.logits(ids_next, torch.ones_like(ids_next))[:, -1:]
        compare_logits("(a) first decode step logits, K2 vs plain", got,
                       want)
        del cache
        B, P = ids_b.shape
        cache = m.init_cache(B, P, dtype=torch.bfloat16)
        loc = torch.full((B,), C - 1, device=DEV)
        for c0 in range(0, P, C):
            got, cache = m.decode(ids_b[:, c0:c0 + C], cache, c0,
                                  logits_at=loc)
        want = m.logits(ids_b, torch.ones_like(ids_b))[:, -1:]
        compare_logits("(b) chunked prefill logits, K3 vs plain", got, want)
        del cache
    del eng_b
    return runs, eng, eng_e, {"a": (ids_a, out_a), "b": (ids_b, out_b)}


def graph_pool_bytes(eng):
    """Device bytes of the graph memory pools of ``eng``'s captured decode
    programs."""
    from deepspeed_tpu_torch.inference.engine import CapturedGenerate
    return sum(p.pool_bytes() for fn in eng._programs.values()
               if isinstance(fn, CapturedGenerate)
               for p in fn.programs.values())


def eager_twin(eng, **config):
    """An engine over ``eng``'s module (its weights as they are) with
    ``enable_cuda_graph=False``: the eager per-step decode loop and
    serving block."""
    from deepspeed_tpu_torch import init_inference
    return init_inference(eng.module, {**config, "enable_cuda_graph": False},
                          dtype="bfloat16", device=DEV)


# --------------------------------------------------------------------- #
# Continuous-batching serving: engine.serve -> submit / drain, (d) and (e)
# --------------------------------------------------------------------- #
def serving_traffic(V, n=RUN_D["requests"]):
    """Run (d)'s requests (the first ``n``: run (l) takes 64): numpy seed
    0, prompt lengths and new tokens drawn from RUN_D's sets, prompt ids
    uniform over the vocabulary."""
    import numpy as np
    rng = np.random.default_rng(RUN_D["seed"])
    reqs = []
    for _ in range(n):
        P = int(rng.choice(RUN_D["prompts"]))
        new = int(rng.choice(RUN_D["new"]))
        reqs.append((rng.integers(0, V, P).astype(np.int32), new))
    return reqs


def drive(srv, reqs, stamps=None):
    """Submit every request, step the server to the end; returns the
    outputs in submission order, the wall seconds (ending in a device
    sync) and the peak page-pool utilization seen between steps.  With
    ``stamps`` (a dict), each request's token stream stamps the host
    clock as each of its tokens is pushed (the drain point, one event
    behind the device): ``stamps[rid]`` lists them."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    if stamps is not None:
        for rid in rids:
            srv.token_events(rid, on_event=token_stamper(stamps, rid))
    outs, peak = {}, 0.0
    while srv.work_pending():
        outs.update(srv.step())
        peak = max(peak, srv.page_pool_utilization)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if sorted(outs) != sorted(rids):
        fail(f"the server finished {len(outs)} of {len(rids)} requests")
    return [outs[r] for r in rids], secs, peak


def token_stamper(stamps, rid):
    times = stamps.setdefault(rid, [])

    def on_event(ev):
        if ev["event"] == "token":
            times.append(time.perf_counter())

    return on_event


def between_tokens(stamps):
    """Time between tokens (ms) at p50 / p99 over every request's stream:
    the JAX bench's reading (a speculative round's m tokens reach a
    stream together, so most gaps inside a round are ~0)."""
    import numpy as np
    gaps = [(b - a) * 1e3 for ts in stamps.values()
            for a, b in zip(ts, ts[1:])]
    return {"tbt_p50_ms": float(np.percentile(gaps, 50)),
            "tbt_p99_ms": float(np.percentile(gaps, 99)),
            "tbt_gaps": len(gaps)}


def check_outputs(tag, outs, reqs, V):
    for (p, n), out in zip(reqs, outs):
        if out.shape != (len(p) + n,) or (out[:len(p)] != p).any():
            fail(f"{tag}: an output is not [prompt, {n} new tokens]")
        if int(out.min()) < 0 or int(out.max()) >= V:
            fail(f"{tag}: token ids outside the vocabulary")


def serve_record(run, srv, secs, peak, counts, reqs):
    st = srv.stats
    useful = sum(n for _, n in reqs)
    return {"run": run, "paged": srv.paged, "requests": len(reqs),
            "slots": srv.num_slots, "cache_len": srv.cache_len,
            **({"page_size": srv.page, "num_pages": srv.num_pages}
               if srv.paged else {}),
            "seconds": secs, "useful_tokens": useful,
            "tokens_per_s": useful / secs,
            "decode_calls": st["decode_calls"],
            "decode_tokens": st["decode_tokens"],
            "prefill_tokens": st["prefill_tokens"],
            "admission_stalls": st["admission_stalls"],
            "page_evictions": st["page_evictions"],
            "peak_page_pool_utilization": peak,
            "cuda_graphs": srv.engine._config.enable_cuda_graph,
            "warmup_seconds": st["warmup_seconds"],
            "sync_secs": st["sync_secs"], "wall_secs": st["wall_secs"],
            "sync_share": st["sync_secs"] / st["wall_secs"],
            "iterations": st["iterations"],
            "paged_attention_fallback": st["paged_attention_fallback"],
            "prefix_hits": st["prefix_hits"],
            "prefix_tokens_reused": st["prefix_tokens_reused"],
            "peak_device_bytes": st["peak_device_bytes"],
            "kv_bytes": st["kv_bytes"],
            "graph_pool_bytes": st["graph_pool_bytes"],
            "kernel_modes": srv.kernel_modes, "launches": counts,
            **({key: st[key] for key in (
                "spec_rounds", "spec_windows", "spec_committed_tokens",
                "spec_accept_rate", "spec_tokens_per_dispatch",
                "spec_draft_secs", "spec_verify_secs",
                "spec_draft_fraction", "program_launches")}
               if srv.speculative else {}),
            **st.get("between_tokens", {})}


def layer_kinds(cfg):
    """(global layers, sliding-window layers) of a model config."""
    local = sum(cfg.window_for_layer(i) is not None
                for i in range(cfg.num_layers))
    return cfg.num_layers - local, local


def serve_kernels(srv):
    """The (decode, prefill chunk[, windowed decode]) kernels a server
    runs: K6 / K7 on a paged pool, K2 / K3 on monolithic lanes, in their
    int8-KV modes on an int8 cache and K2 / K6 in the int8 x int8 mode
    with ``decode_int8_matmuls``; a model with sliding-window layers also
    runs K2 / K6's window mode (its windowed chunks attend dense).  A
    speculative server: K2 (the draft's steps over its lanes), the
    verify's and the target prefill's K3 / K7, the draft prefill's K3."""
    cfg = srv.module.config
    if srv.speculative:
        pre = "paged_" if srv.paged else ""
        return ("decode_attention", f"{pre}chunk_prefill_attention",
                "chunk_prefill_attention")
    pre = "paged_" if srv.paged else ""
    mode = "_int8" if cfg.kv_cache_quant else ""
    dmode = "_i8mm" if cfg.decode_int8_matmuls else mode
    names = (f"{pre}decode_attention{dmode}",
             f"{pre}chunk_prefill_attention{mode}")
    if layer_kinds(cfg)[1]:
        names += (f"{pre}decode_attention_window{dmode}",)
    return names


def serve_expect(srv):
    """The launches a serving run needs: one per global layer per decode
    step and per prefill chunk, and one per windowed layer per decode
    step, of the kernels :func:`serve_kernels` names."""
    if srv.speculative:
        return spec_expect(srv)
    n_global, n_local = layer_kinds(srv.module.config)
    st = srv.stats
    decode, chunk, *window = serve_kernels(srv)
    steps = srv.block * st["decode_calls"]
    want = {decode: n_global * steps,
            chunk: n_global * st["prefill_tokens"] // srv.chunk}
    if window:
        want[window[0]] = n_local * steps
    return expect_only(want)


def spec_expect(srv):
    """A speculative run's launches: per round, k + 1 draft steps (K2 in
    every draft layer, the last step write-only) and one verify (K3 / K7
    in every target layer); per prefill chunk, the target's K3 / K7 and
    the draft's K3."""
    want = spec_program_expect(srv)
    chunks = srv.stats["prefill_tokens"] // srv.chunk
    _, target, draft_chunk = serve_kernels(srv)
    want = {**want["propose"], **want["verify"]}
    want[draft_chunk] = want.get(draft_chunk, 0) \
        + srv.draft_module.config.num_layers * chunks
    want[target] = want.get(target, 0) \
        + srv.module.config.num_layers * chunks
    return expect_only(want)


def spec_program_expect(srv):
    """The launches of the propose and the verify program alone over a
    run: ``L_d (k + 1)`` K2 launches a round in the draft, ``L`` K3 / K7
    launches a round in the verify, nothing else."""
    L = srv.module.config.num_layers
    L_d = srv.draft_module.config.num_layers
    st, k = srv.stats, srv.spec_k
    rounds = st["spec_rounds"]
    if rounds != st["decode_calls"]:
        fail(f"{rounds} speculative rounds processed of "
             f"{st['decode_calls']} dispatched")
    draft, target, _ = serve_kernels(srv)
    return {"propose": {draft: L_d * (k + 1) * rounds},
            "verify": {target: L * rounds}}


class CountedProgram:
    """A server's captured program, wrapped so that the launches each of
    its calls adds (replays included) are summed apart from the run's
    totals: the counts are read just before and just after every call."""

    def __init__(self, prog):
        self.prog = prog
        self.launches = dict.fromkeys(counters(), 0)

    def __call__(self, *args):
        before = read_counts()
        out = self.prog(*args)
        for name, n in read_counts().items():
            self.launches[name] += n - before[name]
        return out

    def __getattr__(self, name):
        return getattr(self.prog, name)


def serve_counted(eng, reqs, tag, tbt=False, **overrides):
    """One server over ``reqs`` (``warmup()`` first: the decode block's
    graph is captured before the count) with every launch count set to 0
    just before and read just after; the counts must be exactly the
    path's.
    The peak device memory of the run and the bytes of its KV pool or
    lanes go into ``srv.stats`` as ``peak_device_bytes`` and
    ``kv_bytes``."""
    import torch
    srv = eng.serve(**overrides)
    warm = srv.warmup()                       # captures the decode block
    if srv.speculative:                       # each program's own count
        srv._propose_prog = CountedProgram(srv._propose_prog)
        srv._verify_prog = CountedProgram(srv._verify_prog)
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    stamps = {} if tbt else None
    outs, secs, peak = drive(srv, reqs, stamps)
    srv.stats["warmup_seconds"] = warm
    if tbt:
        srv.stats["between_tokens"] = between_tokens(stamps)
    counts = read_counts()
    want = serve_expect(srv)
    if counts != want:
        fail(f"{tag}: launches {counts}, the path needs {want}")
    if srv.speculative:
        progs = {"propose": srv._propose_prog.launches,
                 "verify": srv._verify_prog.launches}
        for prog, need in spec_program_expect(srv).items():
            if progs[prog] != expect_only(need):
                fail(f"{tag}: the {prog} program launched {progs[prog]}, "
                     f"it needs {expect_only(need)}")
        srv.stats["program_launches"] = {
            prog: {name: n for name, n in got.items() if n}
            for prog, got in progs.items()}
    for name in serve_kernels(srv):
        if counts[name] == 0:
            fail(f"{tag}: {name} was never launched")
    if srv.stats["completed"] != len(reqs):
        fail(f"{tag}: {srv.stats['completed']} of {len(reqs)} completed")
    check_outputs(tag, outs, reqs, srv.module.config.vocab_size)
    srv.stats["peak_device_bytes"] = torch.cuda.max_memory_allocated(DEV)
    srv.stats["kv_bytes"] = tensor_bytes(srv._cache)
    srv.stats["graph_pool_bytes"] = srv.graph_pool_bytes()
    srv.close()
    torch.cuda.empty_cache()
    return srv, outs, secs, peak, counts


def serving_path(eng, eng_e):
    """Run (d) paged on the captured decode block, again on ``eng_e``'s
    eager block (every request equal), its monolithic twin, the
    decode-window profile each way and run (e).  Returns the runs and run
    (d)'s outputs."""
    import numpy as np
    V = eng.module.config.vocab_size
    reqs = serving_traffic(V)
    warm = eng.serve(**SERVE_D)               # warm-up (allocator, cuBLAS)
    drive(warm, reqs[:4])
    warm.close()
    runs = {}
    srv, outs, secs, peak, counts = serve_counted(eng, reqs, "run (d)",
                                                  **SERVE_D)
    runs["d"] = serve_record("d", srv, secs, peak, counts, reqs)
    runs["d"]["prefill_plan"] = eng.prefill_plan(1, max(RUN_D["prompts"]),
                                                 paged=True)[2]
    emit(runs["d"])
    runs["d_eager"] = eager_serving("d_eager", eng_e, reqs, outs, SERVE_D)
    mono, outs_m, secs_m, peak_m, counts_m = serve_counted(
        eng, reqs, "run (d) monolithic", **{**SERVE_D, "paged": False})
    differ = sum(not np.array_equal(a, b) for a, b in zip(outs, outs_m))
    runs["d_mono"] = serve_record("d_mono", mono, secs_m, peak_m, counts_m,
                                  reqs)
    runs["d_mono"]["requests_differing_from_paged"] = differ
    emit(runs["d_mono"])
    if differ:
        fail(f"run (d): {differ} of {len(reqs)} requests' tokens differ "
             f"between the paged pool and the monolithic lanes")
    runs["d_profile"] = profile_serving(eng_e, reqs)
    runs["d_graph_profile"] = profile_serving(eng, reqs, "d_graph",
                                              "serving_graph_trace.json")
    runs["e"] = prefix_path(eng)
    return runs, outs


def eager_serving(run, eng_e, reqs, outs, serve):
    """``reqs`` served on the eager engine ``eng_e`` (counted as any
    server): every request's tokens must equal ``outs``, the captured
    block's."""
    import numpy as np
    srv, outs_e, secs, peak, counts = serve_counted(eng_e, reqs,
                                                    f"run ({run})", **serve)
    rec = serve_record(run, srv, secs, peak, counts, reqs)
    rec["requests_differing_from_graphs"] = sum(
        not np.array_equal(a, b) for a, b in zip(outs, outs_e))
    emit(rec)
    if rec["requests_differing_from_graphs"]:
        fail(f"run ({run}): {rec['requests_differing_from_graphs']} "
             f"requests' tokens differ from the captured decode block's")
    return rec


def profile_serving(eng, reqs, tag="d", trace="serving_trace.json",
                    serve=SERVE_D, steps=PROFILE_D_STEPS):
    """A decode window with every slot live under ``torch.profiler``:
    the first prompts of ``reqs`` (run (d)'s: 96 slots; run (l)'s: 32;
    run (m)'s: 16) with 128 new tokens each, admitted in one iteration (no
    prefill budget) on a worst-case pool, then ``steps`` decode-only
    scheduler steps (decode blocks, or speculative rounds) traced
    (profile line ``tag``)."""
    import torch
    from deepspeed_tpu_torch.profiling.trace import breakdown
    srv = eng.serve(**{**serve, "prefill_token_budget": 0, "num_pages": 0})
    for p, _ in reqs[:srv.num_slots]:
        srv.submit(p, max_new_tokens=max(RUN_D["new"]))
    srv.step()                              # admits all, first decode block
    srv.step()
    if srv.active_slots != srv.num_slots:
        fail(f"profile window: {srv.active_slots} live slots, expected "
             f"{srv.num_slots}")
    wall = {}

    def window():
        t0 = time.perf_counter()
        for _ in range(steps):
            srv.step()
        torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t0

    trace = os.path.join(ROOT, "build", "profiles", trace)
    ks, held = counted_events(window, trace)
    rec = {"profile": tag, "live_slots": srv.active_slots,
           "cuda_graphs": eng._config.enable_cuda_graph,
           **({"spec_rounds": steps, "spec_k": srv.spec_k}
              if srv.speculative else {"decode_steps": steps * srv.block}),
           **breakdown(ks, wall["s"]), **held,
           "trace": os.path.relpath(trace, ROOT)}
    emit(rec)
    srv.close()
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------- #
# Speculative serving: engine.serve(speculative=True), run (m)
# --------------------------------------------------------------------- #
def spec_traffic(V):
    """Run (m)'s requests: the JAX bench's workload at 16 slots (numpy
    seed 0, prompts and new tokens drawn from RUN_M's sets, ids uniform
    over the vocabulary)."""
    import numpy as np
    rng = np.random.default_rng(RUN_M["seed"])
    n = RUN_M["requests"]
    lens = rng.choice(RUN_M["prompts"], n)
    news = rng.choice(RUN_M["new"], n)
    return [(rng.integers(0, V, int(P)).astype(np.int32), int(new))
            for P, new in zip(lens, news)]


def generated_agreement(outs, ref, reqs):
    """Share of generated token positions where two servers agree."""
    same = total = 0
    for (p, _), a, b in zip(reqs, outs, ref):
        same += int((a[len(p):] == b[len(p):]).sum())
        total += len(a) - len(p)
    return same / total


SPEC_SERVERS = (("m", {}), ("m_self", SPEC_M),
                ("m_self_paged", dict(SPEC_M, paged=True, page_size=64)),
                ("m_draft", dict(SPEC_M, spec_draft_model=RUN_M["draft"])))


def fp32_copy(eng):
    """An OPT-1.3B engine over ``eng``'s weights cast to fp32."""
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import opt_model
    eng32 = init_inference(opt_model(MODEL, dtype="float32"), dtype="float32",
                           device=DEV)
    eng32.set_params({k: v.float()
                      for k, v in eng.module.state_dict().items()})
    return eng32


def spec_path(eng, eng_e):
    """Run (m): the four servers of ``SPEC_SERVERS`` on run (m)'s
    requests (after ``warmup()``, exact launches, time between tokens
    from the streams, bf16 agreement with the plain server), the
    self-draft server again on ``eng_e``'s eager programs (every token
    equal), the first 8 requests on an fp32 copy of the weights (every
    speculative server equal to the plain one), and a profiled window of
    speculative rounds on the graphs (``m_graph``)."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    V = eng.module.config.vocab_size
    reqs = spec_traffic(V)
    runs, outs = {}, {}
    for run, over in SPEC_SERVERS:
        srv, outs[run], secs, peak, counts = serve_counted(
            eng, reqs, f"run ({run})", tbt=True, **SERVE_M, **over)
        rec = serve_record(run, srv, secs, peak, counts, reqs)
        if run != "m":
            rec["bf16_agreement_with_plain"] = generated_agreement(
                outs[run], outs["m"], reqs)
            rec["draft"] = over["spec_draft_model"]
        runs[run] = rec
        emit(rec)
    srv, outs_e, secs, peak, counts = serve_counted(
        eng_e, reqs, "run (m_self) eager", **SERVE_M, **SPEC_M)
    rec = serve_record("m_self_eager", srv, secs, peak, counts, reqs)
    rec["requests_differing_from_graphs"] = sum(
        not np.array_equal(a, b) for a, b in zip(outs["m_self"], outs_e))
    runs["m_self_eager"] = rec
    emit(rec)
    if rec["requests_differing_from_graphs"]:
        fail(f"run (m): {rec['requests_differing_from_graphs']} requests' "
             f"tokens differ between the captured spec programs and eager")
    # the fp32 gate: the same weights in fp32, the first 8 requests
    eng32 = fp32_copy(eng)
    reqs32 = reqs[:RUN_M["fp32_requests"]]
    ref = None
    gate = {"check": "run (m) fp32: speculative servers equal the plain "
                     "server", "requests": len(reqs32)}
    for run, over in SPEC_SERVERS:
        _, got, _, _, _ = serve_counted(eng32, reqs32, f"run ({run}) fp32",
                                        **SERVE_M, **over)
        if ref is None:
            ref = got
            continue
        differ = sum(not np.array_equal(a, b) for a, b in zip(got, ref))
        gate[f"{run}_requests_differing"] = differ
        if differ:
            emit(gate)
            fail(f"run ({run}) on fp32 weights: {differ} of {len(reqs32)} "
                 f"requests differ from the plain server")
    emit(gate)
    del eng32
    torch.cuda.empty_cache()
    runs["m_graph_profile"] = profile_serving(
        eng, reqs, "m_graph", "spec_graph_trace.json",
        serve={**SERVE_M, **SPEC_M}, steps=PROFILE_M_ROUNDS)
    runs["m_seconds"] = time.perf_counter() - t0
    emit({"run_m_seconds": runs["m_seconds"]})
    return runs


def prefix_path(eng):
    """Run (e): 24 requests behind one 512-token system prompt on 8 slots;
    23 must reuse its 8 pages, and the outputs must equal the same
    requests served without prefix sharing."""
    import numpy as np
    V = eng.module.config.vocab_size
    rng = np.random.default_rng(RUN_E["seed"])
    system = rng.integers(0, V, RUN_E["system"]).astype(np.int32)
    reqs = [(np.concatenate([system, rng.integers(0, V, RUN_E["tail"])
                             .astype(np.int32)]), RUN_E["new"])
            for _ in range(RUN_E["tails"])]
    srv, outs, secs, peak, counts = serve_counted(eng, reqs, "run (e)",
                                                  **SERVE_E)
    rec = serve_record("e", srv, secs, peak, counts, reqs)
    hits = RUN_E["tails"] - 1
    reused = hits * RUN_E["system"]
    if (srv.stats["prefix_hits"], srv.stats["prefix_tokens_reused"]) != \
            (hits, reused):
        fail(f"run (e): prefix hits {srv.stats['prefix_hits']} / tokens "
             f"reused {srv.stats['prefix_tokens_reused']}, expected {hits} / "
             f"{reused}")
    ref, outs_r, secs_r, _, counts_r = serve_counted(
        eng, reqs, "run (e) without prefix sharing",
        **{**SERVE_E, "prefix_cache": False})
    differ = sum(not np.array_equal(a, b) for a, b in zip(outs, outs_r))
    rec.update(unshared_seconds=secs_r,
               unshared_prefill_tokens=ref.stats["prefill_tokens"],
               unshared_launches=counts_r,
               requests_differing_from_unshared=differ)
    emit(rec)
    if differ:
        fail(f"run (e): {differ} requests differ from the unshared run")
    return rec


# --------------------------------------------------------------------- #
# The request lifecycle: deadlines, the bounded queue, the breaker,
# preempt -> snapshot -> restore, run (n)
# --------------------------------------------------------------------- #
def overload_run(eng, reqs, outs_d):
    """Run (n-overload): run (d)'s requests submitted in order by this
    thread into ``SERVE_N`` (the queue of 48 blocks it: ``submit()`` steps
    the server), every 12th past its deadline, each with index 5 mod 24
    cancelled at the first scheduling point after its first token event,
    and one ``raise`` at the 40th decode dispatch that the breaker
    absorbs.  Gates: every completed request bitwise run (d)'s, 16 shed
    holding no slot, 8 cancelled, every cancelled or aborted stream ended
    with its status, exactly the one failure absorbed, exact launches, and
    two captures of the decode block (``warmup()`` and the one after the
    failure)."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.inference.serving.slo import RequestStatus
    from deepspeed_tpu_torch.runtime.fault import inject
    n = RUN_N
    srv = eng.serve(**SERVE_N)
    warm = srv.warmup()
    ends, flagged = {}, []

    def on_event(i, rid):
        def cb(ev):
            if ev["event"] == "end":
                ends[rid] = ev["status"]
            elif ev["index"] == 0 and i % n["cancel_every"] == n["cancel_at"]:
                flagged.append(rid)
        return cb

    def cancel_flagged():
        while flagged:
            srv.cancel(flagged.pop())

    spec, = inject.configure_injection(
        {"point": "serving.pre_decode_dispatch", "action": "raise",
         "at": n["fail_at"]})
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rids, blocked, inline = [], 0, 0
    try:
        for i, (p, new) in enumerate(reqs):
            it = srv.stats["iterations"]
            rid = srv.submit(p, max_new_tokens=new, client_id=i,
                             deadline_s=0.0 if i % n["shed_every"] == 0
                             else None)
            blocked += srv.stats["iterations"] > it
            inline += srv.stats["iterations"] - it
            srv.token_events(rid, on_event=on_event(i, rid))
            rids.append(rid)
            cancel_flagged()
        while srv.work_pending():
            srv.step()
            cancel_flagged()
    finally:
        inject.reset_injection()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    st = srv.stats
    by_status = {}
    for rid in rids:
        by_status[srv.status(rid)] = by_status.get(srv.status(rid), 0) + 1
    completed = [i for i, r in enumerate(rids)
                 if srv.status(r) == RequestStatus.COMPLETED]
    shed = [i for i, r in enumerate(rids)
            if srv.status(r) == RequestStatus.SHED_DEADLINE]
    useful = sum(reqs[i][1] for i in completed)
    rec = {"run": "n_overload", "requests": len(reqs),
           "slots": srv.num_slots, "num_pages": srv.num_pages,
           "max_queue_depth": SERVE_N["max_queue_depth"],
           "queue_policy": SERVE_N["queue_policy"],
           "breaker_threshold": SERVE_N["breaker_threshold"],
           "statuses": by_status, "blocked_submits": blocked,
           "steps_inside_submit": inline, "seconds": secs,
           "completed_useful_tokens": useful,
           "completed_tokens_per_s": useful / secs,
           "dispatch_failures_absorbed": st["dispatch_failures"],
           "injected_faults": spec.fired, "breaker_trips":
           srv._breaker.trips, "decode_captures":
           srv._decode_prog.captures, "decode_calls": st["decode_calls"],
           "prefill_tokens": st["prefill_tokens"],
           "iterations": st["iterations"], "warmup_seconds": warm,
           "launches": counts}
    emit(rec)
    differ = sum(not np.array_equal(srv.result(rids[i]).output, outs_d[i])
                 for i in completed)
    rec["completed_differing_from_run_d"] = differ
    want_shed = list(range(0, len(reqs), n["shed_every"]))
    want_cancel = [i for i in range(len(reqs))
                   if i % n["cancel_every"] == n["cancel_at"]]
    cancelled = [i for i, r in enumerate(rids)
                 if srv.status(r) == RequestStatus.CANCELLED]
    aborted = [r for r in rids if srv.status(r) == RequestStatus.ABORTED]
    if differ:
        fail(f"run (n-overload): {differ} completed requests differ from "
             f"run (d)")
    if shed != want_shed or any(srv._requests[rids[i]].slot is not None
                                for i in shed):
        fail(f"run (n-overload): shed {shed}, expected {want_shed}, none "
             f"holding a slot")
    if cancelled != want_cancel:
        fail(f"run (n-overload): cancelled {cancelled}, expected "
             f"{want_cancel}")
    if not aborted or sum(by_status.values()) != len(reqs) \
            or set(by_status) - {RequestStatus.COMPLETED,
                                 RequestStatus.SHED_DEADLINE,
                                 RequestStatus.CANCELLED,
                                 RequestStatus.ABORTED}:
        fail(f"run (n-overload): statuses {by_status}: every request must "
             f"end, and the failure must abort the requests in flight")
    for rid in aborted + [rids[i] for i in cancelled]:
        if ends.get(rid) != srv.status(rid):
            fail(f"run (n-overload): request {rid} ended "
                 f"{srv.status(rid)}, its stream's end event says "
                 f"{ends.get(rid)}")
    if (st["dispatch_failures"], spec.fired, srv._breaker.trips) != (1, 1, 0):
        fail(f"run (n-overload): {st['dispatch_failures']} failures "
             f"absorbed, {spec.fired} injected, {srv._breaker.trips} trips; "
             f"expected 1, 1, 0")
    if srv._decode_prog.captures != 2:
        fail(f"run (n-overload): {srv._decode_prog.captures} captures of "
             f"the decode block, expected 2 (warmup and after the failure)")
    want = serve_expect(srv)
    if counts != want:
        fail(f"run (n-overload): launches {counts}, the path needs {want}")
    srv.close()
    return rec


def step_until(srv, rids, partial, finished):
    """Step ``srv`` until ``partial`` of ``rids`` hold some but not all of
    their tokens and ``finished`` have ended; returns the outputs of those
    that ended."""
    early = {}
    while sum(0 < len(srv._requests[r].tokens) < srv._requests[r].max_new
              and srv.result(r) is None for r in rids) < partial \
            or len(early) < finished:
        if not srv.work_pending():
            fail(f"the server drained before {partial} requests held "
                 f"partial tokens with {finished} ended")
        early.update(srv.step())
    return early


def preempt_and_restore(eng, reqs, serve, partial, finished, ckpt):
    """``reqs`` into a server of ``serve``, stepped until ``partial`` hold
    partial tokens and ``finished`` have ended, preempted at once into
    ``ckpt`` and restored on a fresh server, which drains them. Returns
    the outputs in order, the snapshot's requests and a record: seconds
    of ``preempt()`` and of ``restore()``, the time from the restore to
    the first token a resumed request streams, the generated tokens
    prefilled again."""
    import torch
    from deepspeed_tpu_torch.inference.serving.snapshot import \
        read_snapshot_tag
    from deepspeed_tpu_torch.runtime.fault.manifest import verify_manifest
    srv = eng.serve(**serve)
    srv.warmup()
    rids = [srv.submit(p, max_new_tokens=n, client_id=i)
            for i, (p, n) in enumerate(reqs)]
    outs = step_until(srv, rids, partial, finished)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tag, snapped, finished = srv.preempt(ckpt, drain_budget_s=0.0)
    preempt_s = time.perf_counter() - t0
    outs.update(finished)
    problems = verify_manifest(os.path.join(ckpt, tag))
    if problems:
        fail(f"preempt(): the snapshot {tag} fails its manifest: {problems}")
    snap = read_snapshot_tag(ckpt, tag)["requests"]
    srv2 = eng.serve(**serve)
    srv2.warmup()
    first = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = srv2.restore(ckpt)
    restore_s = time.perf_counter() - t0
    if sorted(restored) != sorted(snapped):
        fail(f"restore() queued {sorted(restored)}, the snapshot holds "
             f"{sorted(snapped)}")
    for rid in restored:
        srv2.token_events(rid, on_event=lambda ev: first.append(
            time.perf_counter()) if not first else None)
    outs.update(srv2.drain())
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    rec = {"requests": len(reqs), "snapshotted": len(snapped),
           "partial_at_preempt": sum(bool(r["tokens"]) for r in snap),
           "finished_before_preempt": len(reqs) - len(snapped),
           "preempt_seconds": preempt_s, "restore_seconds": restore_s,
           "first_token_after_restore_s": first[0] - t0 if first else None,
           "restore_to_drained_seconds": drain_s,
           "tokens_prefilled_again": sum(len(r["tokens"]) for r in snap),
           "prefill_tokens_after_restore": srv2.stats["prefill_tokens"]}
    srv2.close()
    return [outs[r] for r in rids], snap, rec


def lifecycle_path(eng, outs_d):
    """Run (n): the overload (above), preemption and restore in bf16 over
    run (d)'s first 96 requests (those that ended before the preemption,
    and those never started, bitwise run (d)'s; the resumed ones'
    agreement with run (d) reported: re-prefilling a prefix runs GEMMs at
    another M), then on an fp32 copy of the weights (16 of run (m)'s
    requests on run (m)'s lanes, and its self-draft server on 8,
    preempted mid-speculation): every resumed output equal to the
    uninterrupted one, every snapshotted token list a prefix of the final
    output."""
    import tempfile
    import numpy as np
    import torch
    t0 = time.perf_counter()
    V = eng.module.config.vocab_size
    reqs = serving_traffic(V)
    runs = {"n_overload": overload_run(eng, reqs, outs_d)}
    torch.cuda.empty_cache()
    n = RUN_N
    with tempfile.TemporaryDirectory() as tmp:
        k = n["preempt_requests"]
        got, snap, rec = preempt_and_restore(
            eng, reqs[:k], SERVE_N_PREEMPT, n["partial"], n["finished"],
            os.path.join(tmp, "bf16"))
        resumed = {r["rid"] for r in snap if r["tokens"]}
        fresh = [i for i in range(k) if i not in resumed]
        differ = sum(not np.array_equal(got[i], outs_d[i]) for i in fresh)
        idx = sorted(resumed)
        rec.update(run="n_preempt", dtype="bfloat16",
                   not_resumed_differing_from_run_d=differ,
                   resumed_agreement_with_run_d=generated_agreement(
                       [got[i] for i in idx], [outs_d[i] for i in idx],
                       [reqs[i] for i in idx]))
        emit(rec)
        if differ:
            fail(f"run (n-preempt): {differ} requests that finished before "
                 f"the preemption or never started differ from run (d)")
        runs["n_preempt"] = rec
        torch.cuda.empty_cache()
        eng32 = fp32_copy(eng)
        reqs_m = spec_traffic(V)
        k = n["fp32_requests"]
        ref = eng32.serve(**SERVE_M)
        rids = [ref.submit(p, max_new_tokens=m) for p, m in reqs_m[:k]]
        outs = ref.drain()
        ref.close()
        want = [outs[r] for r in rids]
        for run, serve, k, partial in (
                ("n_preempt_fp32", SERVE_M, k, n["fp32_partial"]),
                ("n_spec", {**SERVE_M, **SPEC_M}, n["spec_requests"],
                 n["spec_partial"])):
            got, snap, rec = preempt_and_restore(
                eng32, reqs_m[:k], serve, partial, 0, os.path.join(tmp, run))
            differ = sum(not np.array_equal(a, b)
                         for a, b in zip(got, want[:k]))
            not_prefix = sum(
                r["tokens"] != [int(t) for t in got[r["rid"]][
                    len(reqs_m[r["rid"]][0]):][:len(r["tokens"])]]
                for r in snap)
            rec.update(run=run, dtype="float32",
                       speculative=bool(serve.get("speculative")),
                       requests_differing_from_uninterrupted=differ,
                       snapshots_not_a_prefix_of_the_output=not_prefix)
            emit(rec)
            if differ or not_prefix:
                fail(f"run ({run}): {differ} resumed requests differ from "
                     f"the uninterrupted plain server on fp32 weights, "
                     f"{not_prefix} snapshots are not a prefix of their "
                     f"output")
            runs[run] = rec
        del eng32
    torch.cuda.empty_cache()
    runs["n_seconds"] = time.perf_counter() - t0
    emit({"run_n_seconds": runs["n_seconds"]})
    return runs


# --------------------------------------------------------------------- #
# int8 serving: generate() (g) and serve() (h) with int8 weights and KV
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def plain_kernels():
    """Within: every cached-attention wrapper and the flash forward run
    their plain versions on the card's tensors (the plain path of the
    int8 runs' logits checks); the kernels' arithmetic is what the plain
    versions repeat."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

    def flash(q, k, v, causal=True, scale=None, return_lse=False):
        out, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                            scale=scale)
        return (out, lse) if return_lse else out

    def decode(q, k, v, lengths, scale=None, layer=None, k_scale=None,
               v_scale=None, int8_matmuls=False, new_k=None, new_v=None,
               block_k=da.DEFAULT_BLOCK_K_DECODE, window=None):
        kc, vc = da._layer_view(k, layer), da._layer_view(v, layer)
        ks, vs = da._scale_view(k_scale, layer), da._scale_view(v_scale,
                                                                layer)
        if int8_matmuls:
            return da.decode_attention_i8mm_plain(q, kc, vc, lengths, ks, vs,
                                                  scale, block_k,
                                                  window=window)
        out = da.decode_attention_plain(q, kc, vc, lengths, scale, new_k,
                                        new_v, k_scale=ks, v_scale=vs,
                                        window=window)
        return out if new_k is None else (out, k, v, k_scale, v_scale)

    def chunk(q, k, v, starts, scale=None, layer=None, k_scale=None,
              v_scale=None):
        return da.chunk_prefill_attention_plain(
            q, da._layer_view(k, layer), da._layer_view(v, layer), starts,
            scale, k_scale=da._scale_view(k_scale, layer),
            v_scale=da._scale_view(v_scale, layer))

    def paged_decode(q, k, v, lengths, pages, scale=None, layer=None,
                     k_scale=None, v_scale=None, int8_matmuls=False,
                     new_k=None, new_v=None, window=None, block_k=None):
        kp, vp = pa.pool_layer(k, layer), pa.pool_layer(v, layer)
        ks = None if k_scale is None else pa.pool_layer(k_scale, layer)
        vs = None if v_scale is None else pa.pool_layer(v_scale, layer)
        if int8_matmuls:
            return pa.paged_decode_attention_i8mm_plain(
                q, kp, vp, lengths, pages, ks, vs, scale, block_k,
                window=window)
        out = pa.paged_decode_attention_plain(q, kp, vp, lengths, pages,
                                              scale, new_k, new_v,
                                              k_scale=ks, v_scale=vs,
                                              window=window)
        return out if new_k is None else (out, k, v, k_scale, v_scale)

    def paged_chunk(q, k, v, starts, pages, scale=None, layer=None,
                    k_scale=None, v_scale=None):
        return pa.paged_chunk_prefill_attention_plain(
            q, pa.pool_layer(k, layer), pa.pool_layer(v, layer), starts,
            pages, scale,
            k_scale=None if k_scale is None else pa.pool_layer(k_scale,
                                                               layer),
            v_scale=None if v_scale is None else pa.pool_layer(v_scale,
                                                               layer))

    swaps = [(fa, "flash_attention", flash),
             (da, "decode_attention", decode),
             (da, "chunk_prefill_attention", chunk),
             (pa, "paged_decode_attention", paged_decode),
             (pa, "paged_chunk_prefill_attention", paged_chunk)]
    kernels = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in kernels:
            setattr(mod, name, fn)


def kernels_vs_plain(tag, m, ids, chunk=None, paged=None, gate=True):
    """A prefill (one pass, or ``chunk``-token blocks) and one decode step
    of module ``m`` on a fresh cache (of its config's kind) through the
    kernels, then the same on another fresh cache through the plain
    versions on the card (the decode step fed the kernel path's greedy
    token): per-row cosine of the logits >= 0.999 (reported only when
    ``gate`` is False).  ``paged``: the page size of a pool that maps each
    row's positions through a block table (chunked prefill, K7, then
    K6)."""
    import torch
    B, P = ids.shape
    last = torch.full((B,), P - 1, device=DEV)
    res, nxt = [], None
    for ctx in (contextlib.nullcontext(), plain_kernels()):
        with ctx, torch.no_grad():
            if paged is None:
                cache = m.init_cache(B, P + 8)
            else:
                n_virt = -(-(P + 8) // paged)
                cache = m.init_paged_cache(1 + B * n_virt, paged)
                cache["pages"] = 1 + torch.arange(
                    B * n_virt, device=DEV, dtype=torch.int32).view(B, n_virt)
            if chunk is None:
                pre, cache = m.decode(ids, cache, 0, logits_at=last,
                                      prefill=True)
            else:
                for c0 in range(0, P, chunk):
                    loc = torch.full((B,), min(chunk, P - c0) - 1,
                                     device=DEV)
                    pre, cache = m.decode(ids[:, c0:c0 + chunk], cache, c0,
                                          logits_at=loc)
            if nxt is None:
                nxt = pre[:, 0].float().argmax(-1)
            step, cache = m.decode(nxt[:, None], cache, P)
            res.append((pre, step))
            del cache
    return [compare_logits(f"{tag} prefill logits, kernels vs plain",
                           res[0][0], res[1][0], gate),
            compare_logits(f"{tag} first decode step logits, kernels vs "
                           f"plain", res[0][1], res[1][1], gate)]


def agreement(got, want, P):
    """Share of generated token positions where two greedy runs agree."""
    return float((got[:, P:] == want[:, P:]).float().mean())


def int8_engine(sd, **model_over):
    """``init_inference(opt_model("opt-1.3b"), quant=QUANT)`` with
    ``sd``'s weights (run (a)'s, in bf16: loaded in fp32 and quantized per
    channel); returns the engine and its set-up seconds."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import opt_model
    t0 = time.perf_counter()
    eng = init_inference(opt_model(MODEL, **model_over),
                         {"quant": dict(QUANT)}, dtype="bfloat16",
                         device=DEV)
    eng.set_params(sd)
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def int8_generate_path(eng, tokens, runs):
    """Runs (g) and (g-i8mm) on run (a)'s weights quantized per channel,
    with an int8 KV cache: (g) at run (a)'s shape (K1 prefill, K2-int8
    decode) and run (b)'s (K3-int8, K2-int8), (g-i8mm) at run (a)'s with
    decode_int8_matmuls (K1, K2-i8mm); exact launches, kernel-path logits
    against the plain path, greedy agreement with the bf16 runs."""
    import torch
    from deepspeed_tpu_torch import init_inference
    sd = eng.module.state_dict()
    eng_g, init_s = int8_engine(sd)
    L = eng_g.module.config.num_layers
    (ids_a, out_a), (ids_b, out_b) = tokens["a"], tokens["b"]
    weights = {"weight_bytes": tensor_bytes(eng_g.module),
               "weight_bytes_bf16": tensor_bytes(eng.module),
               "quantized_layers": len(eng_g.module.quantized_leaves()),
               "init_seconds": init_s}
    B, P, new = RUN_A["batch"], RUN_A["prompt"], RUN_A["new"]
    warm = eng_g.warmup(P, new, batch_sizes=(B,))
    out, dt, cnt, peak = run_generate(eng_g, ids_a, new, {
        "flash_attention": L, "decode_attention_int8": L * (new - 1)})
    runs["g"] = {"run": "g", "route": "one_pass", "batch": B, "prompt": P,
                 "new_tokens": new, "seconds": dt,
                 "tokens_per_s": B * new / dt, "launches": cnt,
                 "peak_device_bytes": peak,
                 "peak_device_bytes_run_a": runs["a"]["peak_device_bytes"],
                 "kv_bytes": tensor_bytes(eng_g._workspace._cache),
                 "kv_bytes_bf16": tensor_bytes(eng._workspace._cache),
                 "greedy_agreement_with_a": agreement(out, out_a, P),
                 "cuda_graphs": True, "warmup_seconds": warm,
                 "graph_pool_bytes": graph_pool_bytes(eng_g), **weights,
                 "logits": kernels_vs_plain("(g)", eng_g.module, ids_a)}
    emit(runs["g"])
    # the profile line on an eager engine over the quantized module, as in
    # earlier runs (run (h)'s eager twin serves on it too)
    eng_ge = eager_twin(eng_g, quant=dict(QUANT))
    eng_ge.generate(ids_a, max_new_tokens=4)  # warm-up
    runs["g_profile"] = profile_run(eng_ge, ids_a, new, "g",
                                    "int8_generate_trace.json")
    eng_ge.release_workspace()
    B, P, new, C = (RUN_B[x] for x in ("batch", "prompt", "new", "chunk"))
    # a second engine over the quantized module, as run (b)'s over (a)'s
    eng_gb = init_inference(eng_g.module, {"quant": dict(QUANT),
                                           "prefill_chunk_size": C},
                            dtype="bfloat16", device=DEV)
    warm = eng_gb.warmup(P, new, batch_sizes=(B,))
    out, dt, cnt, peak = run_generate(eng_gb, ids_b, new, {
        "decode_attention_int8": L * (new - 1),
        "chunk_prefill_attention_int8": L * (-(-P // C))})
    runs["g_b"] = {"run": "g_b", "route": "chunked", "chunk": C, "batch": B,
                   "prompt": P, "new_tokens": new, "seconds": dt,
                   "tokens_per_s": B * new / dt, "launches": cnt,
                   "peak_device_bytes": peak,
                   "peak_device_bytes_run_b": runs["b"]["peak_device_bytes"],
                   "greedy_agreement_with_b": agreement(out, out_b, P),
                   "cuda_graphs": True, "warmup_seconds": warm,
                   "logits": kernels_vs_plain("(g) chunked", eng_g.module,
                                              ids_b, chunk=C)}
    emit(runs["g_b"])
    del eng_gb
    eng_m, init_m = int8_engine(sd, kv_cache_quant=True,
                                decode_int8_matmuls=True)
    B, P, new = RUN_A["batch"], RUN_A["prompt"], RUN_A["new"]
    warm = eng_m.warmup(P, new, batch_sizes=(B,))
    out, dt, cnt, peak = run_generate(eng_m, ids_a, new, {
        "flash_attention": L, "decode_attention_i8mm": L * (new - 1)})
    runs["g_i8mm"] = {"run": "g_i8mm", "route": "one_pass",
                      "decode_int8_matmuls": True, "batch": B, "prompt": P,
                      "new_tokens": new, "seconds": dt,
                      "tokens_per_s": B * new / dt, "launches": cnt,
                      "peak_device_bytes": peak, "init_seconds": init_m,
                      "cuda_graphs": True, "warmup_seconds": warm,
                      "greedy_agreement_with_a": agreement(out, out_a, P),
                      "logits": kernels_vs_plain("(g-i8mm)", eng_m.module,
                                                 ids_a)}
    emit(runs["g_i8mm"])
    eng_m.release_workspace()
    torch.cuda.empty_cache()
    return eng_g, eng_ge, eng_m


def int8_serving_path(eng_g, eng_ge, eng_m, outs_d, runs):
    """Run (h): run (d)'s requests and server on the int8 engine (K7-int8
    admission, K6-int8 decode) with the captured decode block, again on
    the eager engine ``eng_ge`` (every request equal), a decode-window
    profile each way, its monolithic twin (K3-int8, K2-int8) with every
    request's tokens equal, and (h-i8mm): run (d)'s first 24 requests
    with decode_int8_matmuls on the pool (K7-int8, K6-i8mm)."""
    import numpy as np
    import torch
    V = eng_g.module.config.vocab_size
    reqs = serving_traffic(V)
    # the paged logits check's batch: the first 4 prompts cut to the
    # shortest of them
    P = min(len(p) for p, _ in reqs[:4])
    ids = torch.tensor([p[:P].tolist() for p, _ in reqs[:4]], device=DEV)
    warm = eng_g.serve(**SERVE_D)             # warm-up (allocator, cuBLAS)
    drive(warm, reqs[:4])
    warm.close()
    srv, outs, secs, peak, counts = serve_counted(eng_g, reqs, "run (h)",
                                                  **SERVE_D)
    rec = serve_record("h", srv, secs, peak, counts, reqs)
    rec.update(peak_device_bytes_run_d=runs["d"]["peak_device_bytes"],
               kv_bytes_run_d=runs["d"]["kv_bytes"],
               prefill_plan=eng_g.prefill_plan(1, max(RUN_D["prompts"]),
                                               paged=True)[2],
               greedy_agreement_with_d=float(np.mean(np.concatenate(
                   [a[len(p):] == b[len(p):] for a, b, (p, _) in
                    zip(outs, outs_d, reqs)]))),
               logits=kernels_vs_plain(
                   "(h) paged", eng_g.module, ids,
                   chunk=SERVE_D["prefill_chunk"],
                   paged=SERVE_D["page_size"]))
    runs["h"] = rec
    emit(rec)
    runs["h_eager"] = eager_serving("h_eager", eng_ge, reqs, outs, SERVE_D)
    runs["h_profile"] = profile_serving(eng_ge, reqs, "h",
                                        "int8_serving_trace.json")
    runs["h_graph_profile"] = profile_serving(
        eng_g, reqs, "h_graph", "int8_serving_graph_trace.json")
    mono, outs_m, secs_m, peak_m, counts_m = serve_counted(
        eng_g, reqs, "run (h) monolithic", **{**SERVE_D, "paged": False})
    differ = sum(not np.array_equal(a, b) for a, b in zip(outs, outs_m))
    runs["h_mono"] = serve_record("h_mono", mono, secs_m, peak_m, counts_m,
                                  reqs)
    runs["h_mono"]["requests_differing_from_paged"] = differ
    emit(runs["h_mono"])
    if differ:
        fail(f"run (h): {differ} of {len(reqs)} requests' tokens differ "
             f"between the int8 pool and the int8 monolithic lanes")
    few = reqs[:RUN_H_I8MM["requests"]]
    srv, outs_i, secs_i, peak_i, counts_i = serve_counted(
        eng_m, few, "run (h-i8mm)", **SERVE_D)
    runs["h_i8mm"] = serve_record("h_i8mm", srv, secs_i, peak_i, counts_i,
                                  few)
    runs["h_i8mm"]["greedy_agreement_with_h"] = float(np.mean(
        np.concatenate([a[len(p):] == b[len(p):]
                        for a, b, (p, _) in zip(outs_i, outs, few)])))
    emit(runs["h_i8mm"])
    return runs


# --------------------------------------------------------------------- #
# GPT-Neo-1.3B: generate() (i) and the paged server (j), global and
# sliding-window layers
# --------------------------------------------------------------------- #
def gpt_neo_engine(module, **model_over):
    """A bf16 engine over ``module`` with its config changed in place by
    ``model_over`` (the KV cache's type and decode mode; the weights stay
    where they are)."""
    import dataclasses
    from deepspeed_tpu_torch import init_inference
    module.replace_config_(dataclasses.replace(module.config, **model_over))
    return init_inference(module, dtype="bfloat16", device=DEV)


def gpt_neo_traffic(V):
    """Run (j)'s requests: numpy seed 0, prompt lengths and new tokens
    uniform in RUN_J's ranges, prompt ids uniform over the vocabulary."""
    import numpy as np
    rng = np.random.default_rng(RUN_J["seed"])
    lo, hi = RUN_J["prompts"]
    nlo, nhi = RUN_J["new"]
    return [(rng.integers(0, V, int(rng.integers(lo, hi + 1)))
             .astype(np.int32), int(rng.integers(nlo, nhi + 1)))
            for _ in range(RUN_J["requests"])]


def fp32_gated_logits(tag, m, m32, ids, **kw):
    """Kernel-path logits against the plain path on a model's weights: in
    bf16 (reported: a deep random model amplifies bf16 rounding — GPT-Neo
    through its unscaled attention logits, |q.k| ~ 10, over 24 layers;
    Llama-7B over 32 layers, each output rounding moving near-tied maxima)
    and on the fp32 copy of the same weights (gated at cosine 0.999: the
    same routes, rounding at 2^-24)."""
    return {"bf16": kernels_vs_plain(f"{tag} bf16", m, ids, gate=False,
                                     **kw),
            "fp32": kernels_vs_plain(f"{tag} fp32", m32, ids, **kw)}


def counted_generate(eng, ids, new, tag, expect, runs, model, **extra):
    """One counted generate() of run ``tag`` (GPT-Neo's (i), Llama's (k))
    after ``warmup()``, and its record."""
    B, P = ids.shape
    warm = eng.warmup(P, new, batch_sizes=(B,))
    out, dt, cnt, peak = run_generate(eng, ids, new, expect)
    runs[tag] = {"run": tag, "model": model, "batch": B, "prompt": P,
                 "new_tokens": new, "seconds": dt,
                 "tokens_per_s": B * new / dt, "launches": cnt,
                 "peak_device_bytes": peak, "cuda_graphs": True,
                 "warmup_seconds": warm,
                 "graph_pool_bytes": graph_pool_bytes(eng),
                 "kv_bytes": tensor_bytes(eng._workspace._cache), **extra}
    return out


def gpt_neo_path():
    """Run (i): GPT-Neo-1.3B generation, one pass at prompt 320 (K1 on
    the global layers, the dense band on the local ones; K2 and K2-window
    decode), chunked at prompt 512 (K3 on global chunks), then with an
    int8 KV cache (K2-int8 / K2-int8-window) and decode_int8_matmuls
    (K2-i8mm / K2-i8mm-window), each with exact launches and its
    kernel-path logits against the plain path; a profile of the one-pass
    run.  Run (j): the paged server and its monolithic twin, then a few
    requests on int8 pools.  Returns the runs."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.gpt_neo import gpt_neo_model
    t0 = time.perf_counter()
    eng = init_inference(gpt_neo_model(GPT_NEO), dtype="bfloat16", device=DEV)
    eng.init_params(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m = eng.module
    cfg = m.config
    n_global, n_local = layer_kinds(cfg)
    # an fp32 copy of the same (bf16) weights for the gated logits checks
    m32 = gpt_neo_model(GPT_NEO, dtype="float32").to_empty(device=DEV)
    m32.load_state_dict(m.state_dict())
    m32.eval()
    V = cfg.vocab_size
    g = torch.Generator(device=DEV).manual_seed(9)
    runs = {}
    B, P, new = RUN_I["batch"], RUN_I["prompt"], RUN_I["new"]
    ids = torch.randint(0, V, (B, P), generator=g, device=DEV)
    plan = eng.prefill_plan(B, P)
    if plan[0] != "one_pass":
        fail(f"run (i) should take one-pass prefill, plan says {plan}")
    steps = n_global * (new - 1), n_local * (new - 1)
    counted_generate(eng, ids, new, "i", {
        "flash_attention": n_global, "decode_attention": steps[0],
        "decode_attention_window": steps[1]}, runs, GPT_NEO,
        route="one_pass",
        window=cfg.window_size, init_seconds=init_s, plan=plan[2],
        logits=fp32_gated_logits("(i)", m, m32, ids))
    emit(runs["i"])
    # the profile line on an eager engine, as in earlier runs
    eng_e = eager_twin(eng)
    eng_e.generate(ids, max_new_tokens=2)     # warm-up
    runs["i_profile"] = profile_run(eng_e, ids, new, "i",
                                    "gpt_neo_generate_trace.json")
    del eng_e
    B, P, new, C = (RUN_I_CHUNKED[x] for x in ("batch", "prompt", "new",
                                               "chunk"))
    eng_c = init_inference(m, {"prefill_chunk_size": C}, dtype="bfloat16",
                           device=DEV)
    ids_c = torch.randint(0, V, (B, P), generator=g, device=DEV)
    if eng_c.prefill_plan(B, P)[:2] != ("chunked", C):
        fail(f"run (i) chunked should take chunked prefill, plan says "
             f"{eng_c.prefill_plan(B, P)}")
    counted_generate(eng_c, ids_c, new, "i_chunked", {
        "chunk_prefill_attention": n_global * (-(-P // C)),
        "decode_attention": n_global * (new - 1),
        "decode_attention_window": n_local * (new - 1)}, runs, GPT_NEO,
        route="chunked", chunk=C,
        logits=fp32_gated_logits("(i) chunked", m, m32, ids_c, chunk=C))
    emit(runs["i_chunked"])
    del eng_c
    torch.cuda.empty_cache()
    serving = gpt_neo_serving_path(eng, m32)
    runs.update(serving)
    eng.release_workspace()
    # the int8 KV modes on the same weights: short runs at run (i)'s shape
    few = gpt_neo_traffic(V)[:RUN_J["int8_requests"]]
    B, P, new = RUN_I_INT8["batch"], RUN_I_INT8["prompt"], RUN_I_INT8["new"]
    ids8 = ids[:B, :P]
    for tag, over, mode in (
            ("i_int8", dict(kv_cache_quant=True), "_int8"),
            ("i_i8mm", dict(kv_cache_quant=True, decode_int8_matmuls=True),
             "_i8mm")):
        eng8 = gpt_neo_engine(m, **over)
        m32.replace_config_(dataclasses.replace(m32.config, **over))
        counted_generate(eng8, ids8, new, tag, {
            "flash_attention": n_global,
            "decode_attention" + mode: n_global * (new - 1),
            "decode_attention_window" + mode: n_local * (new - 1)}, runs,
            GPT_NEO,
            route="one_pass", **over,
            logits=fp32_gated_logits(f"({tag})", m, m32, ids8))
        emit(runs[tag])
        eng8.release_workspace()
        jtag = "j" + tag[1:]
        srv, outs, secs, peak, counts = serve_counted(eng8, few,
                                                      f"run ({jtag})",
                                                      **SERVE_J)
        runs[jtag] = serve_record(jtag, srv, secs, peak, counts, few)
        runs[jtag]["greedy_agreement_with_j"] = float(np.mean(
            np.concatenate([a[len(p):] == b[len(p):] for a, b, (p, _) in
                            zip(outs, serving["j_outputs"], few)])))
        emit(runs[jtag])
        del eng8
        torch.cuda.empty_cache()
    runs.pop("j_outputs")
    del eng, m, m32
    torch.cuda.empty_cache()
    return runs


def gpt_neo_serving_path(eng, m32):
    """Run (j): 32 requests on a 16-slot page pool (K7 on global chunks,
    the gathered dense band on local ones; K6 and K6-window decode), the
    kernel path's logits on a pool against the plain path, and the same
    requests on monolithic lanes (K3; K2 and K2-window), every request
    equal.  Returns the runs and run (j)'s outputs (``j_outputs``)."""
    import numpy as np
    import torch
    V = eng.module.config.vocab_size
    reqs = gpt_neo_traffic(V)
    warm = eng.serve(**SERVE_J)               # warm-up (allocator, cuBLAS)
    drive(warm, reqs[:4])
    warm.close()
    srv, outs, secs, peak, counts = serve_counted(eng, reqs, "run (j)",
                                                  **SERVE_J)
    rec = serve_record("j", srv, secs, peak, counts, reqs)
    P = min(len(p) for p, _ in reqs[:4])
    ids = torch.tensor([p[:P].tolist() for p, _ in reqs[:4]], device=DEV)
    rec["logits"] = fp32_gated_logits("(j) paged", eng.module, m32, ids,
                                   chunk=SERVE_J["prefill_chunk"],
                                   paged=SERVE_J["page_size"])
    emit(rec)
    mono, outs_m, secs_m, peak_m, counts_m = serve_counted(
        eng, reqs, "run (j) monolithic", **{**SERVE_J, "paged": False})
    differ = sum(not np.array_equal(a, b) for a, b in zip(outs, outs_m))
    rec_m = serve_record("j_mono", mono, secs_m, peak_m, counts_m, reqs)
    rec_m["requests_differing_from_paged"] = differ
    emit(rec_m)
    if differ:
        fail(f"run (j): {differ} of {len(reqs)} requests' tokens differ "
             f"between the paged pool and the monolithic lanes")
    return {"j": rec, "j_mono": rec_m, "j_outputs": outs}


# --------------------------------------------------------------------- #
# Llama-7B: generate() (k), the paged server (l), the GQA cut (k-gqa)
# --------------------------------------------------------------------- #
def llama_elementwise(m, B, P, new):
    """Device ms of the plain-PyTorch work that Llama adds to a forward
    (``torch.profiler`` kernel records, all kernels of each call): the
    rotary tables once and q / k rotated in every layer, the 2 RMS norms
    of every layer and the final one, SwiGLU's ``silu(gate) * up`` in
    every layer; for one decode step at batch ``B`` and for the prefill
    of ``B`` x ``P``, and for a whole ``generate()`` of ``new`` tokens
    (the prefill and ``new - 1`` steps)."""
    import torch
    import torch.nn.functional as F
    from deepspeed_tpu_torch.models import transformer as tr
    from deepspeed_tpu_torch.profiling.trace import device_ms_per_call
    cfg = m.config
    L, H, KVH, D = cfg.num_layers, cfg.num_heads, cfg.kv_heads, cfg.head_dim
    dt = cfg.torch_dtype
    g = torch.Generator(device=DEV).manual_seed(14)
    trace = os.path.join(ROOT, "build", "profiles", "llama_elementwise.json")
    rec = {}
    for tag, S in (("decode_step", 1), ("prefill", P)):
        pos = torch.arange(S, device=DEV)[None].expand(B, S) + \
            (P if S == 1 else 0)

        def rand(*shape):
            return torch.randn(*shape, generator=g, device=DEV, dtype=dt)

        q, k = rand(B, S, H, D), rand(B, S, KVH, D)
        x = rand(B, S, cfg.hidden_size)
        gate, up = rand(B, S, cfg.ffn_size), rand(B, S, cfg.ffn_size)

        def rope():
            cs = tr.rope_tables(pos, D, cfg.rope_theta, cfg.rope_dim)
            for _ in range(L):
                tr.apply_rope(q, *cs)
                tr.apply_rope(k, *cs)

        def rms_norm():
            for _ in range(2 * L + 1):
                tr._norm(x, m.final_norm, cfg)

        def swiglu():
            for _ in range(L):
                F.silu(gate) * up

        rec[tag] = {name: device_ms_per_call(fn, 5, trace) for name, fn in
                    (("rope", rope), ("rms_norm", rms_norm),
                     ("swiglu", swiglu))}
        rec[tag]["total"] = sum(rec[tag].values())
    rec["generate_total_ms"] = rec["prefill"]["total"] + \
        (new - 1) * rec["decode_step"]["total"]
    return rec


def llama_path():
    """Run (k): Llama-7B generation at its full widths and depth, one
    pass at run (a)'s shape (K1, K2) on the captured decode graphs after
    ``warmup()``, the same on an eager engine (tokens bitwise), profile
    lines "k" (eager) and "k_graph", the device ms of rope / RMSNorm /
    SwiGLU, then chunked at run (b)'s (K3, K2), each with exact launches;
    run (l); then, on an fp32 copy of the same weights, the checks that
    bf16 rounding on a 32-layer random model would blur
    (:func:`llama_fp32_checks`); then run (k-gqa).  Returns the runs."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import llama_model
    t0 = time.perf_counter()
    eng = init_inference(llama_model(LLAMA), dtype="bfloat16", device=DEV)
    eng.init_params(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m = eng.module
    cfg = m.config
    L, V = cfg.num_layers, cfg.vocab_size
    g = torch.Generator(device=DEV).manual_seed(13)
    runs = {}
    B, P, new = RUN_K["batch"], RUN_K["prompt"], RUN_K["new"]
    ids = torch.randint(0, V, (B, P), generator=g, device=DEV)
    plan = eng.prefill_plan(B, P)
    if plan[0] != "one_pass":
        fail(f"run (k) should take one-pass prefill, plan says {plan}")
    expect = {"flash_attention": L, "decode_attention": L * (new - 1)}
    out = counted_generate(eng, ids, new, "k", expect, runs, LLAMA,
                           route="one_pass", params=cfg.num_params(),
                           weight_bytes=tensor_bytes(m),
                           init_seconds=init_s, plan=plan[2])
    emit(runs["k"])
    eng_e = eager_twin(eng)
    eng_e.generate(ids, max_new_tokens=4)     # warm-up
    out_e, dt, cnt, peak = run_generate(eng_e, ids, new, expect)
    runs["k_eager"] = {"run": "k_eager", "cuda_graphs": False,
                       "seconds": dt, "tokens_per_s": B * new / dt,
                       "launches": cnt, "peak_device_bytes": peak,
                       "tokens_equal_to_graphs": bool(torch.equal(out_e,
                                                                  out))}
    emit(runs["k_eager"])
    if not runs["k_eager"]["tokens_equal_to_graphs"]:
        fail("run (k): the eager engine's tokens differ from the captured "
             "decode graphs'")
    runs["k_profile"] = profile_run(eng_e, ids, new, "k",
                                    "llama_generate_trace.json")
    runs["k_graph_profile"] = profile_run(eng, ids, new, "k_graph",
                                          "llama_generate_graph_trace.json")
    elem = llama_elementwise(m, B, P, new)
    for prof in ("k_profile", "k_graph_profile"):
        elem[f"share_of_{prof[:-8]}_busy"] = \
            elem["generate_total_ms"] / runs[prof]["device_busy_ms"]
    runs["k_elementwise"] = elem
    emit({"llama_elementwise": elem})
    eng_e.release_workspace()
    eng.release_workspace()
    B, P, new, C = (RUN_K_CHUNKED[x] for x in ("batch", "prompt", "new",
                                               "chunk"))
    eng_c = init_inference(m, {"prefill_chunk_size": C}, dtype="bfloat16",
                           device=DEV)
    ids_c = torch.randint(0, V, (B, P), generator=g, device=DEV)
    if eng_c.prefill_plan(B, P)[:2] != ("chunked", C):
        fail(f"run (k) chunked should take chunked prefill, plan says "
             f"{eng_c.prefill_plan(B, P)}")
    counted_generate(eng_c, ids_c, new, "k_chunked", {
        "chunk_prefill_attention": L * (-(-P // C)),
        "decode_attention": L * (new - 1)}, runs, LLAMA, route="chunked",
        chunk=C)
    emit(runs["k_chunked"])
    del eng_c
    torch.cuda.empty_cache()
    serving, reqs = llama_serving_path(eng, eng_e)
    runs.update(serving)
    del eng, eng_e
    torch.cuda.empty_cache()
    runs["k_fp32_checks"] = llama_fp32_checks(m, ids, ids_c, reqs, runs)
    del m
    torch.cuda.empty_cache()
    runs.update(llama_gqa_path())
    return runs


def llama_serving_path(eng, eng_e):
    """Run (l): run (d)'s first 64 requests on a 32-slot page pool (K7
    admission, K6 decode) on the captured decode block, again on the
    eager engine ``eng_e`` (every request equal), a decode-window profile
    each way, then the same requests on monolithic lanes (K3, K2: every
    request equal); the first 4 also through solo generate() calls, their
    greedy agreement with the served stream reported (bf16: a batch of 1
    runs other GEMM kernels than a decode block of 32 slots; the fp32
    check in :func:`llama_fp32_checks` gates the equality).  Returns the
    runs and the requests."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import init_inference
    V = eng.module.config.vocab_size
    reqs = serving_traffic(V, RUN_L["requests"])
    warm = eng.serve(**SERVE_L)               # warm-up (allocator, cuBLAS)
    drive(warm, reqs[:4])
    warm.close()
    srv, outs, secs, peak, counts = serve_counted(eng, reqs, "run (l)",
                                                  **SERVE_L)
    rec = serve_record("l", srv, secs, peak, counts, reqs)
    emit(rec)
    runs = {"l": rec}
    runs["l_eager"] = eager_serving("l_eager", eng_e, reqs, outs, SERVE_L)
    runs["l_profile"] = profile_serving(eng_e, reqs, "l",
                                        "llama_serving_trace.json", SERVE_L)
    runs["l_graph_profile"] = profile_serving(
        eng, reqs, "l_graph", "llama_serving_graph_trace.json", SERVE_L)
    mono, outs_m, secs_m, peak_m, counts_m = serve_counted(
        eng, reqs, "run (l) monolithic", **{**SERVE_L, "paged": False})
    differ = sum(not np.array_equal(a, b) for a, b in zip(outs, outs_m))
    rec_m = serve_record("l_mono", mono, secs_m, peak_m, counts_m, reqs)
    rec_m["requests_differing_from_paged"] = differ
    few = reqs[:RUN_L["solo"]]
    solo_eng = init_inference(eng.module, {
        "prefill_chunk_size": SERVE_L["prefill_chunk"]}, dtype="bfloat16",
        device=DEV)
    solo = [solo_eng.generate(torch.tensor(p[None], device=DEV),
                              max_new_tokens=n)[0].cpu().numpy()
            for p, n in few]
    del solo_eng
    rec_m["bf16_solo"] = {
        "requests": len(few),
        "requests_differing_from_paged": sum(
            not np.array_equal(a, b) for a, b in zip(solo, outs)),
        "greedy_agreement_with_paged": float(np.mean(np.concatenate(
            [a[len(p):] == b[len(p):]
             for a, b, (p, _) in zip(solo, outs, few)])))}
    emit(rec_m)
    runs["l_mono"] = rec_m
    if differ:
        fail(f"run (l): {differ} of {len(reqs)} requests' tokens differ "
             f"between the paged pool and the monolithic lanes")
    torch.cuda.empty_cache()
    return runs, reqs


def llama_fp32_checks(m, ids, ids_c, reqs, runs):
    """On an fp32 copy of Llama-7B's weights (the kernels' fp32 modes):
    kernel-path logits against the plain path for runs (k), (k) chunked
    and (l)'s pool, in bf16 (reported) and fp32 (gated at cosine 0.999),
    beside the bf16 plain path's own cosine to its fp32 logits (the
    rounding floor, reported); and run (l)'s first 4 requests served on
    its pool, each equal to its solo generate() (gated).  Returns the
    checks."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import llama_model
    m32 = llama_model(LLAMA, dtype="float32").to_empty(device=DEV)
    m32.load_state_dict(m.state_dict())
    m32.eval()
    P = min(len(p) for p, _ in reqs[:4])
    ids_l = torch.tensor([p[:P].tolist() for p, _ in reqs[:4]], device=DEV)
    rec = {"k": fp32_gated_logits("(k)", m, m32, ids),
           "k_chunked": fp32_gated_logits("(k) chunked", m, m32, ids_c,
                                          chunk=RUN_K_CHUNKED["chunk"]),
           "l": fp32_gated_logits("(l) paged", m, m32, ids_l,
                                  chunk=SERVE_L["prefill_chunk"],
                                  paged=SERVE_L["page_size"])}
    for run in ("k", "k_chunked", "l"):
        runs[run]["logits"] = rec[run]
    # the bf16 noise floor: the plain path's own bf16 prefill logits
    # against its fp32 ones (reported beside the kernel path's bf16 cosine)
    B, P = ids.shape
    last = torch.full((B,), P - 1, device=DEV)
    with plain_kernels(), torch.no_grad():
        pre = [mm.decode(ids, mm.init_cache(B, P + 8), 0, logits_at=last,
                         prefill=True)[0] for mm in (m, m32)]
    rec["bf16_plain_vs_fp32_plain"] = compare_logits(
        "(k) prefill logits, bf16 plain vs fp32 plain", pre[0], pre[1],
        gate=False)
    del pre
    eng32 = init_inference(m32, {
        "prefill_chunk_size": SERVE_L["prefill_chunk"]}, dtype="float32",
        device=DEV)
    few = reqs[:RUN_L["solo"]]
    srv = eng32.serve(**SERVE_L)
    rids = [srv.submit(p, max_new_tokens=n) for p, n in few]
    done = srv.drain()
    srv.close()
    solo = [eng32.generate(torch.tensor(p[None], device=DEV),
                           max_new_tokens=n)[0].cpu().numpy()
            for p, n in few]
    rec["fp32_solo"] = {"requests": len(few),
                        "requests_differing_from_paged": sum(
                            not np.array_equal(done[r], s)
                            for r, s in zip(rids, solo))}
    emit({"run": "l", "fp32_solo": rec["fp32_solo"]})
    if rec["fp32_solo"]["requests_differing_from_paged"]:
        fail(f"run (l) on fp32 weights: "
             f"{rec['fp32_solo']['requests_differing_from_paged']} of the "
             f"first {len(few)} served requests differ from their solo "
             f"generate()")
    del eng32, m32
    torch.cuda.empty_cache()
    return rec


def llama_gqa_path():
    """Run (k-gqa): the GQA cut (2 layers, 8 kv heads of 128: G = 4) at
    run (k)'s batch and prompt.  In bf16: generate() through K1 and K2
    with exact launches and the kernel-path logits against the plain path
    (cosine >= 0.999), the greedy agreement with the plain path reported.
    On an fp32 copy of the same weights (the kernels' fp32 modes, where
    rounding cannot move a greedy choice): generate() and a paged server
    of 8 requests through the kernels, every token equal to the plain
    path's (``plain_kernels``, on an eager engine)."""
    import dataclasses
    import numpy as np
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import llama_model
    over = {k: RUN_K_GQA[k] for k in ("num_kv_heads", "num_layers")}
    eng = init_inference(llama_model(LLAMA, **over), dtype="bfloat16",
                         device=DEV)
    eng.init_params(seed=1)
    m = eng.module
    cfg = m.config
    L, V = cfg.num_layers, cfg.vocab_size
    g = torch.Generator(device=DEV).manual_seed(15)
    B, P, new = (RUN_K_GQA[x] for x in ("batch", "prompt", "new"))
    ids = torch.randint(0, V, (B, P), generator=g, device=DEV)
    expect = {"flash_attention": L, "decode_attention": L * (new - 1)}
    runs = {}
    out = counted_generate(eng, ids, new, "k_gqa", expect, runs, LLAMA,
                           cut=over, group=cfg.num_heads // cfg.kv_heads,
                           logits=kernels_vs_plain("(k-gqa)", m, ids))
    with plain_kernels():
        plain = eager_twin(eng).generate(ids, max_new_tokens=new)
    runs["k_gqa"]["greedy_agreement_with_plain"] = agreement(out, plain, P)
    # the fp32 copy: kernels against plain, tokens equal
    m32 = llama_model(LLAMA, dtype="float32", **over).to_empty(device=DEV)
    m32.load_state_dict(m.state_dict())
    m32.eval()
    del eng, m
    serve = dict(SERVE_L, num_slots=RUN_K_GQA["requests"], num_pages=0)
    reqs = [(p, new) for p, _ in serving_traffic(V, RUN_K_GQA["requests"])]
    got = {}
    for path in ("kernels", "plain"):
        ctx = plain_kernels() if path == "plain" else contextlib.nullcontext()
        with ctx:
            e32 = init_inference(m32, {"serving": dict(serve),
                                       "enable_cuda_graph": path ==
                                       "kernels"},
                                 dtype="float32", device=DEV)
            reset_counts()
            gen = e32.generate(ids, max_new_tokens=new)
            counts = read_counts()
            srv = e32.serve()
            rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
            done = srv.drain()
            srv.close()
        got[path] = (gen, [done[r] for r in rids])
        if path == "kernels" and counts != expect_only(expect):
            fail(f"run (k-gqa) fp32: launches {counts}, the path needs "
                 f"{expect_only(expect)}")
        del e32
    rec32 = {"generate_tokens_equal": bool(torch.equal(got["kernels"][0],
                                                       got["plain"][0])),
             "served_requests_differing": sum(
                 not np.array_equal(a, b)
                 for a, b in zip(got["kernels"][1], got["plain"][1])),
             "served_requests": len(reqs)}
    runs["k_gqa"]["fp32_kernels_vs_plain"] = rec32
    emit(runs["k_gqa"])
    if not rec32["generate_tokens_equal"] or \
            rec32["served_requests_differing"]:
        fail(f"run (k-gqa): kernel-path tokens differ from the plain path's "
             f"on fp32 weights: {rec32}")
    del m32
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------- #
# Training: initialize -> train_batch for OPT-1.3B, dense (c) and
# block-sparse (f)
# --------------------------------------------------------------------- #
def train_run(run, model, config, settings, want, **extra):
    """One training run on ``model``: ``initialize`` with ``config``,
    warm-up steps, timed steps on one seeded batch with every launch count
    held to ``want`` per step (kernels not named: 0), a finite falling
    loss, and one profiled step.  Returns the run's record."""
    import torch
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.profiling.trace import breakdown
    micro, S, steps = settings["micro"], settings["seq"], settings["steps"]
    t0 = time.perf_counter()
    engine, *_ = initialize(model=model, config=config, device=DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    L, V = engine.module.config.num_layers, engine.module.config.vocab_size
    n_params = sum(p.numel() for p in engine.params)
    g = torch.Generator(device=DEV).manual_seed(settings["seed"])
    batch = {"input_ids": torch.randint(0, V, (1, micro, S), generator=g,
                                        device=DEV)}
    losses = [engine.train_batch(batch=batch)
              for _ in range(settings["warmup"])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        losses.append(engine.train_batch(batch=batch))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    peak = engine.max_memory_allocated()
    losses = torch.stack(losses).float().tolist()
    per_step = {name: n / steps for name, n in counts.items()}
    want = {**{name: 0 for name in counts}, **want}
    if per_step != want:
        fail(f"run ({run}): launches per step {per_step}, the path needs "
             f"{want}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"run ({run}): non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"run ({run}): the loss did not fall on a repeated batch: "
             f"{losses}")
    tok_s = steps * micro * S / dt
    rec = {"run": run, **extra, "micro_batch": micro, "seq": S, "layers": L,
           "params": n_params, "steps": steps, "step_ms": dt / steps * 1e3,
           "tokens_per_s": tok_s,
           "mfu": 6 * n_params * tok_s / PEAK_FLOPS["bfloat16"],
           "peak_device_bytes": peak, "losses": losses,
           "launches": counts, "launches_per_step": per_step,
           "init_seconds": init_s}
    emit(rec)

    wall = {}

    def one_step():
        t = time.perf_counter()
        engine.train_batch(batch=batch)
        torch.cuda.synchronize()
        wall["s"] = time.perf_counter() - t

    trace = os.path.join(ROOT, "build", "profiles", settings["trace"])
    ks, held = counted_events(one_step, trace)
    prof = {**breakdown(ks, wall["s"]), **held}
    emit({"profile": run, **prof, "trace": os.path.relpath(trace, ROOT)})
    # the step's end-to-end numbers beside the profiled step's device ms
    # of each attention kernel group
    rec["profile_attention_ms_per_step"] = {
        grp: ms for grp, ms in prof["device_ms_by_group"].items()
        if grp.split()[0] in ("K1", "K4", "K5", "K8")}
    emit({"run": run, "summary": True, "step_ms": rec["step_ms"],
          "tokens_per_s": tok_s, "mfu": rec["mfu"],
          "profile_wall_ms": prof["wall_ms"],
          "profile_attention_ms_per_step":
              rec["profile_attention_ms_per_step"]})
    del engine, batch
    torch.cuda.empty_cache()
    return rec


def train_path():
    """Run (c): OPT-1.3B at seq 2048, 24 K1, K4 and K5 launches a step."""
    from deepspeed_tpu_torch.models.opt import opt_model
    model = opt_model(MODEL, max_seq_len=RUN_C["seq"], loss_seq_chunks=RUN_C[
        "loss_chunks"], remat=False, dtype="bfloat16")
    L = model.config.num_layers
    return train_run("c", model, TRAIN_CONFIG, RUN_C, {
        "flash_attention": L, "flash_attention_dq": L,
        "flash_attention_dkv": L}, route="train_batch")


# --------------------------------------------------------------------- #
# Checkpointing: save_checkpoint -> load_checkpoint on a fresh engine,
# then serving from the tag and from a 16-bit export, run (c-ckpt)
# --------------------------------------------------------------------- #
class RssPeak:
    """The host's resident set, sampled every 10 ms on a thread: the peak
    growth over the value at ``start()``."""

    def __init__(self):
        import threading
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.base = self.peak = 0

    @staticmethod
    def rss():
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, self.rss())

    def __enter__(self):
        self.base = self.peak = self.rss()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())

    @property
    def growth(self):
        return self.peak - self.base


def digests(engine):
    """Bitwise digests of the master parameters and both Adam moments:
    per tensor, the int64 sum of its int32 view."""
    import torch

    def d(ts):
        return torch.stack([t.view(torch.int32).sum(dtype=torch.int64)
                            for t in ts]).tolist()

    st = engine._opt_state
    return {"params": d(engine.params), "exp_avg": d(st.exp_avg),
            "exp_avg_sq": d(st.exp_avg_sq)}


def evict_page_cache(root):
    """Drop the (fsynced) files under ``root`` from the host's page cache,
    so the load that follows reads them from the disk, as a resume after
    a preemption does."""
    for dirpath, _d, files in os.walk(root):
        for name in files:
            fd = os.open(os.path.join(dirpath, name), os.O_RDONLY)
            try:
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)


def tree_bytes(root):
    n = files = 0
    for dirpath, _d, names in os.walk(root):
        for name in names:
            n += os.path.getsize(os.path.join(dirpath, name))
            files += 1
    return n, files


def ckpt_engine(seed):
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.models.opt import opt_model
    model = opt_model(MODEL, max_seq_len=RUN_C["seq"], loss_seq_chunks=RUN_C[
        "loss_chunks"], remat=False, dtype="bfloat16")
    engine, *_ = initialize(model=model,
                            config={**TRAIN_CKPT_CONFIG, "seed": seed},
                            device=DEV)
    return engine


def ckpt_batch(step, V):
    """Run (c)'s batch shape, drawn from the step number alone."""
    import torch
    g = torch.Generator(device=DEV).manual_seed(RUN_CKPT["seed"] + step)
    return {"input_ids": torch.randint(0, V, (1, RUN_C["micro"],
                                              RUN_C["seq"]),
                                       generator=g, device=DEV)}


def ckpt_steps(engine, V, steps):
    import torch
    losses = [engine.train_batch(batch=ckpt_batch(engine.global_steps + 1,
                                                  V))
              for _ in range(steps)]
    torch.cuda.synchronize()
    return torch.stack(losses).float().tolist()


def served_tokens(tag, eng, ids, new, expect):
    """Greedy tokens of run (a)'s shape on the decode graphs, with run
    (a)'s launch counts."""
    eng.warmup(ids.shape[1], new, batch_sizes=(ids.shape[0],))
    out, dt, counts, _ = run_generate(eng, ids, new, expect)
    return out, {"seconds": dt, "launches": {k: n for k, n in counts.items()
                                             if n}}


def ckpt_serve(engine, d, rec):
    """The tag (``init_inference(config={"checkpoint": d})``), the resumed
    engine's weights (``set_params``) and a ``save_16bit_model``
    safetensors export (``load_checkpoint(file)``) each serve run (a)'s
    shape: bitwise the same greedy tokens, K1 / K2 launches as in run
    (a)."""
    import torch
    from deepspeed_tpu_torch import init_inference
    from deepspeed_tpu_torch.models.opt import opt_model
    L, V = engine.module.config.num_layers, engine.module.config.vocab_size
    B, P, new = RUN_A["batch"], RUN_A["prompt"], RUN_A["new"]
    g = torch.Generator(device=DEV).manual_seed(4)
    ids = torch.randint(0, V, (B, P), generator=g, device=DEV)
    expect = {"flash_attention": L, "decode_attention": L * (new - 1)}
    serve = {}
    t0 = time.perf_counter()
    eng = init_inference(opt_model(MODEL, max_seq_len=RUN_C["seq"]), device=DEV,
                         config={"dtype": "bfloat16", "checkpoint": d})
    torch.cuda.synchronize()
    serve["tag_load_seconds"] = time.perf_counter() - t0
    want, serve["from_tag"] = served_tokens("tag", eng, ids, new, expect)
    del eng
    eng = init_inference(opt_model(MODEL, max_seq_len=RUN_C["seq"]), dtype="bfloat16", device=DEV)
    eng.set_params(engine.module.state_dict())
    got, serve["from_set_params"] = served_tokens("set_params", eng, ids,
                                                  new, expect)
    del eng
    if not torch.equal(got, want):
        fail("run (c-ckpt): tokens from set_params differ from the tag's")
    name = "model.safetensors"
    t0 = time.perf_counter()
    engine.save_16bit_model(d, name)
    serve["export_seconds"] = time.perf_counter() - t0
    serve["export_bytes"] = os.path.getsize(os.path.join(d, name))
    t0 = time.perf_counter()
    eng = init_inference(opt_model(MODEL, max_seq_len=RUN_C["seq"]), dtype="bfloat16", device=DEV)
    eng.load_checkpoint(os.path.join(d, name))
    torch.cuda.synchronize()
    serve["export_load_seconds"] = time.perf_counter() - t0
    got, serve["from_export"] = served_tokens("export", eng, ids, new,
                                              expect)
    del eng
    torch.cuda.empty_cache()
    if not torch.equal(got, want):
        fail("run (c-ckpt): tokens from the safetensors export differ from "
             "the tag's")
    serve["tokens_bitwise_equal"] = True
    rec["serve"] = serve


def ckpt_run(d):
    import gc
    import torch
    from deepspeed_tpu_torch.runtime.fault.manifest import list_tags
    engine = ckpt_engine(RUN_C["seed"])
    L, V = engine.module.config.num_layers, engine.module.config.vocab_size
    state_bytes = sum(t.numel() * t.element_size() for t in
                      engine.params + engine._opt_state.exp_avg +
                      engine._opt_state.exp_avg_sq)
    ckpt_steps(engine, V, RUN_CKPT["before"])
    with RssPeak() as rss:
        t0 = time.perf_counter()
        engine.save_checkpoint(d)
        save_s = time.perf_counter() - t0
    tag = f"global_step{RUN_CKPT['before']}"
    if list_tags(d) != [tag]:
        fail(f"run (c-ckpt): tags {list_tags(d)} after the save, want "
             f"[{tag}]")
    nbytes, nfiles = tree_bytes(os.path.join(d, tag))
    save = {"seconds": save_s, "bytes": nbytes, "files": nfiles,
            "host_rss_growth_bytes": rss.growth,
            **{k: engine.checkpoint_stats["save"][k] for k in (
                "write_stage_s", "write_s", "manifest_s", "publish_s")}}
    at_tag = digests(engine)
    want_losses = ckpt_steps(engine, V, RUN_CKPT["after"])
    want = {"digests": digests(engine), "global_steps": engine.global_steps,
            "lr": engine.get_lr(),
            "scale": float(engine._scaler_state.scale)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    engine = ckpt_engine(RUN_CKPT["fresh_seed"])
    if digests(engine)["params"] == at_tag["params"]:
        fail("run (c-ckpt): the fresh engine already holds the tag's "
             "weights")
    evict_page_cache(d)
    with RssPeak() as rss:
        t0 = time.perf_counter()
        path, _ = engine.load_checkpoint(d)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    if path is None or not path.startswith(os.path.join(d, tag)):
        fail(f"run (c-ckpt): load_checkpoint took {path}, want {tag}")
    stats = engine.checkpoint_stats["load"]
    load = {"seconds": load_s, "host_rss_growth_bytes": rss.growth,
            "bytes": stats["bytes"], "files": stats["files"],
            "verify_s": stats["verify_s"], "read_s": stats["read_s"],
            "copy_s": stats["copy_s"], "page_cache": "evicted"}
    if digests(engine) != at_tag:
        fail("run (c-ckpt): the loaded parameters / moments are not the "
             "tag's bitwise")
    rec = {"run": "c_ckpt", "layers": L, "micro_batch": RUN_C["micro"],
           "seq": RUN_C["seq"], "checksum": "sha256",
           "state_bytes": state_bytes, "save": save, "load": load}
    for phase, n_s in (("save", ("write_s", "manifest_s", "publish_s",
                                 "seconds")),
                       ("load", ("verify_s", "read_s", "copy_s",
                                 "seconds"))):
        part = rec[phase]
        part["gb_per_s"] = {k: part["bytes"] / part[k] / 1e9
                            for k in n_s if part[k] > 0}
    ckpt_serve(engine, d, rec)
    reset_counts()
    got_losses = ckpt_steps(engine, V, RUN_CKPT["after"])
    counts = read_counts()
    per_step = {k: n / RUN_CKPT["after"] for k, n in counts.items()}
    expect = expect_only({"flash_attention": L, "flash_attention_dq": L,
                          "flash_attention_dkv": L})
    if per_step != expect:
        fail(f"run (c-ckpt): launches per step {per_step} after the "
             f"resume, the path needs {expect}")
    got = {"digests": digests(engine), "global_steps": engine.global_steps,
           "lr": engine.get_lr(), "scale": float(engine._scaler_state.scale)}
    rec.update(losses=want_losses, resumed_losses=got_losses,
               launches={k: n for k, n in counts.items() if n},
               launches_per_step={k: n for k, n in per_step.items() if n},
               global_steps=got["global_steps"], lr=got["lr"])
    if got_losses != want_losses:
        fail(f"run (c-ckpt): resumed losses {got_losses} are not the "
             f"unbroken run's {want_losses} bitwise")
    for key in want:
        if got[key] != want[key]:
            fail(f"run (c-ckpt): {key} after the resume differs from the "
                 f"unbroken run's")
    rec["bitwise"] = {"losses": True, "params": True, "exp_avg": True,
                      "exp_avg_sq": True}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def ckpt_path():
    """Run (c-ckpt), in ``build/ckpt`` (removed at the end): needs free
    disk for two tags of OPT-1.3B's fp32 state."""
    import shutil
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    os.makedirs(CKPT_DIR)
    free = shutil.disk_usage(CKPT_DIR).free
    emit({"run": "c_ckpt", "disk_free_bytes": free, "dir": os.path.relpath(
        CKPT_DIR, ROOT)})
    if free < RUN_CKPT["min_free_bytes"]:
        fail(f"run (c-ckpt): {free} bytes free at {CKPT_DIR}, it needs "
             f"{RUN_CKPT['min_free_bytes']:.0f} (two tags of OPT-1.3B's "
             f"fp32 parameters and Adam moments)")
    try:
        rec = ckpt_run(CKPT_DIR)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"ckpt": rec})
    return rec


def sparse_train_path():
    """Run (f): OPT-1.3B at seq 8192 with the tutorial BigBird layout, K8
    twice per layer per step (the forward and remat's recompute)."""
    from deepspeed_tpu_torch.models.opt import opt_model
    from deepspeed_tpu_torch.ops.sparse_attention.block_sparse import (
        cached_layout)
    S, sc = RUN_F["seq"], bigbird()
    model = opt_model(MODEL, max_seq_len=S, sparse_attention=sc, remat=True,
                      loss_seq_chunks=RUN_F["loss_chunks"], dtype="bfloat16")
    layout = cached_layout(sc, S, causal=True)   # the one the model uses
    nb = S // sc.block
    return train_run(
        "f", model, TRAIN_F_CONFIG, RUN_F,
        {"block_sparse_attention_fwd": 2 * model.config.num_layers},
        route="train_batch, block-sparse",
        sparsity="BigBird " + json.dumps(BIGBIRD),
        active_blocks_per_head=int(layout[0].sum()),
        causal_density=float(layout[0].sum()) / (nb * (nb + 1) // 2))


def grad_compare(tag, bars, kernel_model, ref_model, ids, want,
                 ref_context=None):
    """Loss and every parameter's gradient of ``kernel_model`` against
    ``ref_model`` (the same weights) on ``ids``: the kernel model's launch
    counts must be ``want`` (kernels not named: 0); ``ref_context`` is
    entered around the reference's forward and backward."""
    import contextlib
    import torch
    losses = []
    reset_counts()
    for m, ctx in ((kernel_model, contextlib.nullcontext()),
                   (ref_model, ref_context or contextlib.nullcontext())):
        with ctx:
            loss = m({"input_ids": ids})
            loss.backward()
        losses.append(float(loss.detach()))
        if m is kernel_model:
            counts = read_counts()
    want = {**{name: 0 for name in counts}, **want}
    if counts != want:
        fail(f"{tag}: launches {counts}, the path needs {want}")
    # a key bias shifts every score of a row alike, which the softmax
    # ignores: its true gradient is 0 and both paths give roundoff
    cos = {name: float(torch.nn.functional.cosine_similarity(
        p.grad.flatten().float(), q.grad.flatten().float(), dim=0))
        for (name, p), (_, q) in zip(kernel_model.named_parameters(),
                                     ref_model.named_parameters())
        if not name.endswith("attn.k_proj.bias")}
    worst = min(cos, key=cos.get)
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    B, S = ids.shape
    rec = {"check": tag, "layers": kernel_model.config.num_layers,
           "batch": B, "seq": S, "loss_kernel": losses[0],
           "loss_reference": losses[1], "loss_rel_diff": rel,
           "min_grad_cosine": cos[worst], "min_grad_cosine_param": worst,
           "params": len(cos), "launches": counts}
    emit(rec)
    if not rel <= bars["loss_rel"]:
        fail(f"{tag}: losses differ by {rel} relative "
             f"(bar {bars['loss_rel']})")
    if not cos[worst] >= bars["cosine"]:
        fail(f"{tag}: gradient cosine {cos[worst]} for {worst} "
             f"(bar {bars['cosine']})")
    return rec


def grad_check():
    """Loss and gradients through K1 / K4 / K5 against the dense
    reference attention, on OPT-1.3B's widths cut to 2 layers, bf16."""
    import torch
    from deepspeed_tpu_torch.models.opt import opt_model
    n, B, S = (GRAD_CHECK[x] for x in ("layers", "batch", "seq"))
    kw = dict(device=DEV, num_layers=n, max_seq_len=S, remat=False,
              loss_seq_chunks=RUN_C["loss_chunks"], dtype="bfloat16")
    flash = opt_model(MODEL, use_flash_attention=True, **kw)
    flash.init_weights(torch.Generator(device=DEV).manual_seed(7))
    dense = opt_model(MODEL, use_flash_attention=False, **kw)
    dense.load_state_dict(flash.state_dict())
    g = torch.Generator(device=DEV).manual_seed(8)
    ids = torch.randint(0, flash.config.vocab_size, (B, S), generator=g,
                        device=DEV)
    rec = grad_compare("grad: K1/K4/K5 vs dense attention", GRAD_CHECK,
                       flash, dense, ids, {"flash_attention": n,
                                           "flash_attention_dq": n,
                                           "flash_attention_dkv": n})
    del flash, dense
    torch.cuda.empty_cache()
    return rec


@contextlib.contextmanager
def dense_masked_attention(sparsity_config):
    """Within: the model's block-sparse attention runs as dense attention
    masked by ``sparsity_config``'s layout (``sparse_attention_reference``,
    O(S^2)), the oracle of the sparse gradient check."""
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs

    def dense_masked(q, k, v, tables, block, scale=None, causal=False,
                     key_padding_mask=None):
        if key_padding_mask is not None:
            fail("the dense masked oracle takes no key-padding mask")
        layout = bs.cached_layout(sparsity_config, q.shape[1], causal=True)
        return bs.sparse_attention_reference(q, k, v, layout, block, scale,
                                             causal)

    kernel_path = bs.block_sparse_attention_tables
    bs.block_sparse_attention_tables = dense_masked
    try:
        yield
    finally:
        bs.block_sparse_attention_tables = kernel_path


def sparse_grad_check():
    """Loss and gradients through K8 and the gather backward against dense
    attention masked by the same layout, on OPT-1.3B's widths cut to 2
    layers at seq 2048, bf16, the same weights and batch."""
    import numpy as np
    import torch
    from deepspeed_tpu_torch.models.opt import opt_model
    from deepspeed_tpu_torch.ops.sparse_attention import block_sparse as bs
    n, B, S = (SPARSE_GRAD_CHECK[x] for x in ("layers", "batch", "seq"))
    kw = dict(device=DEV, num_layers=n, max_seq_len=S, remat=False,
              loss_seq_chunks=RUN_C["loss_chunks"], dtype="bfloat16")
    sparse = opt_model(MODEL, sparse_attention=bigbird(), **kw)
    sparse.init_weights(torch.Generator(device=DEV).manual_seed(13))
    dense_sc = bigbird()        # the same seed: the same layout
    dense = opt_model(MODEL, sparse_attention=dense_sc, **kw)
    dense.load_state_dict(sparse.state_dict())
    g = torch.Generator(device=DEV).manual_seed(14)
    ids = torch.randint(0, sparse.config.vocab_size, (B, S), generator=g,
                        device=DEV)
    rec = grad_compare(
        "grad: K8 + gather backward vs dense masked attention",
        SPARSE_GRAD_CHECK, sparse, dense, ids,
        {"block_sparse_attention_fwd": n}, dense_masked_attention(dense_sc))
    if not np.array_equal(bs.cached_layout(dense_sc, S, True),
                          bs.cached_layout(sparse.config.sparse_attention, S,
                                           True)):
        fail("sparse grad check: the two models' layouts differ")
    del sparse, dense
    torch.cuda.empty_cache()
    return rec


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port's smoke test runs only on a GPU")
    if not os.path.isdir(os.path.join(ROOT, "deepspeed_tpu_torch")):
        fail("deepspeed_tpu_torch/ is missing: run from a checkout of the "
             "repository")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.ops import op_builder

    t0 = time.perf_counter()
    logs = op_builder.build_all()
    build_s = time.perf_counter() - t0
    ptxas = sorted({line.strip() for log in logs.values()
                    for line in log.splitlines() if "registers" in line})
    emit({"build_seconds": build_s, "built": sorted(logs),
          "ptxas": ptxas})
    if "flash_attention_bwd" in logs:   # K4 / K5: every instantiation
        bwd_lib = op_builder.FLASH_BWD.load()

        def smem_of(name, kind, D):
            return bwd_lib.dstt_flash_attention_bwd_smem(
                0 if "_dq_" in name else 1,
                {"fp32": 0, "bf16": 1, "fp16": 2}[kind], D)

        emit({"ptxas_flash_bwd": ptxas_report(logs["flash_attention_bwd"],
                                              smem_of)})
    if "flash_attention" in logs:       # K1 / K3 / K7: every instantiation
        fwd_lib = op_builder.FLASH.load()

        def fwd_smem_of(kind, int8, D):
            return fwd_lib.dstt_flash_attention_fwd_smem(
                {"fp32": 0, "bf16": 1, "fp16": 2}[kind], int(int8), D)

        emit({"ptxas_flash_fwd": ptxas_report(logs["flash_attention"],
                                              fwd_smem_of, fwd_kernel_of)})
    if "decode_attention" in logs:      # K2 / K6: both decode templates
        dec_lib = op_builder.DECODE.load()

        def i8mm_smem_of(D, G, hpb, paged):
            return dec_lib.dstt_decode_i8mm_smem(D, G, hpb, int(paged),
                                                 I8MM_SMEM_BLOCK)

        emit({"ptxas_decode": ptxas_report(logs["decode_attention"],
                                           i8mm_smem_of, decode_kernel_of),
              "combine": "none: one kernel a call",
              "dynamic_smem": f"decode_kernel none (static); "
                              f"decode_i8mm_kernel at block_k "
                              f"{I8MM_SMEM_BLOCK}"})

    if "block_sparse_attention" in logs:   # K8: every instantiation
        sparse_lib = op_builder.SPARSE.load()

        def sparse_smem_of(kind, D, block):
            return sparse_lib.dstt_block_sparse_attention_fwd_smem(
                {"fp32": 0, "bf16": 1, "fp16": 2}[kind], D, block)

        emit({"ptxas_sparse": ptxas_report(logs["block_sparse_attention"],
                                           sparse_smem_of, sparse_kernel_of)})

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi unavailable ({smi.returncode})"
    print(card, flush=True)

    checks = {}
    for dtype in ("float32", "bfloat16"):
        timed = dtype == "bfloat16"
        checks[("K1", dtype)] = check_flash(dtype, timed)
        checks[("K2", dtype)] = check_decode(dtype, timed)
        torch.cuda.empty_cache()
        checks[("K3", dtype)] = check_chunk(dtype, timed)
        torch.cuda.empty_cache()
        bwd = check_flash_bwd(dtype, timed)
        for key in ("K4", "K5"):
            checks[(key, dtype)] = bwd[key]
        checks[("K1 train", dtype)] = bwd["K1"]
        torch.cuda.empty_cache()
        bwd = check_flash_bwd(dtype, timed, KB_D128_SHAPE)
        for key in ("K4", "K5"):
            checks[(key + " d128", dtype)] = bwd[key]
        checks[("K1 train d128", dtype)] = bwd["K1"]
        torch.cuda.empty_cache()
        checks[("K6", dtype)] = check_paged_decode(dtype, timed)
        checks[("K7", dtype)] = check_paged_chunk(dtype, timed)
        checks[("K3 verify", dtype)], checks[("K7 verify", dtype)] = \
            check_verify(dtype, timed)
        checks[("K8", dtype)] = check_block_sparse(dtype, timed)
        checks[("K2-int8", dtype)], checks[("K2-i8mm", dtype)] = \
            check_decode_int8(dtype, timed)
        checks[("K3-int8", dtype)] = check_chunk_int8(dtype, timed)
        checks[("K6-int8", dtype)], checks[("K6-i8mm", dtype)] = \
            check_paged_decode_int8(dtype, timed)
        checks[("K7-int8", dtype)] = check_paged_chunk_int8(dtype, timed)
        checks[("nan tail", dtype)] = check_nan_tail(dtype)
        checks[("K1 run i", dtype)] = check_flash(dtype, False, K1I_SHAPE)
        for key, rec in {**check_decode_window(dtype, timed),
                         **check_paged_decode_window(dtype, timed)}.items():
            checks[(key, dtype)] = rec
    # K1 / K2 / K3 / K6 / K7 at Llama-7B's width (runs (k), (l)), in bf16
    dtype = "bfloat16"
    checks[("K1 run k", dtype)] = check_flash(dtype, True, K1K_SHAPE)
    checks[("K2 run k", dtype)] = check_decode(dtype, True, K2K_SHAPE)
    torch.cuda.empty_cache()
    checks[("K3 run k", dtype)] = check_chunk(dtype, True, K3K_SHAPE)
    torch.cuda.empty_cache()
    checks[("K6 run l", dtype)] = check_paged_decode(dtype, True, K6L_SHAPE)
    checks[("K7 run l", dtype)] = check_paged_chunk(
        dtype, True, K7L_SHAPE, pool=K6L_SHAPE, extra=())
    torch.cuda.empty_cache()

    runs, eng, eng_e, tokens = main_path()
    serving_runs, outs_d = serving_path(eng, eng_e)
    runs.update(serving_runs)
    runs.update(spec_path(eng, eng_e))
    runs.update(lifecycle_path(eng, outs_d))
    del eng_e
    eng_g, eng_ge, eng_m = int8_generate_path(eng, tokens, runs)
    del eng
    torch.cuda.empty_cache()
    int8_serving_path(eng_g, eng_ge, eng_m, outs_d, runs)
    del eng_g, eng_ge, eng_m
    torch.cuda.empty_cache()
    runs.update(gpt_neo_path())
    runs.update(llama_path())
    emit({"graphs_vs_eager": graphs_vs_eager(runs)})
    runs["c"] = train_path()
    runs["c_ckpt"] = ckpt_path()
    grad_check()
    runs["f"] = sparse_train_path()
    sparse_grad_check()

    def timing(c):
        return {"max_abs_err": c["max_abs_err"], "ms": c["kernel_ms"],
                "call_ms": c["call_ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}

    def row(key, name, source, replaces, launches):
        check = checks[(key, "bfloat16")]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                **timing(check),
                **({"library": check["library"]} if "library" in check
                   else {})}

    csrc = "deepspeed_tpu_torch/ops/csrc/"
    pallas = "deepspeed_tpu/ops/transformer/"
    train = runs["c"]["launches"]
    kernels = [
        row("K1", "flash_attention", csrc + "flash_attention.cu",
            pallas + "flash_attention.py:175",
            runs["a"]["launches"]["flash_attention"]),
        row("K2", "decode_attention", csrc + "decode_attention.cu",
            pallas + "decode_attention.py:630",
            runs["a"]["launches"]["decode_attention"]),
        row("K3", "chunk_prefill_attention", csrc + "flash_attention.cu",
            pallas + "decode_attention.py:448",
            runs["b"]["launches"]["chunk_prefill_attention"]),
        row("K4", "flash_attention_dq", csrc + "flash_attention_bwd.cu",
            pallas + "flash_attention.py:388", train["flash_attention_dq"]),
        row("K5", "flash_attention_dkv", csrc + "flash_attention_bwd.cu",
            pallas + "flash_attention.py:421", train["flash_attention_dkv"]),
        row("K6", "paged_decode_attention", csrc + "decode_attention.cu",
            pallas + "paged_attention.py:206",
            runs["d"]["launches"]["paged_decode_attention"]),
        row("K7", "paged_chunk_prefill_attention", csrc + "flash_attention.cu",
            pallas + "paged_attention.py:293",
            runs["d"]["launches"]["paged_chunk_prefill_attention"]),
        row("K8", "block_sparse_attention", csrc + "block_sparse_attention.cu",
            "deepspeed_tpu/ops/sparse_attention/block_sparse.py:198",
            runs["f"]["launches"]["block_sparse_attention_fwd"]),
    ]
    for k in kernels[5:7]:
        k["library"] = LIBRARY_NOTE
    kernels[7]["launches_per_step"] = \
        runs["f"]["launches_per_step"]["block_sparse_attention_fwd"]
    kernels[7]["library"] = ("F.scaled_dot_product_attention with the "
                             "layout expanded to a boolean [S, S] mask")
    k8 = checks[("K8", "bfloat16")]
    kernels[7]["lse_max_abs_err"] = k8["lse_max_abs_err"]
    kernels[7]["variants"] = [
        {key: var[key] for key in (
            "case", "shape", "block", "max_abs_err", "lse_max_abs_err",
            "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
        for var in k8["variants"]]
    # the int8 modes: their own rows, launches from runs (g), (h)
    int8_rows = [
        row("K2-int8", "decode_attention_int8", csrc + "decode_attention.cu",
            pallas + "decode_attention.py:630",
            runs["g"]["launches"]["decode_attention_int8"]),
        row("K2-i8mm", "decode_attention_i8mm", csrc + "decode_attention.cu",
            pallas + "decode_attention.py:630",
            runs["g_i8mm"]["launches"]["decode_attention_i8mm"]),
        row("K3-int8", "chunk_prefill_attention_int8",
            csrc + "flash_attention.cu", pallas + "decode_attention.py:448",
            runs["g_b"]["launches"]["chunk_prefill_attention_int8"]),
        row("K6-int8", "paged_decode_attention_int8",
            csrc + "decode_attention.cu", pallas + "paged_attention.py:206",
            runs["h"]["launches"]["paged_decode_attention_int8"]),
        row("K6-i8mm", "paged_decode_attention_i8mm",
            csrc + "decode_attention.cu", pallas + "paged_attention.py:206",
            runs["h_i8mm"]["launches"]["paged_decode_attention_i8mm"]),
        row("K7-int8", "paged_chunk_prefill_attention_int8",
            csrc + "flash_attention.cu", pallas + "paged_attention.py:293",
            runs["h"]["launches"]["paged_chunk_prefill_attention_int8"]),
    ]
    int8_rows[0]["launches_run_g_b"] = \
        runs["g_b"]["launches"]["decode_attention_int8"]
    int8_rows[0]["launches_run_h_mono"] = \
        runs["h_mono"]["launches"]["decode_attention_int8"]
    int8_rows[2]["launches_run_h_mono"] = \
        runs["h_mono"]["launches"]["chunk_prefill_attention_int8"]
    kernels += int8_rows
    # the sliding-window modes, launches from GPT-Neo's runs (i), (j): all
    # replace B4's window mode (the JAX paged kernel has none; JAX runs B4
    # over the gathered view of a pool)
    for key, name, run in (
            ("K2-window", "decode_attention_window", "i"),
            ("K2-window-int8", "decode_attention_window_int8", "i_int8"),
            ("K2-window-i8mm", "decode_attention_window_i8mm", "i_i8mm"),
            ("K6-window", "paged_decode_attention_window", "j"),
            ("K6-window-int8", "paged_decode_attention_window_int8",
             "j_int8"),
            ("K6-window-i8mm", "paged_decode_attention_window_i8mm",
             "j_i8mm")):
        kernels.append(row(key, name, csrc + "decode_attention.cu",
                           pallas + "decode_attention.py:630",
                           runs[run]["launches"][name]))
    kernels[-6]["launches_run_i_chunked"] = \
        runs["i_chunked"]["launches"]["decode_attention_window"]
    kernels[-6]["launches_run_j_mono"] = \
        runs["j_mono"]["launches"]["decode_attention_window"]
    kernels[7]["gather_backward_ms"] = \
        checks[("K8", "bfloat16")]["gather_backward_ms"]
    # run (d)'s monolithic twin runs K2 and K3 at the serving shapes
    kernels[1]["launches_run_d_mono"] = \
        runs["d_mono"]["launches"]["decode_attention"]
    kernels[2]["launches_run_d_mono"] = \
        runs["d_mono"]["launches"]["chunk_prefill_attention"]
    kernels[1]["launches_run_b"] = runs["b"]["launches"]["decode_attention"]
    # K1 also runs in every layer of run (c), with the LSE, at [2, 2048]
    kernels[0]["launches_run_c"] = train["flash_attention"]
    # run (c-ckpt): the resumed engine's steps (K1 / K4 / K5) and the
    # generation from the tag (K1 / K2)
    ckpt = runs["c_ckpt"]
    for k in (kernels[0], kernels[3], kernels[4]):
        k["launches_run_c_ckpt"] = ckpt["launches"][k["name"]]
    for k in kernels[:2]:
        k["launches_run_c_ckpt_serve"] = \
            ckpt["serve"]["from_tag"]["launches"][k["name"]]
    k1c = checks[("K1 train", "bfloat16")]
    kernels[0]["run_c_shape"] = {**timing(k1c), "tflops": k1c["tflops"]}
    d128 = checks[("K1 train d128", "bfloat16")]
    kernels[0]["run_c_shape_d128"] = {**timing(d128), "shape": d128["shape"],
                                      "tflops": d128["tflops"]}
    # runs (k) and (l): Llama-7B's width (32 heads of 128, 32 layers)
    for k, key, ran in ((kernels[0], "K1 run k", (("k", "flash_attention"),
                                                  ("k_gqa",
                                                   "flash_attention"))),
                        (kernels[1], "K2 run k", (
                            ("k", "decode_attention"),
                            ("k_chunked", "decode_attention"),
                            ("l_mono", "decode_attention"),
                            ("k_gqa", "decode_attention"))),
                        (kernels[2], "K3 run k", (
                            ("k_chunked", "chunk_prefill_attention"),
                            ("l_mono", "chunk_prefill_attention"))),
                        (kernels[5], "K6 run l", (
                            ("l", "paged_decode_attention"),)),
                        (kernels[6], "K7 run l", (
                            ("l", "paged_chunk_prefill_attention"),))):
        check = checks[(key, "bfloat16")]
        k["llama_shape"] = {
            **timing(check),
            "shape": {x: check[x] for x in ("shape", "cache", "q", "pool",
                                            "table", "timed_shape")
                      if x in check},
            **{f"launches_run_{run}": runs[run]["launches"][name]
               for run, name in ran}}
    # run (m): the verify's K3 (lanes) / K7 (pool) at B = 16, C = 5, and
    # the draft's K2; launches counted over the whole run and, apart, in
    # the verify and the propose program's own calls
    for k, key, run, name in ((kernels[2], "K3 verify", "m_self",
                               "chunk_prefill_attention"),
                              (kernels[6], "K7 verify", "m_self_paged",
                               "paged_chunk_prefill_attention")):
        check = checks[(key, "bfloat16")]
        k["verify_shape"] = {
            **timing(check), "library": check["library"],
            "shape": {x: check[x] for x in ("q", "cache", "pool", "table")
                      if x in check},
            "launches_verify_run_" + run:
                runs[run]["program_launches"]["verify"][name],
            "launches_run_" + run: runs[run]["launches"][name]}
    # run (n-overload): K6 / K7 through deadlines, cancels, a blocking
    # queue and one absorbed dispatch failure
    for k, name in ((kernels[5], "paged_decode_attention"),
                    (kernels[6], "paged_chunk_prefill_attention")):
        k["launches_run_n_overload"] = runs["n_overload"]["launches"][name]
    kernels[1]["launches_run_m_self_draft"] = \
        runs["m_self"]["program_launches"]["propose"]["decode_attention"]
    kernels[1]["launches_run_m_draft_opt125m"] = \
        runs["m_draft"]["program_launches"]["propose"]["decode_attention"]
    for key, k in zip(("K4", "K5"), kernels[3:5]):
        k["launches_per_step"] = runs["c"]["launches_per_step"][k["name"]]
        check = checks[(key, "bfloat16")]
        k.update(tflops=check["tflops"], pair_ms=check["pair_ms"],
                 library="SDPA's whole backward (dq, dk, dv in one call)")
        d128 = checks[(key + " d128", "bfloat16")]
        k["d128_shape"] = {**timing(d128), "shape": d128["shape"],
                           "tflops": d128["tflops"],
                           "pair_ms": d128["pair_ms"]}
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
