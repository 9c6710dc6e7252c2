"""Continuous-batching serving engine — iteration-level scheduling over an
``InferenceEngine`` (port of the scheduler core of
``deepspeed_tpu/inference/serving/engine.py``).

The scheduler loop per iteration (:meth:`ServingEngine.step`):

1. **Admission** — while a slot is free and the queue is not empty, pop a
   request (``fcfs`` or ``shortest_first``) and stream its prompt through
   the model in ``prefill_chunk``-token chunks — into a single-lane cache,
   or straight into the slot's pages of the shared pool — spending at most
   ``prefill_token_budget`` prompt tokens per iteration.  A finished
   prefill is admitted by one admit call (first-token sample, lane copy
   for monolithic lanes, slot-state write).
2. **Decode** — one :func:`~.slots.decode_block` advances every slot
   ``decode_block`` tokens: with the engine's ``enable_cuda_graph`` (the
   default) a CUDA graph of the whole block, captured at the first
   dispatch (or by :meth:`ServingEngine.warmup`) and replayed after.
   Lanes that emit their ``eos`` or exhaust ``max_new_tokens`` retire
   on the device; the host mirrors the retirement from the emitted
   tokens, frees their slots (and pages) mid-flight and hands them to the
   queue — no request waits for a batch to finish.

**Lag-one events.**  The slot state lives on the device and every call
chains through it in stream order, so the host never waits on the device
inside the dispatch path: it dispatches the next decode block first and
only then reads the PREVIOUS block's tokens, which were copied to pinned
host memory with ``non_blocking=True`` behind a CUDA event.  The device
runs while the host does its bookkeeping; ``stats["sync_secs"]`` is the
time the host did wait on such an event.  The price is that a slot freed
in block N is re-admitted from block N+2 on.

**Paged KV pool** (``serving.paged``): one pool ``[L, num_pages,
page_size, KVH*D]`` plus per-slot block tables that the host owns
(:mod:`.paging`) and copies into one static device table (the captured
block reads it) for each dispatch; decode runs
K6 through the table, admission prefill K7.  Pool pressure turns into
admission backpressure (a request waits at the queue head until pages
free up), and hash-matched prompt prefixes map to the same refcounted
pages, prefilled once.

One thread drives the scheduler (``submit`` / ``step`` / ``drain`` /
``close`` are not thread-safe).  The JAX engine's speculative decoding,
SLO layer (deadlines, bounded queue, breaker, drain timeouts, preemption,
snapshots), owner binding and instrumented lock, token streams, HTTP
front end, fairness, priority lanes, tracing and memory telemetry are not
ported yet.
"""

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.serving import slots
from deepspeed_tpu_torch.model_implementations.features.cuda_graph import (
    CompiledGraphModule)
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.paging import (PagePool,
                                                          PrefixIndex,
                                                          pages_for)
from deepspeed_tpu_torch.inference.serving.slo import (RequestResult,
                                                       RequestStatus,
                                                       TERMINAL_STATUSES)
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclass
class ServeRequest:
    """One queued / running request (host bookkeeping only)."""
    rid: int
    ids: np.ndarray                  # [P] int32 prompt
    max_new: int
    eos: int                         # -1 = never stop early
    submitted_it: int = 0
    tokens: list = field(default_factory=list)
    slot: Optional[int] = None
    finished_it: Optional[int] = None
    status: str = RequestStatus.QUEUED
    submit_t: float = 0.0
    first_tok_t: Optional[float] = None


class _PendingPrefill:
    """An admission in progress: the slot is reserved and the prompt
    streams chunk by chunk across scheduler iterations."""

    def __init__(self, req, slot, lane, ids_pad, n_chunks, fill_len):
        self.req, self.slot, self.lane = req, slot, lane
        self.ids_pad = ids_pad           # [1, n_chunks*C] int64
        self.n_chunks = n_chunks
        self.fill_len = fill_len         # real prompt positions
        self.ci = 0                      # chunks completed
        self.sel = None                  # last-real-position logits [1,1,V]
        # paged admission: prefill starts at the shared-prefix boundary
        # (chunk-aligned); positions below it are served by shared pages
        self.start = 0
        self.fill_tokens = None          # the prompt (prefix registration)


class _LanePool:
    """Reusable single-lane prefill caches ``[L, 1, cache_len, KVH*D]``.
    Several admissions can be in flight at once (a lane is given back when
    its admit event is processed, one event behind), so this is a pool."""

    def __init__(self, module):
        self._module = module
        self._lanes = []

    def take(self, cache_len, dtype):
        if self._lanes:
            return self._lanes.pop()
        return self._module.init_cache(1, cache_len, dtype=dtype)

    def give_back(self, lane):
        if lane is not None:             # paged admissions have no lane
            self._lanes.append(lane)

    def release(self):
        self._lanes.clear()


class ServingEngine:
    """Slot-based continuous batching over an ``InferenceEngine``.

    ``submit()`` enqueues a request and returns its id; ``step()`` runs one
    scheduler iteration; ``drain()`` loops until everything submitted has
    finished and returns ``{rid: np.ndarray}``, each output following the
    ``generate()`` contract ``[prompt..., generated...]`` of length
    ``len(prompt) + max_new_tokens`` (eos-padded past an early stop)."""

    def __init__(self, engine, **overrides):
        engine._require_params()
        cfg = engine._config.serving
        if overrides:
            cfg = ServingConfig(**{**cfg.to_dict(), **overrides})
        self.engine = engine
        self.module = engine.module
        self.device = engine.device
        self.config = cfg
        self.num_slots = int(cfg.num_slots)
        if self.num_slots < 1:
            raise ValueError(f"serving.num_slots={cfg.num_slots}: need >= 1")
        # lane length: a multiple of 8, as in the JAX package
        self.cache_len = -(-int(cfg.max_cache_len) // 8) * 8
        # admission chunk: multiple of 8, floor 8, cap 512 (the chunk
        # kernel's longest block)
        self.chunk = min(512, max(8, -(-int(cfg.prefill_chunk) // 8) * 8))
        self.block = max(1, int(cfg.decode_block))
        self.paged = bool(cfg.paged)
        if self.paged:
            # page size: multiple of 8, floor 8; the virtual lane rounds up
            # to whole pages
            self.page = max(8, -(-int(cfg.page_size) // 8) * 8)
            self.cache_len = -(-self.cache_len // self.page) * self.page
            self.n_slot_pages = self.cache_len // self.page
            # pool size incl. the trash page 0; auto = worst case
            self.num_pages = int(cfg.num_pages) \
                or self.num_slots * self.n_slot_pages + 1
            if self.num_pages < 2:
                raise ValueError(f"serving.num_pages={cfg.num_pages}: need "
                                 f">= 2 (trash + 1 allocatable)")
        max_seq = self.module.config.max_seq_len
        if self.cache_len > max_seq:
            logger.warning(
                f"serving lanes hold {self.cache_len} positions but the "
                f"model's max_seq_len is {max_seq}: requests are held to "
                f"{max_seq} positions")
        # positions a request may reach, and where dead lanes clamp theirs:
        # the lane, and the model's max_seq_len.  For a learned position
        # table that is its size (the JAX gather clamps an out-of-range
        # position; PyTorch's embedding faults on it).  A rotary model has
        # no table and computes any position, but max_seq_len is the
        # context it was made for, so it is held to it the same way
        self.max_pos = min(self.cache_len, max_seq)
        from deepspeed_tpu_torch.inference.engine import build_sample_fn
        from deepspeed_tpu_torch.ops.transformer.registry import kernel_modes
        self._sample_fn = build_sample_fn(bool(cfg.do_sample),
                                          float(cfg.temperature),
                                          int(cfg.top_k), float(cfg.top_p))
        # which attention kernel each program class runs (the registry's
        # own probes: what the model dispatches)
        self.kernel_modes = kernel_modes(paged=self.paged)
        self._lane_pool = _LanePool(self.module)
        if self.paged:
            self._pool = PagePool(self.num_pages)
            self._prefix = PrefixIndex()
            # host-owned block tables, copied to the device per dispatch;
            # 0 = the trash page
            self._page_table = np.zeros(
                (self.num_slots, self.n_slot_pages), np.int32)
            self._slot_pages = {}        # slot -> [page ids]
        self._cache = None               # slot lanes, or the page pool
        self._state = None               # device-resident slot state
        self._pages_dev = None           # the static device block table
        # the decode block, captured per (cache, state, table) buffers: one
        # graph per server, as JAX compiles one program per signature
        self._decode_prog = CompiledGraphModule(
            slots.decode_block,
            enable_cuda_graph=engine._config.enable_cuda_graph,
            donate_argnums=(1, 2, 7))
        # host mirror of slot occupancy, updated as events are PROCESSED
        # (it lags the device by the in-flight events — by design)
        self._mirror_active = np.zeros((self.num_slots,), bool)
        self._slots = [None] * self.num_slots
        self._free = deque(range(self.num_slots))
        self._queue = deque()
        self._pending = None
        # dispatched-but-unprocessed device work, processed FIFO one event
        # behind the newest dispatch: ("decode", toks, event) |
        # ("admit", req, slot, lane, first, event), the tensors on the host
        # once their event has fired
        self._events = deque()
        self._gen = engine._accel.manual_seed(int(cfg.seed), self.device)
        self._next_rid = 0
        self._it = 0
        self._requests = {}
        self._results = {}
        self._closed = False
        self.stats = {"iterations": 0, "decode_calls": 0,
                      "decode_tokens": 0, "prefill_tokens": 0,
                      "completed": 0, "admitted": 0, "aborted": 0,
                      "wall_secs": 0.0, "sync_secs": 0.0,
                      "prefix_lookups": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "page_evictions": 0,
                      "admission_stalls": 0,
                      # the JAX key for paged decodes that skipped the
                      # paged kernel: always 0, a pool always runs K6/K7
                      "paged_attention_fallback": 0}
        self.occupancy_trace = []        # (it, n_active)
        log_dist(f"serving engine: {self.num_slots} slots x "
                 f"{self.cache_len} positions, "
                 + (f"paged ({self.num_pages} pages of {self.page})"
                    if self.paged else "monolithic lanes")
                 + f", kernels {self.kernel_modes}", ranks=[0])

    # ------------------------------------------------------------------ #
    # Public API
    # ------------------------------------------------------------------ #
    def submit(self, input_ids, max_new_tokens=32, eos_token_id=-1):
        """Enqueue one prompt (1-D ids in the vocabulary: a list, numpy
        array or tensor); returns the request id.  A request must fit a slot:
        ``ceil(P/chunk)*chunk`` and ``P + max_new_tokens`` positions (and,
        paged, that many pages of the pool) — one that never can is refused
        with ``ValueError``."""
        if self._closed:
            raise RuntimeError("submit() on a closed ServingEngine; create "
                               "a fresh server with engine.serve()")
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        P, max_new = int(ids.shape[0]), int(max_new_tokens)
        if P < 1:
            raise ValueError("empty prompt")
        V = self.module.config.vocab_size
        if int(ids.min()) < 0 or int(ids.max()) >= V:
            # the embedding would fault on the card (a device-side assert)
            raise ValueError(f"prompt token ids must lie in [0, {V})")
        if max_new < 1:
            raise ValueError(f"max_new_tokens={max_new}: need >= 1")
        padded = -(-P // self.chunk) * self.chunk
        need = max(P + max_new, padded)
        if need > self.max_pos:
            raise ValueError(
                f"request needs {need} cache positions (prompt {P} + new "
                f"{max_new}, chunk-padded {padded}) but slots hold "
                f"{self.max_pos} — raise serving.max_cache_len or split the "
                f"request")
        if self.paged and pages_for(need, self.page) > self._pool.allocatable:
            raise ValueError(
                f"request needs {pages_for(need, self.page)} pages ({need} "
                f"positions at page_size={self.page}) but the pool holds "
                f"{self._pool.allocatable} allocatable pages (num_pages="
                f"{self.num_pages} incl. trash) — raise serving.num_pages or "
                f"split the request")
        req = ServeRequest(self._next_rid, ids, max_new, int(eos_token_id),
                           submitted_it=self._it, submit_t=time.monotonic())
        self._next_rid += 1
        self._queue.append(req)
        self._requests[req.rid] = req
        return req.rid

    def result(self, rid):
        """The :class:`~.slo.RequestResult` of a finished request, or None
        while it runs.  Raises ``KeyError`` for an id never issued."""
        if rid not in self._requests:
            raise KeyError(f"unknown request id {rid!r}")
        return self._results.get(rid)

    def step(self):
        """One scheduler iteration: admission prefill under the token
        budget, one decode-block dispatch, then the device results one
        event behind.  Returns ``{rid: output}`` for every request that
        finished in this iteration."""
        if self._closed:
            raise RuntimeError("step() on a closed ServingEngine")
        t0 = time.perf_counter()
        self._ensure_workspace()
        finished = {}
        self._admit()
        dispatched = self._dispatch_decode()
        # lag-one: with fresh work in flight, leave the newest event unread
        # so the device keeps running while the host does bookkeeping; once
        # nothing new was dispatched, flush fully
        self._process_events(finished, keep=1 if dispatched else 0)
        self.stats["iterations"] += 1
        self.stats["wall_secs"] += time.perf_counter() - t0
        self._it += 1
        return finished

    def work_pending(self):
        """True while anything submitted has not finished: queued,
        mid-prefill, dispatched or live on the host mirror."""
        return bool(self._queue or self._pending is not None or self._events
                    or self._mirror_active.any())

    def drain(self):
        """Run the scheduler until every submitted request has finished;
        returns ``{rid: output}`` for everything that finished during the
        call."""
        results = {}
        while self.work_pending():
            results.update(self.step())
        return results

    def close(self):
        """Retire the server: every undrained request ends ``ABORTED``, the
        KV workspaces are freed, and ``submit()`` / ``step()`` raise
        afterwards.  Returns the sorted ids of the requests aborted
        (idempotent: later calls return [])."""
        if self._closed:
            return []
        finished = {}
        self._process_events(finished, keep=0)
        undrained = sorted(
            [r.rid for r in self._slots if r is not None]
            + ([self._pending.req.rid] if self._pending is not None else [])
            + [r.rid for r in self._queue])
        for req in self._queue:
            self._record_abort(req, "engine closed with the request queued")
        self._queue.clear()
        self._abort_in_flight("close()")
        self._cache = None
        self._lane_pool.release()
        self._closed = True
        return undrained

    @property
    def queue_depth(self):
        return len(self._queue) + (1 if self._pending is not None else 0)

    @property
    def active_slots(self):
        """Live slots as of the last PROCESSED event (the host mirror)."""
        return int(np.sum(self._mirror_active))

    @property
    def in_flight(self):
        """Dispatched device events not yet processed."""
        return len(self._events)

    @property
    def page_pool_utilization(self):
        """Allocated fraction of the page pool (0.0 when not paged)."""
        return self._pool.utilization() if self.paged else 0.0

    @property
    def prefix_hit_rate(self):
        """Fraction of prefix lookups that matched >= 1 page."""
        n = self.stats["prefix_lookups"]
        return self.stats["prefix_hits"] / n if n else 0.0

    # ------------------------------------------------------------------ #
    # Host <-> device without waiting on the device
    # ------------------------------------------------------------------ #
    def _upload_table(self):
        """The host block tables into the static device table, from a
        pinned snapshot without waiting (the host may change the tables
        right after; the copy runs in stream order before the block)."""
        host = torch.from_numpy(np.array(self._page_table))
        if self.device.type == "cpu":
            self._pages_dev.copy_(host)
        else:
            self._pages_dev.copy_(host.pin_memory(), non_blocking=True)
        return self._pages_dev

    def _to_device(self, arr):
        """A host array as a fresh device tensor.  On a card the copy reads
        a pinned snapshot of ``arr`` asynchronously, so the host may change
        ``arr`` right after (the block tables do)."""
        host = torch.from_numpy(np.array(arr))
        if self.device.type == "cpu":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t):
        """Start copying a device tensor to pinned host memory; returns
        ``(host tensor, event)`` — read the host tensor after
        ``event.synchronize()`` (event None on the CPU)."""
        if t.device.type == "cpu":
            return t, None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return host, ev

    def _read(self, host, ev):
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        out = host.numpy()
        self.stats["sync_secs"] += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------ #
    # Paging bookkeeping
    # ------------------------------------------------------------------ #
    def _release_slot_pages(self, slot):
        """Paged: return a retired slot's pages to the pool (shared prefix
        pages drop one reference) and point its table row at the trash
        page — the next dispatch's table sends the zombie lane's masked
        writes there, so a freed page can be handed on at once (a write the
        zombie already has queued runs in stream order BEFORE the new
        occupant's prefill)."""
        if not self.paged:
            return
        pages = self._slot_pages.pop(int(slot), None)
        if pages is not None:
            for pg in pages:
                self._pool.decref(pg)
        self._page_table[int(slot), :] = 0

    def _paging_reset(self):
        """Drop every page mapping (pool bookkeeping, prefix index, table
        rows): the pool buffer was just (re)allocated."""
        if not self.paged:
            return
        self._prefix.clear(self._pool)
        self._pool.reset()
        self._page_table[:] = 0
        self._slot_pages.clear()

    def _record_abort(self, req, detail):
        req.status = RequestStatus.ABORTED
        req.finished_it = self._it
        self.stats["aborted"] += 1
        self._results[req.rid] = RequestResult(
            rid=req.rid, status=RequestStatus.ABORTED, detail=detail,
            submitted_it=req.submitted_it, finished_it=self._it)

    def _abort_in_flight(self, why):
        """Drop every request past admission and restore the slot
        bookkeeping to all-free; queued requests survive.  The next step
        starts on a fresh workspace."""
        lost = [r for r in self._slots if r is not None]
        if self._pending is not None:
            lost.append(self._pending.req)
            self._lane_pool.give_back(self._pending.lane)
            self._pending = None
        for req in lost:
            if req.status not in TERMINAL_STATUSES:
                self._record_abort(req, f"in-flight request aborted: {why}")
        self._events.clear()
        self._slots = [None] * self.num_slots
        self._free = deque(range(self.num_slots))
        self._mirror_active[:] = False
        self._state = None
        self._decode_prog.reset()
        self._paging_reset()
        if lost:
            logger.warning(f"serving {why}: aborted {len(lost)} in-flight "
                           f"request(s) {sorted(r.rid for r in lost)}")

    def _ensure_workspace(self):
        if self._cache is None:
            self._decode_prog.reset()    # its graphs read the old buffers
            dtype = self.engine.compute_dtype
            if self.paged:
                self._cache = self.module.init_paged_cache(
                    self.num_pages, self.page, dtype=dtype)
                self._pages_dev = torch.zeros(
                    (self.num_slots, self.n_slot_pages), dtype=torch.int32,
                    device=self.device)
                self._paging_reset()
            else:
                self._cache = self.module.init_cache(
                    self.num_slots, self.cache_len, dtype=dtype)
        if self._state is None:
            self._state = slots.init_slot_state(self.num_slots, self.device)
            self._mirror_active[:] = False

    def _guarded(self, fn, *args):
        """Run one device call; on a failure the workspace may hold half a
        step, so every request past admission is aborted (the queue
        survives), the workspace and the decode graphs captured on it are
        dropped, and the error propagates."""
        try:
            return fn(*args)
        except BaseException:
            self._cache = None
            self._abort_in_flight("dispatch failed")
            raise

    # ------------------------------------------------------------------ #
    # Admission: queue -> prefill chunks -> admit
    # ------------------------------------------------------------------ #
    def _pop_request(self):
        if self.config.admission == "shortest_first":
            req = min(self._queue, key=lambda r: (len(r.ids), r.rid))
            self._queue.remove(req)
            return req
        return self._queue.popleft()

    def _admit(self):
        limit = self.config.prefill_token_budget or math.inf
        spent = 0
        while spent < limit:
            if self._pending is None:
                if not self._queue or not self._free:
                    return
                req = self._pop_request()
                pend = self._start_prefill(req)
                if pend is None:
                    # pool pressure: not enough free pages even after
                    # evicting unreferenced prefix pages — the request waits
                    # at the queue head until retirements free pages
                    self._queue.appendleft(req)
                    self.stats["admission_stalls"] += 1
                    return
                self._pending = pend
            done = self._run_prefill_chunk(self._pending)
            spent += self.chunk
            if done:
                pend, self._pending = self._pending, None
                self._dispatch_admit(pend)

    def _start_prefill(self, req):
        P = len(req.ids)
        if self.paged:
            return self._start_prefill_paged(req, P)
        slot = self._free.popleft()
        req.slot = slot
        req.status = RequestStatus.PREFILLING
        n = -(-P // self.chunk)
        ids_pad = np.zeros((1, n * self.chunk), np.int64)
        ids_pad[0, :P] = req.ids
        lane = self._lane_pool.take(self.cache_len, self.engine.compute_dtype)
        return _PendingPrefill(req, slot, lane, ids_pad, n, P)

    def _start_prefill_paged(self, req, P):
        """Paged admission: map the longest indexed prefix (full pages,
        refcounted — prefilled ONCE per unique prefix), allocate private
        pages for the rest of the virtual lane, and prefill only from the
        shared boundary on.  Returns ``None`` (nothing popped, nothing
        allocated) when the pool cannot back the request yet."""
        fill = req.ids
        matched = []
        if self.config.prefix_cache:
            # cap the match so the block holding the LAST prompt position
            # is always recomputed: admission samples the first token from
            # that position's logits
            matched = self._prefix.lookup(fill, self.page, self._pool,
                                          (P - 1) // self.page)
        m = len(matched)
        # the prefill start must be CHUNK-aligned, not just page-aligned:
        # chunk ci writes the whole padded span [s0+ci*C, s0+(ci+1)*C), and
        # only a chunk-aligned s0 keeps its end at ceil(P/C)*C, the bound
        # submit() checked (page 16, chunk 64, P = 120, m = 7 would pad to
        # 176 > the 8-page lane)
        g = self.chunk // math.gcd(self.page, self.chunk)
        if m % g:
            for pg in matched[(m // g) * g:]:
                self._pool.decref(pg)
            matched = matched[:(m // g) * g]
            m = len(matched)
        s0 = m * self.page               # prefill start
        n_chunks = -(-(P - s0) // self.chunk)
        # the slot's virtual extent: decode writes through P+max_new-1, the
        # padded last chunk through s0+n_chunks*C-1 — those pages are the
        # slot's own
        virt = max(P + req.max_new, s0 + n_chunks * self.chunk)
        need_private = pages_for(virt, self.page) - m
        got = self._pool.alloc(need_private)
        if got is None and self.config.prefix_cache:
            freed = self._prefix.evict(
                self._pool, need_private - self._pool.free_count)
            self.stats["page_evictions"] += freed
            got = self._pool.alloc(need_private)
        if got is None:
            for pg in matched:
                self._pool.decref(pg)
            return None
        if self.config.prefix_cache:
            # count ADMISSIONS, not stalled retries of one request
            self.stats["prefix_lookups"] += 1
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += m * self.page
        slot = self._free.popleft()
        req.slot = slot
        req.status = RequestStatus.PREFILLING
        row = matched + got
        self._slot_pages[slot] = row
        self._page_table[slot, :] = 0
        self._page_table[slot, :len(row)] = row
        ids_pad = np.zeros((1, n_chunks * self.chunk), np.int64)
        ids_pad[0, :P - s0] = fill[s0:]
        pend = _PendingPrefill(req, slot, None, ids_pad, n_chunks, P)
        pend.start = s0
        pend.fill_tokens = fill
        return pend

    def _run_prefill_chunk(self, p):
        C = self.chunk
        P = p.fill_len
        # chunk ci covers positions [start + ci*C, start + (ci+1)*C)
        local = int(min(max(P - 1 - p.start - p.ci * C, 0), C - 1))
        ids = self._to_device(p.ids_pad[:, p.ci * C:(p.ci + 1) * C])
        at = torch.full((1,), local, dtype=torch.long, device=self.device)
        start = p.start + p.ci * C
        if self.paged:
            row = self._to_device(self._page_table[p.slot:p.slot + 1])
            logits = self._guarded(slots.paged_chunk, self.module,
                                   self._cache, row, ids, start, at)
        else:
            logits = self._guarded(slots.prefill_chunk, self.module, p.lane,
                                   ids, start, at)
        if (P - 1 - p.start) // C == p.ci:
            # this chunk holds the prompt's last real position: its logits
            # seed the first token (never read on the host here)
            p.sel = logits
        p.ci += 1
        self.stats["prefill_tokens"] += C
        return p.ci >= p.n_chunks

    def _dispatch_admit(self, p):
        """Prefill complete: one admit call samples the first token (and,
        monolithic, copies the lane into the slot) and writes the slot
        state on the device; the first token is read when the event is
        processed."""
        req = p.req
        sample = (p.sel, p.slot, p.fill_len, req.max_new, req.eos,
                  self._sample_fn, self._gen)
        if self.paged:
            first = self._guarded(slots.paged_admit, self._state, *sample)
        else:
            first = self._guarded(slots.admit, self._cache, self._state,
                                  p.lane, *sample)
        if self.paged and self.config.prefix_cache:
            # index this request's full-prompt pages as sharable: their
            # prefill writes were dispatched before this admit, and nothing
            # writes them again (the slot's own writes land at positions
            # >= fill_len)
            self._prefix.register(p.fill_tokens, self.page,
                                  self._slot_pages[p.slot], self._pool,
                                  p.fill_len // self.page)
        req.status = RequestStatus.RUNNING
        self._slots[p.slot] = req
        self._events.append(("admit", req, p.slot, p.lane,
                             *self._to_host(first)))
        self.stats["admitted"] += 1

    # ------------------------------------------------------------------ #
    # Decode: one block over every slot
    # ------------------------------------------------------------------ #
    def _dispatch_decode(self):
        # dispatch when anything can be live on the device: a slot active
        # as of the mirror, or an unprocessed admit that probably went live
        if not (self._mirror_active.any()
                or any(e[0] == "admit" for e in self._events)):
            return False
        toks = self._guarded(self._decode_prog, *self._decode_args())
        self._events.append(("decode", *self._to_host(toks)))
        self.stats["decode_calls"] += 1
        return True

    def _decode_args(self):
        pages = self._upload_table() if self.paged else None
        return (self.module, self._cache, self._state, self.block,
                self.max_pos, self._sample_fn, self._gen, pages)

    # ------------------------------------------------------------------ #
    # Warmup: capture the decode block up front
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def warmup(self):
        """Run the admission-prefill chunk once and capture the decode
        block before the first request, so that no request pays for them.
        Returns ``{program: seconds}`` under the JAX engine's names
        (``serving_prefill[_paged]:...``, ``serving_decode[_paged]:...``);
        0.0 for both when the block was captured already.

        The prefill chunk runs eagerly (it has no graph): its seconds are a
        first run's.  Unlike JAX's abstract AOT compile, the capture runs
        a real block over the idle server's free lanes: their writes land
        on the trash page (paged) or in free lanes' rows that every read
        masks, the slot state is reset afterwards and the sampling
        generator restored, so the served tokens are unchanged.  Raises
        ``RuntimeError`` once requests are in flight."""
        if self._closed:
            raise RuntimeError("warmup() on a closed ServingEngine")
        if self.work_pending():
            raise RuntimeError("warmup() needs an idle server: call it "
                               "before submit()")
        self._ensure_workspace()
        N, S, C = self.num_slots, self.cache_len, self.chunk
        if self.paged:
            names = (f"serving_prefill_paged:c{C}p{self.page}",
                     f"serving_decode_paged:n{N}s{S}b{self.block}"
                     f"p{self.page}")
        else:
            names = (f"serving_prefill:c{C}",
                     f"serving_decode:n{N}s{S}b{self.block}")
        args = self._decode_args()
        if self._decode_prog.has_graph(*args):
            return {name: 0.0 for name in names}
        accel = self.engine._accel
        ids = torch.zeros((1, C), dtype=torch.long, device=self.device)
        at = torch.full((1,), C - 1, dtype=torch.long, device=self.device)
        gen_state = self._gen.get_state()
        report = {}
        try:
            accel.synchronize(self.device)
            t0 = time.perf_counter()
            if self.paged:
                # an all-trash table row: the chunk writes the trash page
                row = torch.zeros((1, self.n_slot_pages), dtype=torch.int32,
                                  device=self.device)
                self._guarded(slots.paged_chunk, self.module, self._cache,
                              row, ids, 0, at)
            else:
                lane = self._lane_pool.take(self.cache_len,
                                            self.engine.compute_dtype)
                self._guarded(slots.prefill_chunk, self.module, lane, ids, 0,
                              at)
                self._lane_pool.give_back(lane)
            accel.synchronize(self.device)
            t1 = time.perf_counter()
            self._guarded(self._decode_prog, *args)
            accel.synchronize(self.device)
            report = {names[0]: t1 - t0, names[1]: time.perf_counter() - t1}
        finally:
            self._gen.set_state(gen_state)
            if self._state is not None:
                slots.reset_slot_state(self._state)
        for name, dt in report.items():
            log_dist(f"serving warmup[{name}]: {dt:.3f}s", ranks=[0])
        return report

    # ------------------------------------------------------------------ #
    # Event processing (the host's lagging mirror of the device)
    # ------------------------------------------------------------------ #
    def _process_events(self, finished, keep=0):
        while len(self._events) > keep:
            ev = self._events.popleft()
            if ev[0] == "admit":
                self._process_admit(ev, finished)
            else:
                self._process_decode(ev, finished)

    def _process_admit(self, ev, finished):
        _, req, slot, lane, first_host, event = ev
        first = int(self._read(first_host, event))
        self._lane_pool.give_back(lane)
        if req.first_tok_t is None:
            req.first_tok_t = time.monotonic()
        req.tokens = [first]
        # mirror the admit's activation rule
        if (req.eos >= 0 and first == req.eos) or req.max_new == 1:
            self._free_slot(slot)
            finished[req.rid] = self._finalize(req)
        else:
            self._mirror_active[slot] = True

    def _free_slot(self, s):
        self._mirror_active[s] = False
        self._slots[s] = None
        self._free.append(int(s))
        self._release_slot_pages(s)

    def _process_decode(self, ev, finished):
        toks = self._read(ev[1], ev[2])                  # [block, N]
        # mirror the in-program retirement rule step by step: an emitted
        # eos (or max_new reached) ends the request and frees its slot
        for row in toks:
            for s in np.nonzero(self._mirror_active)[0]:
                req = self._slots[s]
                tok = int(row[s])
                req.tokens.append(tok)
                self.stats["decode_tokens"] += 1
                if (req.eos >= 0 and tok == req.eos) \
                        or len(req.tokens) >= req.max_new:
                    self._free_slot(s)
                    finished[req.rid] = self._finalize(req)
        self.occupancy_trace.append(
            (self._it, int(self._mirror_active.sum())))

    def _finalize(self, req):
        """The ``generate()`` output contract: ``[prompt..., tokens...]`` of
        length ``P + max_new_tokens``, eos-padded past an early stop."""
        req.finished_it = self._it
        req.status = RequestStatus.COMPLETED
        self.stats["completed"] += 1
        P = len(req.ids)
        pad = req.eos if req.eos >= 0 else 0
        out = np.full((P + req.max_new,), pad, np.int32)
        out[:P] = req.ids
        out[P:P + len(req.tokens)] = np.asarray(req.tokens, np.int32)
        self._results[req.rid] = RequestResult(
            rid=req.rid, status=RequestStatus.COMPLETED, output=out,
            submitted_it=req.submitted_it, finished_it=self._it,
            ttft_s=req.first_tok_t - req.submit_t)
        return out
