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

**Speculative decoding** (``serving.speculative``, greedy only): a draft
model — the target itself (``spec_draft_model="self"``), an OPT preset,
or a ``(draft_module, draft_params)`` pair given to ``engine.serve()`` —
proposes ``spec_k`` tokens per live slot from its own slot lanes
(:func:`~.slots.draft_propose`), and the target verifies the whole window
in one forward and commits the accepted prefix on the device
(:func:`~.slots.spec_verify`).  Each is one CUDA graph per server.  The
host reads the round's tokens ``[spec_k+1, N]`` and accepted counts
``[N]`` one round behind, like a decode block's.  Every admission chunk
also prefills the draft's lane (:func:`~.slots.draft_chunk`), and the
admit copies it in (:func:`~.slots.draft_admit`); the draft's cache is
always slot lanes, even over a target pool, so prefix sharing is off
under speculation.  Committed tokens are the target's own greedy
samples: outputs equal non-speculative serving's.

**Streams and cancellation.**  :meth:`ServingEngine.token_events` gives a
request's :class:`~.slo.TokenStream`: one event per generated token,
pushed where the host mirror processes it (a speculative round that
commits m tokens pushes m events), then one typed ``end`` event.
:meth:`ServingEngine.cancel` retires a request at once, giving back its
slot, pages and lanes; :meth:`ServingEngine.status` reads its status.

**The request lifecycle** (JAX's robustness / SLO layer).  Every request
ends in a typed terminal status (:mod:`.slo`).  A request's deadline
(``submit(deadline_s=...)`` or ``default_deadline_s``) sheds it from the
queue before it takes a slot, or retires it at the next step once it
holds one — its lane is then made inactive on the device, as
:meth:`ServingEngine.cancel` makes it, so that it cannot write into pages
the host hands on.  The queue is bounded (``max_queue_depth``, with
``queue_policy`` ``"reject"``: :class:`~.slo.QueueFull`, or ``"block"``:
``submit()`` runs scheduler steps until a spot frees).  With
``breaker_threshold`` set, a failed dispatch is absorbed by ``step()``
(the requests in flight end ``ABORTED``, the workspace is dropped and the
next step allocates it and captures its graphs again) and that many
consecutive failures open the :class:`~.slo.CircuitBreaker`.
``drain(timeout_s)`` raises :class:`~.slo.DrainTimeout` with per-slot
diagnostics.  :meth:`ServingEngine.preempt` decodes the slots in flight
under a budget, then publishes every undrained request crash-atomically
(:mod:`.snapshot`) and retires the server; :meth:`ServingEngine.restore`
on a fresh server re-prefills ``prompt + tokens so far`` and decodes the
rest, so greedy outputs equal an uninterrupted run's.  Fault-injection
points (``runtime/fault/inject.py``) fire at JAX's seams.

**Threads.**  One :class:`~.concurrency.InstrumentedRLock` guards every
piece of mutable scheduler state (``concurrency.GUARDED_FIELDS``;
``DSTPU_CONCURRENCY_CHECKS=1`` asserts it at every access), so
``submit`` / ``cancel`` / ``status`` / ``result`` / ``token_events`` /
``close`` are safe from any thread.  ``step`` / ``drain`` / ``preempt``
are bound to one scheduler owner: the first thread that drives the
engine, or the one that calls :meth:`ServingEngine.bind_owner` (the HTTP
front end's scheduler thread does, before it takes requests); any other
thread's call raises.  A ``"block"`` submit from another thread waits on
the lock's condition while the owner steps.  Every CUDA call runs on the
owner thread: ``submit`` is host-only, a lane that another thread
cancels is made inactive on the device at the owner's next dispatch, and
the owner lets go of the lock while it waits on a device event, so the
other threads' lock wait does not grow with the decode time.  A CUDA
graph capture therefore never meets a CUDA call of another thread.

**Tensor parallelism** (``tensor_parallel.tp_size`` > 1): every rank of
the tp group runs a server over its slice of the model, and every device
program carries the group's collectives, so all ranks must run the same
programs in the same order.  Rank 0 of the group (the leader) owns the
queue and the clock: ``submit`` / ``cancel`` / ``step`` / ``drain`` /
``warmup`` / ``close`` run there, and each step first sends the other
ranks a plan (the new requests, the cancels and the deadline sheds,
:mod:`.tp_schedule`); they run :meth:`ServingEngine.follow`, which applies
each plan and runs the same step.  (At tp 1 a step makes the same plan
and applies it.)  At tp > 1 a cancel takes effect at the leader's next
step, and a failed dispatch closes the server on its rank and raises (the
process should end).  Speculative serving, the circuit breaker and
``preempt`` / ``snapshot`` / ``restore`` raise ``NotImplementedError``
there (ROADMAP.md).

**The front end** (``frontend/``): priority lanes with aging
(``priority_lanes``, ``priority_aging_s``), per-client fairness
(``fairness_tokens_per_s``: an over-budget client's ``submit`` raises
:class:`~.slo.QueueFull`), and :func:`~.frontend.serve_http`, the asyncio
HTTP/1.1 server.  **Observability**, all host bookkeeping and off by
default: span tracing and histograms (``tracing``), the flight recorder
(``flight_recorder``), device-memory samples at the owner's scheduler
seams (``memory_telemetry``), and ``Serving/*`` events to a ``monitor``.
"""

import json
import math
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.serving import slots
from deepspeed_tpu_torch.model_implementations.features.cuda_graph import (
    CompiledGraphModule)
from deepspeed_tpu_torch.inference.serving.concurrency import (
    InstrumentedRLock, checks_enabled, install_concurrency_checks)
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.flightrec import FlightRecorder
from deepspeed_tpu_torch.inference.serving.paging import (PagePool,
                                                          PrefixIndex,
                                                          compact_page_str,
                                                          pages_for)
from deepspeed_tpu_torch.inference.serving.tp_schedule import (Plan,
                                                               PlanChannel)
from deepspeed_tpu_torch.inference.serving.slo import (CircuitBreaker,
                                                       DrainTimeout,
                                                       QueueFull,
                                                       RequestResult,
                                                       RequestStatus,
                                                       TERMINAL_STATUSES,
                                                       TokenStream)
from deepspeed_tpu_torch.monitor.trace import ServingHistograms, SpanTracer
from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclass(eq=False)
class ServeRequest:
    """One queued / running request (host bookkeeping only).  ``prefix``
    holds tokens generated by an earlier server (a request restored from
    a preemption snapshot, ``resumed``): admission prefills ``ids +
    prefix`` and the device decodes only the rest of the budget.
    ``deadline`` is a ``time.monotonic()`` instant (``None``: none);
    ``priority`` is the admission lane (0 the most urgent); ``streamed``
    counts the tokens already pushed to its streams.  The ``t_*`` stamps
    (``serving.tracing`` only, on the tracer's clock) bound its span
    tree: submit, admission start, admit dispatched, first token
    processed; ``t_last_tok`` feeds the time-between-tokens histogram,
    stamped once per token where the host mirror drains."""
    rid: int
    ids: np.ndarray                  # [P] int32 prompt
    max_new: int
    eos: int                         # -1 = never stop early
    submitted_it: int = 0
    tokens: list = field(default_factory=list)
    slot: Optional[int] = None
    finished_it: Optional[int] = None
    status: str = RequestStatus.QUEUED
    deadline: Optional[float] = None
    client_id: Any = None
    prefix: list = field(default_factory=list)
    submit_t: float = 0.0
    first_tok_t: Optional[float] = None
    priority: int = 0
    streamed: int = 0
    resumed: bool = False
    t_trace: Optional[float] = None
    t_admit_start: Optional[float] = None
    t_prefill_done: Optional[float] = None
    t_first_tok: Optional[float] = None
    t_last_tok: Optional[float] = None

    @property
    def fill_ids(self):
        """What admission prefills: the prompt plus any resumed tokens."""
        if not self.prefix:
            return self.ids
        return np.concatenate([self.ids, np.asarray(self.prefix, np.int32)])


class _PendingPrefill:
    """An admission in progress: the slot is reserved and the prompt
    streams chunk by chunk across scheduler iterations."""

    def __init__(self, req, slot, lane, ids_pad, n_chunks, fill_len):
        self.req, self.slot, self.lane = req, slot, lane
        self.ids_pad = ids_pad           # [1, n_chunks*C] int64
        self.n_chunks = n_chunks
        self.fill_len = fill_len         # real positions, resumed prefix incl.
        self.ci = 0                      # chunks completed
        self.sel = None                  # last-real-position logits [1,1,V]
        # paged admission: prefill starts at the shared-prefix boundary
        # (chunk-aligned); positions below it are served by shared pages
        self.start = 0
        self.fill_tokens = None          # the prompt (prefix registration)
        # speculative serving: the draft's single-lane prefill cache
        self.draft_lane = None


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

    def __init__(self, engine, monitor=None, draft_module=None,
                 draft_params=None, **overrides):
        engine._require_params()
        cfg = engine._config.serving
        if overrides:
            cfg = ServingConfig(**{**cfg.to_dict(), **overrides})
        self.engine = engine
        self.module = engine.module
        self.device = engine.device
        self.config = cfg
        self.monitor = monitor
        self.num_slots = int(cfg.num_slots)
        if self.num_slots < 1:
            raise ValueError(f"serving.num_slots={cfg.num_slots}: need >= 1")
        # priority lanes and fairness
        self.priority_lanes = int(cfg.priority_lanes)
        if self.priority_lanes < 1:
            raise ValueError(f"serving.priority_lanes="
                             f"{cfg.priority_lanes}: need >= 1")
        if float(cfg.priority_aging_s) < 0:
            raise ValueError(f"serving.priority_aging_s="
                             f"{cfg.priority_aging_s}: need >= 0")
        self._fairness = None
        if float(cfg.fairness_tokens_per_s) > 0:
            from deepspeed_tpu_torch.inference.serving.frontend.fairness \
                import FairnessTracker
            self._fairness = FairnessTracker(float(cfg.fairness_tokens_per_s),
                                             float(cfg.fairness_window_s))
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
        # speculative decoding: the draft model and the fixed verify window
        self.speculative = bool(cfg.speculative)
        self.spec_k = int(cfg.spec_k)
        self.draft_module = None
        topo = engine.topology
        tp = topo.tp if topo is not None else 1
        if tp > 1 and self.speculative:
            raise NotImplementedError(
                f"speculative serving at tensor-parallel size {tp} is not "
                f"ported to deepspeed_tpu_torch yet (see ROADMAP.md, queue "
                f"A): serve with speculative=False, or at tp 1")
        if tp > 1 and cfg.breaker_threshold:
            raise NotImplementedError(
                f"serving.breaker_threshold={cfg.breaker_threshold} at "
                f"tensor-parallel size {tp} is not ported to "
                f"deepspeed_tpu_torch yet (see ROADMAP.md, queue A): a "
                f"failure absorbed on one rank takes it out of the group's "
                f"schedule; serve with breaker_threshold=0 (a failed "
                f"dispatch then ends the server), or at tp 1")
        if self.speculative:
            if cfg.do_sample:
                raise ValueError(
                    "serving.speculative=True requires greedy decoding "
                    "(do_sample=False): the verify-and-commit program's "
                    "bitwise contract is the target's greedy tokens — "
                    "lossless speculative SAMPLING is not implemented")
            if not 1 <= self.spec_k <= 64:
                raise ValueError(f"serving.spec_k={cfg.spec_k}: need "
                                 f"1 <= spec_k <= 64")
            self.draft_module = _resolve_draft(engine, cfg, draft_module,
                                               draft_params)
            dvocab = self.draft_module.config.vocab_size
            tvocab = self.module.config.vocab_size
            if dvocab != tvocab:
                raise ValueError(
                    f"draft model vocab_size={dvocab} != target "
                    f"vocab_size={tvocab} — speculative verification "
                    f"compares token ids, the vocabularies must match")
        elif draft_module is not None or draft_params is not None:
            raise ValueError("draft_module / draft_params are used only "
                             "with serving.speculative=True")
        max_seq = self.module.config.max_seq_len
        if self.speculative:
            # the draft's positions must lie in its own tables too
            max_seq = min(max_seq, self.draft_module.config.max_seq_len)
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
        if self.speculative and self.spec_k + 1 > self.max_pos:
            raise ValueError(
                f"serving.spec_k={self.spec_k}: a verify window of "
                f"{self.spec_k + 1} positions does not fit lanes of "
                f"{self.max_pos}")
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
        # the decode block — or, speculative, the draft propose and the
        # verify-and-commit — captured per (cache, state, table) buffers:
        # one graph each per server, as JAX compiles one program per
        # signature
        graphs = engine._config.enable_cuda_graph
        self._decode_prog = self._propose_prog = self._verify_prog = None
        if not self.speculative:
            self._decode_prog = CompiledGraphModule(
                slots.decode_block, enable_cuda_graph=graphs,
                donate_argnums=(1, 2, 7))
        else:
            self._propose_prog = CompiledGraphModule(
                slots.draft_propose, enable_cuda_graph=graphs,
                donate_argnums=(1, 2))
            self._verify_prog = CompiledGraphModule(
                slots.spec_verify, enable_cuda_graph=graphs,
                donate_argnums=(1, 2, 8))
            # the draft's slot lanes (always lanes, even over a target
            # pool) and its single-lane prefill caches
            self._draft_cache = None
            self._draft_lanes = _LanePool(self.draft_module)
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
        # slots retired by a thread that may not touch the device: their
        # lanes are made inactive at the owner's next dispatch
        self._deactivate = []
        self._gen = engine._accel.manual_seed(int(cfg.seed), self.device)
        self._next_rid = 0
        self._it = 0
        self._requests = {}
        self._results = {}
        # non-COMPLETED terminal outcomes, returned by the next step()
        self._pending_reports = {}
        self._streams = {}               # rid -> [TokenStream]
        # the threads (see the module docstring): one lock, its condition
        # for blocked submits, the scheduler owner, and an event that
        # submit() / restore() set to wake an idle scheduler thread
        self._lock = InstrumentedRLock()
        self._cond = threading.Condition(self._lock)
        self._owner_thread = None
        self.wake = threading.Event()
        self._breaker = CircuitBreaker(cfg.breaker_threshold,
                                       cfg.breaker_cooldown_s)
        self._closed = False
        self._close_report = []          # the ids undrained at close
        self._snap_seq = 0               # snapshot lineage
        self._slot_last_dispatch = {}    # slot -> monotonic time
        # tensor parallelism: the plan link of the tp group (the leader
        # sends, the others follow), the leader's next plan, and the
        # plan's clock while a step runs (the priority lanes' aging)
        self._plans = PlanChannel(topo) if tp > 1 else None
        self._plan_out = Plan()
        self._step_now = None
        self.stats = {"iterations": 0, "decode_calls": 0,
                      "decode_tokens": 0, "prefill_tokens": 0,
                      "completed": 0, "admitted": 0, "shed": 0,
                      "cancelled": 0, "aborted": 0, "resumed": 0,
                      # dispatch failures step() absorbed (breaker on)
                      "dispatch_failures": 0,
                      "wall_secs": 0.0, "sync_secs": 0.0,
                      "prefix_lookups": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "page_evictions": 0,
                      "admission_stalls": 0, "stream_bridge_drops": 0,
                      "fairness_rejected": 0,
                      # the JAX key for paged decodes that skipped the
                      # paged kernel: always 0, a pool always runs K6/K7
                      "paged_attention_fallback": 0,
                      # seconds threads waited on the engine lock
                      "lock_wait_scheduler_s": 0.0,
                      "lock_wait_handler_s": 0.0}
        if self.speculative:
            # windows: (round x live slot) verify opportunities, each
            # committing 1..spec_k+1 tokens; accept_rate = accepted draft
            # tokens / proposed ones; draft / verify secs: host dispatch
            # wall time (the draft's prefill and admit count as draft)
            self.stats.update({
                "spec_rounds": 0, "spec_windows": 0,
                "spec_committed_tokens": 0, "spec_accept_rate": 0.0,
                "spec_tokens_per_dispatch": 0.0,
                "spec_draft_secs": 0.0, "spec_verify_secs": 0.0,
                "spec_draft_fraction": 0.0})
        self.occupancy_trace = []        # (it, n_active)
        # observability, all off by default and all host bookkeeping
        self.tracing = bool(cfg.tracing)
        self._tracer = self._hist = None
        if self.tracing:
            self._tracer = SpanTracer(int(cfg.trace_max_spans))
            # the histograms lock themselves: /metrics renders them
            # without the engine lock; every lock acquire feeds the
            # lock-wait family
            self._hist = ServingHistograms()
            self._lock.on_wait = self._hist.lock_wait.observe
        self._flightrec = self._inject_observer = None
        if cfg.flight_recorder:
            self._flightrec = FlightRecorder(
                int(cfg.flight_recorder_events),
                dump_dir=cfg.flight_recorder_dir or None)
            fr = self._flightrec
            self._inject_observer = inject.add_fire_observer(
                lambda point, action, hit: fr.record(
                    "fault_injection", point=point, action=action,
                    hit=hit))
        self._memwatch = None
        if cfg.memory_telemetry:
            from deepspeed_tpu_torch.monitor.memwatch import \
                DeviceMemorySampler
            self._memwatch = DeviceMemorySampler(
                interval_s=float(cfg.memory_sample_interval_s),
                owners_fn=_weakly(self, "_device_memory_owners"),
                flightrec=self._flightrec, device=self.device)
            self.stats.update({
                "hbm_bytes_in_use": 0, "hbm_peak_bytes": 0,
                "hbm_limit_bytes": 0, "hbm_owned_bytes": 0,
                "hbm_unattributed_bytes": 0, "memory_samples": 0})
        # the lock sorts its waiters into scheduler and handler by this
        self._lock._owner_ref = _weakly(self, "_owner_thread")
        log_dist(f"serving engine: {self.num_slots} slots x "
                 f"{self.cache_len} positions, "
                 + (f"paged ({self.num_pages} pages of {self.page})"
                    if self.paged else "monolithic lanes")
                 + (f", speculative k={self.spec_k}"
                    if self.speculative else "")
                 + f", kernels {self.kernel_modes}", ranks=[0])
        if checks_enabled():
            # DSTPU_CONCURRENCY_CHECKS=1: every guarded-field access now
            # asserts that the lock is held
            install_concurrency_checks(self)

    @property
    def _progs(self):
        """The captured programs this server runs."""
        return [p for p in (self._decode_prog, self._propose_prog,
                            self._verify_prog) if p is not None]

    def graph_pool_bytes(self):
        """Device bytes of the graph memory pools of this server's
        captured programs."""
        return sum(p.pool_bytes() for p in self._progs)

    # ------------------------------------------------------------------ #
    # Observability: spans, histograms, the flight recorder, device memory
    # ------------------------------------------------------------------ #
    def _observed(self, program, fn, **args):
        """``fn`` run inside :meth:`_observe_dispatch` (``fn`` itself when
        tracing and the flight recorder are off); :meth:`_guarded` fires
        its fault-injection point before it, as the JAX engine does."""
        if self._tracer is None and self._flightrec is None:
            return fn

        def observed(*a):
            with self._observe_dispatch(program, **args):
                return fn(*a)

        return observed

    @contextmanager
    def _observe_dispatch(self, program, **args):
        """One device dispatch at its scheduler seam: a span on the
        scheduler track and a dispatch-time sample (tracing), a
        ``dispatch_begin`` / ``dispatch_end`` (or ``dispatch_error``) pair
        (flight recorder).  The time is the host's dispatch call; nothing
        waits on the device.  A pass-through when both are off."""
        tr, fr = self._tracer, self._flightrec
        if tr is None and fr is None:
            yield
            return
        t0 = tr.now() if tr is not None else time.monotonic()
        if fr is not None:
            fr.record("dispatch_begin", program=program, **args)
        try:
            yield
        except BaseException as e:
            if fr is not None:
                fr.record("dispatch_error", program=program,
                          error=f"{type(e).__name__}: {e}"[:200], **args)
            raise
        t1 = tr.now() if tr is not None else time.monotonic()
        if tr is not None:
            tr.add(program, "dispatch", t0, t1, track="scheduler", **args)
            self._hist.dispatch.observe(program, t1 - t0)
        if fr is not None:
            fr.record("dispatch_end", program=program,
                      dur_s=round(t1 - t0, 6), **args)

    def _trace_done(self, req, status):
        """At a request's end: its latency breakdown (the
        :class:`~.slo.RequestResult` fields, the last phase reached taking
        the rest, so the phases sum to ``latency_s``) and its span tree on
        its slot's track (the ``queue`` track if it never had a slot).
        ``{}`` with tracing off."""
        tr = self._tracer
        if tr is None or req.t_trace is None:
            return {}
        t_end = tr.now()
        t_sub = req.t_trace
        bd = {"latency_s": max(t_end - t_sub, 0.0)}
        prev = t_sub
        for name, nxt in (("queue_s", req.t_admit_start),
                          ("prefill_s", req.t_prefill_done),
                          ("host_s", req.t_first_tok),
                          ("decode_s", t_end)):
            if nxt is None:              # ended mid-phase: it takes the rest
                bd[name] = max(t_end - prev, 0.0)
                break
            bd[name] = max(nxt - prev, 0.0)
            prev = nxt
        track = req.slot if req.slot is not None else "queue"
        cid = None if req.client_id is None else str(req.client_id)
        tr.add("request", "request", t_sub, t_end, track=track,
               rid=req.rid, client_id=cid, slot=req.slot,
               priority=req.priority, status=status,
               tokens=len(req.tokens))
        tr.add("queue", "phase", t_sub,
               t_end if req.t_admit_start is None else req.t_admit_start,
               track=track, rid=req.rid, phase="queue")
        if req.t_admit_start is not None:
            tr.add("prefill", "phase", req.t_admit_start,
                   t_end if req.t_prefill_done is None
                   else req.t_prefill_done,
                   track=track, rid=req.rid, phase="prefill")
        if req.t_first_tok is not None:
            tr.add("decode", "phase", req.t_first_tok, t_end,
                   track=track, rid=req.rid, phase="decode",
                   tokens=len(req.tokens))
        return bd

    def _flight_dump(self, reason):
        """A dump that never masks the distress it records; returns the
        path or ``None``."""
        fr = self._flightrec
        if fr is None:
            return None
        try:
            path = fr.dump(reason)
            logger.warning(f"serving flight recorder dumped to {path} "
                           f"({reason})")
            return path
        except Exception as e:           # noqa: BLE001
            logger.warning(f"serving flight-recorder dump failed "
                           f"({reason}): {type(e).__name__}: {e}")
            return None

    def _detach_observability(self):
        """At retirement (close / preempt): unhook the fault-injection
        observer and flush the monitor, so a short-lived serving process
        keeps its last events."""
        if self._inject_observer is not None:
            inject.remove_fire_observer(self._inject_observer)
            self._inject_observer = None
        flush = getattr(self.monitor, "flush", None)
        if callable(flush):
            try:
                flush()
            except Exception as e:       # noqa: BLE001
                logger.warning(f"serving monitor flush on retirement "
                               f"failed: {type(e).__name__}: {e}")

    def dump_trace(self, path):
        """Write the span ring as Chrome trace-event JSON to ``path`` (one
        track per slot plus the scheduler / queue / handler tracks);
        returns ``path``.  Raises with ``serving.tracing`` off.  Only the
        copy of the ring is taken under the engine lock."""
        with self._lock:
            if self._tracer is None:
                raise RuntimeError("dump_trace(): serving.tracing is off — "
                                   "enable it to record spans")
            tracer = self._tracer
            snap = tracer.span_snapshot()
        return tracer.dump(path, spans=snap)

    def histograms(self):
        """The :class:`~deepspeed_tpu_torch.monitor.trace.ServingHistograms`
        (``None`` with tracing off); they lock themselves."""
        return self._hist

    def _device_memory_owners(self):
        """Device bytes of every buffer this engine can name: what the
        sampler reconciles against the device's total (the gap is the
        unattributed figure).  Sizes only, nothing is read."""
        from deepspeed_tpu_torch.monitor.memwatch import tree_device_bytes
        module = self.module
        owners = {"params": tree_device_bytes(
            list(module.parameters()) + list(module.buffers()))}
        owners["page_pool" if self.paged else "kv_slots"] = \
            tree_device_bytes(self._cache)
        owners["slot_state"] = tree_device_bytes(self._state)
        lanes = tree_device_bytes(self._lane_pool._lanes)
        if self._pending is not None:
            lanes += tree_device_bytes(self._pending.lane)
        owners["prefill_lanes"] = lanes
        if self.speculative:
            owners["draft_kv"] = tree_device_bytes(self._draft_cache) \
                + tree_device_bytes(self._draft_lanes._lanes)
            if self.draft_module is not self.module:
                owners["draft_params"] = tree_device_bytes(
                    list(self.draft_module.parameters()))
        owners["graph_pool"] = \
            self.graph_pool_bytes() if self.device.type == "cuda" else 0
        return owners

    def _sample_memory(self):
        """The scheduler seam's sample (owner thread, interval-gated),
        folded into ``stats``."""
        if self._memwatch is None:
            return
        sample = self._memwatch.maybe_sample()
        if sample is not None:
            self._sample_memory_into_stats(sample)

    def memory_snapshot(self):
        """One device-memory sample now (``None`` with
        ``serving.memory_telemetry`` off).  It reads the device, so it runs
        on the scheduler owner's thread (or before there is one)."""
        self._check_driver("memory_snapshot()")
        with self._lock:
            if self._memwatch is None:
                return None
            sample = self._memwatch.sample()
            self._sample_memory_into_stats(sample)
            return sample

    def _sample_memory_into_stats(self, sample):
        st = self.stats
        st["hbm_bytes_in_use"] = sample["bytes_in_use"]
        st["hbm_peak_bytes"] = max(st["hbm_peak_bytes"],
                                   sample["peak_bytes_in_use"],
                                   sample["bytes_in_use"])
        st["hbm_limit_bytes"] = sample["bytes_limit"]
        st["hbm_owned_bytes"] = sample["owned_bytes"]
        st["hbm_unattributed_bytes"] = sample["unattributed_bytes"]
        st["memory_samples"] = self._memwatch.samples

    @property
    def flightrec_enabled(self):
        """Whether ``serving.flight_recorder`` is on (a cheap test; the
        snapshot copies the ring)."""
        return self._flightrec is not None

    def flightrec_snapshot(self):
        """A copy of the flight-recorder ring (``None`` when it is off).
        Never takes the engine lock."""
        fr = self._flightrec
        return None if fr is None else fr.snapshot()

    def dump_flightrec(self, reason="manual", path=None):
        """Dump the flight-recorder ring to a JSON file (default: under
        ``serving.flight_recorder_dir``); returns the path.  Raises with
        the recorder off.  Never takes the engine lock, so a signal
        handler may call it."""
        fr = self._flightrec
        if fr is None:
            raise RuntimeError("dump_flightrec(): serving.flight_recorder "
                               "is off — enable it to record events")
        return fr.dump(reason, path=path)

    # ------------------------------------------------------------------ #
    # Public API
    # ------------------------------------------------------------------ #
    def submit(self, input_ids, max_new_tokens=32, eos_token_id=-1,
               deadline_s=None, client_id=None, priority=0):
        """Enqueue one prompt (1-D ids in the vocabulary: a list, numpy
        array or host tensor); returns the request id.  A request must fit
        a slot: ``ceil(P/chunk)*chunk`` and ``P + max_new_tokens``
        positions (plus ``spec_k - 1`` under speculation; and, paged, that
        many pages of the pool) — one that never can is refused with
        ``ValueError``.

        ``deadline_s`` (seconds from now; ``None``: the config's
        ``default_deadline_s``, ``0``: already expired): past it the
        request is shed from the queue before it takes a slot, or retired
        at the next step once in one — terminal status ``SHED_DEADLINE``.
        ``client_id`` is an opaque value carried through results and
        snapshots (stored as JSON there: a value JSON cannot hold is
        stored as its ``str``); with ``fairness_tokens_per_s`` set it is
        also the accounting key, and an over-budget client's submit
        raises :class:`~.slo.QueueFull`.  ``priority`` is the admission
        lane, ``0 <= priority < priority_lanes``, 0 the most urgent; a
        queued request moves up one lane per ``priority_aging_s``.

        Any thread may submit; nothing here touches the device.  Raises
        :class:`~.slo.CircuitOpen` while the breaker is open, and
        :class:`~.slo.QueueFull` at ``max_queue_depth`` under
        ``queue_policy="reject"`` (``"block"`` runs scheduler steps here
        on the owner's thread, and waits for the owner's steps on any
        other)."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        inject.fire("serving.pre_submit_lock")
        with self._lock:
            rid = self._submit_locked(input_ids, max_new_tokens,
                                      eos_token_id, deadline_s, client_id,
                                      priority)
        self.wake.set()                  # rouse an idle scheduler thread
        return rid

    def _submit_locked(self, input_ids, max_new_tokens, eos_token_id,
                       deadline_s, client_id, priority):
        self._check_leader("submit()")
        if self._closed:
            raise RuntimeError("submit() on a closed ServingEngine; create "
                               "a fresh server with engine.serve()")
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
        priority = int(priority)
        if not 0 <= priority < self.priority_lanes:
            raise ValueError(
                f"priority={priority}: need 0 <= priority < "
                f"serving.priority_lanes={self.priority_lanes} (0 = most "
                f"urgent)")
        padded = -(-P // self.chunk) * self.chunk
        # speculative serving reserves spec_k - 1 tail positions per lane:
        # a live lane's last verify window writes K/V for up to spec_k
        # draft tokens past its final committed position (overwritten or
        # never attended, but inside the lane)
        spec_tail = self._spec_tail
        need = max(P + max_new + spec_tail, padded)
        if need > self.max_pos:
            raise ValueError(
                f"request needs {need} cache positions (prompt {P} + new "
                f"{max_new}"
                + (f" + speculative window reserve {spec_tail}"
                   if spec_tail else "")
                + f", chunk-padded {padded}) but slots hold "
                f"{self.max_pos} — raise serving.max_cache_len or split the "
                f"request")
        if self.paged and pages_for(need, self.page) > self._pool.allocatable:
            raise ValueError(
                f"request needs {pages_for(need, self.page)} pages ({need} "
                f"positions at page_size={self.page}) but the pool holds "
                f"{self._pool.allocatable} allocatable pages (num_pages="
                f"{self.num_pages} incl. trash) — raise serving.num_pages or "
                f"split the request")
        self._breaker.check_submit()     # refuse with the reason when open
        if self._fairness is not None and not self._fairness.allow(client_id):
            self.stats["fairness_rejected"] += 1
            if self._flightrec is not None:
                self._flightrec.record(
                    "fairness_reject", client_id=None if client_id is None
                    else str(client_id))
            raise QueueFull(
                f"client {client_id!r} is over its fairness budget "
                f"({self._fairness.usage(client_id):.0f} window tokens >= "
                f"{self._fairness.budget:.0f}) — retry after the window "
                f"decays (HTTP 429)")
        self._apply_backpressure()
        if deadline_s is None and self.config.default_deadline_s > 0:
            deadline_s = self.config.default_deadline_s
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        req = ServeRequest(self._next_rid, ids, max_new, int(eos_token_id),
                           submitted_it=self._it, deadline=deadline,
                           client_id=client_id, submit_t=time.monotonic(),
                           priority=priority)
        self._enqueue(req)
        if self._plans is not None:
            # the followers queue it from the next plan; a deadline stays
            # the leader's (its sheds are decisions in the plans)
            self._plan_out.submits.append(dict(
                rid=req.rid, ids=ids, max_new=max_new, eos=req.eos,
                client_id=client_id, priority=priority,
                submit_t=req.submit_t))
        if self._tracer is not None:
            # the span tree's root; submissions come from client threads,
            # so the instant lands on the handler track
            req.t_trace = self._tracer.now()
            self._tracer.add("submit", "request", req.t_trace,
                             track="handler", rid=req.rid,
                             priority=priority,
                             client_id=None if client_id is None
                             else str(client_id))
        if self._flightrec is not None:
            self._flightrec.record(
                "submit", rid=req.rid, prompt_len=P, max_new=max_new,
                priority=priority,
                client_id=None if client_id is None else str(client_id))
        return req.rid

    def _enqueue(self, req):
        self._next_rid += 1
        self._queue.append(req)
        self._requests[req.rid] = req

    @property
    def _spec_tail(self):
        """Lane positions reserved past a request's last token: ``spec_k -
        1`` under speculation, else 0."""
        return (self.spec_k - 1) if self.speculative else 0

    def _apply_backpressure(self):
        depth = int(self.config.max_queue_depth)
        if not depth or len(self._queue) < depth:
            return
        if self.config.queue_policy == "reject":
            raise QueueFull(
                f"serving queue at max_queue_depth={depth} "
                f"(policy=reject) — retry later or raise the bound")
        if not self._on_driver_thread():
            # block, on a thread that is not the owner (an HTTP handler):
            # wait for the owner's steps to free a spot; the condition lets
            # go of the lock while it waits
            while len(self._queue) >= depth:
                if self._closed:
                    raise RuntimeError(
                        "submit() on a closed ServingEngine — close() "
                        "retired it while this submit was blocked")
                if self._no_block_progress():
                    raise QueueFull(
                        f"serving queue at max_queue_depth={depth} and the "
                        f"blocked submit cannot make progress: "
                        f"{self._breaker.last_error or 'circuit open'}")
                self._cond.wait(timeout=0.05)
            return
        # block, on the owner's thread (or before there is one): run the
        # scheduler here until a spot frees.  Progress is certain while
        # anything can retire or admit; an open breaker with nothing in
        # flight cannot make any — refuse then
        while len(self._queue) >= depth:
            if self._no_block_progress():
                raise QueueFull(
                    f"serving queue at max_queue_depth={depth} and the "
                    f"blocked submit cannot make progress: "
                    f"{self._breaker.last_error or 'circuit open'}")
            self.step()

    def _no_block_progress(self):
        return self._breaker.open and not self._breaker.allow_dispatch() \
            and not (self._events or self._mirror_active.any()
                     or self._pending is not None)

    def _known(self, rid, what):
        req = self._requests.get(rid)
        if req is None:
            raise KeyError(
                f"unknown request id {rid!r} — {what} on a request this "
                f"server never issued (submit() returned the valid ids)")
        return req

    def result(self, rid):
        """The :class:`~.slo.RequestResult` of a finished request, or None
        while it runs.  Raises ``KeyError`` for an id never issued.  Any
        thread."""
        with self._lock:
            self._known(rid, "result()")
            return self._results.get(rid)

    def status(self, rid):
        """The request's :class:`~.slo.RequestStatus` string; ``KeyError``
        for an id never issued.  Any thread."""
        with self._lock:
            return self._known(rid, "status()").status

    def cancel(self, rid):
        """Retire a request now, with terminal status ``CANCELLED``: a
        queued one never takes a slot; one in its admission prefill gives
        back its slot, pages and prefill lanes; one in a slot gives back
        the slot and its pages, its lane is made inactive on the device
        (a write in stream order, at once on the owner's thread, at the
        owner's next dispatch from any other; nothing is read back), and
        its tokens still in flight are dropped.  Returns False for a
        request already ended (or preempted); ``KeyError`` for an id never
        issued.  Any thread."""
        inject.fire("serving.pre_cancel_lock")
        with self._lock:
            req = self._known(rid, "cancel()")
            if req.status in TERMINAL_STATUSES \
                    or req.status == RequestStatus.PREEMPTED:
                return False
            if self._plans is not None:
                # every rank retires it at the leader's next step
                self._check_leader("cancel()")
                if rid not in self._plan_out.cancels:
                    self._plan_out.cancels.append(rid)
                return True
            return self._cancel_locked(req)

    def _cancel_locked(self, req):
        self.stats["cancelled"] += 1
        if req in self._queue:
            self._queue.remove(req)
            self._record_terminal(req, RequestStatus.CANCELLED,
                                  "cancelled while queued")
            self._cond.notify_all()  # a queue spot freed
            return True
        if self._pending is not None and self._pending.req is req:
            self._give_back_lanes(self._pending)
            self._free.append(int(self._pending.slot))
            self._release_slot_pages(self._pending.slot)
            self._pending = None
            self._record_terminal(req, RequestStatus.CANCELLED,
                                  "cancelled during admission prefill")
            return True
        self._record_terminal(req, RequestStatus.CANCELLED,
                              f"cancelled in slot {req.slot}")
        self._retire_in_slot(req)
        return True

    def _retire_in_slot(self, req):
        """Retire a request that holds a slot (cancelled, or shed at its
        deadline): its lane stops on the device — it must not keep writing
        into a table row (or lane) the host hands to the slot's next
        occupant before that occupant's admit overwrites the state — by a
        write in stream order, with nothing read back; and the host mirror
        frees the slot and its pages.  On a thread other than the owner's
        the write waits for the owner's next dispatch
        (:meth:`_flush_deactivations`), which comes before anything that
        can use the freed slot or pages.  While its admit is still in
        flight (mirror not yet live), ``_process_admit`` frees the
        slot."""
        if self._state is not None:
            if self._on_driver_thread():
                self._state["active"][req.slot] = False
            else:
                self._deactivate.append(int(req.slot))
        if self._mirror_active[req.slot]:
            self._free_slot(req.slot)

    def _flush_deactivations(self):
        """The owner's half of a cancel from another thread: make those
        lanes inactive on the device, before this dispatch."""
        if self._deactivate:
            if self._state is not None:
                for s in self._deactivate:
                    self._state["active"][s] = False
            self._deactivate.clear()

    def _on_driver_thread(self):
        """True on the scheduler owner's thread, or before there is one:
        where the engine may call the device."""
        owner = self._owner_thread
        return owner is None or owner is threading.current_thread()

    def token_events(self, rid, on_event=None):
        """Subscribe to the request's per-token stream: a
        :class:`~.slo.TokenStream` fed where the host mirror processes
        the device's tokens (one event behind the device, one event per
        token).  Subscribing replays every token already generated and,
        for an ended request, its ``end`` event, so the stream is
        lossless whenever it attaches.  ``on_event`` is called with each
        event as it is pushed, under the engine lock, and must not block.
        ``KeyError`` for an id never issued.  Any thread."""
        inject.fire("serving.pre_subscribe_lock")
        with self._lock:
            req = self._known(rid, "token_events()")
            stream = TokenStream(rid, on_event=on_event,
                                 on_drop=_drop_counter(self))
            for i, t in enumerate(req.tokens):
                stream.push({"event": "token", "rid": rid, "index": i,
                             "token": int(t)})
            if req.status in TERMINAL_STATUSES \
                    or req.status == RequestStatus.PREEMPTED:
                res = self._results.get(rid)
                stream.push({"event": "end", "rid": rid,
                             "status": req.status,
                             "detail": res.detail if res is not None
                             else ""})
            else:
                self._streams.setdefault(rid, []).append(stream)
            return stream

    def _publish_progress(self, req):
        """Push the request's tokens not yet streamed to its
        subscribers."""
        n = len(req.tokens)
        for s in self._streams.get(req.rid, ()):
            for i in range(req.streamed, n):
                s.push({"event": "token", "rid": req.rid, "index": i,
                        "token": int(req.tokens[i])})
        req.streamed = n

    def _publish_end(self, req, status, detail=""):
        """The typed terminal event: exactly once, last; the subscribers
        are dropped (a later ``token_events()`` replays from the
        request)."""
        self._publish_progress(req)
        for s in self._streams.pop(req.rid, ()):
            s.push({"event": "end", "rid": req.rid, "status": status,
                    "detail": detail})

    # ------------------------------------------------------------------ #
    # The scheduler owner
    # ------------------------------------------------------------------ #
    def _check_owner(self, what):
        """Bind the scheduler owner to the first thread that drives the
        engine and refuse every other thread afterwards: the host mirror,
        the in-flight events and the device buffers are stateful across
        calls (the lag-one protocol), so two drivers would corrupt the
        slot bookkeeping even with every call locked."""
        me = threading.current_thread()
        with self._lock:
            if self._owner_thread is None:
                self._owner_thread = me
                return
            if self._owner_thread is not me:
                raise RuntimeError(
                    f"{what} from thread {me.name!r} but this "
                    f"ServingEngine's scheduler owner is "
                    f"{self._owner_thread.name!r} — exactly one thread may "
                    f"drive step()/drain()/preempt() (the host mirror is "
                    f"stateful across calls); other threads use "
                    f"submit()/result()/cancel()/token_events()")

    def _check_driver(self, what):
        """Refuse a device-touching call from a thread other than the
        owner's (``warmup``, ``memory_snapshot``) without binding one."""
        with self._lock:
            if not self._on_driver_thread():
                raise RuntimeError(
                    f"{what} from thread {threading.current_thread().name!r}"
                    f" but the scheduler owner is "
                    f"{self._owner_thread.name!r}: it calls the device, so "
                    f"it runs on the owner's thread")

    def bind_owner(self):
        """Claim the scheduler owner's role for this thread now
        (idempotent for the owner; raises on any other thread once bound).
        A dedicated scheduler thread calls it before work can arrive, so a
        blocked ``"block"`` submit cannot bind itself first."""
        self._check_owner("bind_owner()")

    def release_owner(self):
        """Give up the owner's binding (an exiting scheduler thread does),
        so another thread may drive the engine after it.  A no-op when
        there is no owner; raises on any thread but the owner's."""
        me = threading.current_thread()
        with self._lock:
            if self._owner_thread is None:
                return
            if self._owner_thread is not me:
                raise RuntimeError(
                    f"release_owner() from thread {me.name!r} but the "
                    f"scheduler owner is {self._owner_thread.name!r} — only "
                    f"the owner thread may release its binding")
            self._owner_thread = None

    def step(self):
        """One scheduler iteration: deadline shedding, admission prefill
        under the token budget, one decode-block dispatch, then the device
        results one event behind.  Returns ``{rid: output}`` for every
        request that reached a terminal status in this iteration: the
        output for ``COMPLETED``, ``None`` for the others (their detail in
        :meth:`result`).  Owner-bound (the first thread to drive the
        engine becomes its owner; any other thread's call raises)."""
        self._check_owner("step()")
        self._check_leader("step()")
        inject.fire("serving.pre_step_lock")
        with self._lock:
            return self._step_locked()

    def _step_locked(self, plan=None):
        """One iteration; ``plan``: the leader's, on a follower of a
        tensor-parallel group (elsewhere the step makes its own,
        :meth:`_make_plan`)."""
        if self._closed:
            raise RuntimeError("step() on a closed ServingEngine")
        t0 = time.perf_counter()
        t0_tr = self._tracer.now() if self._tracer is not None else None
        inject.fire("serving.sigterm_at_iter")
        self._ensure_workspace()
        finished = {}
        plan = self._make_plan() if plan is None else plan
        self._apply_plan(plan)
        if self._breaker.enabled:
            # a failed dispatch is absorbed (the failing call already
            # aborted the requests in flight and dropped the workspace)
            # and counted; threshold consecutive ones open the breaker:
            # nothing is dispatched until the cooldown's half-open probe
            was_open = self._breaker.open
            dispatched = False
            try:
                if plan.dispatch:
                    self._admit()
                    dispatched = self._dispatch_decode()
            except Exception as e:
                self._breaker.record_failure(e)
                self.stats["dispatch_failures"] += 1
                fr = self._flightrec
                if fr is not None:
                    fr.record("breaker_failure",
                              consecutive=self._breaker.consecutive_failures,
                              threshold=self._breaker.threshold,
                              error=f"{type(e).__name__}: {e}"[:200])
                    if self._breaker.open and not was_open:
                        # the server stops trusting its device: keep what
                        # led here
                        fr.record("breaker_open", trips=self._breaker.trips,
                                  last_error=self._breaker.last_error[:200])
                        self._flight_dump("breaker_open")
                logger.warning(
                    f"serving dispatch failure absorbed by the circuit "
                    f"breaker ({self._breaker.consecutive_failures}"
                    f"/{self._breaker.threshold} consecutive"
                    f"{'; OPEN' if self._breaker.open else ''}): "
                    f"{type(e).__name__}: {e}")
            if was_open and not self._breaker.open \
                    and self._flightrec is not None:
                self._flightrec.record("breaker_close",
                                       trips=self._breaker.trips)
        else:
            try:
                self._admit()
                dispatched = self._dispatch_decode()
            except Exception as e:
                if self._plans is not None:
                    self._tp_dispatch_failed(e)
                raise
        # lag-one: with fresh work in flight, leave the newest event unread
        # so the device keeps running while the host does bookkeeping; once
        # nothing new was dispatched, flush fully
        self._process_events(finished, keep=1 if dispatched else 0,
                             unlocked_wait=True)
        self.stats["lock_wait_scheduler_s"] = self._lock.wait_s["scheduler"]
        self.stats["lock_wait_handler_s"] = self._lock.wait_s["handler"]
        if self._flightrec is not None and self.stats["iterations"] % 32 == 0:
            self._flightrec.record(
                "lock_wait",
                scheduler_s=round(self.stats["lock_wait_scheduler_s"], 6),
                handler_s=round(self.stats["lock_wait_handler_s"], 6))
        self._sample_memory()
        self._emit_metrics()
        self.stats["iterations"] += 1
        self.stats["wall_secs"] += time.perf_counter() - t0
        if self._tracer is not None:
            self._tracer.add("step", "scheduler", t0_tr, self._tracer.now(),
                             track="scheduler", it=self._it)
        self._it += 1
        finished.update(self._pending_reports)
        self._pending_reports.clear()
        # retirements and admissions may have freed queue spots: wake the
        # blocked submits of other threads
        self._cond.notify_all()
        return finished

    def _shed_expired(self):
        """The deadlines now, carried out at once (a step makes them a
        decision of its plan instead)."""
        self._shed(self._expired(time.monotonic()))

    def _expired(self, now):
        """The deadline decisions at ``now``, ``[(rid, detail)]``: the
        queued requests, then the admission in progress, then the slots
        (:meth:`_shed` carries them out)."""
        out = [(r.rid, f"deadline expired {now - r.deadline:.3f}s ago "
                       f"while queued (never occupied a slot)")
               for r in self._queue
               if r.deadline is not None and now >= r.deadline]
        p = self._pending
        if p is not None and p.req.deadline is not None \
                and now >= p.req.deadline:
            out.append((p.req.rid, "deadline expired during admission "
                                   "prefill"))
        for req in self._slots:
            if req is None or req.deadline is None or now < req.deadline \
                    or req.status in TERMINAL_STATUSES:
                continue
            out.append((req.rid, f"deadline expired in slot {req.slot} "
                                 f"after {len(req.tokens)} token(s)"))
        return out

    def _shed(self, decisions):
        """Shed each ``(rid, detail)`` of :meth:`_expired` wherever its
        request is now (one already ended is skipped): a queued request
        never takes a slot; an admission in progress gives back its slot,
        pages and lanes; a request in a slot is retired there
        (:meth:`_retire_in_slot`: its lane stops on the device too)."""
        for rid, detail in decisions:
            req = self._requests[rid]
            if req.status in TERMINAL_STATUSES:
                continue
            self.stats["shed"] += 1
            p = self._pending
            if req in self._queue:
                self._queue.remove(req)
            elif p is not None and p.req is req:
                self._give_back_lanes(p)
                self._free.append(int(p.slot))
                self._release_slot_pages(p.slot)
                self._pending = None
            self._record_terminal(req, RequestStatus.SHED_DEADLINE, detail)
            if req.slot is not None and self._slots[req.slot] is req:
                self._retire_in_slot(req)

    # ------------------------------------------------------------------ #
    # Tensor parallelism: one schedule on every rank (tp_schedule.py)
    # ------------------------------------------------------------------ #
    @property
    def tp_follower(self):
        """True on a follower rank (tp rank > 0) of a tensor-parallel
        server, which runs :meth:`follow`."""
        with self._lock:
            return self._plans is not None and not self._plans.is_leader

    def _check_leader(self, what):
        """Refuse a scheduling call on a follower rank of a tensor-parallel
        group: the leader makes every decision."""
        if self.tp_follower:
            raise RuntimeError(
                f"{what} on a follower rank of a tensor-parallel server: tp "
                f"rank 0 owns the queue and the clock; this rank runs "
                f"follow() (serve_http runs it) and applies rank 0's plans")

    def _make_plan(self):
        """This step's plan, made on the leader of a tensor-parallel group
        (which sends it to the followers) or on a server at tp 1: the
        submits and cancels since the last one (tp > 1), the deadline
        sheds and the breaker's decision now."""
        plan, self._plan_out = self._plan_out, Plan()
        plan.now = time.monotonic()
        plan.shed = self._expired(plan.now)
        plan.dispatch = not self._breaker.enabled \
            or self._breaker.allow_dispatch()
        if self._plans is not None:
            self._plans.send(plan)
        return plan

    def _apply_plan(self, plan):
        """A step plan, on every rank alike: a follower queues the new
        requests (the leader did at submit); then the cancels and the
        sheds; the plan's clock ages the priority lanes."""
        self._step_now = plan.now
        if self.tp_follower:
            for sub in plan.submits:
                if sub["rid"] != self._next_rid:
                    raise RuntimeError(
                        f"tensor-parallel serving out of step: rank 0 "
                        f"submitted request {sub['rid']}, this rank expected"
                        f" {self._next_rid}")
                self._enqueue(ServeRequest(
                    sub["rid"], sub["ids"], sub["max_new"], sub["eos"],
                    submitted_it=self._it, client_id=sub["client_id"],
                    submit_t=sub["submit_t"], priority=sub["priority"]))
        for rid in plan.cancels:
            req = self._requests[rid]
            if req.status not in TERMINAL_STATUSES:
                self._cancel_locked(req)
        self._shed(plan.shed)

    def _tp_dispatch_failed(self, e):
        """A failed dispatch at tp > 1: this rank can no longer run the
        group's schedule, so the server closes here (every request it
        holds ends ``ABORTED``; nothing in flight is read, since it may
        wait on the other ranks) and the error is raised.  The process
        should end: the other ranks then fail in their next collective."""
        self._abort_in_flight("tensor-parallel dispatch failed")
        self._close_locked()
        raise RuntimeError(
            f"tensor-parallel serving: a dispatch failed on this rank "
            f"({type(e).__name__}: {e}); the group's ranks no longer run "
            f"one schedule, so the server is closed and every request it "
            f"held is ABORTED — end the process (the group's other ranks "
            f"fail in their next collective)") from e

    def follow(self):
        """A follower rank's scheduler (tp rank > 0 of a tensor-parallel
        server): receive each of rank 0's plans and run the same step (or
        warmup) until rank 0 closes the server, then close here.  Returns
        ``{rid: output}`` for every request that ended during the call, as
        :meth:`drain` does on rank 0 (``None`` for the non-``COMPLETED``).
        Owner-bound."""
        with self._lock:
            plans = self._plans
        if plans is None or plans.is_leader:
            raise RuntimeError("follow() runs on a follower rank (tp rank > "
                               "0) of a tensor-parallel server")
        self._check_owner("follow()")
        results = {}
        while True:
            plan = plans.recv()
            with self._lock:
                if plan.kind == "close":
                    self._close_locked()
                    return results
                if plan.kind == "warmup":
                    self._warmup_locked()
                else:
                    results.update(self._step_locked(plan))

    def work_pending(self):
        """True while anything submitted has not finished: queued,
        mid-prefill, dispatched or live on the host mirror.  Any
        thread."""
        with self._lock:
            return bool(self._queue or self._pending is not None
                        or self._events or self._mirror_active.any())

    def _anything_in_flight(self):
        with self._lock:
            return bool(self._events or self._mirror_active.any())

    def drain(self, timeout_s=None):
        """Run the scheduler until every submitted request has reached a
        terminal status; returns ``{rid: output}`` for everything that
        ended during the call (``None`` for the non-``COMPLETED``).
        ``timeout_s`` (default: the config's ``drain_timeout_s``; 0 or
        None: no limit) bounds the wall clock: past it
        :class:`~.slo.DrainTimeout` is raised with per-slot diagnostics
        (slot, request, age of its last dispatch).  Owner-bound."""
        self._check_owner("drain()")
        self._check_leader("drain()")
        if timeout_s is None:
            timeout = self.config.drain_timeout_s or None
        else:
            timeout = timeout_s or None      # an explicit 0: no limit
        t0 = time.monotonic()
        results = {}
        while self.work_pending():
            elapsed = time.monotonic() - t0
            if timeout is not None and elapsed > timeout:
                with self._lock:
                    diag = self._drain_diagnostics(timeout, elapsed)
                if self._flightrec is not None:
                    # the dump's tail is the dispatch sequence that led
                    # into the wedge
                    self._flightrec.record("drain_timeout", diag=diag[:400])
                    self._flight_dump("drain_timeout")
                raise DrainTimeout(diag)
            if self._breaker.open and not self._breaker.allow_dispatch() \
                    and not self._anything_in_flight():
                # an open breaker with nothing in flight: wait out the
                # cooldown instead of spinning on the queue
                time.sleep(min(0.01,
                               self._breaker.seconds_until_half_open()))
            results.update(self.step())
        with self._lock:
            # outcomes recorded outside a step (a restore that did not fit)
            results.update(self._pending_reports)
            self._pending_reports.clear()
        return results

    def _drain_diagnostics(self, timeout, elapsed):
        now = time.monotonic()
        lines = [f"drain() exceeded its {timeout:.1f}s wall-clock budget "
                 f"({elapsed:.1f}s elapsed) with work outstanding: "
                 f"queue={len(self._queue)}, "
                 f"in_flight_events={len(self._events)}"]
        for s, req in enumerate(self._slots):
            if req is None:
                continue
            last = self._slot_last_dispatch.get(s)
            age = f"{now - last:.1f}s ago" if last is not None else "never"
            lines.append(f"  slot {s}: request {req.rid} "
                         f"(status {req.status}, {len(req.tokens)} "
                         f"token(s), last dispatch {age})")
        if self._pending is not None:
            lines.append(f"  pending prefill: request "
                         f"{self._pending.req.rid} on slot "
                         f"{self._pending.slot} "
                         f"({self._pending.ci}/{self._pending.n_chunks} "
                         f"chunks)")
        if self._breaker.open:
            lines.append(f"  circuit breaker OPEN "
                         f"({self._breaker.consecutive_failures} "
                         f"consecutive failures; last: "
                         f"{self._breaker.last_error})")
        if self.paged:
            lines.append(f"  page pool: {self._pool.in_use}"
                         f"/{self._pool.allocatable} in use, "
                         f"{len(self._prefix)} prefix entries, "
                         f"{self.stats['admission_stalls']} admission "
                         f"stall(s)")
        return "\n".join(lines)

    def close(self):
        """Retire the server: every undrained request ends ``ABORTED``, the
        KV workspaces are freed, and ``submit()`` / ``step()`` raise
        afterwards.  Returns the sorted ids of the requests that were
        undrained at the first call — the same list on every call (after
        :meth:`preempt`, the snapshotted ids).  Any thread."""
        with self._lock:
            if self._plans is not None and not self._closed:
                # the followers close at the leader's word
                self._check_leader("close()")
                self._plans.send(Plan(kind="close"))
            return self._close_locked()

    def _close_locked(self):
        if self._closed:
            return list(self._close_report)
        finished = {}
        try:
            self._process_events(finished, keep=0)
        except Exception as e:           # a failed device leaves them unread
            logger.warning(f"serving close(): discarding unreadable "
                           f"in-flight events ({type(e).__name__}: {e})")
        undrained = sorted(
            [r.rid for r in self._slots if r is not None]
            + ([self._pending.req.rid] if self._pending is not None else [])
            + [r.rid for r in self._queue])
        for req in self._queue:
            self._record_terminal(req, RequestStatus.ABORTED,
                                  "engine closed with the request queued")
        self._queue.clear()
        self._abort_in_flight("close()")
        self._cache = None
        self._lane_pool.release()
        if self.speculative:
            self._draft_lanes.release()
        self._detach_observability()
        self._closed = True
        self._close_report = undrained
        # blocked submits see the close, an idle scheduler thread wakes
        self._cond.notify_all()
        self.wake.set()
        return list(undrained)

    # the monitoring properties take the (re-entrant) lock: an unlocked
    # read would race the scheduler
    @property
    def queue_depth(self):
        with self._lock:
            return len(self._queue) + (1 if self._pending is not None else 0)

    @property
    def active_slots(self):
        """Live slots as of the last PROCESSED event (the host mirror)."""
        with self._lock:
            return int(np.sum(self._mirror_active))

    @property
    def in_flight(self):
        """Dispatched device events not yet processed."""
        with self._lock:
            return len(self._events)

    @property
    def page_pool_utilization(self):
        """Allocated fraction of the page pool (0.0 when not paged)."""
        with self._lock:
            return self._pool.utilization() if self.paged else 0.0

    @property
    def prefix_hit_rate(self):
        """Fraction of prefix lookups that matched >= 1 page."""
        with self._lock:
            n = self.stats["prefix_lookups"]
            return self.stats["prefix_hits"] / n if n else 0.0

    def health_snapshot(self):
        """One locked view of the scheduler for health endpoints
        (``/healthz``): queue depth, mirror occupancy, in-flight events,
        the breaker, the closed flag.  Any thread."""
        with self._lock:
            snap = {
                "closed": self._closed,
                "queue_depth": self.queue_depth,
                "active_slots": self.active_slots,
                "num_slots": self.num_slots,
                "in_flight_events": self.in_flight,
                "breaker": {
                    "open": self._breaker.open,
                    "consecutive_failures":
                        self._breaker.consecutive_failures,
                    "trips": self._breaker.trips,
                    "last_error": self._breaker.last_error,
                },
            }
            snap["slot_occupancy"] = snap["active_slots"] / self.num_slots
            if self.paged:
                snap["page_pool_utilization"] = self.page_pool_utilization
            return snap

    # ------------------------------------------------------------------ #
    # Graceful preemption: drain -> crash-atomic snapshot -> restore
    # ------------------------------------------------------------------ #
    def _undrained_requests(self):
        """Every request that would be lost if the process died now:
        in a slot, mid-admission and queued, in that order."""
        reqs = [r for r in self._slots
                if r is not None and r.status not in TERMINAL_STATUSES]
        if self._pending is not None \
                and self._pending.req.status not in TERMINAL_STATUSES:
            reqs.append(self._pending.req)
        reqs.extend(r for r in self._queue
                    if r.status not in TERMINAL_STATUSES)
        return reqs

    def preempt(self, checkpoint_dir, drain_budget_s=None, tag=None):
        """The SIGTERM path: stop admitting, keep decoding the slots in
        flight for up to ``drain_budget_s`` seconds (default: the config's
        ``drain_budget_s``; 0: snapshot at once), then snapshot every
        undrained request — prompt, tokens committed so far, remaining
        deadline — and the sampling generator's state crash-atomically
        under ``checkpoint_dir``, and retire the server (closed afterwards;
        the snapshotted requests end their streams ``PREEMPTED``).  Under
        speculation only committed tokens reach the snapshot, and nothing
        of the draft's.  Returns ``(tag, snapshotted_rids, finished)``,
        ``finished`` holding the requests that ended during the drain.  A
        fresh server resumes the snapshot with :meth:`restore`.
        Owner-bound."""
        self._not_at_tp("preempt()")
        self._check_owner("preempt()")
        with self._lock:
            return self._preempt_locked(checkpoint_dir, drain_budget_s, tag)

    def _preempt_locked(self, checkpoint_dir, drain_budget_s, tag):
        if self._closed:
            raise RuntimeError("preempt() on a closed ServingEngine")
        budget = self.config.drain_budget_s if drain_budget_s is None \
            else float(drain_budget_s)
        t0 = time.monotonic()
        finished = {}
        self._shed_expired()
        # the drain: decode-only iterations (no admission) under the budget
        while (self._mirror_active.any()
               or any(e[0] == "admit" for e in self._events)) \
                and time.monotonic() - t0 < budget:
            inject.fire("serving.mid_drain")
            try:
                dispatched = self._dispatch_decode()
            except Exception as e:
                # a sick device must not block the snapshot: the failed
                # dispatch aborted the slots in flight; snapshot the rest
                logger.error(f"serving preempt: drain dispatch failed "
                             f"({type(e).__name__}: {e}) — snapshotting "
                             f"the queue")
                break
            self._process_events(finished, keep=1 if dispatched else 0)
        try:
            # every dispatched round is processed: the snapshot holds the
            # committed tokens, exactly
            self._process_events(finished, keep=0)
        except Exception as e:
            logger.warning(f"serving preempt: discarding unreadable "
                           f"in-flight events ({type(e).__name__}: {e})")
            self._abort_in_flight("preempt event flush failed")
        drain_secs = time.monotonic() - t0
        self._shed_expired()                 # expired work is not resumed
        undrained = self._undrained_requests()
        tag = self.snapshot(checkpoint_dir, tag=tag)
        for req in undrained:
            req.status = RequestStatus.PREEMPTED
            # open streams end with the typed event: the client knows its
            # request resumes on a restarted server
            self._publish_end(req, RequestStatus.PREEMPTED,
                              f"preempted — snapshotted for resume "
                              f"(tag {tag!r})")
        snapped = [r.rid for r in undrained]
        # retire without ABORTED accounting: the snapshotted requests are
        # not lost, they resume elsewhere
        if self._pending is not None:
            self._give_back_lanes(self._pending)
            self._pending = None
        self._queue.clear()
        self._events.clear()
        self._slots = [None] * self.num_slots
        self._free = deque(range(self.num_slots))
        self._mirror_active[:] = False
        self._state = None
        self._cache = None
        for prog in self._progs:
            prog.reset()
        self._lane_pool.release()
        if self.speculative:
            self._draft_cache = None
            self._draft_lanes.release()
        self._paging_reset()
        self._detach_observability()
        self._closed = True
        self._close_report = sorted(snapped)
        self._cond.notify_all()
        self.wake.set()
        self.stats["drain_secs"] = \
            self.stats.get("drain_secs", 0.0) + drain_secs
        self.stats["preempt_snapshotted"] = len(snapped)
        finished.update(self._pending_reports)
        self._pending_reports.clear()
        logger.warning(f"serving preempt: drained {drain_secs:.2f}s, "
                       f"{len(finished)} request(s) finished in drain, "
                       f"{len(snapped)} snapshotted to {tag!r}")
        return tag, snapped, finished

    def snapshot(self, checkpoint_dir, tag=None):
        """Publish the undrained requests and the sampling generator's
        state crash-atomically under ``checkpoint_dir`` (staging dir,
        manifest with checksums, fsync, atomic rename, ``latest`` swap;
        :mod:`.snapshot`).  A pure write: the server's bookkeeping is
        untouched.  Returns the tag.  The generator's state goes under
        ``rng_torch``: the JAX engine's key data (``rng``) means nothing
        to a ``torch.Generator``, and the JAX engine reads only ``rng``,
        so the files stay interchangeable for greedy requests.  The
        fairness balances ride along.  Any thread."""
        self._not_at_tp("snapshot()")
        with self._lock:
            return self._snapshot_locked(checkpoint_dir, tag)

    def _not_at_tp(self, what):
        with self._lock:
            tp = self._plans is not None
        if tp:
            raise NotImplementedError(
                f"{what} of a tensor-parallel server is not ported to "
                f"deepspeed_tpu_torch yet (see ROADMAP.md, queue A)")

    def _snapshot_locked(self, checkpoint_dir, tag):
        from deepspeed_tpu_torch.inference.serving.snapshot import \
            save_snapshot
        self._snap_seq += 1
        tag = tag or f"serving_{self._snap_seq}"
        now = time.monotonic()
        reqs = []
        for r in self._undrained_requests():
            cid = r.client_id
            try:
                json.dumps(cid)
            except (TypeError, ValueError):
                # a client_id JSON cannot hold must never cost the
                # snapshot (and every undrained request with it)
                logger.warning(
                    f"serving snapshot: request {r.rid} client_id "
                    f"{type(cid).__name__} is not JSON-serializable — "
                    f"stored as str()")
                cid = str(cid)
            entry = {
                "rid": int(r.rid),
                "client_id": cid,
                "prompt": [int(t) for t in r.ids],
                # tokens generated so far (a queued resumed request has
                # produced none here: its prefix)
                "tokens": [int(t) for t in (r.tokens or r.prefix)],
                "max_new": int(r.max_new),
                "eos": int(r.eos),
                "deadline_remaining_s":
                    None if r.deadline is None else r.deadline - now,
                "submitted_it": int(r.submitted_it),
                "priority": int(r.priority),
            }
            if self.paged and r.slot is not None \
                    and int(r.slot) in self._slot_pages:
                # diagnostics only: restore re-prefills
                entry["pages"] = compact_page_str(
                    self._slot_pages[int(r.slot)])
            reqs.append(entry)
        state = {
            "seq": int(self._snap_seq),
            "iteration": int(self._it),
            "next_rid": int(self._next_rid),
            "rng_torch": self._gen.get_state().tolist(),
            "requests": reqs,
        }
        if self._fairness is not None:
            state["fairness"] = self._fairness.state_dict()
        return save_snapshot(checkpoint_dir, tag, state)

    def restore(self, checkpoint_dir):
        """Queue the newest valid snapshot's requests on this server with
        their request ids, client ids and remaining deadlines, and restore
        the sampling generator's state (a snapshot written by the JAX
        engine has none the port can use: its key is ignored).  Each
        resumed request re-prefills ``prompt + tokens so far`` through the
        ordinary admission path and decodes the rest of its budget, so a
        greedy output equals the uninterrupted run's.  A request that does
        not fit this server's lanes or pool ends ``ABORTED`` with the
        reason.  The snapshot's priorities (held below this server's
        ``priority_lanes``) and fairness balances are restored too.
        Returns the ids queued (empty when there is nothing to resume).
        Any thread."""
        self._not_at_tp("restore()")
        from deepspeed_tpu_torch.inference.serving.snapshot import \
            load_newest_snapshot
        tag, state = load_newest_snapshot(checkpoint_dir)
        if state is None:
            return []
        with self._lock:
            rids = self._restore_locked(tag, state)
        self.wake.set()                  # rouse an idle scheduler thread
        return rids

    def _restore_locked(self, tag, state):
        self._snap_seq = max(self._snap_seq, int(state.get("seq", 0)))
        if self._fairness is not None and state.get("fairness"):
            self._fairness.load_state(state["fairness"])
        if state.get("rng_torch"):
            self._gen.set_state(torch.tensor(state["rng_torch"],
                                             dtype=torch.uint8))
        elif state.get("rng"):
            logger.warning(f"serving restore[{tag}]: the snapshot's RNG is "
                           f"another framework's key — ignored (sampled "
                           f"streams cannot match across RNGs; greedy "
                           f"outputs are unaffected)")
        now = time.monotonic()
        spec_tail = self._spec_tail
        rids = []
        for r in state.get("requests", []):
            if int(r["rid"]) in self._requests:
                raise ValueError(
                    f"restore(): request id {r['rid']} already exists on "
                    f"this server — call restore() before submitting new "
                    f"work (snapshotted ids are preserved verbatim)")
            ids = np.asarray(r["prompt"], np.int32)
            prefix = [int(t) for t in r.get("tokens", [])]
            max_new, eos = int(r["max_new"]), int(r["eos"])
            if len(prefix) >= max_new or (eos >= 0 and eos in prefix):
                continue                 # finished: nothing to resume
            deadline = None
            if r.get("deadline_remaining_s") is not None:
                deadline = now + float(r["deadline_remaining_s"])
            req = ServeRequest(
                int(r["rid"]), ids, max_new, eos, submitted_it=self._it,
                deadline=deadline, client_id=r.get("client_id"),
                prefix=prefix, submit_t=now, resumed=True,
                priority=min(int(r.get("priority", 0)),
                             self.priority_lanes - 1))
            # submit()'s capacity checks against THIS server (the snapshot
            # may come from one with longer lanes or a bigger pool)
            P = len(ids)
            need = max(P + max_new + spec_tail,
                       -(-P // self.chunk) * self.chunk)
            why = None
            if need > self.max_pos:
                why = (f"restored request needs more than the "
                       f"{self.max_pos} cache positions this server's "
                       f"lanes hold (prompt {P} + new {max_new}) — raise "
                       f"serving.max_cache_len to resume it")
            elif self.paged and pages_for(need, self.page) \
                    > self._pool.allocatable:
                why = (f"restored request needs "
                       f"{pages_for(need, self.page)} pages but this "
                       f"server's pool holds {self._pool.allocatable} "
                       f"allocatable (num_pages={self.num_pages} incl. "
                       f"trash) — raise serving.num_pages to resume it")
            self._requests[req.rid] = req
            self._next_rid = max(self._next_rid, req.rid + 1)
            if why is not None:
                self._record_terminal(req, RequestStatus.ABORTED, why)
                logger.warning(f"serving restore: request {req.rid} does "
                               f"not fit this server — ABORTED")
                continue
            # the resumed fill (prompt + prefix) must still fit a lane;
            # when its chunk-padded tail would not, drop the prefix and
            # decode again from the prompt (the same tokens, at more cost)
            fill = P + len(prefix)
            padded = -(-fill // self.chunk) * self.chunk
            if prefix and max(fill + (max_new - len(prefix)) + spec_tail,
                              padded) > self.max_pos:
                logger.warning(
                    f"serving restore: request {req.rid} prefix "
                    f"({len(prefix)} tokens) does not fit its lane "
                    f"chunk-padded — re-decoding from the prompt")
                req.prefix = []
            if self._tracer is not None:
                req.t_trace = self._tracer.now()
            self._queue.append(req)
            rids.append(req.rid)
        self._next_rid = max(self._next_rid, int(state.get("next_rid", 0)))
        self.stats["resumed"] += len(rids)
        if rids:
            log_dist(f"serving restore[{tag}]: resumed {len(rids)} "
                     f"request(s) {rids}", ranks=[0])
        return rids

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

    def _to_host(self, *ts):
        """Start copying device tensors to pinned host memory; returns
        ``(host tensors, event)`` — read them after ``event.synchronize()``
        (event None on the CPU)."""
        if ts[0].device.type == "cpu":
            return ts, None
        hosts = []
        for t in ts:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            hosts.append(host)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(ts[0].device))
        return tuple(hosts), ev

    def _read(self, hosts, ev, unlocked_wait=False):
        """Wait for ``ev`` and return the host arrays.  ``unlocked_wait``
        (a step's processing on the owner's thread): the engine lock is let
        go for the wait (fully, whatever its depth, as a condition's wait
        does), so the other threads' lock wait does not grow with the
        decode time; the event is already off the queue, and what they
        change meanwhile the mirror reads after."""
        t0 = time.perf_counter()
        if ev is not None and not ev.query():
            if unlocked_wait:
                saved = self._lock._release_save()
                try:
                    ev.synchronize()
                finally:
                    self._lock._acquire_restore(saved)
            else:
                ev.synchronize()
        out = [h.numpy() for h in hosts]
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

    def _record_terminal(self, req, status, detail):
        """A terminal outcome other than ``COMPLETED`` (output None),
        reported by the next ``step()``: the result is recorded before the
        stream's ``end`` event, so a subscriber woken by it can read
        ``result(rid)``."""
        req.status = status
        req.finished_it = self._it
        if status == RequestStatus.ABORTED:
            self.stats["aborted"] += 1
        ttft = (req.first_tok_t - req.submit_t) \
            if req.first_tok_t is not None else None
        self._results[req.rid] = RequestResult(
            rid=req.rid, status=status, detail=detail,
            client_id=req.client_id, submitted_it=req.submitted_it,
            finished_it=self._it, ttft_s=ttft,
            **self._trace_done(req, status))
        if self._flightrec is not None:
            self._flightrec.record("terminal", rid=req.rid, status=status,
                                   detail=detail[:200])
        self._pending_reports[req.rid] = None
        self._publish_end(req, status, detail)

    def _give_back_lanes(self, p):
        """Return a dropped admission's prefill lane(s) to their pools:
        the target's and, under speculation, the draft's."""
        self._lane_pool.give_back(p.lane)
        if p.draft_lane is not None:
            self._draft_lanes.give_back(p.draft_lane)
            p.draft_lane = None

    def _abort_in_flight(self, why):
        """Drop every request past admission and restore the slot
        bookkeeping to all-free; queued requests survive.  The next step
        starts on a fresh workspace (the draft's cache included).  The
        aborted lanes stop on the device with the state they ran on: it is
        dropped here (every lane of the next state is inactive), and so are
        the graphs captured over it, so none of them runs again."""
        lost = [r for r in self._slots if r is not None]
        if self._pending is not None:
            lost.append(self._pending.req)
            self._give_back_lanes(self._pending)
            self._pending = None
        for req in lost:
            if req.status not in TERMINAL_STATUSES:
                self._record_terminal(req, RequestStatus.ABORTED,
                                      f"in-flight request aborted: {why}")
        self._events.clear()
        self._slots = [None] * self.num_slots
        self._free = deque(range(self.num_slots))
        self._mirror_active[:] = False
        self._state = None
        self._deactivate.clear()
        for prog in self._progs:
            prog.reset()
        if self.speculative:
            self._draft_cache = None
        self._paging_reset()
        if lost:
            if self._flightrec is not None:
                self._flightrec.record("abort_in_flight", why=why[:200],
                                       rids=[r.rid for r in lost])
            logger.warning(f"serving {why}: aborted {len(lost)} in-flight "
                           f"request(s) {sorted(r.rid for r in lost)}")

    def _ensure_workspace(self):
        if self._cache is None:
            for prog in self._progs:     # their graphs read the old buffers
                prog.reset()
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
        if self.speculative and self._draft_cache is None:
            for prog in self._progs:
                prog.reset()
            self._draft_cache = self.draft_module.init_cache(
                self.num_slots, self.cache_len,
                dtype=self.engine.compute_dtype)
        if self._state is None:
            self._state = slots.init_slot_state(self.num_slots, self.device)
            self._mirror_active[:] = False
            self._deactivate.clear()

    def _guarded(self, fn, *args, point=None):
        """Run one device call (after firing the fault-injection ``point``,
        if any, so that an injected fault fails the call); on a failure the
        workspace may hold half a step, so every request past admission is
        aborted (the queue survives), the workspace and the decode graphs
        captured on it are dropped, and the error propagates."""
        try:
            if point is not None:
                inject.fire(point)
            return fn(*args)
        except BaseException:
            self._cache = None
            self._abort_in_flight("dispatch failed")
            raise

    # ------------------------------------------------------------------ #
    # Admission: queue -> prefill chunks -> admit
    # ------------------------------------------------------------------ #
    def _pop_request(self):
        if self.priority_lanes > 1:
            return self._pop_request_priority()
        if self.config.admission == "shortest_first":
            req = min(self._queue, key=lambda r: (len(r.ids), r.rid))
            self._queue.remove(req)
            return req
        return self._queue.popleft()

    def _pop_request_priority(self):
        """Priority lanes over the admission order: pop the lowest
        effective lane, ties broken by the policy (queue position for
        fcfs, prompt length for shortest_first).  Effective lane =
        ``priority - floor(waited / priority_aging_s)``, at least 0, so a
        lane-k request reaches lane 0 within ``k * priority_aging_s``
        seconds queued (0: strict lanes); waits are read on the clock of
        this step's plan (at tp > 1, the leader's)."""
        now = self._step_now
        aging = float(self.config.priority_aging_s)

        def lane(r):
            if aging <= 0:
                return r.priority
            return max(0, r.priority - int((now - r.submit_t) / aging))

        if self.config.admission == "shortest_first":
            req = min(self._queue, key=lambda r: (lane(r), len(r.ids), r.rid))
        else:
            req = min(enumerate(self._queue),
                      key=lambda ir: (lane(ir[1]), ir[0]))[1]
        self._queue.remove(req)
        return req

    def _admit(self):
        # lanes another thread retired stop before anything reuses them
        self._flush_deactivations()
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
                    if self._flightrec is not None:
                        self._flightrec.record(
                            "admission_stall", rid=req.rid,
                            pool_in_use=self._pool.in_use
                            if self.paged else None)
                    return
                if self._tracer is not None and req.t_trace is not None:
                    # the queue phase ends: the slot is reserved and the
                    # prefill chunks start
                    req.t_admit_start = self._tracer.now()
                    self._hist.queue_wait.observe(
                        req.t_admit_start - req.t_trace)
                if self._flightrec is not None:
                    self._flightrec.record(
                        "admit_start", rid=req.rid, slot=req.slot,
                        fill_len=pend.fill_len, chunks=pend.n_chunks)
                if self._fairness is not None and not req.resumed:
                    # the prompt is charged once, when admission starts (a
                    # stalled retry above charged nothing); a resumed
                    # request's tokens were charged before its snapshot
                    self._fairness.charge(req.client_id, len(req.fill_ids))
                self._pending = pend
            done = self._run_prefill_chunk(self._pending)
            spent += self.chunk
            if done:
                # still pending while its admit runs: a failed admit
                # aborts it with the requests in flight
                self._dispatch_admit(self._pending)
                self._pending = None

    def _start_prefill(self, req):
        fill = req.fill_ids              # the prompt + any resumed tokens
        P = len(fill)
        if self.paged:
            return self._start_prefill_paged(req, fill, P)
        slot = self._free.popleft()
        req.slot = slot
        req.status = RequestStatus.PREFILLING
        n = -(-P // self.chunk)
        ids_pad = np.zeros((1, n * self.chunk), np.int64)
        ids_pad[0, :P] = fill
        lane = self._lane_pool.take(self.cache_len, self.engine.compute_dtype)
        pend = _PendingPrefill(req, slot, lane, ids_pad, n, P)
        self._take_draft_lane(pend)
        return pend

    def _take_draft_lane(self, pend):
        """Speculative serving: the draft's prefill lane for an admission
        (the prompt's K/V must reach the draft's cache too)."""
        if self.speculative:
            pend.draft_lane = self._draft_lanes.take(
                self.cache_len, self.engine.compute_dtype)

    def _start_prefill_paged(self, req, fill, P):
        """Paged admission: map the longest indexed prefix (full pages,
        refcounted — prefilled ONCE per unique prefix), allocate private
        pages for the rest of the virtual lane, and prefill only from the
        shared boundary on.  Returns ``None`` (nothing popped, nothing
        allocated) when the pool cannot back the request yet."""
        dev_new = req.max_new - len(req.prefix)
        matched = []
        # speculative serving shares no prefix: the draft's lanes have no
        # pool, so its prefill runs from position 0 anyway
        sharing = self.config.prefix_cache and not self.speculative
        if sharing:
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
        # the slot's virtual extent: decode writes through P+dev_new-1, the
        # padded last chunk through s0+n_chunks*C-1 — those pages are the
        # slot's own
        virt = max(P + dev_new, s0 + n_chunks * self.chunk)
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
        if sharing:
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
        self._take_draft_lane(pend)
        return pend

    def _run_prefill_chunk(self, p):
        C = self.chunk
        P = p.fill_len
        # chunk ci covers positions [start + ci*C, start + (ci+1)*C)
        local = int(min(max(P - 1 - p.start - p.ci * C, 0), C - 1))
        ids = self._to_device(p.ids_pad[:, p.ci * C:(p.ci + 1) * C])
        at = torch.full((1,), local, dtype=torch.long, device=self.device)
        start = p.start + p.ci * C
        obs = {"rid": p.req.rid, "slot": p.slot, "chunk": p.ci,
               "phase": "prefill"}
        if self.paged:
            row = self._to_device(self._page_table[p.slot:p.slot + 1])
            logits = self._guarded(
                self._observed("prefill_chunk", slots.paged_chunk, **obs),
                self.module, self._cache, row, ids, start, at)
        else:
            logits = self._guarded(
                self._observed("prefill_chunk", slots.prefill_chunk, **obs),
                self.module, p.lane, ids, start, at)
        if self.speculative:
            # the same chunk into the draft's lane (start is 0-based: no
            # prefix sharing under speculation)
            t0 = time.perf_counter()
            self._guarded(
                self._observed("draft_prefill_chunk", slots.draft_chunk,
                               **obs),
                self.draft_module, p.draft_lane, ids, start)
            self.stats["spec_draft_secs"] += time.perf_counter() - t0
        self._breaker.record_success()
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
        processed.  A resumed request admits with the rest of its budget
        (its prefix already counts against ``max_new``)."""
        req = p.req
        dev_new = req.max_new - len(req.prefix)
        sample = (p.sel, p.slot, p.fill_len, dev_new, req.eos,
                  self._sample_fn, self._gen)
        obs = {"rid": req.rid, "slot": int(p.slot), "phase": "admit"}
        if self.paged:
            first = self._guarded(
                self._observed("admit", slots.paged_admit, **obs),
                self._state, *sample, point="serving.pre_admit")
        else:
            first = self._guarded(
                self._observed("admit", slots.admit, **obs), self._cache,
                self._state, p.lane, *sample, point="serving.pre_admit")
        self._breaker.record_success()
        if self.paged and self.config.prefix_cache and not self.speculative:
            # index this request's full-prompt pages as sharable: their
            # prefill writes were dispatched before this admit, and nothing
            # writes them again (the slot's own writes land at positions
            # >= fill_len)
            self._prefix.register(p.fill_tokens, self.page,
                                  self._slot_pages[p.slot], self._pool,
                                  p.fill_len // self.page)
        if self.speculative:
            t0 = time.perf_counter()
            self._guarded(self._observed("draft_admit", slots.draft_admit,
                                         **obs),
                          self._draft_cache, p.draft_lane, p.slot)
            self.stats["spec_draft_secs"] += time.perf_counter() - t0
        self._slot_last_dispatch[int(p.slot)] = time.monotonic()
        req.status = RequestStatus.RUNNING
        self._slots[p.slot] = req
        self._events.append(("admit", req, p.slot, p.lane, p.draft_lane,
                             *self._to_host(first)))
        self.stats["admitted"] += 1
        if self._tracer is not None and req.t_admit_start is not None:
            # the prefill phase ends with the admit's dispatch; until the
            # first token is processed is the lag-one host window
            req.t_prefill_done = self._tracer.now()

    # ------------------------------------------------------------------ #
    # Decode: one block over every slot
    # ------------------------------------------------------------------ #
    def _dispatch_decode(self):
        # dispatch when anything can be live on the device: a slot active
        # as of the mirror, or an unprocessed admit that probably went live
        if not (self._mirror_active.any()
                or any(e[0] == "admit" for e in self._events)):
            return False
        self._flush_deactivations()
        if self.speculative:
            self._events.append(self._dispatch_spec())
        else:
            live = int(self._mirror_active.sum())
            toks = self._guarded(
                self._observed("decode", self._decode_prog, phase="decode",
                               live_slots=live),
                *self._decode_args(), point="serving.pre_decode_dispatch")
            self._events.append(("decode", *self._to_host(toks)))
        self._breaker.record_success()
        now = time.monotonic()
        for s, r in enumerate(self._slots):
            if r is not None:
                self._slot_last_dispatch[s] = now
        self.stats["decode_calls"] += 1
        return True

    def _decode_args(self):
        pages = self._upload_table() if self.paged else None
        return (self.module, self._cache, self._state, self.block,
                self.max_pos, self._sample_fn, self._gen, pages)

    def _dispatch_spec(self):
        """One speculative round: the draft proposes ``spec_k`` tokens per
        slot from its own lanes, then the target verifies the window in
        one forward and commits on the device — two dispatches chained
        through the device, no host read.  The draft tokens never leave
        the device."""
        t0 = time.perf_counter()
        obs = {"phase": "decode", "live_slots": int(self._mirror_active.sum())}
        draft = self._guarded(
            self._observed("spec_propose", self._propose_prog, **obs),
            *self._propose_args(), point="serving.pre_decode_dispatch")
        t1 = time.perf_counter()
        self.stats["spec_draft_secs"] += t1 - t0
        toks, accepted = self._guarded(
            self._observed("spec_verify", self._verify_prog, **obs),
            *self._verify_args(draft))
        self.stats["spec_verify_secs"] += time.perf_counter() - t1
        return ("spec", *self._to_host(toks, accepted))

    def _propose_args(self):
        return (self.draft_module, self._draft_cache, self._state,
                self.spec_k, self.max_pos)

    def _verify_args(self, draft):
        pages = self._upload_table() if self.paged else None
        return (self.module, self._cache, self._state, draft, self.spec_k,
                self.max_pos, self._sample_fn, self._gen, pages)

    # ------------------------------------------------------------------ #
    # Warmup: capture the decode programs up front
    # ------------------------------------------------------------------ #
    def _warmup_names(self):
        """``warmup()``'s programs under the JAX engine's names."""
        N, S, C, k = self.num_slots, self.cache_len, self.chunk, self.spec_k
        pg, sfx = ("_paged", f"p{self.page}") if self.paged else ("", "")
        names = {"prefill": f"serving_prefill{pg}:c{C}{sfx}"}
        if self.speculative:
            names.update(
                verify=f"serving_spec_verify{pg}:n{N}s{S}k{k}{sfx}",
                propose=f"serving_spec_propose:n{N}s{S}k{k}",
                draft_prefill=f"serving_spec_draft_prefill:c{C}")
        else:
            names["decode"] = f"serving_decode{pg}:n{N}s{S}b{self.block}{sfx}"
        return names

    @torch.no_grad()
    def warmup(self):
        """Run the admission-prefill chunk once and capture the decode
        block — or, speculative, run the draft's prefill chunk and capture
        the propose and verify programs — before the first request, so
        that no request pays for them.  Returns ``{program: seconds}``
        under the JAX engine's names (``serving_prefill[_paged]:...``,
        ``serving_decode[_paged]:...``, ``serving_spec_verify[_paged]:
        ...``, ``serving_spec_propose:...``,
        ``serving_spec_draft_prefill:...``); 0.0 for each once captured.

        The prefill chunks run eagerly (they have no graph): their seconds
        are a first run's.  Unlike JAX's abstract AOT compile, a capture
        runs a real block (or round) over the idle server's free lanes:
        their writes land on the trash page (paged) or in free lanes' rows
        that every read masks and every admission overwrites, the slot
        state is reset afterwards and the sampling generator restored, so
        the served tokens are unchanged.  Raises ``RuntimeError`` once
        requests are in flight."""
        self._check_driver("warmup()")
        with self._lock:
            if self._plans is not None:
                self._check_leader("warmup()")
                self._check_idle("warmup()")
                self._plans.send(Plan(kind="warmup"))
            return self._warmup_locked()

    def _check_idle(self, what):
        if self._closed:
            raise RuntimeError(f"{what} on a closed ServingEngine")
        if self.work_pending():
            raise RuntimeError(f"{what} needs an idle server: call it "
                               "before submit()")

    def _warmup_locked(self):
        self._check_idle("warmup()")
        self._ensure_workspace()
        names = self._warmup_names()
        if self.speculative:
            captured = (self._propose_prog.has_graph(*self._propose_args())
                        and self._verify_prog.num_graphs > 0)
        else:
            captured = self._decode_prog.has_graph(*self._decode_args())
        if captured:
            return {name: 0.0 for name in names.values()}
        accel = self.engine._accel
        C = self.chunk
        ids = torch.zeros((1, C), dtype=torch.long, device=self.device)
        at = torch.full((1,), C - 1, dtype=torch.long, device=self.device)
        gen_state = self._gen.get_state()
        report = {}

        def timed(name, fn, *args):
            accel.synchronize(self.device)
            t0 = time.perf_counter()
            out = self._guarded(fn, *args)
            accel.synchronize(self.device)
            report[names[name]] = time.perf_counter() - t0
            return out

        try:
            if self.paged:
                # an all-trash table row: the chunk writes the trash page
                row = torch.zeros((1, self.n_slot_pages), dtype=torch.int32,
                                  device=self.device)
                timed("prefill", slots.paged_chunk, self.module, self._cache,
                      row, ids, 0, at)
            else:
                lane = self._lane_pool.take(self.cache_len,
                                            self.engine.compute_dtype)
                timed("prefill", slots.prefill_chunk, self.module, lane, ids,
                      0, at)
                self._lane_pool.give_back(lane)
            if self.speculative:
                lane = self._draft_lanes.take(self.cache_len,
                                              self.engine.compute_dtype)
                timed("draft_prefill", slots.draft_chunk, self.draft_module,
                      lane, ids, 0)
                self._draft_lanes.give_back(lane)
                draft = timed("propose", self._propose_prog,
                              *self._propose_args())
                timed("verify", self._verify_prog, *self._verify_args(draft))
            else:
                timed("decode", self._decode_prog, *self._decode_args())
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
    def _process_events(self, finished, keep=0, unlocked_wait=False):
        """Process the dispatched events, oldest first, until ``keep`` are
        left.  ``unlocked_wait`` (a step's processing, on the owner's
        thread): let go of the lock while waiting on each event."""
        while len(self._events) > keep:
            inject.fire("serving.mirror_drain")
            ev = self._events.popleft()
            if ev[0] == "admit":
                self._process_admit(ev, finished, unlocked_wait)
            elif ev[0] == "spec":
                self._process_spec(ev, finished, unlocked_wait)
            else:
                self._process_decode(ev, finished, unlocked_wait)

    def _process_admit(self, ev, finished, unlocked_wait):
        _, req, slot, lane, draft_lane, hosts, event = ev
        first = int(self._read(hosts, event, unlocked_wait)[0])
        self._lane_pool.give_back(lane)
        if draft_lane is not None:
            self._draft_lanes.give_back(draft_lane)
        if req.status in TERMINAL_STATUSES:
            # cancelled while its admit was in flight: free the slot now
            # and drop the token (the lane was made inactive on the device)
            self._slots[slot] = None
            self._free.append(int(slot))
            self._release_slot_pages(slot)
            return
        if req.first_tok_t is None:
            req.first_tok_t = time.monotonic()
        if self._tracer is not None and req.t_first_tok is None \
                and req.t_trace is not None:
            # stamped once, where the first token is processed: a stream's
            # replay re-reads req.tokens and never comes back here
            req.t_first_tok = req.t_last_tok = self._tracer.now()
            self._hist.ttft.observe(req.t_first_tok - req.t_trace)
        req.tokens = list(req.prefix) + [first]
        if self._fairness is not None:
            # the admission's sampled token (the prompt was charged when
            # admission started)
            self._fairness.charge(req.client_id, 1)
        # mirror the admit's activation rule (the device saw the rest of
        # the budget, max_new - len(prefix))
        if (req.eos >= 0 and first == req.eos) \
                or req.max_new - len(req.prefix) == 1:
            self._free_slot(slot)
            finished[req.rid] = self._finalize(req)
        else:
            self._mirror_active[slot] = True
            self._publish_progress(req)

    def _free_slot(self, s):
        self._mirror_active[s] = False
        self._slots[s] = None
        self._free.append(int(s))
        self._release_slot_pages(s)

    def _mirror_commit_token(self, s, req, tok, finished):
        """The per-token mirror rule of both decode paths (a block's
        steps, a speculative window's committed tokens): append the
        token, then retire the slot on its eos or budget (the in-program
        rule) or push the token to the request's streams.  Returns True
        when the slot retired."""
        req.tokens.append(tok)
        self.stats["decode_tokens"] += 1
        if self._tracer is not None and req.t_trace is not None:
            # time between tokens, stamped once per token here
            now = self._tracer.now()
            if req.t_last_tok is not None:
                self._hist.tbt.observe(now - req.t_last_tok)
            req.t_last_tok = now
        if self._fairness is not None:
            self._fairness.charge(req.client_id, 1)
        if (req.eos >= 0 and tok == req.eos) \
                or len(req.tokens) >= req.max_new:
            self._free_slot(s)
            finished[req.rid] = self._finalize(req)
            return True
        self._publish_progress(req)
        return False

    def _process_decode(self, ev, finished, unlocked_wait):
        t0c = self._tracer.now() if self._tracer is not None else None
        n0 = self.stats["decode_tokens"]
        toks = self._read(ev[1], ev[2], unlocked_wait)[0]   # [block, N]
        for row in toks:
            for s in np.nonzero(self._mirror_active)[0]:
                self._mirror_commit_token(s, self._slots[s], int(row[s]),
                                          finished)
        self._observe_commit("decode", t0c,
                             self.stats["decode_tokens"] - n0)
        self.occupancy_trace.append(
            (self._it, int(self._mirror_active.sum())))

    def _observe_commit(self, kind, t0c, committed):
        """The mirror's commit of one event: a span and a ring event."""
        if self._tracer is not None:
            self._tracer.add("commit", "mirror", t0c, self._tracer.now(),
                             track="scheduler", kind=kind, tokens=committed)
        if self._flightrec is not None:
            self._flightrec.record("commit", kind=kind, tokens=committed)

    def _process_spec(self, ev, finished, unlocked_wait):
        """Mirror one speculative round: per live slot, exactly the
        ``accepted[s]`` committed tokens (rows past it are window
        padding), each through the per-token rule — a round that commits
        m tokens pushes m ordered stream events, and a mid-window
        retirement cuts the stream at the terminal token."""
        t0c = self._tracer.now() if self._tracer is not None else None
        n0 = self.stats["spec_committed_tokens"]
        # [k+1, N], [N]
        toks, acc = self._read(ev[1], ev[2], unlocked_wait)
        st = self.stats
        st["spec_rounds"] += 1
        for s in np.nonzero(self._mirror_active)[0]:
            req = self._slots[s]
            m = int(acc[s])
            st["spec_windows"] += 1
            st["spec_committed_tokens"] += m
            for i in range(m):
                # the device stopped committing at exactly the token that
                # retires here
                if self._mirror_commit_token(s, req, int(toks[i, s]),
                                             finished):
                    break
        w = st["spec_windows"]
        if w:
            committed = st["spec_committed_tokens"]
            st["spec_accept_rate"] = (committed - w) / (w * self.spec_k)
            st["spec_tokens_per_dispatch"] = committed / st["spec_rounds"]
        d, v = st["spec_draft_secs"], st["spec_verify_secs"]
        if d + v > 0:
            st["spec_draft_fraction"] = d / (d + v)
        self._observe_commit("spec", t0c, st["spec_committed_tokens"] - n0)
        self.occupancy_trace.append(
            (self._it, int(self._mirror_active.sum())))

    def _finalize(self, req):
        """The ``generate()`` output contract: ``[prompt..., tokens...]`` of
        length ``P + max_new_tokens``, eos-padded past an early stop (a
        resumed request's tokens begin with its prefix)."""
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
            client_id=req.client_id, submitted_it=req.submitted_it,
            finished_it=self._it, ttft_s=req.first_tok_t - req.submit_t,
            **self._trace_done(req, RequestStatus.COMPLETED))
        if self._flightrec is not None:
            self._flightrec.record("terminal", rid=req.rid,
                                   status=RequestStatus.COMPLETED,
                                   tokens=len(req.tokens))
        self._publish_end(req, RequestStatus.COMPLETED)
        return out


    def _emit_metrics(self):
        """The ``Serving/*`` monitor events of this iteration (the JAX
        engine's series)."""
        mon = self.monitor
        if mon is None or not getattr(mon, "enabled", True):
            return
        st, it = self.stats, self._it
        wall = st["wall_secs"]
        events = [
            ("Serving/queue_depth", self.queue_depth, it),
            ("Serving/slot_occupancy", self.active_slots / self.num_slots,
             it),
            ("Serving/decode_tok_s",
             st["decode_tokens"] / wall if wall > 0 else 0.0, it),
            ("Serving/prefill_decode_ratio",
             st["prefill_tokens"] / max(st["decode_tokens"], 1), it),
            ("Serving/completed", st["completed"], it),
            ("Serving/shed", st["shed"], it),
            ("Serving/cancelled", st["cancelled"], it),
            ("Serving/aborted", st["aborted"], it),
            ("Serving/breaker_open", 1.0 if self._breaker.open else 0.0, it),
            ("Serving/lock_wait_scheduler_s", st["lock_wait_scheduler_s"],
             it),
            ("Serving/lock_wait_handler_s", st["lock_wait_handler_s"], it),
        ]
        if self._fairness is not None:
            events.append(("Serving/fairness_rejected",
                           st["fairness_rejected"], it))
        if self.paged:
            events += [("Serving/page_pool_util",
                        self.page_pool_utilization, it),
                       ("Serving/prefix_hit_rate", self.prefix_hit_rate, it)]
        if self._memwatch is not None:
            events += [(f"Serving/{k}", st[k], it) for k in (
                "hbm_bytes_in_use", "hbm_peak_bytes",
                "hbm_unattributed_bytes")]
        if self.speculative:
            events += [(f"Serving/{k}", st[k], it) for k in (
                "spec_accept_rate", "spec_tokens_per_dispatch",
                "spec_draft_fraction")]
        mon.write_events(events)


def _weakly(server, name):
    """A callable that reads ``server``'s attribute ``name`` (calling it if
    it is a method) through a weak reference, past the concurrency
    checks: what the server's own lock and sampler hold of it must not
    keep a deleted server alive until the cycle collector runs."""
    ref = weakref.ref(server)

    def read():
        srv = ref()
        if srv is None:
            return None
        value = object.__getattribute__(srv, name)
        return value() if callable(value) else value

    return read


def _drop_counter(server):
    """A stream's ``on_drop`` hook that counts into ``server``'s
    ``stats["stream_bridge_drops"]``, holding the server weakly: a strong
    reference from its own streams would keep a deleted server, its
    caches and its graphs alive until the cycle collector ran."""
    ref = weakref.ref(server)

    def on_drop(rid, exc):
        srv = ref()
        if srv is not None:
            srv.stats["stream_bridge_drops"] += 1

    return on_drop


def _draft_engine(engine, module):
    """An inference engine over a draft module, on ``engine``'s device in
    its compute dtype (its ``set_params`` casts float weights as the
    target's does)."""
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import InferenceEngine
    return InferenceEngine(module, DeepSpeedInferenceConfig(
        dtype=engine._config.dtype), device=engine.device)


def _resolve_draft(engine, cfg, draft_module, draft_params):
    """The draft model behind ``serving.speculative`` (JAX
    ``ServingEngine._resolve_draft``): an explicit ``(draft_module,
    draft_params)`` pair wins; ``spec_draft_model="self"`` drafts with the
    target's own module and weights, no copy; an OPT preset name builds
    the architecture at the target's vocabulary with the given
    ``draft_params`` — or seeded random weights with a loud warning (the
    accept rate's floor).  Returns the module, on the engine's device in
    its compute dtype."""
    if draft_module is not None:
        if draft_params is None:
            raise ValueError("draft_module passed without draft_params")
        draft = _draft_engine(engine, draft_module)
        draft.set_params(draft_params)
        return draft.module
    name = (cfg.spec_draft_model or "").strip()
    if name == "self":
        if draft_params is not None:
            raise ValueError(
                "spec_draft_model='self' drafts with the TARGET model's own "
                "weights, but draft_params was also passed — silently "
                "ignoring them would run the wrong draft; pass draft_module "
                "with those params, or drop one of the two")
        return engine.module
    if not name:
        raise ValueError(
            "serving.speculative=True needs a draft model: pass "
            "engine.serve(draft_module=..., draft_params=...) or set "
            "serving.spec_draft_model ('self' = the target drafts for "
            "itself; docs/serving.md 'Speculative decoding')")
    from deepspeed_tpu_torch.models.opt import opt_model
    tcfg = engine.module.config
    draft = _draft_engine(engine, opt_model(
        name, vocab_size=tcfg.vocab_size,
        max_seq_len=max(tcfg.max_seq_len, int(cfg.max_cache_len)),
        dtype=tcfg.dtype))
    if draft_params is not None:
        draft.set_params(draft_params)
    else:
        logger.warning(
            f"serving.spec_draft_model={name!r} with no draft_params — "
            f"RANDOM draft weights: the accept rate will be ~0 and "
            f"speculation will SLOW decode; pass trained weights via "
            f"engine.serve(draft_params=...)")
        draft.init_params(seed=0)
    return draft.module
