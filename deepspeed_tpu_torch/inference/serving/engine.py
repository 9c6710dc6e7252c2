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

One thread drives the scheduler (``submit`` / ``step`` / ``drain`` /
``cancel`` / ``preempt`` / ``close`` are not thread-safe; a stream may be
read from any thread).  The JAX engine's owner binding and instrumented
lock (and with them a ``"block"`` submit from another thread), HTTP front
end, fairness, priority lanes, tracing and memory telemetry are not
ported yet.
"""

import json
import math
import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.serving import slots
from deepspeed_tpu_torch.model_implementations.features.cuda_graph import (
    CompiledGraphModule)
from deepspeed_tpu_torch.inference.serving.config import ServingConfig
from deepspeed_tpu_torch.inference.serving.paging import (PagePool,
                                                          PrefixIndex,
                                                          compact_page_str,
                                                          pages_for)
from deepspeed_tpu_torch.inference.serving.slo import (CircuitBreaker,
                                                       DrainTimeout,
                                                       QueueFull,
                                                       RequestResult,
                                                       RequestStatus,
                                                       TERMINAL_STATUSES,
                                                       TokenStream)
from deepspeed_tpu_torch.runtime.fault import inject
from deepspeed_tpu_torch.utils.logging import log_dist, logger


@dataclass(eq=False)
class ServeRequest:
    """One queued / running request (host bookkeeping only).  ``prefix``
    holds tokens generated by an earlier server (a request restored from
    a preemption snapshot, ``resumed``): admission prefills ``ids +
    prefix`` and the device decodes only the rest of the budget.
    ``deadline`` is a ``time.monotonic()`` instant (``None``: none);
    ``priority`` is the admission lane (always 0: priority lanes are not
    ported); ``streamed`` counts the tokens already pushed to its
    streams."""
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

    def __init__(self, engine, draft_module=None, draft_params=None,
                 **overrides):
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
        # speculative decoding: the draft model and the fixed verify window
        self.speculative = bool(cfg.speculative)
        self.spec_k = int(cfg.spec_k)
        self.draft_module = None
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
        self._gen = engine._accel.manual_seed(int(cfg.seed), self.device)
        self._next_rid = 0
        self._it = 0
        self._requests = {}
        self._results = {}
        # non-COMPLETED terminal outcomes, returned by the next step()
        self._pending_reports = {}
        self._streams = {}               # rid -> [TokenStream]
        self._breaker = CircuitBreaker(cfg.breaker_threshold,
                                       cfg.breaker_cooldown_s)
        self._closed = False
        self._close_report = []          # the ids undrained at close
        self._snap_seq = 0               # snapshot lineage
        self._slot_last_dispatch = {}    # slot -> monotonic time
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
                      # the JAX key for paged decodes that skipped the
                      # paged kernel: always 0, a pool always runs K6/K7
                      "paged_attention_fallback": 0}
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
        log_dist(f"serving engine: {self.num_slots} slots x "
                 f"{self.cache_len} positions, "
                 + (f"paged ({self.num_pages} pages of {self.page})"
                    if self.paged else "monolithic lanes")
                 + (f", speculative k={self.spec_k}"
                    if self.speculative else "")
                 + f", kernels {self.kernel_modes}", ranks=[0])

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
    # Public API
    # ------------------------------------------------------------------ #
    def submit(self, input_ids, max_new_tokens=32, eos_token_id=-1,
               deadline_s=None, client_id=None, priority=0):
        """Enqueue one prompt (1-D ids in the vocabulary: a list, numpy
        array or tensor); returns the request id.  A request must fit a slot:
        ``ceil(P/chunk)*chunk`` and ``P + max_new_tokens`` positions (plus
        ``spec_k - 1`` under speculation; and, paged, that many pages of
        the pool) — one that never can is refused with ``ValueError``.

        ``deadline_s`` (seconds from now; ``None``: the config's
        ``default_deadline_s``, ``0``: already expired): past it the
        request is shed from the queue before it takes a slot, or retired
        at the next step once in one — terminal status ``SHED_DEADLINE``.
        ``client_id`` is an opaque value carried through results and
        snapshots (stored as JSON there: a value JSON cannot hold is
        stored as its ``str``).  ``priority`` must be 0 (priority lanes
        are not ported).  Raises :class:`~.slo.CircuitOpen` while the
        breaker is open, and :class:`~.slo.QueueFull` at
        ``max_queue_depth`` under ``queue_policy="reject"`` (``"block"``
        runs scheduler steps here until a spot frees)."""
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
        priority = int(priority)
        lanes = int(self.config.priority_lanes)
        if not 0 <= priority < lanes:
            raise ValueError(
                f"priority={priority}: need 0 <= priority < "
                f"serving.priority_lanes={lanes} (0 = most urgent)")
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
        self._apply_backpressure()
        if deadline_s is None and self.config.default_deadline_s > 0:
            deadline_s = self.config.default_deadline_s
        deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        req = ServeRequest(self._next_rid, ids, max_new, int(eos_token_id),
                           submitted_it=self._it, deadline=deadline,
                           client_id=client_id, submit_t=time.monotonic(),
                           priority=priority)
        self._next_rid += 1
        self._queue.append(req)
        self._requests[req.rid] = req
        return req.rid

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
        # block: run the scheduler here until a spot frees.  Progress is
        # certain while anything can retire or admit; an open breaker
        # with nothing in flight cannot make any — refuse then
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
        while it runs.  Raises ``KeyError`` for an id never issued."""
        self._known(rid, "result()")
        return self._results.get(rid)

    def status(self, rid):
        """The request's :class:`~.slo.RequestStatus` string; ``KeyError``
        for an id never issued."""
        return self._known(rid, "status()").status

    def cancel(self, rid):
        """Retire a request now, with terminal status ``CANCELLED``: a
        queued one never takes a slot; one in its admission prefill gives
        back its slot, pages and prefill lanes; one in a slot gives back
        the slot and its pages, its lane is made inactive on the device
        (a write in stream order: nothing is read back), and its tokens
        still in flight are dropped.  Returns False for a request already
        ended (or preempted); ``KeyError`` for an id never issued."""
        req = self._known(rid, "cancel()")
        if req.status in TERMINAL_STATUSES \
                or req.status == RequestStatus.PREEMPTED:
            return False
        self.stats["cancelled"] += 1
        if req in self._queue:
            self._queue.remove(req)
            self._record_terminal(req, RequestStatus.CANCELLED,
                                  "cancelled while queued")
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
        frees the slot and its pages.  While its admit is still in flight
        (mirror not yet live), ``_process_admit`` frees the slot."""
        if self._state is not None:
            self._state["active"][req.slot] = False
        if self._mirror_active[req.slot]:
            self._free_slot(req.slot)

    def token_events(self, rid, on_event=None):
        """Subscribe to the request's per-token stream: a
        :class:`~.slo.TokenStream` fed where the host mirror processes
        the device's tokens (one event behind the device, one event per
        token).  Subscribing replays every token already generated and,
        for an ended request, its ``end`` event, so the stream is
        lossless whenever it attaches.  ``on_event`` is called with each
        event as it is pushed and must not block.  ``KeyError`` for an id
        never issued."""
        req = self._known(rid, "token_events()")
        stream = TokenStream(rid, on_event=on_event,
                             on_drop=_drop_counter(self))
        for i, t in enumerate(req.tokens):
            stream.push({"event": "token", "rid": rid, "index": i,
                         "token": int(t)})
        if req.status in TERMINAL_STATUSES \
                or req.status == RequestStatus.PREEMPTED:
            res = self._results.get(rid)
            stream.push({"event": "end", "rid": rid, "status": req.status,
                         "detail": res.detail if res is not None else ""})
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

    def step(self):
        """One scheduler iteration: deadline shedding, admission prefill
        under the token budget, one decode-block dispatch, then the device
        results one event behind.  Returns ``{rid: output}`` for every
        request that reached a terminal status in this iteration: the
        output for ``COMPLETED``, ``None`` for the others (their detail in
        :meth:`result`)."""
        if self._closed:
            raise RuntimeError("step() on a closed ServingEngine")
        t0 = time.perf_counter()
        inject.fire("serving.sigterm_at_iter")
        self._ensure_workspace()
        finished = {}
        self._shed_expired()
        if self._breaker.enabled:
            # a failed dispatch is absorbed (the failing call already
            # aborted the requests in flight and dropped the workspace)
            # and counted; threshold consecutive ones open the breaker:
            # nothing is dispatched until the cooldown's half-open probe
            dispatched = False
            try:
                if self._breaker.allow_dispatch():
                    self._admit()
                    dispatched = self._dispatch_decode()
            except Exception as e:
                self._breaker.record_failure(e)
                self.stats["dispatch_failures"] += 1
                logger.warning(
                    f"serving dispatch failure absorbed by the circuit "
                    f"breaker ({self._breaker.consecutive_failures}"
                    f"/{self._breaker.threshold} consecutive"
                    f"{'; OPEN' if self._breaker.open else ''}): "
                    f"{type(e).__name__}: {e}")
        else:
            self._admit()
            dispatched = self._dispatch_decode()
        # lag-one: with fresh work in flight, leave the newest event unread
        # so the device keeps running while the host does bookkeeping; once
        # nothing new was dispatched, flush fully
        self._process_events(finished, keep=1 if dispatched else 0)
        self.stats["iterations"] += 1
        self.stats["wall_secs"] += time.perf_counter() - t0
        self._it += 1
        finished.update(self._pending_reports)
        self._pending_reports.clear()
        return finished

    def _shed_expired(self):
        """Deadlines at the scheduling point: expired queued requests are
        shed before admission (they never take a slot); an expired
        admission in progress gives back its slot, pages and lanes; an
        expired request in a slot is retired there (:meth:`_retire_in_slot`:
        its lane stops on the device too)."""
        now = time.monotonic()
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        for req in expired:
            self._queue.remove(req)
            self.stats["shed"] += 1
            self._record_terminal(
                req, RequestStatus.SHED_DEADLINE,
                f"deadline expired {now - req.deadline:.3f}s ago while "
                f"queued (never occupied a slot)")
        p = self._pending
        if p is not None and p.req.deadline is not None \
                and now >= p.req.deadline:
            self._give_back_lanes(p)
            self._free.append(int(p.slot))
            self._release_slot_pages(p.slot)
            self._pending = None
            self.stats["shed"] += 1
            self._record_terminal(p.req, RequestStatus.SHED_DEADLINE,
                                  "deadline expired during admission "
                                  "prefill")
        for req in list(self._slots):
            if req is None or req.deadline is None or now < req.deadline \
                    or req.status in TERMINAL_STATUSES:
                continue
            self.stats["shed"] += 1
            self._record_terminal(req, RequestStatus.SHED_DEADLINE,
                                  f"deadline expired in slot {req.slot} "
                                  f"after {len(req.tokens)} token(s)")
            self._retire_in_slot(req)

    def work_pending(self):
        """True while anything submitted has not finished: queued,
        mid-prefill, dispatched or live on the host mirror."""
        return bool(self._queue or self._pending is not None or self._events
                    or self._mirror_active.any())

    def drain(self, timeout_s=None):
        """Run the scheduler until every submitted request has reached a
        terminal status; returns ``{rid: output}`` for everything that
        ended during the call (``None`` for the non-``COMPLETED``).
        ``timeout_s`` (default: the config's ``drain_timeout_s``; 0 or
        None: no limit) bounds the wall clock: past it
        :class:`~.slo.DrainTimeout` is raised with per-slot diagnostics
        (slot, request, age of its last dispatch)."""
        if timeout_s is None:
            timeout = self.config.drain_timeout_s or None
        else:
            timeout = timeout_s or None      # an explicit 0: no limit
        t0 = time.monotonic()
        results = {}
        while self.work_pending():
            elapsed = time.monotonic() - t0
            if timeout is not None and elapsed > timeout:
                raise DrainTimeout(self._drain_diagnostics(timeout, elapsed))
            if self._breaker.open and not self._breaker.allow_dispatch() \
                    and not (self._events or self._mirror_active.any()):
                # an open breaker with nothing in flight: wait out the
                # cooldown instead of spinning on the queue
                time.sleep(min(0.01,
                               self._breaker.seconds_until_half_open()))
            results.update(self.step())
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
        :meth:`preempt`, the snapshotted ids)."""
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
        self._closed = True
        self._close_report = undrained
        return list(undrained)

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
        fresh server resumes the snapshot with :meth:`restore`."""
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
        self._closed = True
        self._close_report = sorted(snapped)
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
        so the files stay interchangeable for greedy requests."""
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
        reason.  Returns the ids queued (empty when there is nothing to
        resume)."""
        from deepspeed_tpu_torch.inference.serving.snapshot import \
            load_newest_snapshot
        tag, state = load_newest_snapshot(checkpoint_dir)
        if state is None:
            return []
        self._snap_seq = max(self._snap_seq, int(state.get("seq", 0)))
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
                prefix=prefix, submit_t=now, resumed=True)
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

    def _read(self, hosts, ev):
        t0 = time.perf_counter()
        if ev is not None:
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
            finished_it=self._it, ttft_s=ttft)
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
        for prog in self._progs:
            prog.reset()
        if self.speculative:
            self._draft_cache = None
        self._paging_reset()
        if lost:
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
        if self.paged:
            row = self._to_device(self._page_table[p.slot:p.slot + 1])
            logits = self._guarded(slots.paged_chunk, self.module,
                                   self._cache, row, ids, start, at)
        else:
            logits = self._guarded(slots.prefill_chunk, self.module, p.lane,
                                   ids, start, at)
        if self.speculative:
            # the same chunk into the draft's lane (start is 0-based: no
            # prefix sharing under speculation)
            t0 = time.perf_counter()
            self._guarded(slots.draft_chunk, self.draft_module, p.draft_lane,
                          ids, start)
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
        if self.paged:
            first = self._guarded(slots.paged_admit, self._state, *sample,
                                  point="serving.pre_admit")
        else:
            first = self._guarded(slots.admit, self._cache, self._state,
                                  p.lane, *sample, point="serving.pre_admit")
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
            self._guarded(slots.draft_admit, self._draft_cache, p.draft_lane,
                          p.slot)
            self.stats["spec_draft_secs"] += time.perf_counter() - t0
        self._slot_last_dispatch[int(p.slot)] = time.monotonic()
        req.status = RequestStatus.RUNNING
        self._slots[p.slot] = req
        self._events.append(("admit", req, p.slot, p.lane, p.draft_lane,
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
        if self.speculative:
            self._events.append(self._dispatch_spec())
        else:
            toks = self._guarded(self._decode_prog, *self._decode_args(),
                                 point="serving.pre_decode_dispatch")
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
        draft = self._guarded(self._propose_prog, *self._propose_args(),
                              point="serving.pre_decode_dispatch")
        t1 = time.perf_counter()
        self.stats["spec_draft_secs"] += t1 - t0
        toks, accepted = self._guarded(self._verify_prog,
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
        if self._closed:
            raise RuntimeError("warmup() on a closed ServingEngine")
        if self.work_pending():
            raise RuntimeError("warmup() needs an idle server: call it "
                               "before submit()")
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
    def _process_events(self, finished, keep=0):
        while len(self._events) > keep:
            inject.fire("serving.mirror_drain")
            ev = self._events.popleft()
            if ev[0] == "admit":
                self._process_admit(ev, finished)
            elif ev[0] == "spec":
                self._process_spec(ev, finished)
            else:
                self._process_decode(ev, finished)

    def _process_admit(self, ev, finished):
        _, req, slot, lane, draft_lane, hosts, event = ev
        first = int(self._read(hosts, event)[0])
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
        req.tokens = list(req.prefix) + [first]
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
        if (req.eos >= 0 and tok == req.eos) \
                or len(req.tokens) >= req.max_new:
            self._free_slot(s)
            finished[req.rid] = self._finalize(req)
            return True
        self._publish_progress(req)
        return False

    def _process_decode(self, ev, finished):
        toks = self._read(ev[1], ev[2])[0]               # [block, N]
        for row in toks:
            for s in np.nonzero(self._mirror_active)[0]:
                self._mirror_commit_token(s, self._slots[s], int(row[s]),
                                          finished)
        self.occupancy_trace.append(
            (self._it, int(self._mirror_active.sum())))

    def _process_spec(self, ev, finished):
        """Mirror one speculative round: per live slot, exactly the
        ``accepted[s]`` committed tokens (rows past it are window
        padding), each through the per-token rule — a round that commits
        m tokens pushes m ordered stream events, and a mid-window
        retirement cuts the stream at the terminal token."""
        toks, acc = self._read(ev[1], ev[2])             # [k+1, N], [N]
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
            finished_it=self._it, ttft_s=req.first_tok_t - req.submit_t)
        self._publish_end(req, RequestStatus.COMPLETED)
        return out


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
