"""``serving`` config block (port of
``deepspeed_tpu/inference/serving/config.py``).

The same keys and defaults as the JAX package's ``ServingConfig``, as a
dataclass.  Ported: slots, the admission chunk and its token budget, the
decode block, the admission order, the paged pool with prefix sharing,
sampling, speculative decoding (a draft model proposes ``spec_k`` tokens
per slot, the target verifies them in one forward), and the request
lifecycle — the bounded queue (``max_queue_depth``, ``queue_policy``),
default deadlines, the circuit breaker, the ``drain()`` timeout and the
preemption drain budget — and the front end and its observability:
priority lanes with aging, per-client fairness, span tracing and
histograms, the flight recorder, the profile endpoint and device-memory
telemetry.  ``paged_kernel=False`` (the JAX package's A/B switch to a
gather path) raises ``NotImplementedError``: a page pool always runs the
paged kernels K6 / K7.
"""

import dataclasses

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel


@dataclasses.dataclass(init=False)
class ServingConfig(DeepSpeedConfigModel):
    """Knobs of :class:`deepspeed_tpu_torch.inference.serving.ServingEngine`
    (``engine.serve()``); see the JAX package's ``ServingConfig`` for each
    knob's full story."""
    enabled: bool = False
    # fixed KV slot lanes: every decode block runs all of them
    num_slots: int = 8
    # per-slot cache positions (rounded up to a multiple of 8); a request
    # needs ceil(prompt/chunk)*chunk and prompt + max_new_tokens positions
    max_cache_len: int = 2048
    # admission-prefill chunk (multiple of 8, floor 8, cap 512)
    prefill_chunk: int = 128
    # prefill tokens spent per scheduler iteration before decode resumes;
    # 0 = finish each admission's prefill in one iteration
    prefill_token_budget: int = 512
    # decode steps per scheduler iteration
    decode_block: int = 4
    # admission order: "fcfs" | "shortest_first"
    admission: str = "fcfs"
    # one shared page pool + per-slot block tables instead of slot lanes
    paged: bool = False
    # positions per page (rounded up to a multiple of 8, floor 8)
    page_size: int = 64
    # pool pages INCLUDING the trash page 0; 0 = worst case,
    # num_slots * ceil(max_cache_len / page_size) + 1
    num_pages: int = 0
    # paged attention kernels K6 / K7; False (the JAX gather path) raises
    paged_kernel: bool = True
    # copy-on-write prefix sharing at page granularity (paged only)
    prefix_cache: bool = True
    # ---- speculative decoding (greedy only) ----
    speculative: bool = False
    # draft tokens proposed per slot and round (1..64)
    spec_k: int = 4
    # the draft when no draft_module is passed to serve(): "self" (the
    # target drafts for itself) or an OPT preset name (random weights)
    spec_draft_model: str = ""
    # ---- sampling, for every request ----
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # ---- the request lifecycle ----
    # bounded queue: submit() beyond this depth raises QueueFull
    # ("reject") or runs scheduler iterations until a spot frees
    # ("block"); 0 = unbounded
    max_queue_depth: int = 0
    queue_policy: str = "reject"
    # default per-request deadline, seconds from submit (submit(
    # deadline_s=...) overrides it); 0 = none.  Past it a queued request
    # is shed before it takes a slot, a running one at the next step
    default_deadline_s: float = 0.0
    # this many consecutive failed dispatches open the circuit breaker
    # (submit() raises CircuitOpen, nothing dispatches) until a half-open
    # probe after the cooldown succeeds; 0 = off, failures propagate
    breaker_threshold: int = 0
    breaker_cooldown_s: float = 30.0
    # drain() wall-clock budget: past it DrainTimeout with per-slot
    # diagnostics; 0 = no limit
    drain_timeout_s: float = 0.0
    # preempt(): decode the slots in flight for up to this long, then
    # snapshot the rest; 0 = snapshot at once
    drain_budget_s: float = 30.0
    # ---- the front end ----
    # admission lanes: submit(priority=p), 0 <= p < priority_lanes, 0 the
    # most urgent; 1 = no lanes
    priority_lanes: int = 1
    # a queued request moves up one lane per this many seconds waited; 0 =
    # strict lanes (low priority can starve)
    priority_aging_s: float = 30.0
    # per-client_id token budget: submit() from a client whose decaying
    # balance reaches fairness_tokens_per_s * fairness_window_s raises
    # QueueFull (HTTP 429); 0 = off
    fairness_tokens_per_s: float = 0.0
    # the balance's decay time constant (seconds)
    fairness_window_s: float = 10.0
    # ---- observability (host bookkeeping only; tokens and graph
    # captures are the same either way) ----
    # per-request span trees (srv.dump_trace(path): Chrome trace JSON),
    # the latency breakdown on every RequestResult, and the TTFT / time
    # between tokens / queue wait / dispatch / lock wait histograms
    tracing: bool = False
    trace_max_spans: int = 100000
    # a bounded ring of recent scheduler events, dumped to JSON on
    # breaker-open, DrainTimeout, ConcurrencyViolation, scheduler-thread
    # death, GET /debug/flightrec, SIGUSR2 or srv.dump_flightrec()
    flight_recorder: bool = False
    flight_recorder_events: int = 2048
    # where dumps land; "" = <tmpdir>/dstpu_flightrec
    flight_recorder_dir: str = ""
    # POST /debug/profile?secs=N: a torch.profiler Chrome trace
    profile_endpoint: bool = False
    # device-memory samples at the scheduler's seams on its owner thread,
    # reconciled against the engine's known owners
    memory_telemetry: bool = False
    memory_sample_interval_s: float = 10.0

    def validate(self):
        if not self.paged_kernel:
            raise NotImplementedError(
                "serving config: paged_kernel=False (the gather path) is not "
                "offered by deepspeed_tpu_torch: a page pool always runs the "
                "paged attention kernels")
        if self.queue_policy not in ("reject", "block"):
            raise ValueError(f"serving.queue_policy={self.queue_policy!r}: "
                             f"one of 'reject', 'block'")
        if self.admission not in ("fcfs", "shortest_first"):
            raise ValueError(f"serving.admission={self.admission!r}: one of "
                             f"'fcfs', 'shortest_first'")
