"""``serving`` config block (port of
``deepspeed_tpu/inference/serving/config.py``).

The same keys and defaults as the JAX package's ``ServingConfig``, as a
dataclass.  The continuous-batching core is ported: slots, the admission
chunk and its token budget, the decode block, the admission order, the
paged pool with prefix sharing, and sampling.  Every other knob — speculative decoding, the SLO / queue /
breaker / drain knobs, priority lanes, fairness, tracing, the flight
recorder, the profile endpoint and memory telemetry — raises
``NotImplementedError`` when set away from its default, so a config never
silently does nothing.  ``paged_kernel=False`` (the JAX package's A/B
switch to a gather path) raises too: a page pool always runs the paged
kernels K6 / K7.
"""

import dataclasses

from deepspeed_tpu_torch.runtime.config_utils import DeepSpeedConfigModel

# knobs whose feature is not ported yet (a value other than the default
# raises)
NOT_PORTED = (
    "speculative", "spec_k", "spec_draft_model",
    "max_queue_depth", "queue_policy", "default_deadline_s",
    "breaker_threshold", "breaker_cooldown_s", "drain_timeout_s",
    "priority_lanes", "priority_aging_s", "fairness_tokens_per_s",
    "fairness_window_s", "drain_budget_s",
    "tracing", "trace_max_spans", "flight_recorder",
    "flight_recorder_events", "flight_recorder_dir", "profile_endpoint",
    "memory_telemetry", "memory_sample_interval_s",
)


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
    # ---- not ported (raise when set) ----
    speculative: bool = False
    spec_k: int = 4
    spec_draft_model: str = ""
    # ---- sampling, for every request ----
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # ---- not ported (raise when set) ----
    max_queue_depth: int = 0
    queue_policy: str = "reject"
    default_deadline_s: float = 0.0
    breaker_threshold: int = 0
    breaker_cooldown_s: float = 30.0
    drain_timeout_s: float = 0.0
    priority_lanes: int = 1
    priority_aging_s: float = 30.0
    fairness_tokens_per_s: float = 0.0
    fairness_window_s: float = 10.0
    drain_budget_s: float = 30.0
    tracing: bool = False
    trace_max_spans: int = 100000
    flight_recorder: bool = False
    flight_recorder_events: int = 2048
    flight_recorder_dir: str = ""
    profile_endpoint: bool = False
    memory_telemetry: bool = False
    memory_sample_interval_s: float = 10.0

    def validate(self):
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for knob in NOT_PORTED:
            if getattr(self, knob) != defaults[knob]:
                raise NotImplementedError(
                    f"serving config: {knob}={getattr(self, knob)!r} is not "
                    f"ported to deepspeed_tpu_torch yet (see ROADMAP.md, "
                    f"queue A item 6)")
        if not self.paged_kernel:
            raise NotImplementedError(
                "serving config: paged_kernel=False (the gather path) is not "
                "offered by deepspeed_tpu_torch: a page pool always runs the "
                "paged attention kernels")
        if self.admission not in ("fcfs", "shortest_first"):
            raise ValueError(f"serving.admission={self.admission!r}: one of "
                             f"'fcfs', 'shortest_first'")
