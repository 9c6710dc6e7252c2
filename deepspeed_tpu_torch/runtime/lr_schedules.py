"""LR schedules (port of ``deepspeed_tpu/runtime/lr_schedules.py``).

The JAX package's module is pure Python; the port keeps its own copy (it
imports nothing of ``deepspeed_tpu``).  Schedules are pure functions of
the step (``lr_at``) behind the stateful ``step()`` / ``get_lr()`` API:
``WarmupLR``, ``WarmupDecayLR``, ``WarmupCosineLR`` (alias
``CosineAnnealingLR``), ``LRRangeTest`` and ``OneCycle``.
"""

import math

VALID_SCHEDULES = ["LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR",
                   "WarmupCosineLR", "CosineAnnealingLR"]


class _Schedule:
    """Stateful wrapper (reference schedules subclass torch lr_scheduler)."""

    def __init__(self, optimizer=None, last_batch_iteration=-1):
        self.optimizer = optimizer
        self.last_batch_iteration = last_batch_iteration

    def lr_at(self, step):
        raise NotImplementedError

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [self.lr_at(max(self.last_batch_iteration, 0))]

    def get_last_lr(self):
        return self.get_lr()

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_Schedule):
    """Linear warmup then constant (reference ``lr_schedules.py:626``)."""

    def __init__(self, optimizer=None, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log", last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_gamma(self, step):
        if step < self.warmup_num_steps:
            if self.warmup_type == "log":
                return self.inverse_log_warm_up * math.log(step + 1)
            return step / self.warmup_num_steps
        return 1.0

    def lr_at(self, step):
        g = self._warmup_gamma(step)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * g


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 at total_num_steps (reference ``:715``)."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def lr_at(self, step):
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        decay = max(0.0, (self.total_num_steps - step) /
                    max(1, self.total_num_steps - self.warmup_num_steps))
        return self.warmup_max_lr * decay


class WarmupCosineLR(WarmupLR):
    """TPU-native addition: warmup + cosine decay to min_lr."""

    def __init__(self, optimizer=None, total_num_steps=10000, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000, cos_min_ratio=0.0,
                 warmup_type="linear", last_batch_iteration=-1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps
        self.cos_min_ratio = cos_min_ratio

    def lr_at(self, step):
        if step < self.warmup_num_steps:
            return super().lr_at(step)
        progress = min(1.0, (step - self.warmup_num_steps) /
                       max(1, self.total_num_steps - self.warmup_num_steps))
        cos = 0.5 * (1 + math.cos(math.pi * progress))
        floor = self.warmup_max_lr * self.cos_min_ratio
        return floor + (self.warmup_max_lr - floor) * cos


CosineAnnealingLR = WarmupCosineLR


class LRRangeTest(_Schedule):
    """LR range sweep (reference ``lr_schedules.py:258``)."""

    def __init__(self, optimizer=None, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000, lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        interval = step // self.step_size if self.staircase else step / self.step_size
        return self.min_lr * (1 + self.step_rate * interval)


class OneCycle(_Schedule):
    """1-cycle policy (reference ``lr_schedules.py:361``): lr ramps
    first_step_size up then back down, then decays; momentum cycles inversely."""

    def __init__(self, optimizer=None, cycle_min_lr=1e-4, cycle_max_lr=1e-3,
                 decay_lr_rate=0.0, cycle_first_step_size=2000,
                 cycle_second_step_size=None, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, decay_step_size=0,
                 cycle_momentum=True, cycle_min_mom=0.85, cycle_max_mom=0.99,
                 decay_mom_rate=0.0, last_batch_iteration=-1):
        super().__init__(optimizer, last_batch_iteration)
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first = cycle_first_step_size
        self.second = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom
        self.decay_mom_rate = decay_mom_rate

    def lr_at(self, step):
        total = self.first + self.second
        if step <= self.first:
            frac = step / self.first
            return self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * frac
        if step <= total:
            frac = (step - self.first) / self.second
            return self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * frac
        post = step - total
        if self.decay_step_size > 0:
            return self.cycle_min_lr / (1 + self.decay_lr_rate * (post // self.decay_step_size))
        return self.cycle_min_lr

    def mom_at(self, step):
        total = self.first + self.second
        if step <= self.first:
            frac = step / self.first
            return self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * frac
        if step <= total:
            frac = (step - self.first) / self.second
            return self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * frac
        return self.cycle_max_mom


SCHEDULE_REGISTRY = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
    "CosineAnnealingLR": WarmupCosineLR,
    "LRRangeTest": LRRangeTest,
    "OneCycle": OneCycle,
}


def build_lr_scheduler(sched_config, optimizer=None):
    """Map config ``scheduler`` block to an instance (reference
    ``engine.py:842 _configure_lr_scheduler``)."""
    if sched_config is None or sched_config.type is None:
        return None
    cls = SCHEDULE_REGISTRY.get(sched_config.type)
    if cls is None:
        raise ValueError(f"unknown scheduler {sched_config.type}; valid: {VALID_SCHEDULES}")
    return cls(optimizer=optimizer, **sched_config.params)
