"""Wall-clock and throughput timers (port of ``deepspeed_tpu/utils/timer.py``,
reference ``utils/timer.py``: ``SynchronizedWallClockTimer:33``,
``ThroughputTimer:137``).

A :class:`SynchronizedWallClockTimer` timer waits for its device before it
reads the clock (``torch.cuda.synchronize`` on a card, nothing on the CPU,
whose work is done when the call returns), so a span covers the device work
queued inside it.  The engine runs them only under ``wall_clock_breakdown``.
:class:`ThroughputTimer` never synchronizes: the engine runs it on every
step, and a sync there would serialize the queue; over a window the queue
throttles itself, so a windowed wall-clock rate stays honest.
"""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


class SynchronizedWallClockTimer:
    """Named timers over one device (``device``: a ``torch.device`` or
    string; the CPU by default)."""

    class Timer:

        def __init__(self, name, device):
            self.name_ = name
            self.device = torch.device(device)
            self.started_ = False
            self.elapsed_ = 0.0
            self.start_time = 0.0
            self.records = []

        def _sync(self):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        def start(self, sync=True):
            if self.started_:
                return
            if sync:
                self._sync()
            self.start_time = time.perf_counter()
            self.started_ = True

        def stop(self, sync=True, record=True):
            if not self.started_:
                return
            if sync:
                self._sync()
            delta = time.perf_counter() - self.start_time
            self.elapsed_ += delta
            if record:
                self.records.append(delta)
            self.started_ = False

        def elapsed(self, reset=True):
            val = self.elapsed_
            if reset:
                self.elapsed_ = 0.0
            return val

        def mean(self):
            return sum(self.records) / len(self.records) if self.records \
                else 0.0

        def reset(self):
            self.elapsed_ = 0.0
            self.records = []
            self.started_ = False

    def __init__(self, device="cpu"):
        self.device = device
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = self.Timer(name, self.device)
        return self.timers[name]

    def log(self, names, normalizer=1.0, reset=True, ranks=None):
        """One ``time (ms) | name: ms | ...`` line of the named timers'
        elapsed time since their last reset, divided by ``normalizer``."""
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 \
                    / normalizer
                parts.append(f"{name}: {elapsed:.2f}")
        log_dist(f"time (ms) | {' | '.join(parts)}", ranks=ranks or [0])


class ThroughputTimer:
    """Samples a second over the steps after ``start_step``, logged every
    ``steps_per_output`` global steps; it never waits for the device."""

    def __init__(self, batch_size, start_step=2, steps_per_output=50,
                 monitor_memory=False, logging_fn=None):
        self.start_time = 0
        self.end_time = 0
        self.started = False
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.epoch_count = 0
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0
        self.step_elapsed_time = 0
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or log_dist

    def update_epoch_count(self):
        self.epoch_count += 1
        self.micro_step_count = 0

    def start(self):
        self.started = True
        if self.global_step_count >= self.start_step:
            self.start_time = time.perf_counter()

    def stop(self, global_step=False, report_speed=True):
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0 and self.global_step_count >= self.start_step:
            self.end_time = time.perf_counter()
            duration = self.end_time - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step and report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                now = self.batch_size / max(self.step_elapsed_time, 1e-9)
                self.logging(
                    f"epoch={self.epoch_count}/micro_step="
                    f"{self.micro_step_count}/global_step="
                    f"{self.global_step_count}, "
                    f"RunningAvgSamplesPerSec="
                    f"{self.avg_samples_per_sec():.4f}, "
                    f"CurrSamplesPerSec={now:.4f}")
                self.step_elapsed_time = 0
            elif global_step:
                self.step_elapsed_time = 0

    def avg_samples_per_sec(self):
        if self.global_step_count > self.start_step:
            samples = self.batch_size * (self.global_step_count -
                                         self.start_step)
            return samples / max(self.total_elapsed_time, 1e-9)
        return 0.0
