"""Experiment monitoring (port of ``deepspeed_tpu/monitor/monitor.py``):
the ``Monitor`` base, ``MonitorMaster`` fanning out to the TensorBoard,
WandB and CSV backends.

Events are ``(name, value, global_step)`` tuples given to
``write_events``.  Every backend has ``flush()`` and ``close()``, and the
base is a context manager.  The CSV backend keeps one file handle open
per series and flushes each batch by default; ``csvMonitor(cfg,
batch_flush=False)`` buffers fully, and then a ``flush()`` / ``close()``
is required.  The serving engine flushes its monitor on ``close()`` and
``preempt()``.  The port runs at world size 1, so process 0 — the only
process — writes.
"""

import os
import csv as _csv
from abc import ABC, abstractmethod

from deepspeed_tpu_torch.utils.logging import logger


class Monitor(ABC):

    def __init__(self, monitor_config):
        self.monitor_config = monitor_config

    @abstractmethod
    def write_events(self, event_list):
        ...

    def flush(self):
        """Push buffered events to durable storage (default: no-op for
        backends that write through)."""

    def close(self):
        """Flush and release any handles; idempotent."""
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class TensorBoardMonitor(Monitor):

    def __init__(self, tensorboard_config):
        super().__init__(tensorboard_config)
        self.enabled = tensorboard_config.enabled
        self.summary_writer = None
        if self.enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
                log_dir = os.path.join(tensorboard_config.output_path or "./runs",
                                       tensorboard_config.job_name)
                self.summary_writer = SummaryWriter(log_dir=log_dir)
            except ImportError:
                logger.warning("tensorboard not available; TensorBoardMonitor disabled")
                self.enabled = False

    def write_events(self, event_list, flush=True):
        if not self.enabled or self.summary_writer is None:
            return
        for event in event_list:
            self.summary_writer.add_scalar(*event)
        if flush:
            self.summary_writer.flush()

    def flush(self):
        if self.summary_writer is not None:
            self.summary_writer.flush()

    def close(self):
        if self.summary_writer is not None:
            self.summary_writer.close()
            self.summary_writer = None
            self.enabled = False


class WandbMonitor(Monitor):

    def __init__(self, wandb_config):
        super().__init__(wandb_config)
        self.enabled = wandb_config.enabled
        if self.enabled:
            try:
                import wandb
                self.wandb = wandb
                wandb.init(project=wandb_config.project, group=wandb_config.group,
                           entity=wandb_config.team)
            except ImportError:
                logger.warning("wandb not available; WandbMonitor disabled")
                self.enabled = False

    def write_events(self, event_list):
        if not self.enabled:
            return
        for name, value, step in event_list:
            self.wandb.log({name: value}, step=int(step))

    def close(self):
        if self.enabled:
            self.wandb.finish()
            self.enabled = False


class csvMonitor(Monitor):
    """CSV backend: one ``<series>.csv`` per event name, its file handle
    kept open across ``write_events`` calls.  Each batch ends with a flush
    of the files it touched, so callers that never ``flush()`` /
    ``close()`` (the training engine) keep their rows on disk;
    ``batch_flush=False`` buffers fully for writers that do."""

    def __init__(self, csv_config, batch_flush=True):
        super().__init__(csv_config)
        self.enabled = csv_config.enabled
        self.batch_flush = batch_flush
        self.output_path = csv_config.output_path or "./csv_monitor"
        self.job_name = csv_config.job_name
        self.filehandles = {}            # path -> (file, csv.writer)
        if self.enabled:
            os.makedirs(os.path.join(self.output_path, self.job_name), exist_ok=True)

    def _entry(self, name):
        safe = name.replace("/", "_")
        path = os.path.join(self.output_path, self.job_name, f"{safe}.csv")
        entry = self.filehandles.get(path)
        if entry is None:
            new = not os.path.exists(path)
            f = open(path, "a", newline="")
            w = _csv.writer(f)
            if new:
                w.writerow(["step", safe])
            entry = self.filehandles[path] = (f, w)
        return entry

    def write_events(self, event_list):
        if not self.enabled:
            return
        touched = []
        for name, value, step in event_list:
            f, w = self._entry(name)
            w.writerow([int(step), float(value)])
            touched.append(f)
        if self.batch_flush:
            for f in touched:
                f.flush()

    def flush(self):
        for f, _ in self.filehandles.values():
            f.flush()

    def close(self):
        for f, _ in self.filehandles.values():
            try:
                f.close()
            except OSError:
                pass
        self.filehandles.clear()


class MonitorMaster(Monitor):
    """Fan events out to every enabled backend (process 0 writes: at world
    size 1 that is this process).  ``flush`` / ``close`` fan out too."""

    def __init__(self, monitor_config):
        super().__init__(monitor_config)
        self.enabled = monitor_config.enabled
        self.backends = []
        if monitor_config.tensorboard.enabled:
            self.backends.append(TensorBoardMonitor(monitor_config.tensorboard))
        if monitor_config.wandb.enabled:
            self.backends.append(WandbMonitor(monitor_config.wandb))
        if monitor_config.csv_monitor.enabled:
            self.backends.append(csvMonitor(monitor_config.csv_monitor))

    def write_events(self, event_list):
        for backend in self.backends:
            backend.write_events(event_list)

    def flush(self):
        for backend in self.backends:
            backend.flush()

    def close(self):
        for backend in self.backends:
            backend.close()
