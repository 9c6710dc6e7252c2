"""Elastic agent (port of ``deepspeed_tpu/elasticity/elastic_agent.py``;
reference ``elasticity/elastic_agent.py:28``, ``DSElasticAgent(
LocalElasticAgent)``): monitor workers, patch their env, restart on
membership change.

Here the membership event is a preemption, which arrives as SIGTERM. The
agent wraps the training or serving loop in-process: it installs signal
handlers (from the main thread: Python accepts them nowhere else), marks
the preemption for the loop to act on at its next boundary (an emergency
checkpoint, or ``ServingEngine.preempt``), and on restart recomputes a
batch-size-compatible config for the new world size through the
elasticity solver (``compute_elastic_config``), preserving the global
batch like the reference's v0.1/v0.2 schedulers.  The world size is
``torch.cuda.device_count()`` when CUDA is present, else 1.
"""

import signal
import time

from deepspeed_tpu_torch.elasticity.elasticity import compute_elastic_config
from deepspeed_tpu_torch.utils.logging import logger


class DSElasticAgent:

    def __init__(self, ds_config, checkpoint_dir=None, checkpoint_fn=None,
                 world_size=None):
        self.ds_config = ds_config
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_fn = checkpoint_fn
        self._preempted = False
        self._prev_handlers = {}
        if world_size is None:
            import torch
            world_size = torch.cuda.device_count() \
                if torch.cuda.is_available() else 1
        self.world_size = world_size

    # ---------------------------------------------------------------- #
    def elastic_config_for(self, num_devices):
        """Batch-size-preserving config for a new world size (reference
        ``compute_elastic_config``/``_get_compatible_gpus``)."""
        gbs, _, mbs = compute_elastic_config(self.ds_config,
                                             world_size=num_devices,
                                             return_microbatch=True)
        cfg = dict(self.ds_config)
        cfg["train_micro_batch_size_per_gpu"] = mbs
        cfg["gradient_accumulation_steps"] = gbs // (mbs * num_devices)
        cfg["train_batch_size"] = gbs
        return cfg

    # ---------------------------------------------------------------- #
    def _handler(self, signum, frame):
        logger.warning(f"elastic agent: received signal {signum} — "
                       "marking preemption, checkpoint on next boundary")
        self._preempted = True

    def start(self):
        """Install preemption handlers for SIGTERM and SIGINT (reference
        patches worker env + monitors)."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            self._prev_handlers[sig] = signal.signal(sig, self._handler)
        return self

    def stop(self):
        for sig, h in self._prev_handlers.items():
            signal.signal(sig, h)
        self._prev_handlers = {}

    @property
    def preempted(self):
        return self._preempted

    def checkpoint_if_preempted(self, engine, tag=None):
        """Call at every step boundary: on a pending preemption, write the
        emergency checkpoint and return True (caller should exit)."""
        if not self._preempted:
            return False
        if self.checkpoint_fn is not None:
            self.checkpoint_fn()
        elif self.checkpoint_dir is not None:
            engine.save_checkpoint(self.checkpoint_dir,
                                   tag=tag or f"preempt_{int(time.time())}")
        logger.warning("elastic agent: emergency checkpoint complete")
        return True

    # ---------------------------------------------------------------- #
    def run(self, train_step_fn, engine, max_steps=None):
        """Reference ``_invoke_run``: loop the training fn, watching for
        membership changes; returns ('preempted'|'done', steps_run)."""
        self.start()
        steps = 0
        try:
            while max_steps is None or steps < max_steps:
                train_step_fn()
                steps += 1
                if self.checkpoint_if_preempted(engine):
                    return "preempted", steps
        finally:
            self.stop()
        return "done", steps
