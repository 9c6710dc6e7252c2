"""Distributed-aware logging (port of ``deepspeed_tpu/utils/logging.py``).

``log_dist`` logs only on selected ranks; the rank comes from
``torch.distributed`` when a process group is up, else 0.
"""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name="DeepSpeedTPUTorch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        logger_.addHandler(handler)
    return logger_


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(), logging.INFO))


def _process_index():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given process ranks (None/[-1 in list] = all)."""
    my_rank = _process_index()
    if ranks is None or my_rank in ranks or -1 in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def warning_once(message, _seen=set()):
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)
