"""Request lifecycle of the serving engine (the core-engine part of
``deepspeed_tpu/inference/serving/slo.py``).

A request is ``QUEUED``, then ``PREFILLING`` while its prompt streams into
a slot, then ``RUNNING``, and ends ``COMPLETED`` — or ``ABORTED`` when the
engine is closed or a dispatch fails with it in flight.  Deadlines, the
bounded queue, the circuit breaker, drain timeouts and token streams are
not ported yet.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np


class RequestStatus:
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    ABORTED = "ABORTED"


TERMINAL_STATUSES = frozenset({RequestStatus.COMPLETED,
                               RequestStatus.ABORTED})


@dataclass
class RequestResult:
    """Terminal record of one request (``ServingEngine.result(rid)``):
    ``output`` follows the ``generate()`` contract ``[prompt...,
    generated...]`` for ``COMPLETED`` and is ``None`` otherwise;
    ``detail`` says why a request was aborted; ``ttft_s`` is
    submit-to-first-token wall time as the host saw it (``None`` when no
    token was produced)."""
    rid: int
    status: str
    output: Optional[np.ndarray] = None
    detail: str = ""
    submitted_it: int = 0
    finished_it: Optional[int] = None
    ttft_s: Optional[float] = None
