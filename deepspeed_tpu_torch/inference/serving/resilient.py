"""Preemption-aware serving loop (port of
``deepspeed_tpu/inference/serving/resilient.py``) — the serving analog of
the JAX package's ``runtime/fault/supervisor.run_resilient``.

:func:`serve_resilient` drives a :class:`ServingEngine` until everything
submitted has reached a terminal status, watching a
:class:`~deepspeed_tpu_torch.elasticity.elastic_agent.DSElasticAgent` for
SIGTERM preemption: on preemption it stops admission, drains the
in-flight slots under the config's ``drain_budget_s``, snapshots the
undrained requests crash-atomically (``ServingEngine.preempt``) and
returns ``("preempted", results)`` so the process can exit for the
scheduler to reschedule.  A restarted server calls
``ServingEngine.restore`` (done here with ``resume=True``) and finishes
the snapshotted requests — greedy outputs bitwise-identical to an
uninterrupted run (``tests/test_torch_serving_resilient.py`` kills the
loop at every serving fault-injection seam to prove it).  Signal handlers
can only be installed from the main thread, so the agent, and this loop,
run there.
"""

from deepspeed_tpu_torch.utils.logging import logger


def serve_resilient(srv, checkpoint_dir, agent=None, resume=True):
    """Run ``srv`` to completion or preemption.  Returns
    ``(status, results)`` with status ``"done"`` | ``"preempted"`` and
    ``results`` the merged ``{rid: output}`` map of every request that
    reached a terminal status during the call (``None`` outputs for
    non-COMPLETED terminals; typed detail via ``srv.result(rid)``).

    ``resume=True`` restores the newest valid snapshot under
    ``checkpoint_dir`` before the first iteration; pass ``False`` when
    the caller already ran ``srv.restore()`` itself (e.g. to dedup its
    own workload against the resumed requests).  On a clean finish an
    EMPTY snapshot is published so the next restart resumes nothing."""
    own_agent = agent is None
    if own_agent:
        from deepspeed_tpu_torch.elasticity.elastic_agent import \
            DSElasticAgent
        agent = DSElasticAgent({}, checkpoint_dir=checkpoint_dir)
    agent.start()
    results = {}
    try:
        if resume:
            srv.restore(checkpoint_dir)
        while srv.work_pending():
            if agent.preempted:
                break
            results.update(srv.step())
        if agent.preempted:
            tag, snapped, finished = srv.preempt(checkpoint_dir)
            results.update(finished)
            logger.warning(f"[serving] preempted — snapshot {tag!r} "
                           f"holds {len(snapped)} request(s)")
            return "preempted", results
        # clean completion: publish an empty snapshot so a restarted
        # server does not re-resume already-finished work
        srv.snapshot(checkpoint_dir)
        return "done", results
    finally:
        if own_agent:
            agent.stop()
