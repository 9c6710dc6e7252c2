"""One schedule on every rank of a tensor-parallel serving group (a
port-only module: the JAX package serves its whole mesh from one process,
so one host makes every decision).

At tp > 1 each rank of the group runs a :class:`~.engine.ServingEngine`
over its slice of the model, and every device program it runs — the
admission chunks, the admits, the captured decode block and the lane
writes of a retirement — carries the group's collectives, so every rank
must run the same programs in the same order: a rank that skips or
reorders one deadlocks the group.  Everything a host decides from its
clock or from its callers could differ between processes, so tp rank 0
(the *leader*) owns the queue and the clock, and at each ``step()`` it
sends the others (the *followers*) one small :class:`Plan`: the requests
submitted since the last plan (ids, prompts, parameters), the cancels,
the deadline sheds it decided, and its clock for the priority lanes'
aging.  A follower applies the plan and runs the same step; the rest of a
step depends only on the tokens, which are bitwise equal on every rank
(the logits are gathered whole and every rank draws from a generator
seeded alike).  At tp 1 a server makes the same plan for each step and
applies it without sending it; there it also carries the circuit
breaker's decision to dispatch.

A failure on one rank cannot be absorbed there without taking that rank
out of step, so at tp > 1 the circuit breaker is refused and a failed
dispatch closes the server on the rank that saw it and raises; the
process then ends, and the group's other ranks fail in their next
collective (at once over gloo, at the process group's timeout over
NCCL).

Plans go over the tp group's gloo twin, which the topology builds once
beside the NCCL group (``ParallelTopology.build_groups``), so sending one
costs no device synchronization, never interleaves with the model's
collectives, and a server creates no group.  A follower waits for the
next plan up to the twin's timeout (``CPU_GROUP_TIMEOUT``, a day: an idle
server sends none).
"""

import time
from dataclasses import dataclass, field


@dataclass
class Plan:
    """What the leader decided for one scheduler call.  ``kind``: "step",
    "warmup" (capture the programs), or "close" (the server retires;
    followers return from :meth:`~.engine.ServingEngine.follow`)."""
    kind: str = "step"
    submits: list = field(default_factory=list)   # ServeRequest fields
    cancels: list = field(default_factory=list)   # rids, in call order
    shed: list = field(default_factory=list)      # (rid, detail)
    dispatch: bool = True                         # the breaker's (tp 1)
    now: float = 0.0                              # the leader's clock


class PlanChannel:
    """The plan link of one tp group: the topology's gloo twin of the
    group; the group's first rank is the leader.  ``seconds`` / ``calls``:
    the host time spent sending (leader) or receiving (follower) plans,
    a receive's wait for the leader included."""

    def __init__(self, topology):
        import torch.distributed as dist
        from deepspeed_tpu_torch.parallel.topology import TP_AXIS
        self.group = topology.get_model_parallel_cpu_group()
        me = dist.get_rank()
        ranks = topology.ranks_of_group((TP_AXIS,), me)
        self.leader_rank = ranks[0]
        self.is_leader = me == self.leader_rank
        self.size = len(ranks)
        self.seconds = 0.0
        self.calls = 0

    def send(self, plan):
        """The leader: this call's plan to every follower."""
        self._broadcast(plan)

    def recv(self):
        """A follower: the leader's next plan (blocks until it comes)."""
        return self._broadcast(None)

    def _broadcast(self, plan):
        import torch.distributed as dist
        t0 = time.perf_counter()
        box = [plan]
        dist.broadcast_object_list(box, src=self.leader_rank,
                                   group=self.group)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return box[0]
