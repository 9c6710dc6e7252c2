"""Communication verbs over ``torch.distributed`` (port of
``deepspeed_tpu/comm/comm.py``).

The verb set is the JAX module's — ``all_reduce`` (SUM / AVG / MAX / MIN /
PRODUCT), ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast``, ``reduce``, ``all_gather``,
``gather``, ``scatter``, ``send`` / ``recv``, ``barrier``,
``monitored_barrier``, ``inference_all_reduce`` — with the reference's
torch signatures: a group is a ``ProcessGroup`` (``None``: the world), the
verbs are eager calls on tensors, in place where torch's are, and each
also returns its result tensor.

One regime only.  The JAX verbs run traced inside ``shard_map`` on mesh
axes and eagerly across processes; here every verb is an eager collective
of the process group on the tensors' device (NCCL on CUDA, gloo on the
CPU).  JAX's traced-``ppermute`` machinery — ``ppermute``,
``send_recv_next`` / ``_prev``, ``p2p`` and the trace-scoped queue that
pairs ``send`` with ``recv`` inside one program — has no counterpart:
``send`` / ``recv`` (and ``isend`` / ``irecv``) are torch's eager
point-to-point calls between two ranks.

``AVG`` is a SUM followed by a division by the group's size on every
backend, so NCCL and gloo give the same bits and a group of one is exact.

Every verb is wrapped with ``timed_op`` feeding the ``CommsLogger``
(``utils/comms_logging.py``): with the logger enabled the device is
synchronized before and after the collective, so the recorded latency is
the collective's own.
"""

import functools
import os
import time
from enum import Enum

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm.backend import TorchBackend, backend_for
from deepspeed_tpu_torch.utils.comms_logging import (CommsLogger,
                                                     get_msg_size_from_args)
from deepspeed_tpu_torch.utils.logging import logger


class ReduceOp(Enum):
    SUM = 0
    PRODUCT = 1
    MIN = 2
    MAX = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM,
              ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
              ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.MAX: dist.ReduceOp.MAX,
              ReduceOp.AVG: dist.ReduceOp.SUM}   # then divided (see above)

cdb = None  # "communication data backend" — name kept for parity
comms_logger = CommsLogger()

# torch renamed the tensor-form gather / scatter; take whichever this
# torch has, so neither name warns
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


# --------------------------------------------------------------------- #
# Init / identity
# --------------------------------------------------------------------- #
def _env_int(name):
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def init_distributed(dist_backend=None, auto_mpi_discovery=True, verbose=True,
                     timeout=None, init_method=None, dist_init_required=None,
                     config=None, rank=-1, world_size=-1, device=None):
    """Join the process group (reference ``comm.py:562``).

    The rank, local rank and world size come from ``RANK``, ``LOCAL_RANK``
    and ``WORLD_SIZE`` (or ``rank`` / ``world_size``), the rendezvous from
    ``MASTER_ADDR`` / ``MASTER_PORT`` (or ``init_method``), as the launcher
    (``python -m deepspeed_tpu_torch.launcher.runner``) sets them.
    ``device``: ``None`` means this rank's card, ``cuda:LOCAL_RANK``, over
    NCCL (made current before the group exists); ``"cpu"`` means gloo.  A
    missing ``WORLD_SIZE`` raises: a group is never silently a single
    process.  Returns the backend."""
    global cdb
    if cdb is not None and cdb.is_initialized():
        return cdb
    if auto_mpi_discovery and "OMPI_COMM_WORLD_SIZE" in os.environ \
            and "WORLD_SIZE" not in os.environ:
        mpi_discovery(verbose=verbose)
    world = world_size if world_size is not None and world_size > 0 \
        else _env_int("WORLD_SIZE")
    if world is None:
        raise RuntimeError(
            "init_distributed: WORLD_SIZE is not set — start each rank with "
            "python -m deepspeed_tpu_torch.launcher.runner --num_gpus N "
            "script.py (or set RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and "
            "MASTER_PORT)")
    me = rank if rank is not None and rank >= 0 else _env_int("RANK")
    if me is None:
        raise RuntimeError("init_distributed: RANK is not set")
    local = _env_int("LOCAL_RANK")
    local = me if local is None else local
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: the port's ranks run on CUDA devices by "
                "default and none is available; pass device='cpu' for gloo")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    backend = backend_for(device, dist_backend)
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise RuntimeError("init_distributed: MASTER_ADDR and "
                               "MASTER_PORT are not set")
        init_method = f"tcp://{addr}:{port}"
    os.environ.setdefault("LOCAL_RANK", str(local))
    cdb = TorchBackend(backend, me, world, init_method, device,
                       timeout=timeout)
    cdb.init_process_group()
    return cdb


def mpi_discovery(distributed_port=29500, verbose=True):
    """Map OpenMPI's variables to the rendezvous environment (reference
    ``comm.py:627``)."""
    rank = int(os.environ["OMPI_COMM_WORLD_RANK"])
    world = int(os.environ["OMPI_COMM_WORLD_SIZE"])
    local = int(os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", rank))
    os.environ.setdefault("RANK", str(rank))
    os.environ.setdefault("WORLD_SIZE", str(world))
    os.environ.setdefault("LOCAL_RANK", str(local))
    os.environ.setdefault("MASTER_ADDR", "127.0.0.1")
    os.environ.setdefault("MASTER_PORT", str(distributed_port))
    if verbose:
        logger.info(f"MPI discovery: rank {rank}/{world} master "
                    f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def get_backend():
    return cdb.backend if cdb is not None else None


def get_device():
    """This rank's device (``cuda:LOCAL_RANK`` or ``cpu``), None without a
    group."""
    if cdb is None or not cdb.is_initialized():
        return None
    return cdb.device


def get_rank(group=None):
    if not is_initialized():
        return 0
    return dist.get_rank(group) if group is not None else dist.get_rank()


def get_world_size(group=None):
    if not is_initialized():
        return 1
    return dist.get_world_size(group) if group is not None \
        else dist.get_world_size()


def get_local_rank():
    return int(os.environ.get("LOCAL_RANK", 0))


def get_global_rank(group, group_rank):
    """The world rank of ``group``'s rank ``group_rank``."""
    if group is None:
        return group_rank
    return dist.get_global_rank(group, group_rank)


def new_group(ranks=None, axes=None):
    """A process group: over the world ranks ``ranks`` (every rank of the
    world must call it, as torch requires), or the live topology's group
    for ``axes`` (``("dp",)``-style names, as the JAX package's groups)."""
    if axes is not None:
        from deepspeed_tpu_torch.parallel import topology as topo
        return topo.get_topology().group_for(tuple(axes))
    return dist.new_group(ranks)


# --------------------------------------------------------------------- #
# timed_op — profiling decorator (reference comm.py:104)
# --------------------------------------------------------------------- #
def _first_tensor(args):
    for a in args:
        if torch.is_tensor(a):
            return a
        if isinstance(a, (list, tuple)) and a and torch.is_tensor(a[0]):
            return a
    return None


def timed_op(fn):

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not comms_logger.enabled:
            return fn(*args, **kwargs)
        name = kwargs.get("log_name") or fn.__name__
        if not getattr(comms_logger, "prof_all", True):
            allowed = getattr(comms_logger, "prof_ops", None) or []
            if fn.__name__ not in allowed and name not in allowed:
                return fn(*args, **kwargs)
        payload = _first_tensor(args)
        dev = payload[0].device if isinstance(payload, (list, tuple)) \
            else getattr(payload, "device", None)
        cuda = dev is not None and dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize(dev)
        latency = time.perf_counter() - t0
        comms_logger.append(fn.__name__, name, latency,
                            get_msg_size_from_args(payload))
        return result

    return wrapper


def configure(deepspeed_config=None, enabled=None, prof_all=None,
              prof_ops=None, verbose=None, debug=None):
    if deepspeed_config is not None and \
            getattr(deepspeed_config, "comms_config", None):
        comms_logger.configure(deepspeed_config.comms_config)
    if enabled is not None:
        comms_logger.enabled = enabled
    if verbose is not None:
        comms_logger.verbose = verbose
    if debug is not None:
        comms_logger.debug = debug
    if prof_all is not None:
        comms_logger.prof_all = prof_all
    if prof_ops is not None:
        comms_logger.prof_ops = prof_ops


def log_summary():
    return comms_logger.log_all()


# --------------------------------------------------------------------- #
# Collectives
# --------------------------------------------------------------------- #
def _avg(tensor, op, group):
    if op == ReduceOp.AVG:
        if not tensor.is_floating_point():
            raise ValueError("ReduceOp.AVG needs a floating tensor")
        tensor.div_(get_world_size(group))
    return tensor


def _sync_only(op, async_op):
    if async_op and op == ReduceOp.AVG:
        raise ValueError("ReduceOp.AVG divides after the collective: call "
                         "it with async_op=False")


@timed_op
def all_reduce(tensor, op=ReduceOp.SUM, group=None, async_op=False,
               log_name=None):
    """In-place reduction over ``group`` (reference ``comm.py:454``);
    returns ``tensor`` (the work handle with ``async_op``)."""
    _sync_only(op, async_op)
    work = dist.all_reduce(tensor, op=_TORCH_OPS[op], group=group,
                           async_op=async_op)
    return work if async_op else _avg(tensor, op, group)


@timed_op
def all_gather_into_tensor(output_tensor, tensor, group=None, async_op=False,
                           log_name=None):
    """Concatenated all-gather along dim 0 (reference ``comm.py:310``):
    ``output_tensor`` holds the group's ``tensor``s in rank order."""
    work = _all_gather_single(output_tensor, tensor, group=group,
                              async_op=async_op)
    return work if async_op else output_tensor


# reference comm.py:308 allgather_fn capability fallback — one impl here
allgather_fn = all_gather_into_tensor


@timed_op
def reduce_scatter_tensor(output_tensor, tensor, op=ReduceOp.SUM, group=None,
                          async_op=False, log_name=None):
    """Reduce, then scatter dim 0 (reference ``comm.py:257``): rank r's
    ``output_tensor`` is the reduction of every rank's r-th chunk."""
    _sync_only(op, async_op)
    work = _reduce_scatter_single(output_tensor, tensor, op=_TORCH_OPS[op],
                                  group=group, async_op=async_op)
    return work if async_op else _avg(output_tensor, op, group)


reduce_scatter_fn = reduce_scatter_tensor


@timed_op
def all_to_all_single(output, tensor, output_split_sizes=None,
                      input_split_sizes=None, group=None, async_op=False,
                      log_name=None):
    """All-to-all along dim 0 (reference ``comm.py:337``): chunk j of
    ``tensor`` goes to rank j, which places it at chunk r of ``output``."""
    work = dist.all_to_all_single(output, tensor, output_split_sizes,
                                  input_split_sizes, group=group,
                                  async_op=async_op)
    return work if async_op else output


@timed_op
def broadcast(tensor, src=0, group=None, async_op=False, log_name=None):
    """Every rank takes world rank ``src``'s ``tensor``, in place
    (reference ``comm.py:224``)."""
    work = dist.broadcast(tensor, src, group=group, async_op=async_op)
    return work if async_op else tensor


@timed_op
def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, async_op=False,
           log_name=None):
    """Reduction into world rank ``dst``'s ``tensor``; the others'
    ``tensor`` is left undefined, as torch's."""
    _sync_only(op, async_op)
    work = dist.reduce(tensor, dst, op=_TORCH_OPS[op], group=group,
                       async_op=async_op)
    if async_op:
        return work
    return _avg(tensor, op, group) if get_rank() == dst else tensor


@timed_op
def all_gather(tensor_list, tensor, group=None, async_op=False,
               log_name=None):
    """List-style all-gather (reference ``comm.py:284``): ``tensor_list[r]``
    takes rank r's ``tensor``; returns the list."""
    work = dist.all_gather(tensor_list, tensor, group=group,
                           async_op=async_op)
    return work if async_op else tensor_list


@timed_op
def gather(tensor, gather_list=None, dst=0, group=None, async_op=False,
           log_name=None):
    """Gather to world rank ``dst`` (reference ``comm.py:362``):
    ``gather_list`` (given on ``dst`` only) takes every rank's tensor."""
    work = dist.gather(tensor, gather_list if get_rank() == dst else None,
                       dst, group=group, async_op=async_op)
    return work if async_op else gather_list


@timed_op
def scatter(tensor, scatter_list=None, src=0, group=None, async_op=False,
            log_name=None):
    """Scatter from world rank ``src`` (reference ``comm.py:375``): rank r's
    ``tensor`` takes ``scatter_list[r]`` (given on ``src`` only)."""
    work = dist.scatter(tensor, scatter_list if get_rank() == src else None,
                        src, group=group, async_op=async_op)
    return work if async_op else tensor


@timed_op
def send(tensor, dst, group=None, tag=0, log_name=None):
    """Eager point-to-point send to world rank ``dst`` (reference
    ``comm.py:428``)."""
    dist.send(tensor, dst, group=group, tag=tag)
    return tensor


@timed_op
def recv(tensor, src=None, group=None, tag=0, log_name=None):
    """Eager receive into ``tensor`` from world rank ``src``; returns
    ``tensor``."""
    dist.recv(tensor, src, group=group, tag=tag)
    return tensor


def isend(tensor, dst, group=None, tag=0):
    """Asynchronous send (reference ``comm.py:420``): the work handle."""
    return dist.isend(tensor, dst, group=group, tag=tag)


def irecv(tensor, src=None, group=None, tag=0):
    return dist.irecv(tensor, src, group=group, tag=tag)


def barrier(group=None):
    """Cross-process sync (reference ``comm.py:398``)."""
    if not is_initialized():
        return
    if get_backend() == "nccl":
        dist.barrier(group=group, device_ids=[cdb.device.index])
    else:
        dist.barrier(group=group)


def monitored_barrier(group=None, timeout=None, wait_all_ranks=False):
    """Barrier that names the ranks that failed to arrive (reference
    ``comm.py:405``).  torch implements it on gloo only; on NCCL it is the
    plain barrier, whose timeout fails the collective."""
    if not is_initialized():
        return
    if get_backend() == "gloo":
        import datetime
        if timeout is not None and not isinstance(timeout,
                                                  datetime.timedelta):
            timeout = datetime.timedelta(seconds=float(timeout))
        dist.monitored_barrier(group=group, timeout=timeout,
                               wait_all_ranks=wait_all_ranks)
    else:
        barrier(group)


def inference_all_reduce(tensor, op=ReduceOp.SUM, group=None):
    """TP all-reduce inside injected inference layers (reference
    ``pt_binding.cpp`` inference_all_reduce) — the same all-reduce."""
    return all_reduce(tensor, op=op, group=group,
                      log_name="inference_all_reduce")


def destroy_process_group():
    global cdb
    if cdb is not None:
        cdb.destroy_process_group()
        cdb = None
    elif is_initialized():
        dist.destroy_process_group()
    from deepspeed_tpu_torch.parallel import topology as topo
    topo.reset_topology()
