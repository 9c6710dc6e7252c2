"""One rank of the port's data-parallel CPU tests (gloo).  It imports no
JAX: the tests start it through the port's launcher,

    python -m deepspeed_tpu_torch.launcher.runner --num_gpus N \\
        tests/torch_dp_worker.py SUITE OUT_DIR [INPUT]

and each rank writes ``OUT_DIR/SUITE.rank<r>.pt`` (``torch.save`` of a
dict), which the tests read and hold against numpy and the JAX package.

Suites: ``comm`` (every collective of ``deepspeed_tpu_torch.comm``, the
coalesced collectives, the live topology, ``GatheredParameters`` and
``zero.Init``), ``zero3`` (ZeRO-3 and MiCS from INPUT: the runs, shards
and moments, ``tensor_fragment``, ``zero.Init`` / ``OnDevice`` /
``GatheredParameters`` on an engine, the offload, a ``TiledLinear``, the
fp16 skip, and at dp 4 the stage-3 and MiCS checkpoints), ``zero3_cuda``
(on the cards: stage 3's peak against stage 2's, the collectives in
order, the fp16 skip),
``zero`` (the engine at ZeRO stages 0 / 1 / 2 from the weights and
batches in INPUT, a ``torch.save`` dict the test writes; with a
``remainder`` entry at dp 2 the partitioned backward, the nebula writer
and an offloaded optimizer's tag; with a ``ckpt`` entry it then loads the
tag ``ckpt`` wrote), ``ckpt`` (a tag saved at
this world size), ``fail`` (rank 1 exits 3 at once, the others sleep: the
launcher's exit code).  ``WORKER_DEVICE=cuda`` runs the ranks on their
cards over NCCL (the card tests), otherwise on the CPU over gloo.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import deepspeed_tpu_torch as ds  # noqa: E402
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.comm import ReduceOp  # noqa: E402

# "cpu" (gloo) or "cuda" (NCCL, each rank on cuda:LOCAL_RANK)
CUDA = os.environ.get("WORKER_DEVICE", "cpu") == "cuda"
DEV = None if CUDA else "cpu"


def _save(out_dir, suite, rank, rec):
    tmp = os.path.join(out_dir, f"{suite}.rank{rank}.pt.tmp")
    torch.save(rec, tmp)
    os.replace(tmp, os.path.join(out_dir, f"{suite}.rank{rank}.pt"))


# --------------------------------------------------------------------- #
# comm
# --------------------------------------------------------------------- #
VERBS = ("all_reduce_sum", "all_reduce_avg", "all_reduce_max",
         "all_reduce_min", "all_reduce_product", "all_reduce_bf16",
         "inference_all_reduce", "all_gather_into_tensor",
         "reduce_scatter_tensor", "reduce_scatter_avg", "all_to_all_single",
         "broadcast", "reduce", "all_gather", "scatter", "send_recv")


def comm_inputs(world):
    """Every rank's inputs to the comm suite."""
    return {
        "x": [np.arange(8.0) + 10 * r for r in range(world)],
        "src": [np.arange(8.0 * world) * (r + 1) for r in range(world)],
        "a2a": [np.arange(4.0 * world) + 100 * r for r in range(world)],
    }


def comm_expected(name, world, r):
    """What numpy says rank r holds after verb ``name`` (for ``reduce``
    only rank 0's tensor is defined, torch's rule)."""
    inp = comm_inputs(world)
    x = np.stack(inp["x"])
    if name.startswith("all_reduce_"):
        op = name[len("all_reduce_"):]
        if op == "bf16":
            return x.sum(0)
        return {"sum": np.sum, "avg": np.mean, "max": np.max, "min": np.min,
                "product": np.prod}[op](x + 1, axis=0)
    if name in ("inference_all_reduce", "reduce"):
        return x.sum(0)
    if name == "all_gather_into_tensor":
        return x.reshape(-1)
    if name == "reduce_scatter_tensor":
        return np.stack(inp["src"]).sum(0).reshape(world, 8)[r]
    if name == "reduce_scatter_avg":
        return np.stack(inp["src"]).mean(0).reshape(world, 8)[r]
    if name == "all_to_all_single":
        a = np.stack(inp["a2a"]).reshape(world, world, 4)
        return a[:, r].reshape(-1)
    if name == "broadcast":
        return x[world - 1]
    if name == "all_gather":
        return x
    if name == "scatter":
        return np.arange(3.0 * world).reshape(world, 3)[r]
    if name == "send_recv":
        return x[(r - 1) % world]
    raise KeyError(name)

def comm_suite(rank, world):
    from deepspeed_tpu_torch.parallel import topology as topo_mod
    from deepspeed_tpu_torch.runtime import zero
    from deepspeed_tpu_torch.runtime.comm import (all_gather_coalesced,
                                                  all_reduce_coalesced,
                                                  reduce_scatter_coalesced)
    from deepspeed_tpu_torch.utils import groups
    rec = {"rank": comm.get_rank(), "world": comm.get_world_size(),
           "local_rank": comm.get_local_rank(), "backend": comm.get_backend()}
    x = torch.arange(8.0) + 10 * rank
    for name, op in (("sum", ReduceOp.SUM), ("avg", ReduceOp.AVG),
                     ("max", ReduceOp.MAX), ("min", ReduceOp.MIN),
                     ("product", ReduceOp.PRODUCT)):
        rec["all_reduce_" + name] = comm.all_reduce(x.clone() + 1, op=op)
    rec["all_reduce_bf16"] = comm.all_reduce(x.to(torch.bfloat16))
    rec["inference_all_reduce"] = comm.inference_all_reduce(x.clone())
    rec["all_gather_into_tensor"] = comm.all_gather_into_tensor(
        torch.empty(8 * world), x)
    src = torch.arange(8.0 * world).view(world, 8) * (rank + 1)
    rec["reduce_scatter_tensor"] = comm.reduce_scatter_tensor(
        torch.empty(8), src.reshape(-1))
    rec["reduce_scatter_avg"] = comm.reduce_scatter_tensor(
        torch.empty(8), src.reshape(-1), op=ReduceOp.AVG)
    a2a = torch.arange(4.0 * world) + 100 * rank
    rec["all_to_all_single"] = comm.all_to_all_single(
        torch.empty(4 * world), a2a)
    rec["broadcast"] = comm.broadcast(x.clone(), src=world - 1)
    rec["reduce"] = comm.reduce(x.clone(), dst=0)
    rec["all_gather"] = torch.stack(comm.all_gather(
        [torch.empty(8) for _ in range(world)], x))
    gl = [torch.empty(8) for _ in range(world)] if rank == 0 else None
    got = comm.gather(x.clone(), gl, dst=0)
    rec["gather"] = torch.stack(got) if rank == 0 else None
    sl = list(torch.arange(3.0 * world).view(world, 3)) if rank == 0 \
        else None
    rec["scatter"] = comm.scatter(torch.empty(3), sl, src=0)
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    buf = torch.empty(8)
    if rank % 2 == 0:
        comm.send(x.clone(), dst=nxt)
        comm.recv(buf, src=prv)
    else:
        comm.recv(buf, src=prv)
        comm.send(x.clone(), dst=nxt)
    rec["send_recv"] = buf
    comm.barrier()
    comm.monitored_barrier(timeout=60)
    # the comms logger
    comm.configure(enabled=True)
    comm.all_reduce(torch.ones(16))
    rec["comms_log"] = comm.log_summary()
    rec["comms_totals"] = comm.comms_logger.totals()
    comm.configure(enabled=False)
    # coalesced: every rank holds the same tensors
    a, b = torch.arange(16.0), torch.ones(3, 5)
    rec["reduce_scatter_coalesced"] = reduce_scatter_coalesced([a, b])
    shard = torch.tensor([float(rank)])
    rec["all_gather_coalesced"] = all_gather_coalesced([shard])[0]
    t1, t2 = torch.full((2, 3), float(rank)), torch.arange(4.0) * rank
    rec["all_reduce_coalesced"] = all_reduce_coalesced(
        [t1, t2], op=ReduceOp.AVG)
    # the live topology and the group getters
    topo = topo_mod.initialize_topology()
    dp_group = groups._get_data_parallel_group()
    rec["topology"] = {
        "dp": topo.dp, "world_size": topo.world_size,
        "dp_rank": groups._get_data_parallel_rank(),
        "dp_group_size": comm.get_world_size(dp_group),
        "tp_group_size": comm.get_world_size(
            groups._get_model_parallel_group()),
        "rows": topo.data_spec(8 * world),
        "group_axes": comm.get_world_size(comm.new_group(axes=("edp",)))}
    rec["dp_group_sum"] = comm.all_reduce(torch.ones(1), group=dp_group)
    # tensor parallelism (ported): tp 2 over the world, its group of 2
    tp_topo = topo_mod.initialize_topology(tp=2)
    rec["tp_group_size"] = comm.get_world_size(
        tp_topo.get_model_parallel_group())
    topo_mod.set_topology(topo)
    # GatheredParameters: a partitioned tensor and a plain one; rank 0's
    # edit wins everywhere
    plan = zero.build_sharding_plan([(4, 6)], world, rank, 1)
    leaf = plan.opt[0]
    full = torch.arange(24.0).view(4, 6)
    part = zero.Partitioned(leaf.take(full).contiguous(), leaf)
    plain = torch.full((3,), float(rank))
    with zero.GatheredParameters({"w": part, "b": plain},
                                 modifier_rank=0) as g:
        rec["gathered_full"] = g.full["w"].clone()
        g.full["w"][:] = 0.25 if rank == 0 else 9.0
        g.full["b"][:] = 7.0 if rank == 0 else -1.0
    rec["gathered_shard"] = part.shard.clone()
    rec["gathered_leaf"] = (leaf.dim, leaf.shard_shape)
    rec["gathered_plain"] = plain.clone()
    untouched = torch.full((2,), float(rank))
    with zero.GatheredParameters(untouched, modifier_rank=None) as g:
        g.full.add_(1)
    rec["gathered_none"] = untouched.clone()
    # zero.Init partitions at birth: each rank keeps its shard
    got = zero.Init().materialize(
        lambda: {"w": torch.arange(24.0).view(4, 6)})["w"]
    rec["init_partitions"] = isinstance(got, zero.Partitioned) and \
        torch.equal(got.shard, got.leaf.take(torch.arange(24.0).view(4, 6)))
    return rec


# --------------------------------------------------------------------- #
# zero
# --------------------------------------------------------------------- #
def _engine(inp, stage, dtype, gas, micro, clip=1.0, zero_extra=None,
            **extra):
    from deepspeed_tpu_torch.models import transformer as pt
    cfg = dict(inp["cfg"], dtype=dtype)
    config = {"train_micro_batch_size_per_gpu": micro,
              "gradient_accumulation_steps": gas,
              "optimizer": {"type": "AdamW", "params": {
                  "lr": inp["lr"], "weight_decay": 0.01}},
              "gradient_clipping": clip,
              "zero_optimization": {"stage": stage,
                                    "reduce_bucket_size": 3000,
                                    **(zero_extra or {})},
              **extra}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
    if dtype == "float16":
        config["fp16"] = {"enabled": True, "initial_scale_power": 8,
                          "hysteresis": 1}
    eng, *_ = ds.initialize(model=pt.Transformer(pt.TransformerConfig(**cfg)),
                            model_parameters=inp["weights"], config=config,
                            device=DEV)
    return eng


def _names(eng):
    return [n for n, p in eng.module.named_parameters() if p.requires_grad]


def _moments(eng):
    """Each moment's shard, in the JAX layout's dim order (whole where
    the plan keeps it whole, in the port's layout)."""
    out = {}
    for field in ("exp_avg", "exp_avg_sq"):
        tensors = getattr(eng._opt_state, field)
        for name, t, leaf in zip(_names(eng), tensors, eng._plan.opt):
            out[f"{field}/{name}"] = (leaf.to_natural(t).float().clone(),
                                      leaf.sharded)
    return out


def zero_suite(rank, world, inp, out_dir):
    rec = {"runs": {}}
    for key in inp["runs"][world]:
        stage, dtype, gas = key
        micro = inp["global_micro"] // world
        eng = _engine(inp, stage, dtype, gas, micro)
        losses = [float(eng.train_batch(batch=b))
                  for b in inp["batches"][gas]]
        sd = {k: v.float().clone() for k, v in
              eng.module_state_dict().items()}
        rec["runs"][key] = {
            "losses": losses, "params": sd if rank == 0 else None,
            "digest": sum(float(v.double().sum()) for v in sd.values()),
            "moments": _moments(eng),
            "grad_norm": float(eng.get_global_grad_norm())}
        del eng
    # the 3-call path and the loader give train_batch's bits
    batch = inp["batches"][2][0]
    a = _engine(inp, 2, "float32", 2, inp["global_micro"] // world)
    want = float(a.train_batch(batch=batch))
    b = _engine(inp, 2, "float32", 2, inp["global_micro"] // world)
    three = []
    for i in range(2):
        loss = b({"input_ids": batch["input_ids"][i]})
        three.append(float(b._last_loss))
        b.backward(loss)
        b.step()
    samples = [{"input_ids": row} for row in
               batch["input_ids"].reshape(-1, batch["input_ids"].shape[-1])]
    c = _engine(inp, 2, "float32", 2, inp["global_micro"] // world)
    loader = c.deepspeed_io(samples)
    got_loader = float(c.train_batch(data_iter=iter(loader)))
    first = next(iter(loader))["input_ids"]
    rec["paths"] = {
        "train_batch": want, "three_call": float(np.mean(three)),
        "loader": got_loader, "loader_rows": tuple(first.shape),
        "equal_3call": all(torch.equal(x, y) for x, y in zip(
            a.module.parameters(), b.module.parameters())),
        "equal_loader": all(torch.equal(x, y) for x, y in zip(
            a.module.parameters(), c.module.parameters()))}
    del a, b, c
    # unequal padding across the ranks: the global-token mean
    rec["padded"] = {}
    for stage in (0, 2):
        eng = _engine(inp, stage, "float32", 1, inp["global_micro"] // world)
        loss = float(eng.train_batch(batch=inp["padded"]))
        rec["padded"][stage] = {"loss": loss,
                                "grad_norm": float(eng.get_global_grad_norm())}
        del eng
    # fp16: rank 1's gradients overflow, every rank skips
    rec["fp16"] = {}
    for stage in (0, 2):
        eng = _engine(inp, stage, "float16", 1, inp["global_micro"] // world)
        before = [p.detach().clone() for p in eng.module.parameters()]
        handle = None
        if rank == 1:
            emb = eng.module.embed_tokens.weight
            handle = emb.register_hook(lambda g: g * float("inf"))
        scale0 = float(eng._scaler_state.scale)
        eng.train_batch(batch=inp["batches"][1][0])
        if handle is not None:
            handle.remove()
        rec["fp16"][stage] = {
            "unchanged": all(torch.equal(x, y) for x, y in zip(
                before, eng.module.parameters())),
            "skipped": eng.skipped_steps, "scale0": scale0,
            "scale": float(eng._scaler_state.scale)}
        del eng
    if world == 2 and "remainder" in inp:
        rec["remainder"] = remainder_suite(inp, rank, world)
    if "ckpt" in inp:
        rec["ckpt"] = ckpt_load(inp, world)
    return rec


def remainder_suite(inp, rank, world):
    """The data-parallel remainder at dp 2: the partitioned backward
    (``grad_partition_groups`` 2) at stages 0 and 2; one engine's state
    written by the synchronous and by the asynchronous (nebula) writer;
    an offloaded optimizer's tag, resumed in a fresh engine."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine.checkpoint_engine \
        import NebulaCheckpointEngine
    from deepspeed_tpu_torch.runtime.config import NebulaConfig
    rem = inp["remainder"]
    micro = inp["global_micro"] // world
    out = {"grouped": {}}
    for stage in (0, 2):
        eng = _engine(inp, stage, "float32", 2, micro,
                      zero_extra={"grad_partition_groups": 2})
        losses = [float(eng.train_batch(batch=b))
                  for b in inp["batches"][2]]
        sd = {k: v.float().clone() for k, v in
              eng.module_state_dict().items()}
        out["grouped"][stage] = {"losses": losses,
                                 "params": sd if rank == 0 else None}
        del eng
    # nebula: the same engine's state through both writers
    eng = _engine(inp, 2, "float32", 1, micro)
    for b in inp["batches"][1][:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(rem["sync_dir"], tag="t")
    eng.checkpoint_engine = NebulaCheckpointEngine(NebulaConfig(
        enabled=True))
    eng.save_checkpoint(rem["nebula_dir"], tag="t")
    del eng
    # the offloaded optimizer: a tag after 2 steps, then a third step; a
    # fresh engine loads the tag and takes the same third step
    off = {"offload_optimizer": {"device": "cpu"}}
    a = _engine(inp, 2, "float32", 1, micro, clip=0.0, zero_extra=off)
    for b in inp["batches"][1][:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(rem["offload_dir"], tag="off")
    saved = {k: v.clone() for k, v in a.module_state_dict().items()}
    a.train_batch(batch=inp["batches"][1][2])
    want = {k: v.clone() for k, v in a.module_state_dict().items()}
    host = a._host_opt.state_dict()
    del a
    b = _engine(inp, 2, "float32", 1, micro, clip=0.0, zero_extra=off)
    b.load_checkpoint(rem["offload_dir"], tag="off")
    b.train_batch(batch=inp["batches"][1][2])
    got = b.module_state_dict()
    host_b = b._host_opt.state_dict()
    out["offload"] = {
        "resumed_bitwise": all(torch.equal(got[k], v)
                               for k, v in want.items()),
        "host_bitwise": all(torch.equal(x, y) for key in (
            "masters", "exp_avg", "exp_avg_sq")
            for x, y in zip(host[key], host_b[key])),
        "saved": saved if rank == 0 else None}
    return out


def ckpt_save(inp, rank, world):
    """dp 2, stage 2 (sharded moments), crash-atomic: 2 steps, a tag, one
    more step; then a marker file for the ranks that load it."""
    ck = inp["ckpt"]
    eng = _engine(inp, 2, "float32", 1, inp["global_micro"] // world,
                  fault={"enabled": True})
    for b in ck["batches"][:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(ck["dir"], tag="dp2")
    loss = float(eng.train_batch(batch=ck["batches"][2]))
    rec = {"loss_after": loss,
           "params": {k: v.clone() for k, v in
                      eng.module_state_dict().items()} if rank == 0 else None}
    comm.barrier()
    if rank == 0:
        open(os.path.join(ck["dir"], "dp2.done"), "w").close()
    return rec


def ckpt_load(inp, world):
    """Once dp 2's tag is there: load it at stage 1 and take the step dp 2
    took after its save."""
    ck = inp["ckpt"]
    done = os.path.join(ck["dir"], "dp2.done")
    deadline = time.monotonic() + 300
    while not os.path.exists(done):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{done} never appeared")
        time.sleep(0.2)
    eng = _engine(inp, 1, "float32", 1, inp["global_micro"] // world,
                  fault={"enabled": True})
    path, _ = eng.load_checkpoint(ck["dir"], tag="dp2")
    return {"path": path, "global_steps": eng.global_steps,
            "loss_after": float(eng.train_batch(batch=ck["batches"][2]))}


# --------------------------------------------------------------------- #
# zero3
# --------------------------------------------------------------------- #
def _natural_masters(eng):
    """Each parameter's master as this rank holds it: the shard in the JAX
    layout's dim order (``(tensor, True)``), or the whole tensor."""
    out = {}
    for name, m, leaf in zip(eng._names, eng._masters, eng._plan.param):
        if m is not None:
            out[name] = (leaf.to_natural(m).float().clone(), True)
        else:
            out[name] = (eng.module.get_parameter(name).detach().float()
                         .clone(), False)
    return out


def _stage3_run(inp, key, world, rank):
    stage, dtype, gas, mics = key
    extra = {"mics_shard_size": mics} if mics > 0 else {}
    eng = _engine(inp, stage, dtype, gas, inp["global_micro"] // world,
                  zero_extra=extra)
    rec = {"shards0": _natural_masters(eng) if stage == 3 else None}
    losses = [float(eng.train_batch(batch=b)) for b in inp["batches"][gas]]
    sd = {k: v.float().clone() for k, v in eng.module_state_dict().items()}
    rec.update(losses=losses, params=sd if rank == 0 else None,
               digest=sum(float(v.double().sum()) for v in sd.values()),
               moments=_moments(eng),
               shards=_natural_masters(eng) if stage == 3 else None,
               stats=dict(eng._coord.stats) if eng._coord else None,
               shard_world=eng.shard_world, shard_rank=eng.shard_rank)
    return rec, eng


def _fragments(eng, inp):
    """tensor_fragment's whole views, and a gradient in mid-window."""
    from deepspeed_tpu_torch.utils import tensor_fragment as tf
    rec = {"fp32": {n: tf.safe_get_full_fp32_param(eng, n)
                    for n in eng._names},
           "exp_avg": {n: tf.safe_get_full_optimizer_state(eng, n, "exp_avg")
                       for n in eng._names},
           "local": {n: tf.get_local_fragment(eng, n) for n in eng._names}}
    loss = eng(inp["mid_batch"])
    eng.backward(loss)
    rec["grad"] = {n: tf.safe_get_full_grad(eng, n) for n in eng._names}
    return rec


def _init_suite(inp, world, rank):
    """zero.Init at birth, the engine from a meta module, and
    GatheredParameters on the engine's live parameters."""
    from deepspeed_tpu_torch.models import transformer as pt
    from deepspeed_tpu_torch.runtime import zero
    from deepspeed_tpu_torch.utils import tensor_fragment as tf
    from deepspeed_tpu_torch.utils.init_on_device import OnDevice
    cfg = pt.TransformerConfig(**inp["cfg"])
    config = {"zero_optimization": {"stage": 3}, "seed": 5}
    with OnDevice(dtype=torch.float32, device="meta"):
        model = pt.Transformer(cfg, device="cpu")
    with zero.Init(config=config, device=DEV) as zi:
        shards = zi.materialize(model)
    rec = {"init": {n: (v.leaf.to_natural(v.shard).clone(), True)
                    if isinstance(v, zero.Partitioned)
                    else (v.detach().clone(), False)
                    for n, v in shards.items()},
           "storage": {n: p.numel() for n, p in model.named_parameters()}}
    eng, *_ = ds.initialize(model=model, device=DEV, config={
        "train_micro_batch_size_per_gpu": inp["global_micro"] // world,
        "optimizer": {"type": "AdamW", "params": {"lr": inp["lr"]}},
        **config})
    rec["engine_masters"] = _natural_masters(eng)
    name = "layers.0.mlp.up_proj.weight"
    p = eng.module.get_parameter(name)
    rec["released"] = p.numel()
    with zero.GatheredParameters([p], modifier_rank=0) as g:
        rec["inside_shape"] = tuple(g.full[0].shape)
        g.full[0].data.fill_(0.25 if rank == 0 else 9.0)
    rec["after_exit"] = p.numel()
    rec["written_back"] = tf.safe_get_full_fp32_param(eng, name)
    rec["loss_after"] = float(eng.train_batch(batch=inp["batches"][1][0]))
    # a meta module straight into initialize: the same shards at birth
    with OnDevice(device="meta"):
        m2 = pt.Transformer(cfg, device="cpu")
    e2, *_ = ds.initialize(model=m2, device=DEV, config={
        "train_micro_batch_size_per_gpu": inp["global_micro"] // world,
        "optimizer": {"type": "AdamW", "params": {"lr": inp["lr"]}},
        **config})
    rec["birth_masters"] = _natural_masters(e2)
    return rec


def _offload_suite(inp, world, rank):
    """ZeRO-Offload at dp > 1, no clipping: each rank's host state."""
    out = {}
    for stage in (2, 3):
        eng = _engine(inp, stage, "float32", 1, inp["global_micro"] // world,
                      clip=0.0, zero_extra={"offload_optimizer": {
                          "device": "cpu"}})
        losses = [float(eng.train_batch(batch=b))
                  for b in inp["batches"][1]]
        host = eng._host_opt.state_dict()
        leaves = eng._plan.param if stage == 3 else eng._plan.opt
        nat = {}
        for field in ("masters", "exp_avg", "exp_avg_sq"):
            for name, t, leaf in zip(eng._names, host[field], leaves):
                shape = leaf.shard_shape
                nat[f"{field}/{name}"] = (
                    leaf.to_natural(t.view(shape)).clone(), leaf.sharded)
        out[stage] = {"losses": losses, "host": nat,
                      "host_numel": sum(t.numel() for f in ("masters",
                                                            "exp_avg",
                                                            "exp_avg_sq")
                                        for t in host[f])}
    return out


def _tiled_suite(inp, world, rank):
    """A TiledLinear under ZeRO-3: each tile gathers on its own."""
    from deepspeed_tpu_torch.runtime.zero.tiling import TiledLinear

    class TiledLM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.tiled = TiledLinear(8, 12, in_splits=2, out_splits=3,
                                     device=DEV or "cpu")

        def zero3_units(self):
            return [(n, m, [f"tiled.{x}" for x in own],
                     [f"tiled.{x}" for x in used])
                    for n, m, own, used in self.tiled.zero3_units()]

        def forward(self, batch):
            return (self.tiled(batch["x"]) - batch["y"]).square().mean()

    torch.manual_seed(0)
    want = TiledLM().state_dict()
    rng = np.random.default_rng(7)
    batches = [{"x": rng.standard_normal((2, 4, 8)).astype(np.float32),
                "y": rng.standard_normal((2, 4, 12)).astype(np.float32)}
               for _ in range(3)]
    out = {}
    for stage in (0, 3):
        model = TiledLM()
        model.load_state_dict(want)
        eng, *_ = ds.initialize(model=model, device=DEV, config={
            "train_micro_batch_size_per_gpu": 2,
            "optimizer": {"type": "Adam", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": stage}})
        out[stage] = {"losses": [float(eng.train_batch(batch=b))
                                 for b in batches],
                      "stats": dict(eng._coord.stats) if eng._coord
                      else None}
    return out


def zero3_suite(rank, world, inp, out_dir):
    rec = {"runs": {}}
    frag_eng = None
    for key in inp["zero3_runs"][world]:
        r, eng = _stage3_run(inp, key, world, rank)
        rec["runs"][key] = r
        if key == inp["fragment_run"].get(world):
            frag_eng = eng
        else:
            del eng
    if frag_eng is not None:
        rec["fragments"] = _fragments(frag_eng, inp)
        del frag_eng
    if world == 2:
        rec["init"] = _init_suite(inp, world, rank)
        rec["offload"] = _offload_suite(inp, world, rank)
        rec["tiled"] = _tiled_suite(inp, world, rank)
        # fp16: rank 1's gradients overflow, every rank skips
        eng = _engine(inp, 3, "float16", 1, inp["global_micro"] // world)
        before = _natural_masters(eng)
        if rank == 1:
            eng.module.embed_tokens.weight.register_hook(
                lambda g: g * float("inf"))
        scale0 = float(eng._scaler_state.scale)
        eng.train_batch(batch=inp["batches"][1][0])
        after = _natural_masters(eng)
        rec["fp16"] = {"unchanged": all(torch.equal(before[n][0],
                                                    after[n][0])
                                        for n in before),
                       "skipped": eng.skipped_steps, "scale0": scale0,
                       "scale": float(eng._scaler_state.scale)}
        del eng
    if "ckpt3" in inp and world == 4:
        rec["ckpt3"] = ckpt3_suite(inp, world, rank)
    return rec


def ckpt3_suite(inp, world, rank):
    """Stage 3 at dp 4: a tag (2 steps) the test loads at world size 1;
    then the test's world-size-1 tag loaded at stage 3; and a MiCS tag
    loaded flat, the flat tag loaded under MiCS."""
    ck = inp["ckpt3"]
    out = {}
    eng = _engine(inp, 3, "float32", 1, inp["global_micro"] // world)
    for b in ck["batches"][:2]:
        eng.train_batch(batch=b)
    eng.save_checkpoint(ck["dir"], tag="dp4s3")
    # the 16-bit export gathers the shards (every rank; rank 0 writes)
    eng.save_16bit_model(os.path.join(ck["dir"], "export_dp4"),
                         "model.safetensors")
    out["loss_after"] = float(eng.train_batch(batch=ck["batches"][2]))
    # every rank gathers (a collective), rank 0 keeps the result
    sd = {k: v.clone() for k, v in eng.module_state_dict().items()}
    out["params_after"] = sd if rank == 0 else None
    del eng
    comm.barrier()
    if rank == 0:
        open(os.path.join(ck["dir"], "dp4s3.done"), "w").close()
    # the world-size-1 tag the test wrote meanwhile, at stage 3 here
    done = os.path.join(ck["dir"], "w1.done")
    deadline = time.monotonic() + 300
    while not os.path.exists(done):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{done} never appeared")
        time.sleep(0.2)
    eng = _engine(inp, 3, "float32", 1, inp["global_micro"] // world)
    eng.load_checkpoint(ck["dir"], tag="w1")
    out["w1_steps"] = eng.global_steps
    out["w1_loss_after"] = float(eng.train_batch(batch=ck["batches"][2]))
    del eng
    # MiCS -> flat -> MiCS
    mics = _engine(inp, 3, "float32", 1, inp["global_micro"] // world,
                   zero_extra={"mics_shard_size": 2})
    for b in ck["batches"][:2]:
        mics.train_batch(batch=b)
    mics.save_checkpoint(ck["dir"], tag="mics")
    before = {k: v.clone() for k, v in mics.module_state_dict().items()}
    del mics
    flat = _engine(inp, 3, "float32", 1, inp["global_micro"] // world)
    flat.load_checkpoint(ck["dir"], tag="mics")
    got = flat.module_state_dict()
    out["mics_to_flat_equal"] = all(torch.equal(before[k], got[k])
                                    for k in before)
    out["mics_to_flat_steps"] = flat.global_steps
    flat.train_batch(batch=ck["batches"][2])
    flat.save_checkpoint(ck["dir"], tag="flat")
    before = {k: v.clone() for k, v in flat.module_state_dict().items()}
    del flat
    back = _engine(inp, 3, "float32", 1, inp["global_micro"] // world,
                   zero_extra={"mics_shard_size": 2})
    back.load_checkpoint(ck["dir"], tag="flat")
    got = back.module_state_dict()
    out["flat_to_mics_equal"] = all(torch.equal(before[k], got[k])
                                    for k in before)
    out["flat_to_mics_steps"] = back.global_steps
    out["flat_to_mics_loss"] = float(back.train_batch(
        batch=ck["batches"][3]))
    return out


def zero3_cuda_suite(rank, world, inp):
    """The card tests of ZeRO-3 (``tests/test_torch_zero3_cuda.py``): the
    peak of a train step at stages 2 and 3, the collectives each rank
    issues at stage 3 in order, the fp16 skip at stage 3."""
    rec = {"peak": {}}
    for stage in (2, 3):
        torch.cuda.empty_cache()
        eng = _engine(inp, stage, "bfloat16", 1,
                      inp["global_micro"] // world)
        eng.train_batch(batch=inp["batches"][1][0])     # settle the state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng.train_batch(batch=inp["batches"][1][1])
        torch.cuda.synchronize()
        rec["peak"][stage] = {"peak": torch.cuda.max_memory_allocated(),
                              "before": base,
                              "n": sum(int(np.prod(leaf.full_shape))
                                       for leaf in eng._plan.param)}
        if stage == 3:
            # every collective this rank issues in one step, in order
            seq = []
            names = ("all_gather_into_tensor", "reduce_scatter_tensor",
                     "all_reduce")
            saved = {n: getattr(comm, n) for n in names}

            def logged(name, fn):
                def call(*args, **kwargs):
                    t = args[1] if name != "all_reduce" else args[0]
                    seq.append((name, int(t.numel()), str(t.dtype)))
                    return fn(*args, **kwargs)
                return call
            for n in names:
                setattr(comm, n, logged(n, saved[n]))
            try:
                eng.train_batch(batch=inp["batches"][1][2])
            finally:
                for n in names:
                    setattr(comm, n, saved[n])
            rec["collectives"] = seq
            rec["stats"] = dict(eng._coord.stats)
        del eng
    # fp16: rank 1's gradients overflow, every rank skips the stage-3 step
    eng = _engine(inp, 3, "float16", 1, inp["global_micro"] // world)
    before = _natural_masters(eng)
    if rank == 1:
        eng.module.embed_tokens.weight.register_hook(
            lambda g: g * float("inf"))
    scale0 = float(eng._scaler_state.scale)
    eng.train_batch(batch=inp["batches"][1][0])
    after = _natural_masters(eng)
    rec["fp16"] = {"unchanged": all(torch.equal(before[n][0], after[n][0])
                                    for n in before),
                   "skipped": eng.skipped_steps, "scale0": scale0,
                   "scale": float(eng._scaler_state.scale)}
    return rec


def main():
    suite, out_dir = sys.argv[1], sys.argv[2]
    rank = int(os.environ["RANK"])
    if suite == "fail":
        if rank == 1:
            sys.exit(3)
        time.sleep(120)
        return
    torch.set_num_threads(1)
    ds.init_distributed(device=DEV, timeout=240)
    world = comm.get_world_size()
    if CUDA:
        # the comm suite's tensors go to this rank's card
        torch.set_default_device(comm.get_device())
    if suite == "comm":
        rec = comm_suite(rank, world)
    elif suite == "zero":
        inp = torch.load(sys.argv[3], weights_only=False)
        rec = zero_suite(rank, world, inp, out_dir)
    elif suite == "ckpt":
        inp = torch.load(sys.argv[3], weights_only=False)
        rec = ckpt_save(inp, rank, world)
    elif suite == "zero3":
        inp = torch.load(sys.argv[3], weights_only=False)
        rec = zero3_suite(rank, world, inp, out_dir)
    elif suite == "zero3_cuda":
        inp = torch.load(sys.argv[3], weights_only=False)
        rec = zero3_cuda_suite(rank, world, inp)
    else:
        raise SystemExit(f"unknown suite {suite!r}")
    _save(out_dir, suite, rank, rec)
    comm.barrier()
    comm.destroy_process_group()


if __name__ == "__main__":
    main()
