"""The port's communication layer (``deepspeed_tpu_torch.comm`` over
``torch.distributed``) on the CPU over gloo, against numpy and against the
JAX package's verbs on its virtual mesh — the scenarios of
``tests/unit/test_comm.py:29-135`` and
``tests/unit/test_coalesced_zero_linear.py:17-50``.

Real processes: ``tests/torch_dp_worker.py comm`` is started through the
port's launcher at world sizes 2 and 4 at once, while this process runs
each JAX verb inside ``shard_map`` on the same per-rank inputs (rank r's
input is device r's shard).  Exact equality where the values are small
integers; the JAX PRODUCT (``exp(psum(log))``) at 1e-5.

Also: the live topology and the group getters, ``GatheredParameters``
(rank 0's edit wins, a partitioned tensor keeps its shard of it),
``zero.Init`` partitioning and a ``tp`` group of 2, the comms logger, the
launcher's exit code when one rank fails, the errors of
``init_distributed`` (no ``WORLD_SIZE``, NCCL without CUDA, gloo with a
CUDA device), and a group of one: stages 0, 1, 2 bitwise the engine
without a group (fp32 and bf16, gas 2, clipping).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import deepspeed_tpu.comm as jdist
from deepspeed_tpu.parallel.topology import (DP_AXES, initialize_topology,
                                              reset_topology)
from deepspeed_tpu.runtime.comm.coalesced_collectives import (
    all_gather_coalesced as j_all_gather_coalesced,
    reduce_scatter_coalesced as j_reduce_scatter_coalesced)
from deepspeed_tpu.utils.jax_compat import shard_map

import deepspeed_tpu_torch
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import backend_for
from deepspeed_tpu_torch.models import transformer as pt

from torch_dp_worker import VERBS, comm_expected, comm_inputs
from torch_zero_dp_common import REPO, WORKER, free_port, join, launch

WORLDS = (2, 4)


def _jax_reference(world):
    """The JAX verbs on ``world`` virtual devices, rank r's input on device
    r; each result as the list of the devices' values."""
    topo = initialize_topology(dp=world, devices=jax.devices()[:world])
    inp = comm_inputs(world)
    try:
        def run(fn, x, in_spec=P(DP_AXES), out_spec=P(DP_AXES)):
            return np.asarray(jax.jit(shard_map(
                fn, mesh=topo.mesh, in_specs=(in_spec,), out_specs=out_spec,
                check_vma=False))(jnp.asarray(x)))

        x = np.concatenate(inp["x"])
        rows = lambda y: list(y.reshape(world, -1))  # noqa: E731
        ref = {}
        for name, op in (("sum", jdist.ReduceOp.SUM),
                         ("avg", jdist.ReduceOp.AVG),
                         ("max", jdist.ReduceOp.MAX),
                         ("min", jdist.ReduceOp.MIN),
                         ("product", jdist.ReduceOp.PRODUCT)):
            ref["all_reduce_" + name] = rows(run(
                lambda v, op=op: jdist.all_reduce(v + 1, op=op,
                                                  group=DP_AXES), x))
        ref["inference_all_reduce"] = rows(run(
            lambda v: jdist.inference_all_reduce(v, group=DP_AXES), x))
        full = run(lambda v: jdist.all_gather_into_tensor(v, group=DP_AXES),
                   x, out_spec=P(None))
        ref["all_gather_into_tensor"] = [full] * world
        ref["reduce_scatter_tensor"] = rows(run(
            lambda v: jdist.reduce_scatter_tensor(v[0], group=DP_AXES),
            np.stack(inp["src"]), in_spec=P(DP_AXES, None)))
        ref["all_to_all_single"] = rows(run(
            lambda v: jdist.all_to_all_single(v, group=DP_AXES, split_axis=0,
                                              concat_axis=0),
            np.concatenate(inp["a2a"])))
        ref["broadcast"] = rows(run(
            lambda v: jdist.broadcast(v, src=world - 1, group=DP_AXES), x))
        stacked = run(lambda v: jdist.all_gather(v, group=DP_AXES), x,
                      out_spec=P(None, None))
        ref["all_gather"] = [stacked] * world
        ref["gather"] = stacked
        ref["scatter"] = rows(run(
            lambda v: jdist.scatter(v, group=DP_AXES),
            np.arange(3.0 * world).reshape(world, 3), in_spec=P(None, None)))
        # the coalesced pair on a one-axis mesh, as the JAX test builds it
        mesh = Mesh(np.asarray(jax.devices()[:world]), ("dp",))

        def rsc(a, b):
            outs = j_reduce_scatter_coalesced([a, b], "dp")
            return outs[0], outs[1]

        s1, s2 = jax.jit(shard_map(
            rsc, mesh=mesh, in_specs=(P(), P()), out_specs=(P("dp"), P("dp")),
            check_vma=False))(jnp.arange(16.0), jnp.ones((3, 5)))
        ref["reduce_scatter_coalesced"] = [
            [np.asarray(s1).reshape(world, -1)[r],
             np.asarray(s2).reshape(world, -1)[r]] for r in range(world)]
        agc = jax.jit(shard_map(
            lambda s: j_all_gather_coalesced([s[0]], "dp")[0], mesh=mesh,
            in_specs=(P("dp"),), out_specs=P(), check_vma=False))(
                jnp.arange(float(world)).reshape(world, 1))
        ref["all_gather_coalesced"] = [np.asarray(agc)] * world
        return ref
    finally:
        reset_topology()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("comm")
    outs = {w: tmp / f"w{w}" for w in WORLDS}
    for d in outs.values():
        os.makedirs(d)
    procs = {w: launch(w, "comm", outs[w]) for w in WORLDS}
    try:
        ref = {w: _jax_reference(w) for w in WORLDS}
        ranks = {w: join(procs[w], outs[w], "comm", w) for w in WORLDS}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return ranks, ref


def _np(t):
    return t.float().numpy() if torch.is_tensor(t) else np.asarray(t)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("verb", VERBS)
def test_collective_matches_numpy_and_jax(results, world, verb):
    ranks, ref = results
    for r, rec in enumerate(ranks[world]):
        if verb == "reduce" and r != 0:
            continue            # only dst's tensor is defined (torch's rule)
        got = _np(rec[verb])
        np.testing.assert_array_equal(got, comm_expected(verb, world, r),
                                      err_msg=f"rank {r}")
        if verb in ref[world]:
            want = ref[world][verb][r]
            tol = 1e-5 if verb.endswith("product") else 0
            np.testing.assert_allclose(got, want, rtol=tol, atol=0,
                                       err_msg=f"rank {r} vs JAX")


@pytest.mark.parametrize("world", WORLDS)
def test_gather_lands_on_dst_only(results, world):
    ranks, ref = results
    np.testing.assert_array_equal(_np(ranks[world][0]["gather"]),
                                  ref[world]["gather"])
    assert all(rec["gather"] is None for rec in ranks[world][1:])


@pytest.mark.parametrize("world", WORLDS)
def test_coalesced_collectives(results, world):
    """``reduce_scatter_coalesced`` of tensors every rank holds alike:
    world × each piece, the 15-element tensor padded to 16 with a zero
    tail; ``all_gather_coalesced`` of one scalar a rank; both equal to the
    JAX functions; ``all_reduce_coalesced`` writes the mean back."""
    ranks, ref = results
    for r, rec in enumerate(ranks[world]):
        s1, s2 = (_np(t) for t in rec["reduce_scatter_coalesced"])
        w1, w2 = ref[world]["reduce_scatter_coalesced"][r]
        np.testing.assert_array_equal(s1, w1)
        np.testing.assert_array_equal(s2, w2)
        full1 = world * np.arange(16.0)
        np.testing.assert_array_equal(s1, full1.reshape(world, -1)[r])
        full2 = np.concatenate([world * np.ones(15), np.zeros(1)])
        np.testing.assert_array_equal(s2, full2.reshape(world, -1)[r])
        np.testing.assert_array_equal(_np(rec["all_gather_coalesced"]),
                                      np.arange(float(world)))
        np.testing.assert_array_equal(ref[world]["all_gather_coalesced"][r],
                                      np.arange(float(world)))
        t1, t2 = (_np(t) for t in rec["all_reduce_coalesced"])
        mean = np.mean(np.arange(world))
        np.testing.assert_array_equal(t1, np.full((2, 3), mean))
        np.testing.assert_array_equal(t2, np.arange(4.0) * mean)


@pytest.mark.parametrize("world", WORLDS)
def test_identity_topology_and_groups(results, world):
    ranks, _ = results
    for r, rec in enumerate(ranks[world]):
        assert (rec["rank"], rec["world"], rec["local_rank"]) == (r, world, r)
        assert rec["backend"] == "gloo"
        topo = rec["topology"]
        assert (topo["dp"], topo["world_size"], topo["dp_rank"]) == \
            (world, world, r)
        assert topo["dp_group_size"] == world and topo["tp_group_size"] == 1
        assert topo["group_axes"] == world
        assert topo["rows"] == slice(8 * r, 8 * (r + 1))
        assert float(rec["dp_group_sum"]) == world
        assert rec["tp_group_size"] == 2 and rec["init_partitions"]


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_parameters_surgery(results, world):
    """The JAX test's surgery (``tests/unit/test_zero_api.py:42-72``):
    full values inside, rank 0's edit everywhere after, each rank keeping
    its own shard; ``modifier_rank=None`` moves nothing."""
    ranks, _ = results
    full = np.arange(24.0).reshape(4, 6)
    for r, rec in enumerate(ranks[world]):
        np.testing.assert_array_equal(_np(rec["gathered_full"]), full)
        dim, shape = rec["gathered_leaf"]
        assert dim == (1 if world == 2 else 0)
        assert _np(rec["gathered_shard"]).shape == shape
        np.testing.assert_array_equal(_np(rec["gathered_shard"]), 0.25)
        np.testing.assert_array_equal(_np(rec["gathered_plain"]), 7.0)
        np.testing.assert_array_equal(_np(rec["gathered_none"]), r + 1.0)


def test_comms_logger_records(results):
    ranks, _ = results
    for rec in ranks[2]:
        assert "all_reduce" in rec["comms_log"]
        tot = rec["comms_totals"]["all_reduce"]
        assert tot["count"] == 1 and tot["bytes"] == 64 and \
            tot["seconds"] > 0


def test_launcher_exit_code_when_a_rank_fails(tmp_path):
    """Rank 1 exits 3 at once; the others would sleep 120 s: the launcher
    stops them and exits 3."""
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
         "--num_gpus", "3", "--master_port", str(free_port()),
         WORKER, "fail", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert time.monotonic() - t0 < 30


def test_launcher_refuses_multi_node(tmp_path):
    from deepspeed_tpu_torch.launcher import runner
    hostfile = tmp_path / "hostfile"
    hostfile.write_text("node1 slots=4\nnode2 slots=4\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.main(["-H", str(hostfile), WORKER])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.main(["--launcher", "pdsh", "--num_gpus", "2", WORKER])
    assert runner.fetch_hostfile(str(hostfile)) == {"node1": 4, "node2": 4}
    assert runner.decode_world_info(runner.encode_world_info(
        {"node1": 4})) == {"node1": 4}


def test_init_distributed_errors(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        comm.init_distributed(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            comm.init_distributed()
        with pytest.raises(RuntimeError, match="nccl"):
            comm.init_distributed(dist_backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        backend_for("cuda:0", "gloo")
    assert backend_for("cpu") == "gloo"
    assert not comm.is_initialized()


CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu", remat=False)


def _run(dtype, stage=None, steps=3):
    model = pt.Transformer(pt.TransformerConfig(**dict(CFG, dtype=dtype)))
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 3e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "seed": 5,
              "zero_optimization": {"stage": stage or 0,
                                    "reduce_bucket_size": 3000}}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
        config["data_types"] = {"grad_accum_dtype": "bf16"}
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                             device="cpu")
    rng = np.random.default_rng(3)
    losses = [eng.train_batch(batch={"input_ids": rng.integers(
        0, 97, (2, 2, 16)).astype(np.int32)}) for _ in range(steps)]
    return losses, eng


@pytest.fixture(scope="module")
def world_one(tmp_path_factory):
    """A gloo group of one in this process: stages 0, 1, 2 and the engine
    without a group, fp32 and bf16 (bf16 accumulation)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    want = {d: _run(d) for d in ("float32", "bfloat16")}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    comm.init_distributed(device="cpu")
    try:
        got = {(d, s): _run(d, s) for d in ("float32", "bfloat16")
               for s in (0, 1, 2)}
        assert comm.get_world_size() == 1
    finally:
        torch.set_num_threads(threads)
        comm.destroy_process_group()
        for var in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR",
                    "MASTER_PORT"):
            os.environ.pop(var, None)
    return want, got


@pytest.mark.parametrize("stage", (0, 1, 2))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_group_of_one_is_bitwise_no_group(world_one, dtype, stage):
    want, got = world_one
    (wl, we), (gl, ge) = want[dtype], got[(dtype, stage)]
    assert ge.dp_world == 1 and ge._dp and not we._dp
    for a, b in zip(gl, wl):
        assert torch.equal(a, b)
    assert torch.equal(ge.get_global_grad_norm(), we.get_global_grad_norm())
    for (name, a), b in zip(ge.module_state_dict().items(),
                            we.module_state_dict().values()):
        assert torch.equal(a, b), name
    for fa, fb in zip(ge._opt_state, we._opt_state):
        for a, b in zip(fa, fb):
            assert torch.equal(a, b)
