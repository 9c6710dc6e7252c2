"""One rank of the port's tensor-parallel CPU tests (gloo).  It imports no
JAX: the tests start it through the port's launcher,

    python -m deepspeed_tpu_torch.launcher.runner --num_gpus N \\
        tests/torch_tp_worker.py SUITE OUT_DIR INPUT

and each rank writes ``OUT_DIR/SUITE.rank<r>.pt``, which the tests hold
against the JAX engine at the same mesh (``tests/torch_tp_common.py``).

Suites: ``serve`` (world 2: serving at tp 2), ``uni4`` / ``uni2``
(world 4 / 2: a universal checkpoint written at tp 2 × dp 2 under ZeRO-3
and loaded at tp 2 and at dp 2), ``tp`` (world 2, tp 2: training runs from INPUT, each rank's
slices, gradients of one micro step with and without copy-to-TP's
all-reduce, the gradient norm, greedy ``generate`` of the port's model, of
an HF model and of int8 weights, ``initialize(mpu= / topology=)``, a
module each rank drew from its own seed),
``serve_cuda`` (on the cards: serving at tp 2 against one card's),
``tp4`` (world 4:
tp 2 × dp 2 under ZeRO-1/2/3 with each rank's moments, tp 4 with kv heads
that do not divide by tp, the order of the collectives, and a tag saved
at dp 4 under ZeRO-3 loaded at tp 2 × dp 2 and back), ``tp_cuda`` (on
the cards, ``WORKER_DEVICE=cuda``: tp 2 in bf16 against one card's engine,
greedy generate at tp 2 with and without the captured decode graphs).
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import deepspeed_tpu_torch as ds  # noqa: E402
from deepspeed_tpu_torch import comm  # noqa: E402
from deepspeed_tpu_torch.models import transformer as pt  # noqa: E402
from deepspeed_tpu_torch.parallel import tensor_parallel as ptp  # noqa: E402
from deepspeed_tpu_torch.parallel import topology as topo_mod  # noqa: E402

from torch_dp_worker import _save  # noqa: E402

# "cpu" (gloo) or "cuda" (NCCL, each rank on cuda:LOCAL_RANK)
CUDA = os.environ.get("WORKER_DEVICE", "cpu") == "cuda"
DEV = None if CUDA else "cpu"


def _config(inp, stage, dtype, tp, micro, gas, clip):
    config = {"train_micro_batch_size_per_gpu": micro,
              "gradient_accumulation_steps": gas,
              "optimizer": {"type": "AdamW", "params": {
                  "lr": inp["lr"], "weight_decay": 0.01}},
              "gradient_clipping": clip,
              "zero_optimization": {"stage": stage,
                                    "reduce_bucket_size": 3000},
              "tensor_parallel": {"tp_size": tp}}
    if dtype == "bfloat16":
        config["bf16"] = {"enabled": True}
    return config


def _engine(inp, variant, stage, dtype, tp, gas=2, clip=None, weights=True,
            **extra):
    cfg = dict(inp["cfgs"][variant], dtype=dtype)
    dp = comm.get_world_size() // tp
    config = _config(inp, stage, dtype, tp, inp["global_micro"] // dp, gas,
                     inp["clip"] if clip is None else clip)
    config.update(extra)
    eng, *_ = ds.initialize(model=pt.Transformer(pt.TransformerConfig(**cfg)),
                            model_parameters=inp["weights"][variant]
                            if weights else None, config=config, device=DEV)
    return eng


def _natural(eng, tensors):
    """``{name: tensor}`` of this rank's pieces in the JAX layout's dim
    order (the tp slice; under ZeRO the shard's ``to_natural``)."""
    lay = eng.module.jax_layouts()
    names = [n for n, p in eng.module.named_parameters() if p.requires_grad]
    out = {}
    for i, (name, t) in enumerate(zip(names, tensors)):
        if eng._plan is not None and t.shape != eng._params[i].shape:
            out[name] = eng._plan.opt[i].to_natural(t).float().clone()
            continue
        view = lay.get(name, (None,))[0]
        out[name] = (t if view is None else view(t)).float().clone()
    return out


def _run(inp, key, rank):
    variant, stage, dtype, tp = key
    eng = _engine(inp, variant, stage, dtype, tp)
    losses, norms = [], []
    for b in inp["batches"]:
        losses.append(float(eng.train_batch(batch=b)))
        norms.append(float(eng.get_global_grad_norm()))
    local = _natural(eng, [p.data for p in eng._params]) \
        if stage < 3 else None
    full = {k: v.float().clone() for k, v in
            eng.module_state_dict().items()}
    rec = {"losses": losses, "grad_norms": norms, "local": local,
           "params": full if rank == 0 else None,
           "digest": sum(float(v.double().sum()) for v in full.values()),
           "plan": {n: None if t is None else t.dim
                    for n, t in (eng._tp_plan or {}).items()}}
    if stage > 0:
        rec["moments"] = {
            field: _natural(eng, getattr(eng._opt_state, field))
            for field in ("exp_avg", "exp_avg_sq")}
    return rec


def _grads(inp, variant, copy_allreduce=True):
    """One micro step's gradients (no step), each rank's pieces."""
    eng = _engine(inp, variant, 0, "float32", 2, gas=1)
    saved = ptp._CopyToTP.backward
    if not copy_allreduce:
        ptp._CopyToTP.backward = staticmethod(lambda ctx, g: (g, None))
    try:
        loss = eng({"input_ids": inp["batches"][0]["input_ids"][0]})
        eng.backward(loss)
    finally:
        ptp._CopyToTP.backward = saved
    return {"loss": float(loss), "grads": _natural(eng, eng._grads())}


def _generate(inp, variant):
    cfg = dict(inp["cfgs"][variant], dtype="float32")
    eng = ds.init_inference(pt.Transformer(pt.TransformerConfig(**cfg)),
                            config={"dtype": "float32",
                                    "tensor_parallel": {"tp_size": 2},
                                    "prefill_chunk_size": None},
                            device="cpu")
    eng.set_params(inp["weights"][variant])
    out = {"one_pass": eng.generate(inp["gen_ids"], max_new_tokens=8)}
    try:
        eng.serve(speculative=True, spec_draft_model="self")
        out["serve_raises"] = False
    except NotImplementedError as e:
        out["serve_raises"] = "ROADMAP" in str(e)
    return out


class _LegacyMpu:
    """Megatron's legacy model-parallel unit (tp 2)."""

    def get_model_parallel_world_size(self):
        return 2

    def get_pipe_parallel_world_size(self):
        return 1


class _CoreMpu:
    """Megatron-Core's names (tp 2)."""

    def get_tensor_model_parallel_world_size(self):
        return 2

    def get_pipeline_model_parallel_world_size(self):
        return 1


def _entry_points(inp):
    """``initialize(mpu=, topology=, dist_init_required=)``: the tp and dp
    sizes each choice gives the engine (an explicit topology wins over an
    mpu, an mpu over the config)."""
    cfg = pt.TransformerConfig(**inp["cfgs"]["opt96"])
    config = _config(inp, 0, "float32", 1, 2, 1, 1.0)
    del config["tensor_parallel"]
    out = {}
    for name, kw in (("legacy_mpu", {"mpu": _LegacyMpu()}),
                     ("core_mpu", {"mpu": _CoreMpu()}),
                     ("topology_wins", {
                         "mpu": _LegacyMpu(),
                         "topology": topo_mod.initialize_topology(tp=1)}),
                     ("config", {"config_tp": 2})):
        topo_mod.reset_topology()
        c = dict(config)
        if kw.pop("config_tp", None):
            c["tensor_parallel"] = {"tp_size": 2}
            c["train_micro_batch_size_per_gpu"] = 4
        elif "topology" not in kw:
            c["train_micro_batch_size_per_gpu"] = 4
        eng, *_ = ds.initialize(model=pt.Transformer(cfg), config=c,
                                device="cpu", dist_init_required=True, **kw)
        out[name] = (eng.tp_world, eng.dp_world,
                     eng.train_micro_batch_size_per_gpu())
        del eng
    topo_mod.reset_topology()
    return out


def hf_like(inp):
    """An HF OPT as ``module_inject`` reads one (``.config`` with HF's
    attribute names, ``.state_dict()`` with HF's keys): the tiny OPT's
    weights exported through ``OPTPolicy.export_convert``."""
    import types
    from deepspeed_tpu_torch.module_inject import OPTPolicy
    cfg = pt.TransformerConfig(**inp["cfgs"]["opt96"])
    flat = {k: v.numpy() for k, v in pt.params_to_flax(
        inp["weights"]["opt96"], cfg).items()}
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             OPTPolicy().export_convert(flat, cfg).items()}
    config = types.SimpleNamespace(
        model_type="opt", vocab_size=cfg.vocab_size,
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, ffn_dim=cfg.ffn_size,
        max_position_embeddings=cfg.max_seq_len, activation_function="relu",
        tie_word_embeddings=True, word_embed_proj_dim=cfg.hidden_size,
        do_layer_norm_before=True)
    return types.SimpleNamespace(config=config, state_dict=lambda: state)


def _generate_other_routes(inp):
    """Greedy tokens at tp 2 of an HF model (converted, then cut) and of
    int8 weights (kept whole on every rank, as JAX keeps them)."""
    out = {}
    hf = ds.init_inference(hf_like(inp), config={
        "dtype": "float32", "tensor_parallel": {"tp_size": 2},
        "prefill_chunk_size": None}, device="cpu")
    out["hf"] = (hf._tp is not None,
                 hf.generate(inp["gen_ids"], max_new_tokens=8))
    cfg = dict(inp["cfgs"]["opt96"], dtype="float32")
    q = ds.init_inference(pt.Transformer(pt.TransformerConfig(**cfg)),
                          config={"dtype": "float32",
                                  "tensor_parallel": {"tp_size": 2},
                                  "quant": {"enabled": True, "bits": 8},
                                  "prefill_chunk_size": None}, device="cpu")
    q.set_params(inp["weights"]["opt96"])
    out["int8"] = (q._tp is None and q.topology.tp == 2,
                   q.generate(inp["gen_ids"], max_new_tokens=8))
    return out


def _rank_inits(inp, rank):
    """A module every rank materialized from its own seed, given to
    ``initialize`` at tp 2 with no ``model_parameters``: the whole model the
    engine then holds (``module_state_dict``, gathered over tp)."""
    cfg = pt.TransformerConfig(**inp["cfgs"]["opt96"])
    model = pt.Transformer(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(100 + rank))
    eng, *_ = ds.initialize(model=model, config=_config(
        inp, 0, "float32", 2, 4, 1, 1.0), device="cpu")
    return {k: v.clone() for k, v in eng.module_state_dict().items()}


def tp_suite(rank, inp):
    rec = {"runs": {key: _run(inp, key, rank) for key in inp["runs"][2]}}
    rec["routes"] = _generate_other_routes(inp)
    rec["entry"] = _entry_points(inp)
    rec["rank_inits"] = _rank_inits(inp, rank)
    rec["grads"] = {v: _grads(inp, v) for v in inp["grad_variants"]}
    rec["grads_no_copy_allreduce"] = _grads(inp, "opt96",
                                            copy_allreduce=False)
    rec["generate"] = {v: _generate(inp, v) for v in inp["gen_variants"]}
    return rec


def _collective_order(inp):
    """The collectives one tp 2 × dp 2 ZeRO-2 step issues, in order, as
    ``(verb, group size)``."""
    seen = []
    verbs = ("all_reduce", "all_gather", "reduce_scatter_tensor",
             "all_gather_into_tensor", "broadcast")
    saved = {v: getattr(comm, v) for v in verbs}

    def wrap(name, fn):
        def inner(*args, group=None, **kw):
            seen.append((name, comm.get_world_size(group)))
            return fn(*args, group=group, **kw)
        return inner

    eng = _engine(inp, "opt96", 2, "float32", 2)
    for v in verbs:
        setattr(comm, v, wrap(v, saved[v]))
    try:
        eng.train_batch(batch=inp["batches"][0])
    finally:
        for v in verbs:
            setattr(comm, v, saved[v])
    return seen


def _ckpt_chain(inp, rank):
    """A tag saved at dp 4 under ZeRO-3 (2 steps), loaded at tp 2 × dp 2
    (ZeRO-3) where one more step runs and a second tag is saved, which
    dp 4 loads back: the parameters and moments after each load are the
    saved ones, bitwise."""
    ck = inp["ckpt_dir"]
    out = {}
    a = _engine(inp, "opt96", 3, "float32", 1)
    for b in inp["batches"][:2]:
        a.train_batch(batch=b)
    a.save_checkpoint(ck, tag="dp4")
    out["dp4"] = {k: v.clone() for k, v in a.module_state_dict().items()}
    del a
    topo_mod.reset_topology()
    b = _engine(inp, "opt96", 3, "float32", 2, weights=False)
    b.load_checkpoint(ck, tag="dp4")
    out["tp2_loaded"] = {k: v.clone()
                         for k, v in b.module_state_dict().items()}
    out["tp2_steps"] = b.global_steps
    out["tp2_loss"] = float(b.train_batch(batch=inp["batches"][2]))
    b.save_checkpoint(ck, tag="tp2")
    out["tp2"] = {k: v.clone() for k, v in b.module_state_dict().items()}
    moments = [t.clone() for t in b._opt_state.exp_avg]
    del b
    topo_mod.reset_topology()
    c = _engine(inp, "opt96", 3, "float32", 1, weights=False)
    c.load_checkpoint(ck, tag="tp2")
    out["dp4_loaded"] = {k: v.clone()
                         for k, v in c.module_state_dict().items()}
    d = _engine(inp, "opt96", 3, "float32", 2, weights=False)
    d.load_checkpoint(ck, tag="tp2")
    out["moments_back"] = all(torch.equal(x, y) for x, y in zip(
        moments, d._opt_state.exp_avg))
    return out if rank == 0 else {"moments_back": out["moments_back"]}


def tp4_suite(rank, inp):
    rec = {"runs": {}}
    for key in inp["runs"][4]:
        topo_mod.reset_topology()
        rec["runs"][key] = _run(inp, key, rank)
    topo_mod.reset_topology()
    rec["order"] = _collective_order(inp)
    topo_mod.reset_topology()
    rec["ckpt"] = _ckpt_chain(inp, rank)
    return rec


# --------------------------------------------------------------------- #
# universal checkpoints (tests/test_torch_universal_checkpoint.py)
# --------------------------------------------------------------------- #
def uni4_suite(rank, inp):
    """tp 2 × dp 2 under ZeRO-3 from the converted weights: the steps, a
    tag, its universal directory (rank 0), then the next step."""
    from deepspeed_tpu_torch.checkpoint import convert_to_universal
    uni = inp["uni"]
    eng = _engine(inp, "opt96", 3, "float32", 2)
    losses = [float(eng.train_batch(batch=b)) for b in inp["batches"]]
    eng.save_checkpoint(uni["ckpt_dir"], tag="tp2dp2")
    if rank == 0:
        convert_to_universal(uni["ckpt_dir"], uni["dir"], tag="tp2dp2")
        open(uni["dir"] + ".done", "w").close()
    return {"losses": losses,
            "loss_next": float(eng.train_batch(batch=uni["next"]))}


def uni2_suite(rank, inp):
    """Once the universal directory is there: load it at tp 2 (ZeRO-1) and
    at dp 2 (ZeRO-3), save each engine's tag, take the next step."""
    from deepspeed_tpu_torch.checkpoint import load_universal_into_engine
    uni = inp["uni"]
    deadline = time.monotonic() + 600
    while not os.path.exists(uni["dir"] + ".done"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{uni['dir']} never appeared")
        time.sleep(0.2)
    rec = {}
    for tag, stage, tp in (("tp2", 1, 2), ("dp2", 3, 1)):
        topo_mod.reset_topology()
        eng = _engine(inp, "opt96", stage, "float32", tp, weights=False)
        load_universal_into_engine(eng, uni["dir"])
        eng.save_checkpoint(uni["ckpt_dir"], tag=tag)
        rec[tag] = {"steps": eng.global_steps,
                    "loss_next": float(eng.train_batch(batch=uni["next"]))}
    return rec


# --------------------------------------------------------------------- #
# serving at tp 2 (tests/test_torch_serving_tp.py)
# --------------------------------------------------------------------- #
def _serve_engine(inp):
    eng = ds.init_inference(
        pt.Transformer(pt.TransformerConfig(**inp["cfg"])),
        config={"dtype": "float32", "prefill_chunk_size": 8,
                "serving": dict(inp["serving"]),
                "tensor_parallel": {"tp_size": 2}}, device=DEV)
    eng.set_params(inp["sd"])
    return eng


def _served(srv, submit):
    """Rank 0 submits and drains; a follower follows.  Each request's
    output, status and replayed stream, and the ids the call returned."""
    if srv.tp_follower:
        returned = srv.follow()
    else:
        submit(srv)
        returned = srv.drain()
        srv.close()
    rids = sorted(srv._requests)
    return {"returned": sorted(returned),
            "outs": {r: srv.result(r).output for r in rids},
            "status": {r: srv.status(r) for r in rids},
            "detail": {r: srv.result(r).detail for r in rids},
            "streams": {r: list(srv.token_events(r).events(timeout=5))
                        for r in rids}}


def _lifecycle(srv, inp):
    """Rank 0's decisions: a request shed from the queue (deadline 0), one
    whose deadline passes in its slot, a cancel of a queued and of a
    running request; then drain."""
    reqs = inp["requests"]
    shed_q = srv.submit(reqs[0][0], max_new_tokens=8, deadline_s=0.0)
    late = srv.submit(reqs[1][0], max_new_tokens=12, deadline_s=0.5)
    rest = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in reqs[2:]]
    running = []
    while not running:
        srv.step()
        running = [r for r in rest if srv.status(r) == "RUNNING"]
    srv.cancel(rest[-1])                 # still queued (3 slots)
    srv.cancel(running[0])
    time.sleep(0.6)                      # `late` expires in its slot
    return shed_q, late


def _dispatch_failure(eng, rank, submit_all):
    """A fault injected into rank 1's second decode dispatch: each rank's
    error (the wall-clock instant it came), whether its server closed, and
    every request's status there.  The ranks' collectives are out of step
    after it, so this runs last and the process ends without a barrier."""
    from deepspeed_tpu_torch.runtime.fault import inject
    srv = eng.serve()
    if rank == 1:
        inject.configure_injection({"point": "serving.pre_decode_dispatch",
                                    "at": 2})
    out = {"error": None}
    try:
        _served(srv, submit_all)
    except RuntimeError as e:
        out.update(error=str(e), at=time.time())
    finally:
        inject.reset_injection()
    out["closed"] = srv._closed
    out["status"] = sorted({srv.status(r) for r in srv._requests})
    srv.close()
    return out


def serve_suite(rank, inp):
    """tp 2 serving on lanes, on a pool, sampled; a lifecycle with rank
    1's clock skewed; ``serve_http`` on rank 0 against direct submits; the
    circuit breaker refused; a dispatch failure on rank 1 alone."""
    from types import SimpleNamespace
    from deepspeed_tpu_torch.inference.serving import engine as seng
    from deepspeed_tpu_torch.inference.serving import serve_http
    eng = _serve_engine(inp)
    reqs = inp["requests"]

    def submit_all(srv):
        return [srv.submit(p, max_new_tokens=n, eos_token_id=e)
                for p, n, e in reqs]

    rec = {}
    for route, kw in inp["routes"].items():
        srv = eng.serve(**kw)
        if not srv.tp_follower and route == "paged":
            srv.warmup()                 # the followers capture alike
        rec[route] = _served(srv, submit_all)
    # a clock a day ahead on rank 1: a follower takes no time decision
    real = time.monotonic
    if rank == 1:
        seng.time = SimpleNamespace(monotonic=lambda: real() + 86400.0,
                                    perf_counter=time.perf_counter,
                                    sleep=time.sleep, time=time.time)
    try:
        srv = eng.serve(paged=True, page_size=16)
        rec["lifecycle"] = _served(srv, lambda s: _lifecycle(s, inp))
    finally:
        seng.time = time
    # the HTTP front end listens on rank 0 only
    srv = eng.serve()
    if srv.tp_follower:
        rec["http"] = {"follower_result": type(serve_http(srv)).__name__}
    else:
        import http.client
        import json
        fe = serve_http(srv, port=0)
        outs = []
        for p, n, e in reqs:
            conn = http.client.HTTPConnection("127.0.0.1", fe.port,
                                              timeout=120)
            conn.request("POST", "/v1/generate", json.dumps(
                {"input_ids": [int(t) for t in p], "max_new_tokens": n,
                 "eos_token_id": e}))
            outs.append(json.loads(conn.getresponse().read())["output"])
            conn.close()
        fe.shutdown(close_engine=True)
        rec["http"] = {"outputs": outs}
    try:
        eng.serve(breaker_threshold=2)
        rec["breaker"] = None
    except NotImplementedError as e:
        rec["breaker"] = str(e)
    rec["failure"] = _dispatch_failure(eng, rank, submit_all)
    return rec


def serve_cuda_suite(rank, inp):
    """On the cards: one card's fp32 ``serve()`` of the requests on rank 0
    before the group exists, then ``serve()`` at tp 2 over NCCL (captured
    decode block) on a pool and on lanes: rank 0's outputs."""
    import torch.distributed as dist
    reqs = inp["requests"]

    def serve_all(eng, **kw):
        srv = eng.serve(**kw)
        if srv.tp_follower:
            srv.follow()
            return None
        srv.warmup()
        rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
                for p, n, e in reqs]
        outs = srv.drain()
        srv.close()
        return [outs[r] for r in rids]

    ref = None
    if rank == 0:
        one = ds.init_inference(
            pt.Transformer(pt.TransformerConfig(**inp["cfg"])),
            config={"dtype": "float32", "prefill_chunk_size": 8,
                    "serving": dict(inp["serving"])}, device="cuda")
        one.set_params(inp["sd"])
        ref = {route: serve_all(one, **kw)
               for route, kw in inp["routes"].items()}
        del one
    os.environ.setdefault("LOCAL_RANK", str(rank))
    ds.init_distributed(device=DEV, timeout=240)
    box = [ref]
    dist.broadcast_object_list(box, src=0)
    eng = _serve_engine(inp)
    return {"ref": box[0], "tp2": {route: serve_all(eng, **kw)
                                   for route, kw in inp["routes"].items()}}


def tp_cuda_suite(rank, inp):
    """On the cards: the one-card references on rank 0 before the group
    exists, then tp 2 (bf16 training, fp32 greedy generate with the decode
    graphs and eagerly)."""
    import torch.distributed as dist
    variant = "cuda"
    ref = None
    if rank == 0:
        eng = ds.initialize(model=pt.Transformer(pt.TransformerConfig(
            **dict(inp["cfgs"][variant], dtype="bfloat16"))),
            model_parameters=inp["weights"][variant],
            config=_config(inp, 0, "bfloat16", 1, inp["global_micro"],
                           2, inp["clip"]), device="cuda")[0]
        losses = [float(eng.train_batch(batch=b)) for b in inp["batches"]]
        gen = ds.init_inference(pt.Transformer(pt.TransformerConfig(
            **inp["cfgs"][variant])), config={"dtype": "float32"},
            device="cuda")
        gen.set_params(inp["weights"][variant])
        ref = {"losses": losses, "tokens": gen.generate(
            inp["gen_ids"], max_new_tokens=8).cpu()}
        del eng, gen
    os.environ.setdefault("LOCAL_RANK", str(rank))
    ds.init_distributed(device=DEV, timeout=240)
    box = [ref]
    dist.broadcast_object_list(box, src=0)
    ref = box[0]
    eng = _engine(inp, variant, 0, "bfloat16", 2)
    losses = [float(eng.train_batch(batch=b)) for b in inp["batches"]]
    del eng
    out = {"losses": losses, "ref": ref, "tokens": {}}
    for graphs in (True, False):
        gen = ds.init_inference(
            pt.Transformer(pt.TransformerConfig(**inp["cfgs"][variant])),
            config={"dtype": "float32", "tensor_parallel": {"tp_size": 2},
                    "enable_cuda_graph": graphs})
        gen.set_params(inp["weights"][variant])
        try:
            out["tokens"][graphs] = gen.generate(inp["gen_ids"],
                                                 max_new_tokens=8).cpu()
        except RuntimeError as e:
            out["tokens"][graphs] = str(e)
        del gen
    return out


def main():
    suite, out_dir = sys.argv[1], sys.argv[2]
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    inp = torch.load(sys.argv[3], weights_only=False)
    if suite in ("tp_cuda", "serve_cuda"):
        rec = (tp_cuda_suite if suite == "tp_cuda" else serve_cuda_suite)(
            rank, inp)
        _save(out_dir, suite, rank, rec)
        comm.barrier()
        comm.destroy_process_group()
        return
    ds.init_distributed(device="cpu", timeout=240)
    if suite == "tp":
        rec = tp_suite(rank, inp)
    elif suite == "tp4":
        rec = tp4_suite(rank, inp)
    elif suite == "serve":
        # its last phase leaves the group out of step: no barrier after it
        _save(out_dir, suite, rank, serve_suite(rank, inp))
        sys.stdout.flush()
        os._exit(0)
    elif suite == "uni4":
        rec = uni4_suite(rank, inp)
    elif suite == "uni2":
        rec = uni2_suite(rank, inp)
    else:
        raise SystemExit(f"unknown suite {suite!r}")
    _save(out_dir, suite, rank, rec)
    comm.barrier()
    comm.destroy_process_group()


if __name__ == "__main__":
    main()
