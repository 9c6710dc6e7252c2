"""``deepspeed_tpu_torch`` continuous-batching serving (``engine.serve()`` →
``submit`` / ``drain``) on the CPU, against solo ``generate()`` runs and
the JAX package, with one tiny fp32 OPT-style parameter tree converted by
``params_from_flax``.

The contract is the JAX package's (``tests/unit/test_serving_paged.py``):
7 mixed requests on 3 slots, with eos probed mid-stream, give every
request the greedy tokens of its solo ``generate()`` (same
``prefill_chunk_size`` as the serving chunk) on monolithic lanes and on a
paged pool at page sizes 16, 64 and 128 — and those equal JAX
``generate()``'s and a JAX paged ``ServingEngine``'s.  Pool exhaustion
stalls admission without changing a token, prefix sharing prefills a
shared prefix once, and ``paged_kernel=False`` (the JAX package's switch
to a gather path) raises: a page pool always runs the paged kernels.  On
the CPU the kernels' plain versions run.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference.serving import ServingConfig
from deepspeed_tpu_torch.inference.serving.slo import RequestStatus
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
N_REQ = 7


def random_tree(jmodel, seed=0):
    """Numpy-drawn parameter tree (as in test_torch_generate_parity.py):
    matrices with std 0.5 give the tiny model varied greedy streams."""
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0),
                                                {"input_ids": ids}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return 0.5 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_engine(sd, cfg=CFG, serving=SERVING, chunk=8):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)),
        config={"dtype": "float32", "prefill_chunk_size": chunk,
                "serving": dict(serving)}, device="cpu")
    eng.set_params(sd)
    return eng


def solo(eng, prompt, new, eos=-1):
    return eng.generate(torch.from_numpy(prompt[None]).long(),
                        max_new_tokens=new, eos_token_id=eos).numpy()[0]


@pytest.fixture(scope="module")
def setup():
    """Weights, the 7-request workload with eos probed mid-stream on every
    other request, and each request's solo greedy output."""
    jmodel = jt.Transformer(jt.TransformerConfig(**CFG))
    tree = random_tree(jmodel)
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    eng = port_engine(sd)
    rng = np.random.default_rng(3)
    lens = rng.integers(9, 21, (N_REQ,))
    news = [int(x) for x in rng.integers(3, 13, (N_REQ,))]
    prompts = [rng.integers(1, 97, (int(p),)).astype(np.int32) for p in lens]
    eos = []
    for i, (p, n) in enumerate(zip(prompts, news)):
        eos.append(int(solo(eng, p, n)[len(p) + n // 2]) if i % 2 == 0
                   else -1)
    want = [solo(eng, p, n, e) for p, n, e in zip(prompts, news, eos)]
    return dict(jmodel=jmodel, tree=tree, sd=sd, eng=eng, prompts=prompts,
                news=news, eos=eos, want=want)


def serve_all(srv, s, **kw):
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e, **kw)
            for p, n, e in zip(s["prompts"], s["news"], s["eos"])]
    outs = srv.drain()
    assert sorted(outs) == sorted(rids)
    return [outs[r] for r in rids]


def test_solo_generate_matches_jax(setup):
    """The references: the port's solo greedy tokens (split prefill in
    chunks of 8, eos early exit) equal JAX ``generate()``'s."""
    s = setup
    jeng = deepspeed_tpu.init_inference(
        s["jmodel"], config={"dtype": "float32", "prefill_chunk_size": 8})
    jeng.set_params(s["tree"])
    for p, n, e, w in zip(s["prompts"], s["news"], s["eos"], s["want"]):
        got = np.asarray(jeng.generate(jnp.asarray(p[None]),
                                       max_new_tokens=n, eos_token_id=e))[0]
        np.testing.assert_array_equal(w, got)
    # eos really stopped the probed requests early
    for i in range(0, N_REQ, 2):
        n = s["news"][i]
        assert (s["want"][i][-(n - n // 2):] == s["eos"][i]).all()


def _dip_and_recover(trace):
    occ = [n for _, n in trace]
    for i in range(1, len(occ)):
        if occ[i] < occ[i - 1] and max(occ[i + 1:], default=-1) > occ[i]:
            return True
    return False


@pytest.mark.parametrize("route", ["mono", "paged16", "paged64", "paged128"])
def test_serving_matches_solo_generate(setup, route):
    """7 requests on 3 slots: slot churn, mid-stream eos retirements —
    every output equals its solo generate(); the occupancy trace dips when
    a request retires and recovers when the freed slot is refilled; after
    the drain every slot's pages are back and the table is all trash."""
    s = setup
    paged = route != "mono"
    kw = dict(paged=True, page_size=int(route[5:])) if paged else {}
    srv = s["eng"].serve(**kw)
    got = serve_all(srv, s)
    for g, w in zip(got, s["want"]):
        np.testing.assert_array_equal(g, w)
    assert _dip_and_recover(srv.occupancy_trace), srv.occupancy_trace
    assert srv.stats["completed"] == srv.stats["admitted"] == N_REQ
    assert srv.queue_depth == srv.active_slots == srv.in_flight == 0
    if paged:
        assert srv.kernel_modes == {"decode": "cuda_paged_decode",
                                    "prefill_chunk": "cuda_chunked_prefill"}
        assert not srv._slot_pages
        assert (srv._page_table == 0).all()
        assert srv.stats["paged_attention_fallback"] == 0
    else:
        assert srv.kernel_modes == {"decode": "cuda_decode",
                                    "prefill_chunk": "cuda_chunked_prefill"}


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_routes_reach_each_kernel_once_per_layer(setup, paged, monkeypatch):
    """Where a CUDA tensor would launch each kernel (the plain versions on
    the CPU): paged serving runs K6 once per layer and decode step and K7
    once per layer and prefill chunk, monolithic serving K2 and K3 — the
    launch counts chip_smoke.py reads on the card."""
    counted = {}
    for mod, name in ((da, "decode_attention_plain"),
                      (da, "chunk_prefill_attention_plain"),
                      (pa, "paged_decode_attention_plain"),
                      (pa, "paged_chunk_prefill_attention_plain")):
        counted[name] = _Counted(getattr(mod, name))
        monkeypatch.setattr(mod, name, counted[name])
    s = setup
    srv = s["eng"].serve(paged=paged)
    serve_all(srv, s)
    L, st = CFG["num_layers"], srv.stats
    decode_steps = L * srv.block * st["decode_calls"]
    chunks = L * st["prefill_tokens"] // srv.chunk
    calls = {k: c.calls for k, c in counted.items()}
    if paged:
        assert calls == {"decode_attention_plain": 0,
                         "chunk_prefill_attention_plain": 0,
                         "paged_decode_attention_plain": decode_steps,
                         "paged_chunk_prefill_attention_plain": chunks}
    else:
        assert calls == {"decode_attention_plain": decode_steps,
                         "chunk_prefill_attention_plain": chunks,
                         "paged_decode_attention_plain": 0,
                         "paged_chunk_prefill_attention_plain": 0}


def test_pool_exhaustion_stalls_admission(setup):
    """3 allocatable pages against (mostly) 2-page requests: admissions
    stall at the queue head while three slots sit free, everything still
    completes with the same tokens, and the pool drains back to empty; a
    request the pool can never hold is refused at submit()."""
    s = setup
    srv = s["eng"].serve(paged=True, num_pages=4, prefix_cache=False)
    got = serve_all(srv, s)
    for g, w in zip(got, s["want"]):
        np.testing.assert_array_equal(g, w)
    assert srv.stats["admission_stalls"] > 0
    assert srv._pool.in_use == 0 and srv.page_pool_utilization == 0.0
    with pytest.raises(ValueError, match="pages"):
        srv.submit(np.arange(1, 41, dtype=np.int32), max_new_tokens=20)


def test_prefix_sharing_prefills_a_shared_prefix_once(setup):
    """4 requests behind one 2-page prefix: the first registers it, the
    other 3 map the same pages (prefix_hits == N - 1) and skip its
    prefill, with every output equal to its solo generate()."""
    s = setup
    rng = np.random.default_rng(11)
    pre = rng.integers(1, 97, (32,)).astype(np.int32)
    reqs = [np.concatenate([pre, rng.integers(1, 97, (5,)).astype(np.int32)])
            for _ in range(4)]
    srv = s["eng"].serve(paged=True)
    rids = [srv.submit(q, max_new_tokens=6) for q in reqs]
    outs = srv.drain()
    for rid, q in zip(rids, reqs):
        np.testing.assert_array_equal(outs[rid], solo(s["eng"], q, 6))
    st = srv.stats
    assert (st["prefix_lookups"], st["prefix_hits"]) == (4, 3)
    assert st["prefix_tokens_reused"] == 3 * 32
    assert srv.prefix_hit_rate == 0.75
    # 4 prompts of 37 tokens cost 4 * 40 chunk tokens unshared; each hit
    # skips the two shared pages
    assert st["prefill_tokens"] == 4 * 40 - 3 * 32


def test_prefix_chunk_unaligned_boundary(setup):
    """A prefix match whose page boundary is not chunk-aligned rounds down
    to a chunk-aligned start (page 16, chunk 64, P = 120: 7 matched pages
    -> 4), so the padded last chunk stays inside the lane; outputs equal
    the solo generate() with the same chunk."""
    cfg = dict(CFG, max_seq_len=128)
    jmodel = jt.Transformer(jt.TransformerConfig(**cfg))
    sd = pt.params_from_flax(random_tree(jmodel, seed=1),
                             pt.TransformerConfig(**cfg))
    eng = port_engine(sd, cfg=cfg, chunk=64, serving={
        "num_slots": 2, "max_cache_len": 128, "prefill_chunk": 64,
        "prefill_token_budget": 128, "decode_block": 2, "paged": True,
        "page_size": 16})
    p = np.random.default_rng(31).integers(1, 97, (120,)).astype(np.int32)
    want = solo(eng, p, 8)
    srv = eng.serve()
    r1 = srv.submit(p, max_new_tokens=8)     # registers the prefix
    outs = srv.drain()
    r2 = srv.submit(p, max_new_tokens=8)     # matches 7 pages -> 4
    outs.update(srv.drain())
    np.testing.assert_array_equal(outs[r1], want)
    np.testing.assert_array_equal(outs[r2], want)
    assert srv.stats["prefix_hits"] == 1
    assert srv.stats["prefix_tokens_reused"] == 64


@pytest.mark.parametrize("paged", [False, True], ids=["mono", "paged"])
def test_paged_kernel_off_raises(setup, paged):
    """serving.paged_kernel=False, the JAX package's A/B switch to a gather
    path, is refused: the port has no path that skips K6 / K7 on a pool."""
    with pytest.raises(NotImplementedError, match="paged_kernel=False"):
        setup["eng"].serve(paged=paged, paged_kernel=False)
    with pytest.raises(NotImplementedError, match="paged_kernel=False"):
        ServingConfig(paged=True, paged_kernel=False)


def test_jax_paged_serving_matches_port(setup):
    """One JAX ServingEngine(paged=True) run and the port's on the same
    requests, config and weights give equal tokens."""
    s = setup
    jeng = deepspeed_tpu.init_inference(
        s["jmodel"], config={"dtype": "float32", "prefill_chunk_size": 8,
                             "serving": dict(SERVING, paged=True)})
    jeng.set_params(s["tree"])
    jsrv = jeng.serve()
    rids = [jsrv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(s["prompts"], s["news"], s["eos"])]
    jouts = jsrv.drain()
    got = serve_all(s["eng"].serve(paged=True), s)
    for rid, g in zip(rids, got):
        np.testing.assert_array_equal(g, jouts[rid])


def test_shortest_first_admission_keeps_tokens(setup):
    s = setup
    srv = s["eng"].serve(paged=True, admission="shortest_first")
    for g, w in zip(serve_all(srv, s), s["want"]):
        np.testing.assert_array_equal(g, w)


def test_config_validation_and_lifecycle(setup):
    """The serving block parses into ServingConfig; the front-end knobs
    build servers and bad values raise; a request that never fits is refused; close() aborts
    what is undrained and retires the server; prefill_plan names the
    paged kernels."""
    s = setup
    eng = s["eng"]
    assert isinstance(eng._config.serving, ServingConfig)
    assert eng._config.serving.num_slots == 3
    for knob in (dict(flight_recorder=True), dict(tracing=True),
                 dict(fairness_tokens_per_s=4.0), dict(priority_lanes=2)):
        eng.serve(**knob).close()        # the front-end knobs are ported
    with pytest.raises(ValueError, match="priority_lanes"):
        eng.serve(priority_lanes=0)
    with pytest.raises(ValueError, match="fairness_window_s"):
        eng.serve(fairness_tokens_per_s=4.0, fairness_window_s=0.0)
    with pytest.raises(ValueError, match="queue_policy"):
        eng.serve(queue_policy="drop")
    with pytest.raises(ValueError, match="admission"):
        eng.serve(admission="lifo")
    with pytest.raises(ValueError, match="num_pages"):
        eng.serve(paged=True, num_pages=1)
    srv = eng.serve()
    assert srv.device.type == "cpu"
    with pytest.raises(ValueError, match="cache positions"):
        srv.submit(np.arange(1, 60, dtype=np.int32), max_new_tokens=10)
    with pytest.raises(ValueError, match="empty"):
        srv.submit([], max_new_tokens=4)
    for bad in ([1, 97], [-1, 3]):
        with pytest.raises(ValueError, match="vocab|token ids"):
            srv.submit(bad, max_new_tokens=4)
    rids = [srv.submit(p, max_new_tokens=n)
            for p, n in zip(s["prompts"][:4], s["news"][:4])]
    srv.step()
    srv.step()
    aborted = srv.close()
    assert aborted == sorted(aborted) and set(aborted) <= set(rids)
    assert aborted
    for rid in aborted:
        assert srv.result(rid).status == RequestStatus.ABORTED
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(s["prompts"][0], max_new_tokens=2)
    with pytest.raises(KeyError):
        srv.result(999)
    reason = eng.prefill_plan(1, 40, paged=True)[2]
    assert reason.endswith("[kernels: prefill=cuda_chunked_prefill "
                           "decode=cuda_paged_decode]")
