"""Speculative serving of ``deepspeed_tpu_torch`` (``engine.serve(
speculative=True, ...)``) and the serving engine's per-token streams,
``status`` and ``cancel``, against the JAX package on the same
numpy-drawn parameter trees converted by ``params_from_flax`` (fp32, the
CPU; the kernels' plain versions run).

The contract is the JAX package's (``tests/unit/test_serving_spec.py``):
7 mixed requests on 3 slots with eos probed mid-stream give, bitwise, the
JAX package's speculative outputs, JAX solo ``generate()``'s and the
port's non-speculative ``serve()``'s, at ``spec_k`` 1 and 3 with a
self-draft (``test_torch_spec_serving_variants.py`` holds the distinct
draft pair and the page pool, ``test_torch_spec_families.py`` the llama
and GPT-Neo targets, on these helpers); the port's ``spec_commit`` equals JAX's ``_spec_commit``, the
``spec_*`` stats equal JAX's on the same run, the validation errors and
the window-reserve rejection carry JAX's messages, every captured
program donates the server's buffers, streams are ordered, lossless and
end once, and ``cancel`` gives back the slot, its pages and its lanes.

The card tests (``cuda`` marker, skipped without a card; no JAX import)
hold K3 and K7 at the verify shape (C = 2, 5, 9; B = 16, 96; dead rows,
starts at the lane's end, trash table rows) against their plain
versions, speculative serving on graphs bitwise eager (lanes, pool) with
equal launch counts, a second server's capture leaving the first's
tokens unchanged, and dead lanes' windows at the lane's end faulting
nothing:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_spec_serving.py
"""

import functools
import gc
import weakref

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.serving import slots
from deepspeed_tpu_torch.inference.serving.slo import RequestStatus
from deepspeed_tpu_torch.models import opt as popt
from deepspeed_tpu_torch.models import transformer as pt

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
# the distinct draft: smaller, the same vocabulary
DRAFT = dict(CFG, hidden_size=32, num_layers=1)
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
N_REQ = 7
SELF = dict(speculative=True, spec_draft_model="self")


def _jax():
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models import opt as jopt
    from deepspeed_tpu.models import transformer as jt
    return jax, jnp, deepspeed_tpu, jopt, jt


def random_tree(jcfg, seed=0, std=0.5):
    """Numpy-drawn tree of the JAX model ``jcfg`` (norm scales near 1,
    biases std 0.1, matrices ``std``): varied greedy streams."""
    jax, jnp, _, _, jt = _jax()
    shapes = jax.eval_shape(lambda: jt.Transformer(jcfg).init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return std * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def engines(jcfg, cfg, tree, prefill_chunk=8):
    """The JAX and the port engine over one tree, with SERVING."""
    _, _, deepspeed_tpu, _, jt = _jax()
    config = {"dtype": "float32", "prefill_chunk_size": prefill_chunk,
              "serving": dict(SERVING)}
    jeng = deepspeed_tpu.init_inference(jt.Transformer(jcfg),
                                        config=dict(config))
    jeng.set_params(tree)
    eng = deepspeed_tpu_torch.init_inference(pt.Transformer(cfg),
                                             config=dict(config),
                                             device="cpu")
    eng.set_params(pt.params_from_flax(tree, cfg))
    return jeng, eng


def solo(eng, prompt, new, eos=-1):
    return eng.generate(torch.from_numpy(prompt[None]).long(),
                        max_new_tokens=new, eos_token_id=eos).numpy()[0]


def workload(eng, seed, n, vocab, every=2):
    """``n`` mixed requests (prompts 9 to 20, 3 to 12 new tokens), an eos
    probed from the greedy continuation on every ``every``-th one (it
    fires mid-stream), and each request's solo output."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(9, 21, (n,))
    news = [int(x) for x in rng.integers(3, 13, (n,))]
    prompts = [rng.integers(1, vocab, (int(p),)).astype(np.int32)
               for p in lens]
    eos = [int(solo(eng, p, m)[len(p) + m // 2]) if i % every == 0 else -1
           for i, (p, m) in enumerate(zip(prompts, news))]
    want = [solo(eng, p, m, e) for p, m, e in zip(prompts, news, eos)]
    return dict(prompts=prompts, news=news, eos=eos, want=want)


def serve_all(srv, w):
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(w["prompts"], w["news"], w["eos"])]
    outs = srv.drain()
    assert sorted(outs) == sorted(rids)
    return [np.asarray(outs[r]) for r in rids]


SPEC_STATS = ("spec_rounds", "spec_windows", "spec_committed_tokens",
              "spec_accept_rate", "spec_tokens_per_dispatch",
              "decode_calls", "decode_tokens", "prefill_tokens")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops: one intra-op thread
    keeps a parallel test run's workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _opt():
    """The OPT-style target and the draft pair, converted from JAX."""
    jt = _jax()[4]
    jcfg, cfg = jt.TransformerConfig(**CFG), pt.TransformerConfig(**CFG)
    tree = random_tree(jcfg)
    jeng, eng = engines(jcfg, cfg, tree)
    dj, dc = jt.TransformerConfig(**DRAFT), pt.TransformerConfig(**DRAFT)
    dtree = random_tree(dj, seed=1)
    w = workload(eng, 3, N_REQ, CFG["vocab_size"])
    return dict(jeng=jeng, eng=eng, w=w, djcfg=dj, dtree=dtree,
                dsd=pt.params_from_flax(dtree, dc), dcfg=dc)


@pytest.fixture(scope="module")
def opt():
    return _opt()


@functools.lru_cache(maxsize=None)
def jax_served(key):
    """One JAX server's outputs and stats on the OPT workload (each JAX
    server compiles its programs: shared across the tests)."""
    s = _opt()
    kw = dict(key)
    if kw.pop("draft_pair", False):
        jt = _jax()[4]
        kw.update(draft_module=jt.Transformer(s["djcfg"]),
                  draft_params=s["dtree"])
    srv = s["jeng"].serve(**kw)
    outs = serve_all(srv, s["w"])
    return outs, {k: srv.stats[k] for k in SPEC_STATS if k in srv.stats}


@functools.lru_cache(maxsize=None)
def jax_solo():
    jnp = _jax()[1]
    s = _opt()
    w = s["w"]
    return [np.asarray(s["jeng"].generate(jnp.asarray(p[None]),
                                          max_new_tokens=n,
                                          eos_token_id=e))[0]
            for p, n, e in zip(w["prompts"], w["news"], w["eos"])]


def _churned(trace):
    occ = [n for _, n in trace]
    return any(occ[i] < occ[i - 1] for i in range(1, len(occ)))


# --------------------------------------------------------------------- #
# The bitwise-greedy contract against the JAX package
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("k", [1, 3])
def test_spec_matches_jax_solo_and_nonspec(opt, k):
    """Self-draft speculation on slot lanes: every output equals the JAX
    package's speculative server, JAX solo ``generate()`` and the port's
    non-speculative server, through slot churn and mid-stream eos; the
    spec stats equal JAX's on the same run."""
    srv = opt["eng"].serve(spec_k=k, **SELF)
    got = serve_all(srv, opt["w"])
    jouts, jstats = jax_served((("speculative", True), ("spec_k", k),
                                ("spec_draft_model", "self")))
    plain = serve_all(opt["eng"].serve(), opt["w"])
    for g, j, s, p, w in zip(got, jouts, jax_solo(), plain, opt["w"]["want"]):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)
    assert _churned(srv.occupancy_trace), srv.occupancy_trace
    assert {k_: srv.stats[k_] for k_ in jstats} == jstats
    st = srv.stats
    assert st["completed"] == N_REQ
    assert st["spec_committed_tokens"] > st["spec_windows"]
    assert 0.0 <= st["spec_accept_rate"] <= 1.0
    assert st["spec_draft_secs"] > 0.0 and st["spec_verify_secs"] > 0.0
    assert 0.0 < st["spec_draft_fraction"] < 1.0
    # one propose and one verify program for the server's lifetime
    assert srv._decode_prog is None
    assert srv._propose_prog.iter_count == srv._verify_prog.iter_count \
        == st["spec_rounds"] == st["decode_calls"]


def test_spec_preset_draft_random_weights(opt, monkeypatch):
    """``spec_draft_model`` naming an OPT preset builds it at the target's
    vocabulary with seeded random weights, loudly; outputs stay the
    target's.  The preset is cut to 2 of its layers here (its widths
    stay): the depth is an override of ``opt_model``, which the engine
    calls."""
    from deepspeed_tpu_torch.inference.serving import engine as se
    warned, built = [], []
    monkeypatch.setattr(se.logger, "warning", warned.append)
    preset = popt.opt_model

    def two_layers(name, **kw):
        built.append(name)
        return preset(name, num_layers=2, **kw)

    monkeypatch.setattr(popt, "opt_model", two_layers)
    srv = opt["eng"].serve(spec_k=2, speculative=True,
                           spec_draft_model="opt-125m")
    assert built == ["opt-125m"]
    assert any("RANDOM draft weights" in m for m in warned)
    cfg = srv.draft_module.config
    assert (cfg.hidden_size, cfg.num_heads, cfg.num_layers,
            cfg.vocab_size) == (768, 12, 2, CFG["vocab_size"])
    w = {k: v[:3] for k, v in opt["w"].items()}
    for g, want in zip(serve_all(srv, w), w["want"]):
        np.testing.assert_array_equal(g, want)


def _counted(monkeypatch):
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    counts = {}
    for mod, name in ((da, "decode_attention_plain"),
                      (da, "chunk_prefill_attention_plain"),
                      (pa, "paged_decode_attention_plain"),
                      (pa, "paged_chunk_prefill_attention_plain")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return counts


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "pool"])
def test_spec_routes_reach_each_kernel(opt, paged, monkeypatch):
    """Where a CUDA tensor would launch each kernel: the draft's k + 1
    steps a round run K2 (the last only writes), the verify runs K3 over
    lanes or K7 over a pool once per layer a round, the draft's prefill
    chunks K3 — the counts chip_smoke.py's run (m) asserts on the card."""
    counts = _counted(monkeypatch)
    k = 3
    srv = opt["eng"].serve(paged=paged, spec_k=k, **SELF)
    serve_all(srv, opt["w"])
    L, st = CFG["num_layers"], srv.stats
    rounds, chunks = st["spec_rounds"], st["prefill_tokens"] // srv.chunk
    verify = "paged_chunk_prefill_attention_plain" if paged \
        else "chunk_prefill_attention_plain"
    want = {"decode_attention_plain": L * (k + 1) * rounds,
            "chunk_prefill_attention_plain": L * chunks}
    want[verify] = want.get(verify, 0) + L * rounds
    if paged:
        want["paged_chunk_prefill_attention_plain"] += L * chunks
    else:
        want["chunk_prefill_attention_plain"] += L * chunks
    assert counts == want


# --------------------------------------------------------------------- #
# The commit rule, validation, the window reserve
# --------------------------------------------------------------------- #
def test_spec_commit_matches_jax():
    """``slots.spec_commit`` against JAX ``_spec_commit`` on seeded random
    windows with forced edge cases: a full match, no match, eos at the
    window's start and mid-window, budget 1 and 0, dead lanes, free lanes
    (eos -1) and positions at the lane's end."""
    jax, jnp = _jax()[:2]
    from deepspeed_tpu.inference.serving.slots import _spec_commit
    rng = np.random.default_rng(11)
    N, k, cache_len = 24, 4, 64
    for trial in range(6):
        t = rng.integers(0, 6, (N, k + 1)).astype(np.int32)
        draft = np.where(rng.random((N, k)) < 0.7, t[:, :k],
                         rng.integers(0, 6, (N, k))).astype(np.int32)
        state = {"token": rng.integers(0, 6, N).astype(np.int32),
                 "pos": rng.integers(0, cache_len, N).astype(np.int32),
                 "active": rng.random(N) < 0.8,
                 "remaining": rng.integers(0, 8, N).astype(np.int32),
                 "eos": rng.integers(-1, 6, N).astype(np.int32)}
        draft[0] = t[0, :k]                                 # full match
        draft[1, 0] = (t[1, 0] + 1) % 6                     # no match
        t[2, 0], state["eos"][2] = 3, 3                     # eos first
        draft[3], t[3, 2], state["eos"][3] = t[3, :k], 5, 5  # eos inside
        draft[3, 2] = 5
        state["remaining"][4] = 1                           # budget 1
        state["remaining"][5] = 0
        state["active"][6] = False                          # dead lane
        state["active"][7], state["eos"][7] = False, -1     # free lane
        state["pos"][8] = cache_len - 1                     # lane's end
        state["active"][:4] = True
        state["remaining"][:4] = 8
        jt_, ja, js = _spec_commit(
            jnp.asarray(t), jnp.asarray(draft),
            {kk: jnp.asarray(v) for kk, v in state.items()}, k, cache_len)
        pt_, pa_, ps = slots.spec_commit(
            torch.from_numpy(t).long(), torch.from_numpy(draft).long(),
            {kk: torch.from_numpy(v).long() if v.dtype != bool
             else torch.from_numpy(v) for kk, v in state.items()},
            k, cache_len)
        np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt_), trial)
        np.testing.assert_array_equal(pa_.numpy(), np.asarray(ja), trial)
        for kk in js:
            np.testing.assert_array_equal(ps[kk].numpy(), np.asarray(js[kk]),
                                          f"{trial} {kk}")
    assert pa_[6] == pa_[7] == 0 and pa_[0] >= 1


def test_spec_validation_messages_match_jax(opt):
    """Each refusal raises ``ValueError`` with the JAX engine's message."""
    jt = _jax()[4]
    jeng, eng = opt["jeng"], opt["eng"]
    bad_j = jt.TransformerConfig(**dict(DRAFT, vocab_size=96))
    bad_tree = random_tree(bad_j, seed=2)
    bad_sd = pt.params_from_flax(bad_tree, pt.TransformerConfig(
        **dict(DRAFT, vocab_size=96)))
    cases = [
        (dict(do_sample=True, **SELF), {}, {}, "greedy"),
        (dict(speculative=True), {}, {}, "draft model"),
        (dict(speculative=True), dict(draft_module=jt.Transformer(
            opt["djcfg"])), dict(draft_module=pt.Transformer(opt["dcfg"])),
         "draft_params"),
        (dict(spec_k=0, **SELF), {}, {}, "spec_k"),
        (dict(spec_k=65, **SELF), {}, {}, "spec_k"),
        (SELF, dict(draft_params=opt["dtree"]),
         dict(draft_params=opt["dsd"]), "TARGET"),
        (dict(speculative=True),
         dict(draft_module=jt.Transformer(bad_j), draft_params=bad_tree),
         dict(draft_module=pt.Transformer(pt.TransformerConfig(
             **dict(DRAFT, vocab_size=96))), draft_params=bad_sd), "vocab"),
    ]
    for over, jkw, pkw, match in cases:
        with pytest.raises(ValueError, match=match) as jerr:
            jeng.serve(**jkw, **over)
        with pytest.raises(ValueError, match=match) as perr:
            eng.serve(**pkw, **over)
        assert str(perr.value) == str(jerr.value), match


def test_spec_window_reserve(opt):
    """A lane reserves ``spec_k - 1`` tail positions for the verify
    window: a request that exactly fills a lane without speculation is
    refused under it, with JAX's message; one that fits is served
    bitwise."""
    jeng, eng = opt["jeng"], opt["eng"]
    p = np.ones((40,), np.int32)
    eng.serve().submit(p, max_new_tokens=24)         # 40 + 24 = 64 fits
    srv = eng.serve(spec_k=4, **SELF)
    jsrv = jeng.serve(spec_k=4, **SELF)
    with pytest.raises(ValueError, match="speculative window reserve") as e:
        srv.submit(p, max_new_tokens=24)
    with pytest.raises(ValueError) as je:
        jsrv.submit(p, max_new_tokens=24)
    assert str(e.value) == str(je.value).replace("slot lanes hold",
                                                 "slots hold")
    rid = srv.submit(p, max_new_tokens=21)           # 40 + 21 + 3 = 64
    np.testing.assert_array_equal(srv.drain()[rid], solo(eng, p, 21))


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "pool"])
def test_spec_warmup_names_match_jax(opt, paged):
    """``warmup()`` on an idle speculative server captures propose and
    verify and reports the JAX engine's program names (its ``warmup()``
    f-strings, ``deepspeed_tpu/inference/serving/engine.py``); the server
    then serves the same tokens as a fresh one."""
    srv = opt["eng"].serve(paged=paged, spec_k=2, **SELF)
    got = srv.warmup()
    want = ["serving_spec_draft_prefill:c8", "serving_spec_propose:n3s64k2"]
    want += (["serving_prefill_paged:c8p16",
              "serving_spec_verify_paged:n3s64k2p16"] if paged else
             ["serving_prefill:c8", "serving_spec_verify:n3s64k2"])
    assert sorted(got) == sorted(want)
    assert all(v > 0.0 for v in got.values())
    assert not srv._state["active"].any()
    assert (srv._state["eos"] == -1).all()
    w = {k: v[:4] for k, v in opt["w"].items()}
    for g, ref in zip(serve_all(srv, w), w["want"]):
        np.testing.assert_array_equal(g, ref)
    assert srv._propose_prog.iter_count == srv.stats["spec_rounds"] + 1


@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "pool"])
def test_programs_donate_the_server_buffers(opt, paged):
    """Each captured program donates exactly the server's static buffers —
    the decode block and the verify the cache, the slot state and the
    block table, the propose the draft's lanes and the state — so a graph
    holds them by address (the table's pointer is in the verify's
    signature) and a replay copies none of them in."""
    plain = opt["eng"].serve(paged=paged)
    srv = opt["eng"].serve(paged=paged, spec_k=2, **SELF)
    plain._ensure_workspace()
    srv._ensure_workspace()
    draft = torch.zeros((srv.num_slots, 2), dtype=torch.long)
    verify_args = srv._verify_args(draft)
    for prog, args, want in (
            (plain._decode_prog, plain._decode_args(),
             (plain._cache, plain._state, plain._pages_dev)),
            (srv._propose_prog, srv._propose_args(),
             (srv._draft_cache, srv._state)),
            (srv._verify_prog, verify_args,
             (srv._cache, srv._state, srv._pages_dev))):
        donated = [args[i] for i in sorted(prog._donate)]
        assert len(donated) == len(want)
        assert all(a is b for a, b in zip(donated, want))
    table = srv._verify_prog._signature(verify_args)[8]
    if paged:
        assert table[0][-1] == srv._pages_dev.data_ptr()
    else:
        assert table == (("value", None),)


# --------------------------------------------------------------------- #
# Streams, status, cancel
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_streams_are_per_token_ordered_and_lossless(opt, spec):
    """One event per token with indices 0, 1, ..; the stream equals the
    output's generated part; an eos (mid-window under speculation) ends
    it at the eos; ``end`` comes once and last; a subscriber attached
    mid-flight and one attached after the end get a replay."""
    eng = opt["eng"]
    w = opt["w"]
    srv = eng.serve(spec_k=3, **SELF) if spec else eng.serve()
    rids = [srv.submit(p, max_new_tokens=max(n, 8), eos_token_id=e)
            for p, n, e in zip(w["prompts"], w["news"], w["eos"])]
    early = {r: srv.token_events(r) for r in rids}
    outs = {}
    for _ in range(4):
        outs.update(srv.step())
    late = {r: srv.token_events(r) for r in rids}
    seen = []
    ev_stream = srv.token_events(rids[-1], on_event=seen.append)
    outs.update(srv.drain())
    for rid, p, e in zip(rids, w["prompts"], w["eos"]):
        out = outs[rid]
        for stream in (early[rid], late[rid], srv.token_events(rid)):
            events = list(stream.events(timeout=1))
            toks = [ev for ev in events if ev["event"] == "token"]
            assert [ev["index"] for ev in toks] == list(range(len(toks)))
            assert [ev["token"] for ev in toks] == \
                [int(t) for t in out[len(p):len(p) + len(toks)]]
            assert [ev["event"] for ev in events].count("end") == 1
            assert events[-1] == {"event": "end", "rid": rid,
                                  "status": RequestStatus.COMPLETED,
                                  "detail": ""}
            if e >= 0:
                assert toks[-1]["token"] == e
                assert e not in [ev["token"] for ev in toks[:-1]]
            else:
                assert len(toks) == len(out) - len(p)
        assert srv.status(rid) == RequestStatus.COMPLETED
    assert seen == list(ev_stream.events(timeout=1))
    if spec:
        assert srv.stats["spec_tokens_per_dispatch"] > 1.0


@pytest.mark.parametrize("route", ["plain", "spec", "spec_paged"])
def test_cancel_frees_slot_pages_and_lanes(opt, route):
    """Cancel a queued request, one in its admission prefill and one in a
    slot: each ends ``CANCELLED`` (status, result, the stream's ``end``),
    gives back its slot, pages and lanes (the draft's too), and every
    other request's output is unchanged."""
    eng, w = opt["eng"], opt["w"]
    kw = {"plain": {}, "spec": dict(spec_k=2, **SELF),
          "spec_paged": dict(paged=True, spec_k=2, **SELF)}[route]
    srv = eng.serve(**kw)
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(w["prompts"], w["news"], w["eos"])]
    streams = {r: srv.token_events(r) for r in rids}
    assert srv.status(rids[6]) == RequestStatus.QUEUED
    assert srv.cancel(rids[6])
    srv.step()
    srv.step()
    srv.step()
    in_slot = next(r for r in rids if srv.status(r) == RequestStatus.RUNNING)
    assert srv.cancel(in_slot)
    while srv._pending is None:
        srv.step()
    pending = srv._pending.req.rid
    assert srv.status(pending) == RequestStatus.PREFILLING
    assert srv.cancel(pending)
    assert not srv.cancel(pending)            # already ended
    outs = srv.drain()
    cancelled = {rids[6], in_slot, pending}
    for rid, want in zip(rids, w["want"]):
        toks, end = streams[rid].tokens(timeout=1)
        if rid in cancelled:
            res = srv.result(rid)
            assert srv.status(rid) == res.status == end["status"] \
                == RequestStatus.CANCELLED
            assert res.output is None and end["detail"] == res.detail
            # reported without an output, as JAX's step() reports it
            assert outs.get(rid, None) is None
        else:
            np.testing.assert_array_equal(outs[rid], want)
    assert srv.stats["cancelled"] == 3
    assert srv.stats["completed"] == N_REQ - 3
    assert sorted(srv._free) == list(range(srv.num_slots))
    assert not srv._mirror_active.any() and srv._pending is None
    if srv.paged:
        assert not srv._slot_pages and srv.page_pool_utilization == 0.0
    if srv.speculative:
        # every draft lane taken came back: one per admission in flight
        # at once, at most
        assert 1 <= len(srv._draft_lanes._lanes) <= srv.num_slots + 1
    assert len(srv._lane_pool._lanes) <= srv.num_slots + 1
    with pytest.raises(KeyError, match="never issued"):
        srv.cancel(999)
    with pytest.raises(KeyError, match="never issued"):
        srv.status(999)


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "spec"])
def test_cancelled_lane_stops_writing_on_a_pool(opt, spec):
    """A request cancelled in its slot stops on the device at once: the
    slot's next occupant prefills into pages its table row now maps over
    several iterations, while another slot keeps decoding, and its tokens
    (and the other's) stay those of solo ``generate()``."""
    eng = opt["eng"]
    rng = np.random.default_rng(5)
    long_a, long_c = (rng.integers(1, 97, 10).astype(np.int32)
                      for _ in range(2))
    newcomer = rng.integers(1, 97, 30).astype(np.int32)
    kw = dict(spec_k=2, **SELF) if spec else {}
    srv = eng.serve(paged=True, page_size=8, num_slots=2,
                    prefill_token_budget=8, **kw)
    rc = srv.submit(long_c, max_new_tokens=40)
    ra = srv.submit(long_a, max_new_tokens=40)
    rb = srv.submit(newcomer, max_new_tokens=6)
    while srv.status(ra) != RequestStatus.RUNNING \
            or not srv._mirror_active[srv._requests[ra].slot]:
        srv.step()
    assert srv.cancel(ra)
    outs = srv.drain()
    np.testing.assert_array_equal(outs[rb], solo(eng, newcomer, 6))
    np.testing.assert_array_equal(outs[rc], solo(eng, long_c, 40))


def test_close_ends_streams_aborted(opt):
    w = opt["w"]
    srv = opt["eng"].serve(spec_k=2, **SELF)
    rids = [srv.submit(p, max_new_tokens=n)
            for p, n in zip(w["prompts"], w["news"])]
    streams = [srv.token_events(r) for r in rids]
    srv.step()
    srv.step()
    aborted = srv.close()
    assert aborted
    for rid, stream in zip(rids, streams):
        toks, end = stream.tokens(timeout=1)
        assert end["status"] == srv.status(rid)
        if rid in aborted:
            assert end["status"] == RequestStatus.ABORTED
    assert srv._draft_cache is None and not srv._draft_lanes._lanes


def test_spec_server_frees_on_del(opt):
    """With the cycle collector off, ``del`` of an engine whose closed
    speculative server had streams (and a preset draft) frees the
    modules at once: nothing holds the server back."""
    sd = pt.params_from_flax(random_tree(_jax()[4].TransformerConfig(**CFG)),
                             pt.TransformerConfig(**CFG))
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)),
        config={"dtype": "float32", "prefill_chunk_size": 8,
                "serving": dict(SERVING)}, device="cpu")
    eng.set_params(sd)
    gc.disable()
    try:
        srv = eng.serve(spec_k=2, **SELF)
        rid = srv.submit(opt["w"]["prompts"][0], max_new_tokens=4)
        stream = srv.token_events(rid)
        srv.drain()
        srv.close()
        module, server = weakref.ref(eng.module), weakref.ref(srv)
        del srv, eng
        assert server() is None and module() is None
        assert stream.tokens(timeout=1)[1]["status"] == \
            RequestStatus.COMPLETED
    finally:
        gc.enable()


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
CARD = dict(CFG, hidden_size=256, num_heads=4, vocab_size=512,
            max_seq_len=128, dtype="bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels and CUDA graphs)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_engine(cfg=CARD, dtype="bfloat16", **config):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**dict(cfg, dtype=dtype))),
        config={"dtype": dtype, "serving": dict(
            SERVING, max_cache_len=128, num_slots=4, page_size=16),
            **config}, device="cuda")
    eng.init_params(0)
    return eng


def _verify_rows(g, B, C, S_max, seed):
    """Per-row starts of a verify block: live rows anywhere up to the
    lane's end (``start + C == S_max``), a third of the rows dead (start
    clamped to ``S_max - C``, as ``spec_verify`` clamps it)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, S_max - C + 1, B)
    starts[:3] = [0, S_max - C, S_max - C - 1]
    dead = rng.random(B) < 0.33
    dead[1] = True
    starts[dead] = S_max - C
    return torch.tensor(starts, dtype=torch.int32, device="cuda"), \
        torch.tensor(dead, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 5, 9])
@pytest.mark.parametrize("B", [16, 96])
def test_card_k3_k7_at_the_verify_shape(cuda, C, B):
    """K3 over slot lanes and K7 over a pool (dead rows' table rows on
    the trash page) at the verify window's shape, against their plain
    versions (bf16 2e-2); K7 bitwise K3 over the gathered view."""
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
    g = torch.Generator(device=cuda).manual_seed(C * 100 + B)
    H, D, S_max, page, L = 32, 64, 384, 64, 2
    dt = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda, dtype=dt)

    starts, dead = _verify_rows(g, B, C, S_max, seed=C + B)
    q = rnd(B, C, H, D)
    kc, vc = rnd(L, B, S_max, H * D), rnd(L, B, S_max, H * D)
    out = da.chunk_prefill_attention(q, kc, vc, starts, layer=1)
    want = da.chunk_prefill_attention_plain(q, kc[1], vc[1], starts)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    n_virt = S_max // page
    n_pages = 1 + B * n_virt
    kp, vp = rnd(L, n_pages, page, H * D), rnd(L, n_pages, page, H * D)
    table = (1 + torch.randperm(B * n_virt, generator=torch.Generator()
                                .manual_seed(B)).view(B, n_virt)).to(
        device=cuda, dtype=torch.int32)
    table[dead] = 0                                  # the trash page
    out = pa.paged_chunk_prefill_attention(q, kp, vp, starts, table, layer=1)
    want = pa.paged_chunk_prefill_attention_plain(q, kp[1], vp[1], starts,
                                                  table)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    mono = da.chunk_prefill_attention(q, pa.gather_pages(kp[1], table),
                                      pa.gather_pages(vp[1], table), starts)
    assert torch.equal(out, mono)


def _card_serve_on(srv, reqs):
    """``reqs`` through ``srv``: the outputs and the launch counts."""
    from deepspeed_tpu_torch.ops import op_builder
    c0 = op_builder.launch_counts()
    rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
    outs = srv.drain()
    counts = [a - b for a, b in zip(op_builder.launch_counts(), c0)]
    return [outs[r] for r in rids], counts


def _card_serve(eng, reqs, **kw):
    srv = eng.serve(**kw)
    return (srv, *_card_serve_on(srv, reqs))


def _card_requests(n=10, seed=4, vocab=512):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(5, 60))), int(m))
            for m in rng.integers(2, 30, n)]


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "pool"])
def test_card_spec_graphs_equal_eager(cuda, paged):
    """Speculative serving on the captured propose and verify graphs:
    tokens bitwise the eager loop's, with equal launch counts, one graph
    each; and equal to non-speculative serving on fp32 weights."""
    on = _card_engine()
    off = deepspeed_tpu_torch.init_inference(
        on.module, config={"dtype": "bfloat16", "enable_cuda_graph": False,
                           "serving": on._config.serving.to_dict()},
        device="cuda")
    reqs = _card_requests()
    kw = dict(paged=paged, spec_k=4, **SELF)
    _, want, wc = _card_serve(off, reqs, **kw)
    for warm in (False, True):
        srv = on.serve(**kw)
        if warm:
            assert srv.warmup()
        got, counts = _card_serve_on(srv, reqs)
        assert counts == wc
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert srv._propose_prog.num_graphs == 1
        assert srv._verify_prog.num_graphs == 1
    f32 = _card_engine(dtype="float32")
    _, spec, _ = _card_serve(f32, reqs, **kw)
    _, plain, _ = _card_serve(f32, reqs, paged=paged)
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_card_second_capture_keeps_first_server(cuda):
    """A second speculative server's captures on the same engine leave
    the first server's graphs serving the same tokens."""
    eng = _card_engine()
    reqs = _card_requests(6, seed=8)
    first = eng.serve(spec_k=3, **SELF)
    a, _ = _card_serve_on(first, reqs)
    second = eng.serve(paged=True, spec_k=2, **SELF)
    second.warmup()
    _card_serve_on(second, reqs)
    b, _ = _card_serve_on(first, reqs)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert first._verify_prog.num_graphs == 1


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "pool"])
def test_card_dead_lanes_at_the_lane_end(cuda, paged):
    """Requests that fill their lanes to the last reserved position
    (``P + new + spec_k - 1 == max_cache_len``) retire there: their dead
    windows sit at the lane's end for the rest of the run, and nothing
    faults; the outputs equal the plain server's on fp32 weights."""
    eng = _card_engine(dtype="float32")
    k = 4
    reqs = [(np.arange(1, 1 + P) % 512, 128 - P - (k - 1))
            for P in (40, 64, 90, 100, 7)]
    _, spec, _ = _card_serve(eng, reqs, paged=paged, spec_k=k, **SELF)
    torch.cuda.synchronize()
    _, plain, _ = _card_serve(eng, reqs, paged=paged)
    for a, b in zip(spec, plain):
        np.testing.assert_array_equal(a, b)
