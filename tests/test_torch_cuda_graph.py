"""The compiled decode programs of ``deepspeed_tpu_torch``:
``CompiledGraphModule`` (CUDA graphs), the k-step decode program of
``generate()``, ``warmup()`` and the capturable serving decode block.

On the CPU (no graph there, the programs run directly), against the JAX
package on one parameter tree where JAX has the same thing:

- ``CompiledGraphModule``'s contract against the JAX mixin's
  (``iter_count``; ``enable_cuda_graph=False`` calls ``apply`` directly);
- the k-step decode program (``CapturedGenerate``) against the per-step
  eager loop and JAX ``generate()``, greedy tokens identical, with an eos
  that rows reach at different steps, blocks of 3 (a tail of 1) and of
  4, ``decode_early_exit`` on and off, one-pass / chunked / padded;
- the tensor-position decode route (the captured step's) against the
  int-start route: logits and every cache tensor bitwise, on float,
  int8-KV, int8×int8 and windowed pool caches;
- ``warmup()``'s report names against the JAX engines' ``warmup()``
  (generate: one pass and chunked; serving: lanes and a pool);
- ``decode_block`` keeps each slot-state tensor's identity;
- the workspace: smaller shapes share its buffers, growing or releasing
  it drops the captured programs;
- launches counted as captured × replays, and a donated buffer's
  identity in the signature, through a stand-in for the CUDA graph API.

The card tests (``cuda`` marker, skipped without a card) hold, at small
shapes with the kernels: greedy tokens bitwise equal with graphs on and
off for every route above and on the serving engine (lanes, pool, int8),
the launch counts equal, seeded sampling reproducible with graphs on and
no draw repeated across replays, ctypes launches (K2) captured, and a
failed capture raising.  They import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda_graph.py
"""

import contextlib

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import engine as te
from deepspeed_tpu_torch.inference.serving import slots
from deepspeed_tpu_torch.model_implementations import CompiledGraphModule
from deepspeed_tpu_torch.model_implementations.features import cuda_graph
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops import op_builder

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="relu")
# GPT-Neo's layout: global and sliding-window layers
NEO = dict(CFG, activation="gelu", attention_bias=False,
           attention_out_bias=True, attention_softmax_scale=1.0,
           attention_layers=("global", "local"), window_size=8,
           scan_layers=False)
B, P, NEW = 3, 20, 12
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}


def _tree(cfg, seed=0):
    """A numpy-drawn JAX parameter tree (as in test_torch_generate_parity)
    and the port's state dict of it."""
    import jax
    import jax.numpy as jnp
    from deepspeed_tpu.models import transformer as jt
    jmodel = jt.Transformer(jt.TransformerConfig(**cfg))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return 0.5 * x

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jmodel, tree, pt.params_from_flax(tree, pt.TransformerConfig(
        **cfg))


def _port(sd, cfg=CFG, device="cpu", **config):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)),
        config={"dtype": "float32", **config}, device=device)
    eng.set_params(sd)
    return eng


@pytest.fixture(scope="module")
def setup():
    jmodel, tree, sd = _tree(CFG)
    ids = np.random.default_rng(5).integers(0, 97, (B, P)).astype(np.int32)
    eng = _port(sd, enable_cuda_graph=False)
    greedy = eng.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    # an eos that row 0 reaches mid-stream: the rows finish at different
    # steps (or never)
    eos = int(greedy[0, P + NEW // 2])
    return dict(jmodel=jmodel, tree=tree, sd=sd, ids=ids, eos=eos)


# --------------------------------------------------------------------- #
# CompiledGraphModule against the JAX mixin
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("enable", [True, False])
def test_compiled_graph_module_contract_matches_jax_mixin(enable):
    import jax.numpy as jnp
    from deepspeed_tpu.model_implementations.features.cuda_graph import (
        CompiledGraphModule as JaxModule)
    calls = []

    def apply(x, y):
        calls.append(1)
        return x * 2 + y

    x = np.arange(6, dtype=np.float32)
    jm = JaxModule(lambda p, y: p * 2 + y, enable_cuda_graph=enable)
    tm = CompiledGraphModule(apply, enable_cuda_graph=enable)
    for i in range(3):
        want = np.asarray(jm(jnp.asarray(x), jnp.float32(i)))
        got = tm(torch.from_numpy(x), float(i))
        np.testing.assert_array_equal(got.numpy(), want)
    assert tm.iter_count == jm.iter_count == 3
    assert tm.enable_cuda_graph is jm.enable_cuda_graph is enable
    # no graph on the CPU: apply runs directly on every call
    assert len(calls) == 3 and tm.num_graphs == 0


# --------------------------------------------------------------------- #
# The k-step decode program against the eager loop and JAX
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("steps", [3, 4])
@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("route", ["one_pass", "chunked", "padded"])
def test_decode_program_matches_eager_loop_and_jax(setup, route, early_exit,
                                                   steps, monkeypatch):
    import deepspeed_tpu
    import jax.numpy as jnp
    monkeypatch.setattr(te, "DECODE_STEPS_PER_GRAPH", steps)
    s = setup
    config = {"decode_early_exit": early_exit}
    if route == "chunked":
        config["prefill_chunk_size"] = 8
    kw = dict(max_new_tokens=NEW, eos_token_id=s["eos"])
    ids = s["ids"]
    if route == "padded":
        mask = np.ones_like(ids)
        mask[1, P - 5:] = 0
        mask[2, P - 9:] = 0
        kw["attention_mask"] = mask
    graphed = _port(s["sd"], **config)
    eager = _port(s["sd"], enable_cuda_graph=False, **config)
    assert eager.prefill_plan(B, P)[0] == (
        "chunked" if route == "chunked" else "one_pass")
    got = graphed.generate(torch.from_numpy(ids), **kw).numpy()
    want = eager.generate(torch.from_numpy(ids), **kw).numpy()
    np.testing.assert_array_equal(got, want)
    fn = next(iter(graphed._programs.values()))
    assert isinstance(fn, te.CapturedGenerate)
    assert fn.plan == [steps] * ((NEW - 1) // steps) + (
        [(NEW - 1) % steps] if (NEW - 1) % steps else [])
    jeng = deepspeed_tpu.init_inference(s["jmodel"], config={
        "dtype": "float32", **config})
    jeng.set_params(s["tree"])
    jax_out = np.asarray(jeng.generate(jnp.asarray(ids), **kw))
    np.testing.assert_array_equal(got, jax_out)
    # row 0 stopped at its eos, the others ran on
    assert (got[0, P + NEW // 2:] == s["eos"]).all()


def test_decode_program_stops_once_every_row_is_done(setup):
    """With the early exit, a batch whose rows all hit eos in the first
    block replays nothing after it: ``done`` is read once per block."""
    s = setup
    eng = _port(s["sd"])
    ids = s["ids"][:1]
    greedy = eng.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    eos = int(greedy[0, P + 1])
    fn = next(iter(eng._programs.values()))
    before = sum(p.iter_count for p in fn.programs.values())
    out = eng.generate(torch.from_numpy(ids), max_new_tokens=NEW,
                       eos_token_id=eos).numpy()
    # none when the first token is already eos, else the first block only
    replays = 0 if greedy[0, P] == eos else 1
    assert sum(p.iter_count for p in fn.programs.values()) - before \
        == replays
    assert (out[0, P + 1:] == eos).all()
    np.testing.assert_array_equal(out[0, :P + 2], greedy[0, :P + 2])


# --------------------------------------------------------------------- #
# The tensor-position route (the captured step's) against the int start
# --------------------------------------------------------------------- #
def _prefilled(model, ids, paged, page=16):
    torch.manual_seed(0)
    Bn, Pn = ids.shape
    if paged:
        n_virt = -(-(Pn + 8) // page)
        cache = model.init_paged_cache(1 + Bn * n_virt, page)
        # a shuffled table over the pool (page 0 is the trash page)
        perm = 1 + torch.randperm(Bn * n_virt, generator=torch.Generator()
                                  .manual_seed(1))
        cache["pages"] = perm.view(Bn, n_virt).to(torch.int32)
        for c0 in range(0, Pn, 8):
            model.decode(ids[:, c0:c0 + 8], cache, c0,
                         logits_at=torch.full((Bn,), 7))
    else:
        cache = model.init_cache(Bn, Pn + 8)
        model.decode(ids, cache, 0, logits_at=torch.full((Bn,), Pn - 1),
                     prefill=True)
    return cache


@pytest.mark.parametrize("mode", ["float", "int8", "i8mm", "window_pool",
                                  "window_int8_pool"])
@torch.no_grad()
def test_tensor_position_route_matches_int_start(mode):
    cfg = dict(NEO if mode.startswith("window") else CFG)
    if mode != "float" and mode != "window_pool":
        cfg["kv_cache_quant"] = True
    if mode == "i8mm":
        cfg["decode_int8_matmuls"] = True
    _, _, sd = _tree(cfg, seed=2)
    model = pt.Transformer(pt.TransformerConfig(**cfg), device="cpu")
    model.load_state_dict(sd)
    model.eval()
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        0, 97, (B, 16)))
    paged = mode.endswith("pool")
    tok = torch.tensor([[5], [11], [3]])
    results = []
    for start in (16, torch.full((B,), 16)):
        cache = _prefilled(model, ids, paged)
        logits = []
        for step in range(3):
            pos = start + step
            out, cache = model.decode(tok, cache, pos)
            logits.append(out)
            tok = out[:, -1].argmax(-1, keepdim=True)
        results.append((torch.cat(logits, 1), cache))
        tok = torch.tensor([[5], [11], [3]])
    (want, wcache), (got, gcache) = results
    assert torch.equal(got, want)
    assert sorted(gcache) == sorted(wcache)
    for key in wcache:
        assert torch.equal(gcache[key], wcache[key]), key


# --------------------------------------------------------------------- #
# warmup() names against the JAX engines'
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("chunk", [None, 8])
def test_generate_warmup_names_match_jax(setup, chunk):
    import deepspeed_tpu
    s = setup
    config = {} if chunk is None else {"prefill_chunk_size": chunk}
    jeng = deepspeed_tpu.init_inference(s["jmodel"], config={
        "dtype": "float32", **config})
    jeng.set_params(s["tree"])
    eng = _port(s["sd"], **config)
    kw = dict(batch_sizes=(1, B))
    want = jeng.warmup(P, NEW, **kw)
    got = eng.warmup(P, NEW, **kw)
    assert sorted(got) == sorted(want)
    assert all(isinstance(v, float) and v >= 0.0 for v in got.values())
    assert any(name.startswith("prefill_chunk") for name in got) \
        == (chunk is not None)
    # warming left the generator and the tokens as they were
    ids = torch.from_numpy(s["ids"])
    np.testing.assert_array_equal(
        eng.generate(ids, max_new_tokens=NEW).numpy(),
        _port(s["sd"], **config).generate(ids, max_new_tokens=NEW).numpy())
    eager = _port(s["sd"], enable_cuda_graph=False, **config)
    assert set(eager.warmup(P, NEW, **kw).values()) == {0.0}


@pytest.mark.parametrize("paged", [False, True])
def test_serving_warmup_names_match_jax(setup, paged):
    import deepspeed_tpu
    s = setup
    serving = dict(SERVING, paged=paged)
    jeng = deepspeed_tpu.init_inference(s["jmodel"], config={
        "dtype": "float32", "prefill_chunk_size": 8, "serving": serving})
    jeng.set_params(s["tree"])
    want = jeng.serve().warmup()
    eng = _port(s["sd"], prefill_chunk_size=8, serving=serving)
    srv = eng.serve()
    got = srv.warmup()
    assert sorted(got) == sorted(want)
    # the server is as fresh as before: every lane free, tokens unchanged
    assert not srv._state["active"].any()
    assert (srv._state["eos"] == -1).all()
    prompts = [s["ids"][i, :10 + 3 * i] for i in range(B)]
    outs = [srv.result(srv.submit(p, max_new_tokens=5)) for p in prompts]
    assert outs == [None] * B
    got_out = srv.drain()
    ref = eng.serve()
    want_out = {r: ref.submit(p, max_new_tokens=5) for r, p in
                enumerate(prompts)}
    ref_out = ref.drain()
    for r, rid in want_out.items():
        np.testing.assert_array_equal(got_out[r], ref_out[rid])
    srv.submit(prompts[0], max_new_tokens=3)
    with pytest.raises(RuntimeError, match="idle"):
        srv.warmup()


# --------------------------------------------------------------------- #
# decode_block's state, the workspace
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("paged", [False, True])
@torch.no_grad()
def test_decode_block_keeps_state_identity(setup, paged):
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu")
    model.load_state_dict(setup["sd"])
    model.eval()
    N = 3
    state = slots.init_slot_state(N, "cpu")
    before = {k: (v, v.data_ptr()) for k, v in state.items()}
    state["token"].copy_(torch.tensor([4, 9, 0]))
    state["pos"].copy_(torch.tensor([3, 7, 0]))
    state["active"].copy_(torch.tensor([True, True, False]))
    state["remaining"].copy_(torch.tensor([5, 1, 0]))
    state["eos"].copy_(torch.tensor([-1, -1, -1]))
    if paged:
        cache = model.init_paged_cache(1 + N * 4, 16)
        pages = torch.arange(1, 1 + N * 4, dtype=torch.int32).view(N, 4)
    else:
        cache, pages = model.init_cache(N, 64), None
    sample = te.build_sample_fn(False, 1.0, 0, 1.0)
    toks = slots.decode_block(model, cache, state, 2, 64, sample, None,
                              pages)
    assert toks.shape == (2, N)
    for key, (t, ptr) in before.items():
        assert state[key] is t and t.data_ptr() == ptr, key
    # lane 1 retired after its last token, lane 2 stayed free
    assert state["active"].tolist() == [True, False, False]
    assert state["pos"].tolist() == [5, 9, 2]
    assert state["remaining"].tolist() == [3, 0, 0]
    assert toks[:, 2].tolist() == [-1, -1]
    slots.reset_slot_state(state)
    for key, (t, ptr) in before.items():
        assert state[key] is t and t.data_ptr() == ptr, key
    fresh = slots.init_slot_state(N, "cpu")
    for key in fresh:
        assert torch.equal(state[key], fresh[key]), key


def test_workspace_views_and_drops_programs(setup, monkeypatch):
    drops = []
    monkeypatch.setattr(te.CapturedGenerate, "reset",
                        lambda self: drops.append(self))
    eng = _port(setup["sd"])
    ids = torch.from_numpy(setup["ids"])
    eng.generate(ids, max_new_tokens=NEW)
    first = eng._workspace._cache["k"]
    # a smaller shape takes a view of the same buffer: nothing dropped
    eng.generate(ids[:1, :10], max_new_tokens=4)
    assert not drops
    assert eng._workspace._cache["k"].data_ptr() == first.data_ptr()
    # a larger one grows the buffers: every program is dropped first
    eng.generate(ids, max_new_tokens=NEW + 24)
    assert len(drops) == len(eng._programs) == 3
    assert eng._workspace._cache["k"].shape[2] >= P + NEW + 24
    drops.clear()
    eng.release_workspace()
    assert len(drops) == len(eng._programs)
    assert eng._workspace._cache is None
    eng.release_workspace()            # nothing held: nothing to drop
    assert len(drops) == len(eng._programs)


@pytest.mark.parametrize("paged", [None, False, True],
                         ids=["generate", "lanes", "pool"])
def test_engine_frees_its_weights_on_del(setup, paged):
    """With the cycle collector off, ``del`` of an engine that captured
    its decode programs (and of a closed server) frees its module at
    once: the workspace holds its engine's drop callback weakly."""
    import gc
    import weakref
    eng = _port(setup["sd"], serving=dict(SERVING))
    ids = torch.from_numpy(setup["ids"])
    gc.disable()
    try:
        if paged is None:
            eng.generate(ids, max_new_tokens=NEW)
            eng.warmup(10, 4)
        else:
            srv = eng.serve(paged=paged)
            srv.submit(setup["ids"][0], max_new_tokens=4)
            srv.drain()
            srv.close()
            del srv
        module = weakref.ref(eng.module)
        del eng
        assert module() is None
    finally:
        gc.enable()


def test_seeded_generator_is_reseeded_in_place(setup):
    eng = _port(setup["sd"])
    gen = eng._gen
    ids = torch.from_numpy(setup["ids"])
    kw = dict(max_new_tokens=NEW, do_sample=True, top_k=5, seed=3)
    a = eng.generate(ids, **kw)
    b = eng.generate(ids, **kw)
    assert eng._gen is gen
    assert torch.equal(a, b)
    assert not torch.equal(a, eng.generate(ids, **dict(kw, seed=4)))


# --------------------------------------------------------------------- #
# Launch accounting and signatures, through a stand-in for the graph API
# --------------------------------------------------------------------- #
class _FakeGraph:
    """Records a capture; a replay does nothing (the launches it would
    make are what the module adds)."""
    replays = 0

    def register_generator_state(self, gen):
        pass

    def replay(self):
        _FakeGraph.replays += 1


class _FakeStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(cuda_graph, "_on_cuda", lambda args: True)
    monkeypatch.setattr(cuda_graph, "_generator_states", lambda args: [])
    cuda = torch.cuda
    monkeypatch.setattr(cuda, "current_stream", _FakeStream)
    monkeypatch.setattr(cuda, "set_stream", lambda s: None)
    monkeypatch.setattr(cuda, "Stream", _FakeStream)
    monkeypatch.setattr(cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(cuda, "graph",
                        lambda g, pool=None: contextlib.nullcontext())
    _FakeGraph.replays = 0


def test_launches_counted_as_captured_times_replays(fake_graphs):
    def wrapper():
        pass

    op_builder.launch_counters(wrapper, "launches")
    try:
        def apply(cache, x):
            for _ in range(3):            # three kernel launches a call
                wrapper.launches += 1
            cache["k"].add_(x)
            return cache["k"] * 2

        m = CompiledGraphModule(apply, donate_argnums=(0,))
        cache = {"k": torch.zeros(4)}
        out = m(cache, torch.ones(4))     # warm-up pass + capture
        assert wrapper.launches == 3      # the capture launched nothing
        assert torch.equal(out, torch.full((4,), 2.0))
        assert m.num_graphs == 1 and _FakeGraph.replays == 0
        for _ in range(4):
            m(cache, torch.ones(4))       # replays
        assert _FakeGraph.replays == 4
        assert wrapper.launches == 3 + 3 * 4
        # a non-donated input is copied into the module's own buffer
        static = m._graphs[next(iter(m._graphs))].static_args
        m(cache, torch.full((4,), 7.0))
        assert torch.equal(static[1], torch.full((4,), 7.0))
        assert static[0] is cache
        # another buffer for the donated argument is another signature
        other = {"k": torch.zeros(4)}
        assert not m.has_graph(other, torch.ones(4))
        m(other, torch.ones(4))
        assert m.num_graphs == 2
        m.reset()
        assert m.num_graphs == 0 and m._pool is None
        assert m.iter_count == 7
    finally:
        op_builder.LAUNCH_COUNTERS.remove((wrapper, "launches"))


def test_failed_capture_raises_and_keeps_counts(fake_graphs, monkeypatch):
    def wrapper():
        pass

    op_builder.launch_counters(wrapper, "launches")
    state = {"capturing": False}

    def apply(x):
        wrapper.launches += 1
        if state["capturing"]:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return x + 1

    class Graph(_FakeGraph):
        def __init__(self):
            state["capturing"] = True

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    try:
        m = CompiledGraphModule(apply)
        with pytest.raises(RuntimeError, match="capture of apply failed"):
            m(torch.zeros(2))
        assert wrapper.launches == 1 and m.num_graphs == 0
    finally:
        op_builder.LAUNCH_COUNTERS.remove((wrapper, "launches"))


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
CARD = dict(CFG, hidden_size=256, num_heads=4, vocab_size=512,
            max_seq_len=128, dtype="bfloat16")
CARD_NEO = dict(NEO, hidden_size=256, num_heads=2, vocab_size=512,
                max_seq_len=128, dtype="bfloat16", window_size=16)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and the kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_engine(cfg, seed=0, **config):
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**cfg)),
        config={"dtype": "bfloat16", **config}, device="cuda")
    eng.init_params(seed)
    return eng


def _counts():
    return op_builder.launch_counts()


CARD_ROUTES = {
    "one_pass": (CARD, {}),
    "chunked": (CARD, {"prefill_chunk_size": 16}),
    "padded": (CARD, {}),
    "int8_kv": (dict(CARD, kv_cache_quant=True), {}),
    "i8mm": (dict(CARD, kv_cache_quant=True, decode_int8_matmuls=True), {}),
    "int8_weights": (CARD, {"quant": {"enabled": True, "bits": 8,
                                      "per_channel": True,
                                      "kv_cache": True}}),
    "window": (CARD_NEO, {}),
    "window_int8": (dict(CARD_NEO, kv_cache_quant=True), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(CARD_ROUTES))
def test_card_generate_graphs_equal_eager(cuda, route):
    cfg, config = CARD_ROUTES[route]
    on = _card_engine(cfg, **config)
    off = deepspeed_tpu_torch.init_inference(
        on.module, config={"dtype": "bfloat16", "enable_cuda_graph": False,
                           **config}, device="cuda")
    g = torch.Generator(device=cuda).manual_seed(1)
    Bc, Pc, new = 4, 40, 19
    ids = torch.randint(0, 512, (Bc, Pc), generator=g, device=cuda)
    kw = dict(max_new_tokens=new)
    if route == "padded":
        mask = torch.ones_like(ids)
        mask[1, 30:] = 0
        mask[3, 12:] = 0
        kw["attention_mask"] = mask
    eager = off.generate(ids, **kw)
    eos = int(eager[0, Pc + 6])
    for eos_id in (-1, eos):
        want = off.generate(ids, eos_token_id=eos_id, **kw)
        c0 = _counts()
        want2 = off.generate(ids, eos_token_id=eos_id, **kw)
        eager_counts = [a - b for a, b in zip(_counts(), c0)]
        assert torch.equal(want, want2)
        for rep in range(2):      # the capture, then replays only
            c0 = _counts()
            got = on.generate(ids, eos_token_id=eos_id, **kw)
            counts = [a - b for a, b in zip(_counts(), c0)]
            assert torch.equal(got, want), (route, eos_id, rep)
            # without an eos both run every step: the same launches
            # (with one, the graphs run whole blocks past the last eos)
            if eos_id < 0:
                assert counts == eager_counts, (route, rep)
    fn = next(iter(on._programs.values()))
    assert sum(p.num_graphs for p in fn.programs.values()) == len(
        set(fn.plan))


@pytest.mark.cuda
def test_card_warmup_captures_everything(cuda):
    eng = _card_engine(CARD, prefill_chunk_size=16)
    rep = eng.warmup(40, 19, batch_sizes=(1, 4))
    assert sorted(rep) == ["decode:b1p40n19", "decode:b4p40n19",
                           "prefill_chunk:b1c16", "prefill_chunk:b4c16"]
    assert all(v > 0.0 for v in rep.values())
    assert set(eng.warmup(40, 19, batch_sizes=(1, 4)).values()) == {0.0}
    fn = next(iter(eng._programs.values()))
    graphs = sum(p.num_graphs for p in fn.programs.values())
    ids = torch.randint(0, 512, (4, 40), device=cuda)
    eng.generate(ids, max_new_tokens=19)
    eng.generate(ids[:1], max_new_tokens=19)
    assert sum(p.num_graphs for p in fn.programs.values()) == graphs


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("int8", [False, True])
def test_card_serving_graphs_equal_eager(cuda, paged, int8):
    cfg = dict(CARD, kv_cache_quant=int8)
    serving = dict(SERVING, max_cache_len=128, paged=paged, num_slots=4,
                   decode_block=4, page_size=16)
    on = _card_engine(cfg, serving=serving)
    off = deepspeed_tpu_torch.init_inference(
        on.module, config={"dtype": "bfloat16", "enable_cuda_graph": False,
                           "serving": serving}, device="cuda")
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 512, int(rng.integers(5, 60))), int(n))
            for n in rng.integers(2, 30, 10)]
    outs = []
    for eng, warm in ((off, False), (on, False), (on, True)):
        srv = eng.serve()
        if warm:
            assert srv.warmup()
            assert srv._decode_prog.num_graphs == 1
        c0 = _counts()
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        done = srv.drain()
        counts = [a - b for a, b in zip(_counts(), c0)]
        outs.append(([done[r] for r in rids], counts,
                      srv.stats["decode_calls"]))
        if eng is on:
            assert srv._decode_prog.num_graphs == 1
            assert srv._decode_prog.iter_count == srv.stats[
                "decode_calls"] + int(warm)
        srv.close()
    (want, wc, wd), *graphed = outs
    for got, gc, gd in graphed:
        assert gd == wd and gc == wc
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_card_seeded_sampling_reproducible(cuda):
    eng = _card_engine(CARD)
    ids = torch.randint(0, 512, (4, 24), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    kw = dict(max_new_tokens=17, do_sample=True, top_k=40, top_p=0.9,
              temperature=0.8)
    a = eng.generate(ids, seed=7, **kw)       # captures
    b = eng.generate(ids, seed=7, **kw)       # replays
    c = eng.generate(ids, seed=8, **kw)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    off = deepspeed_tpu_torch.init_inference(
        eng.module, config={"dtype": "bfloat16", "enable_cuda_graph": False},
        device="cuda")
    assert torch.equal(off.generate(ids, seed=7, **kw), a)


@pytest.mark.cuda
def test_card_replays_never_repeat_draws(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    m = CompiledGraphModule(
        lambda x, g: torch.rand(x.shape, device=x.device, generator=g) + x)
    x = torch.zeros(1024, device=cuda)
    draws = [m(x, gen).clone() for _ in range(4)]    # capture, 3 replays
    assert m.num_graphs == 1
    for i in range(4):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j])
    gen.manual_seed(5)                               # reseeded in place
    again = [m(x, gen).clone() for _ in range(4)]
    ref = torch.Generator(device=cuda).manual_seed(5)
    eager = [torch.rand(1024, device=cuda, generator=ref) for _ in range(4)]
    for a, b, c in zip(draws, again, eager):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_card_ctypes_kernel_captured(cuda):
    from deepspeed_tpu_torch.ops.transformer import decode_attention as da
    g = torch.Generator(device=cuda).manual_seed(3)
    Bc, H, D, S = 4, 8, 64, 96

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda,
                           dtype=torch.bfloat16)

    def step(q, kc, vc, lengths, nk, nv):
        return da.decode_attention(q, kc, vc, lengths, new_k=nk,
                                   new_v=nv)[0]

    kc, vc = rnd(Bc, S, H * D), rnd(Bc, S, H * D)
    kc2, vc2 = kc.clone(), vc.clone()
    m = CompiledGraphModule(step, donate_argnums=(1, 2))
    for t in range(4):
        lengths = torch.tensor([5 + t, 60 + t, 1 + t, 90 + t],
                               device=cuda, dtype=torch.int32)
        q, nk, nv = rnd(Bc, H, D), rnd(Bc, H, D), rnd(Bc, H, D)
        c0 = da.decode_attention.launches
        got = m(q, kc, vc, lengths, nk, nv).clone()
        assert da.decode_attention.launches - c0 == 1
        want = step(q, kc2, vc2, lengths, nk, nv)
        assert torch.equal(got, want)
        assert torch.equal(kc, kc2) and torch.equal(vc, vc2)
    assert m.num_graphs == 1


@pytest.mark.cuda
def test_card_failed_capture_raises(cuda):
    m = CompiledGraphModule(lambda x: x * float(x.sum().item()))
    with pytest.raises(RuntimeError, match="capture of <lambda> failed"):
        m(torch.ones(4, device=cuda))
    assert m.num_graphs == 0
    # the card is still usable after the failed capture, its random
    # generators included
    y = torch.ones(4, device=cuda) * 3
    assert float(y.sum()) == 12.0
    gen = torch.Generator(device=cuda).manual_seed(1)
    m = CompiledGraphModule(
        lambda x, g: x * float(torch.rand(1, device=x.device,
                                          generator=g).item()))
    with pytest.raises(RuntimeError, match="failed"):
        m(torch.ones(4, device=cuda), gen)
    torch.manual_seed(0)
    a = torch.randn(8, device=cuda)
    torch.manual_seed(0)
    assert torch.equal(a, torch.randn(8, device=cuda))
    # the generator continues from its warm-up pass's one draw
    ref = torch.Generator(device=cuda).manual_seed(1)
    torch.rand(1, device=cuda, generator=ref)
    assert torch.equal(torch.rand(8, device=cuda, generator=gen),
                       torch.rand(8, device=cuda, generator=ref))
    torch.nn.Linear(4, 4, device=cuda)              # default-RNG init
