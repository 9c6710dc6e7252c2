"""Llama generation and serving: ``deepspeed_tpu_torch.init_inference(...)``
``.generate`` / ``.serve()`` against the JAX package's on one parameter
tree, with ``llama-tiny`` (G = 2) in fp32, its MHA twin and a G = 4 twin.

On the CPU (the kernels' plain versions):

- greedy tokens identical to JAX ``generate()`` on the one-pass route (K1
  prefill, K2 decode), the chunked route (K3) and with an int8 KV cache
  (K2-int8), each kernel counted where a CUDA tensor would launch it; in
  bf16 on the one-pass route too (the RMS norms rounded once, as flax);
- served requests (7 on 3 slots, eos probed mid-stream) on monolithic
  lanes and on a page pool equal to their solo ``generate()`` and to a
  JAX paged ``ServingEngine``'s; behind a shared page-aligned prefix, a
  served tail equals the same request unshared, bitwise (rope's absolute
  positions: a shared prefix starts at position 0);
- the rotated keys reach every write: a decode step's fused write on an
  int8 pool and a chunk's write on a float pool leave the JAX registry's
  bits.

The card tests (``cuda`` marker, skipped without a card; no JAX import)
run a 2-layer Llama of 8 heads of 64 (the kernels take head dims 64 and
128; llama-tiny's are 32) at G = 1, 2 and 4:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_llama_serving.py

kernel path against the plain path (greedy tokens equal on fp32 weights,
logits cosine >= 0.999 in bf16), captured graphs against eager (bitwise,
generate and a served pool), and ``warmup()`` followed by a second
capture leaving the rotation intact.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import opt as popt
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.transformer import decode_attention as da
from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

TWINS = {"gqa2": {}, "mha": dict(num_kv_heads=8), "gqa4": dict(num_kv_heads=2)}
OVER = dict(dtype="float32", scan_layers=False)
V = popt.LLAMA_CONFIGS["llama-tiny"]["vocab_size"]
B, P, NEW = 2, 24, 8
KV = {"fp": {}, "int8": dict(kv_cache_quant=True)}
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
N_REQ = 7


def _jax():
    import jax
    import jax.numpy as jnp
    import deepspeed_tpu
    from deepspeed_tpu.models import opt as jopt
    from deepspeed_tpu.models import transformer as jt
    return jax, jnp, deepspeed_tpu, jopt, jt


def random_tree(cfg, seed=0):
    """Numpy-drawn tree of the JAX model ``cfg``: RMS scales near 1,
    matrices and embeddings std 0.1."""
    jax, jnp, _, _, jt = _jax()
    jmodel = jt.Transformer(cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), {"input_ids": jnp.zeros((1, 8), jnp.int32)}))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) \
            else 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def configs(twin, **over):
    jopt = _jax()[3]
    kw = dict(OVER, **TWINS[twin], **over)
    return (jopt.llama_config("llama-tiny", **kw),
            popt.llama_config("llama-tiny", **kw))


@functools.lru_cache(maxsize=None)
def _setup(twin):
    jcfg, cfg = configs(twin)
    tree = random_tree(jcfg)
    sd = pt.params_from_flax(tree, cfg)
    ids = np.random.default_rng(5).integers(0, V, (B, P)).astype(np.int32)
    return dict(twin=twin, tree=tree, sd=sd, ids=ids)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tiny models run thousands of small ops: one intra-op thread
    keeps a parallel test run's workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=sorted(TWINS))
def setup(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def tiny():
    """llama-tiny itself (G = 2)."""
    return _setup("gqa2")


def engines(s, kv="fp", chunk=None, dtype="float32"):
    _, _, deepspeed_tpu, _, jt = _jax()
    jcfg, cfg = configs(s["twin"], dtype=dtype, **KV[kv])
    config = dict(dtype=dtype, prefill_chunk_size=chunk)
    jeng = deepspeed_tpu.init_inference(jt.Transformer(jcfg),
                                        config=dict(config))
    jeng.set_params(s["tree"])
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(cfg), config=dict(config), device="cpu")
    teng.set_params(s["sd"])
    return jeng, teng


class _Counted:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


@pytest.mark.parametrize("kv", list(KV))
@pytest.mark.parametrize("chunk", [None, 8], ids=["one_pass", "chunked"])
def test_greedy_identical_to_jax(setup, chunk, kv, monkeypatch):
    jnp = _jax()[1]
    jeng, teng = engines(setup, kv, chunk)
    route = "chunked" if chunk else "one_pass"
    assert jeng.prefill_plan(B, P)[0] == teng.prefill_plan(B, P)[0] == route
    ids = setup["ids"]
    want = np.asarray(jeng.generate(jnp.asarray(ids), max_new_tokens=NEW))
    counted = {name: _Counted(getattr(mod, name)) for mod, name in
               ((fa, "flash_attention_plain"), (da, "decode_attention_plain"),
                (da, "chunk_prefill_attention_plain"))}
    for name, fn in counted.items():
        monkeypatch.setattr(fa if name.startswith("flash") else da, name, fn)
    got = teng.generate(torch.from_numpy(ids), max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)
    for row in got[:, P:]:                     # a stream, not one token
        assert len(set(row.tolist())) >= 3, row
    L = teng.module.config.num_layers
    assert counted["flash_attention_plain"].calls == (0 if chunk else L)
    assert counted["chunk_prefill_attention_plain"].calls == \
        (L * P // chunk if chunk else 0)
    assert counted["decode_attention_plain"].calls == L * (NEW - 1)


JAX_BF16_GENERATE = """
import sys
import numpy as np
import jax.numpy as jnp
import deepspeed_tpu
from deepspeed_tpu.models import opt, transformer
flat = dict(np.load(sys.argv[1]))
tree = {}
for path, leaf in flat.items():
    node = tree
    *parents, name = path.split("/")
    for key in parents:
        node = node.setdefault(key, {})
    node[name] = leaf
cfg = opt.llama_config("llama-tiny", dtype="bfloat16", scan_layers=False,
                       num_kv_heads=int(sys.argv[2]))
eng = deepspeed_tpu.init_inference(transformer.Transformer(cfg),
                                   config={"dtype": "bfloat16"})
eng.set_params({"params": tree})
ids = np.load(sys.argv[3])
np.save(sys.argv[4], np.asarray(eng.generate(jnp.asarray(ids),
                                             max_new_tokens=int(sys.argv[5]))))
"""


def test_bf16_greedy_identical_to_jax(tiny, tmp_path):
    """bf16 weights and activations, one pass: the port rounds where the
    JAX model's operations round (the RMS norms return fp32 and the block
    rounds once, as flax).  JAX's jitted program runs with XLA's
    ``--xla_allow_excess_precision=false`` (in a process of its own: XLA
    reads its flags once), so that it rounds each bf16 intermediate as its
    operations say; with excess precision allowed, XLA skips some of those
    roundings and its greedy stream leaves its own op-by-op one at a
    near-tie (this tree's first token: logits 1.5 bf16 ulps apart)."""
    import os
    import subprocess
    import sys
    _, cfg = configs("gqa2")
    np.savez(tmp_path / "tree.npz", **pt._flatten(tiny["tree"]["params"]))
    np.save(tmp_path / "ids.npy", tiny["ids"])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(os.path.dirname(os.path.abspath(
                       __file__))), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", JAX_BF16_GENERATE,
                    str(tmp_path / "tree.npz"), str(cfg.kv_heads),
                    str(tmp_path / "ids.npy"), str(tmp_path / "want.npy"),
                    str(NEW)], env=env, check=True, timeout=900,
                   capture_output=True)
    want = np.load(tmp_path / "want.npy")
    teng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(dataclasses.replace(cfg, dtype="bfloat16")),
        config={"dtype": "bfloat16"}, device="cpu")
    teng.set_params(tiny["sd"])
    got = teng.generate(torch.from_numpy(tiny["ids"]),
                        max_new_tokens=NEW).numpy()
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _served(twin):
    """The port's engine for serving, the 7-request workload (eos probed
    mid-stream on every other request) and each request's solo greedy
    output (the serving chunk as ``prefill_chunk_size``)."""
    setup = _setup(twin)
    _, cfg = configs(twin)
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(cfg), config={"dtype": "float32",
                                     "prefill_chunk_size": 8,
                                     "serving": dict(SERVING)}, device="cpu")
    eng.set_params(setup["sd"])
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, V, (int(n),)).astype(np.int32)
               for n in rng.integers(9, 25, (N_REQ,))]
    news = [int(x) for x in rng.integers(3, 13, (N_REQ,))]
    eos = [int(solo(eng, p, n)[len(p) + n // 2]) if i % 2 == 0 else -1
           for i, (p, n) in enumerate(zip(prompts, news))]
    want = [solo(eng, p, n, e) for p, n, e in zip(prompts, news, eos)]
    return dict(eng=eng, prompts=prompts, news=news, eos=eos, want=want)


@pytest.fixture(scope="module")
def served(setup):
    return _served(setup["twin"])


def solo(eng, prompt, new, eos=-1):
    return eng.generate(torch.from_numpy(prompt[None]).long(),
                        max_new_tokens=new, eos_token_id=eos).numpy()[0]


def serve_all(srv, s):
    rids = [srv.submit(p, max_new_tokens=n, eos_token_id=e)
            for p, n, e in zip(s["prompts"], s["news"], s["eos"])]
    outs = srv.drain()
    return [outs[r] for r in rids]


@pytest.mark.parametrize("route", ["mono", "paged"])
def test_serving_matches_solo_generate_and_jax(setup, served, route):
    """Every request equals its solo generate() on lanes and on a pool,
    and a JAX ServingEngine's on the same route."""
    _, _, deepspeed_tpu, _, jt = _jax()
    paged = route == "paged"
    srv = served["eng"].serve(paged=paged)
    assert srv.kernel_modes["decode"] == ("cuda_paged_decode" if paged
                                          else "cuda_decode")
    got = serve_all(srv, served)
    for g, w in zip(got, served["want"]):
        np.testing.assert_array_equal(g, w)
    assert srv.stats["completed"] == N_REQ
    # the eos really stopped a probed request early
    n = served["news"][0]
    assert (got[0][-(n - n // 2):] == served["eos"][0]).all()
    jcfg, _ = configs(setup["twin"])
    jeng = deepspeed_tpu.init_inference(
        jt.Transformer(jcfg), config={"dtype": "float32",
                                      "prefill_chunk_size": 8,
                                      "serving": dict(SERVING, paged=paged)})
    jeng.set_params(setup["tree"])
    jsrv = jeng.serve()
    jrids = [jsrv.submit(p, max_new_tokens=n, eos_token_id=e) for p, n, e in
             zip(served["prompts"], served["news"], served["eos"])]
    jouts = jsrv.drain()
    for rid, g in zip(jrids, got):
        np.testing.assert_array_equal(g, jouts[rid])


def test_prefix_shared_tail_equals_unshared(tiny):
    """4 requests behind one 2-page prefix: 3 map its pages (rope keys at
    absolute positions 0..31, the same for every request) and every
    output equals the same request served without sharing and its solo
    generate(), bitwise."""
    served = _served(tiny["twin"])
    rng = np.random.default_rng(11)
    pre = rng.integers(1, V, (32,)).astype(np.int32)
    reqs = [np.concatenate([pre, rng.integers(1, V, (5,)).astype(np.int32)])
            for _ in range(4)]
    outs = {}
    for sharing in (True, False):
        srv = served["eng"].serve(paged=True, prefix_cache=sharing)
        rids = [srv.submit(q, max_new_tokens=6) for q in reqs]
        got = srv.drain()
        outs[sharing] = [got[r] for r in rids]
        assert srv.stats["prefix_hits"] == (3 if sharing else 0)
    for a, b, q in zip(outs[True], outs[False], reqs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, solo(served["eng"], q, 6))


def test_rotated_keys_reach_every_pool_write():
    """Rotated keys (as ``Attention`` hands them to the registry) written
    by a chunk into a float pool and by a decode step's fused write into
    an int8 pool: the port's pool holds the JAX registry's bits, and the
    chunk's rows are rope(k) at their positions."""
    jax, jnp, _, _, jt = _jax()
    from deepspeed_tpu.ops.transformer import registry as jax_registry
    from deepspeed_tpu_torch.ops.transformer import registry as pt_registry
    _, cfg = configs("gqa2")
    H, KVH, D = cfg.num_heads, cfg.kv_heads, cfg.head_dim
    rng = np.random.default_rng(2)
    pages = np.asarray([[3, 1], [2, 4]], np.int32)
    for int8, S, start in ((False, 8, 12), (True, 1, 19)):
        jc, tc = configs("gqa2", kv_cache_quant=int8)
        q = rng.standard_normal((2, S, H, D)).astype(np.float32)
        k = rng.standard_normal((2, S, KVH, D)).astype(np.float32)
        v = rng.standard_normal((2, S, KVH, D)).astype(np.float32)
        pos = np.tile(np.arange(start, start + S, dtype=np.int32), (2, 1))
        # rotate as Attention does, in each package
        jq, jk = jt._rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                          D, 1e4)
        tq, tk = pt._rope(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(pos).long(), D, 1e4)
        tmodel = pt.Transformer(dataclasses.replace(tc, num_layers=1),
                                device="cpu")
        pool = tmodel.init_paged_cache(5, 16)
        jpool = {key: jnp.asarray(val.numpy()) for key, val in pool.items()}
        jpool.update(pages=jnp.asarray(pages), layer=0)
        if S == 1:
            jpool["per_row"] = True
        _, jnew = jax_registry.write_and_attend(
            jc, jq, jk, jnp.asarray(v), jnp.asarray(pos), jpool)
        pool["pages"] = torch.from_numpy(pages)
        pt_registry.write_and_attend(
            tc, tq, tk, torch.from_numpy(v), torch.from_numpy(pos).long(),
            pool, 0, start=start if S > 1 else None)
        for key in ("k", "v") + (("k_scale", "v_scale") if int8 else ()):
            if int8:
                np.testing.assert_array_equal(pool[key].numpy(),
                                              np.asarray(jnew[key]),
                                              err_msg=key)
            else:
                np.testing.assert_allclose(pool[key].numpy(),
                                           np.asarray(jnew[key]), rtol=1e-6,
                                           atol=1e-6, err_msg=key)
        if not int8:      # rows 12..15 of virtual page 0 hold rope(k)
            got = pool["k"][0, pages[0, 0], 12:16].view(4, KVH, D)
            torch.testing.assert_close(got, tk[0, :4])


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #
CARD = dict(vocab_size=512, hidden_size=512, num_layers=2, num_heads=8,
            ffn_hidden_size=1376, max_seq_len=256, scan_layers=False)
CARD_G = {1: 8, 2: 4, 4: 2}
CARD_SERVING = {"enabled": True, "num_slots": 4, "max_cache_len": 128,
                "prefill_chunk": 16, "prefill_token_budget": 32,
                "decode_block": 4, "page_size": 16, "paged": True}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_engine(G, dtype="bfloat16", **config):
    cfg = popt.llama_config("llama-tiny", **CARD, num_kv_heads=CARD_G[G],
                            dtype=dtype)
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(cfg), config={"dtype": dtype, **config},
        device="cuda")
    eng.init_params(seed=G)
    return eng


def _plain_greedy(module, ids, new):
    """Greedy tokens of the plain path: the full uncached forward with a
    key-padding mask (dense reference attention in every layer, no
    kernel) once per token."""
    out = ids
    with torch.no_grad():
        for _ in range(new):
            logits = module.logits(out, torch.ones_like(out))[:, -1]
            out = torch.cat([out, logits.float().argmax(-1)[:, None]], 1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("G", sorted(CARD_G))
@pytest.mark.parametrize("chunk", [None, 16], ids=["one_pass", "chunked"])
def test_card_kernels_match_plain_path(cuda, G, chunk):
    """Greedy tokens of the kernel path (K1 or K3, then K2) equal the
    plain path's on fp32 weights; in bf16 the kernel path's prefill and
    first-step logits hold cosine >= 0.999 against the plain path's."""
    g = torch.Generator(device=cuda).manual_seed(G)
    ids = torch.randint(0, 512, (4, 40), generator=g, device=cuda)
    eng = _card_engine(G, "float32", prefill_chunk_size=chunk)
    got = eng.generate(ids, max_new_tokens=12)
    assert torch.equal(got, _plain_greedy(eng.module, ids, 12))
    eng = _card_engine(G, prefill_chunk_size=chunk)
    m = eng.module
    with torch.no_grad():
        cache = m.init_cache(4, 56)
        last = torch.full((4,), 39, device=cuda)
        if chunk is None:
            pre, _ = m.decode(ids, cache, 0, logits_at=last, prefill=True)
        else:
            for c0 in range(0, 40, 16):
                n = min(16, 40 - c0)
                pre, _ = m.decode(ids[:, c0:c0 + n], cache, c0,
                                  logits_at=torch.full((4,), n - 1,
                                                       device=cuda))
        nxt = pre[:, 0].float().argmax(-1)
        step, _ = m.decode(nxt[:, None], cache, 40)
        ids2 = torch.cat([ids, nxt[:, None]], 1)
        want = m.logits(ids2, torch.ones_like(ids2))
    for a, b in ((pre[:, 0], want[:, -2]), (step[:, 0], want[:, -1])):
        cos = torch.nn.functional.cosine_similarity(a.float(), b.float(),
                                                    dim=-1)
        assert float(cos.min()) >= 0.999, float(cos.min())


@pytest.mark.cuda
@pytest.mark.parametrize("G", sorted(CARD_G))
def test_card_graphs_equal_eager(cuda, G):
    """generate() (one pass and chunked) and a served pool: tokens bitwise
    equal with captured decode graphs and eager."""
    g = torch.Generator(device=cuda).manual_seed(10 + G)
    ids = torch.randint(0, 512, (4, 40), generator=g, device=cuda)
    for chunk in (None, 16):
        on = _card_engine(G, prefill_chunk_size=chunk)
        off = deepspeed_tpu_torch.init_inference(
            on.module, config={"dtype": "bfloat16", "prefill_chunk_size":
                               chunk, "enable_cuda_graph": False},
            device="cuda")
        want = off.generate(ids, max_new_tokens=19)
        for _ in range(2):            # the capture, then a replay
            assert torch.equal(on.generate(ids, max_new_tokens=19), want)
    on = _card_engine(G, serving=dict(CARD_SERVING))
    off = deepspeed_tpu_torch.init_inference(
        on.module, config={"dtype": "bfloat16", "enable_cuda_graph": False,
                           "serving": dict(CARD_SERVING)}, device="cuda")
    rng = np.random.default_rng(G)
    reqs = [(rng.integers(0, 512, int(n)).astype(np.int32), int(m))
            for n, m in zip(rng.integers(20, 60, 6), rng.integers(8, 30, 6))]
    outs = []
    for eng in (on, off):
        srv = eng.serve()
        rids = [srv.submit(p, max_new_tokens=n) for p, n in reqs]
        done = srv.drain()
        outs.append([done[r] for r in rids])
        srv.close()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_card_second_capture_keeps_rope(cuda):
    """warmup() captures one shape's decode graphs, a second warmup()
    another's; the first shape's replays still equal eager, so nothing of
    the rotation lives in a capture's private memory."""
    g = torch.Generator(device=cuda).manual_seed(3)
    ids = torch.randint(0, 512, (4, 40), generator=g, device=cuda)
    on = _card_engine(2)
    off = deepspeed_tpu_torch.init_inference(
        on.module, config={"dtype": "bfloat16", "enable_cuda_graph": False},
        device="cuda")
    on.warmup(40, 19, batch_sizes=(4,))
    on.warmup(24, 9, batch_sizes=(2,))
    assert torch.equal(on.generate(ids, max_new_tokens=19),
                       off.generate(ids, max_new_tokens=19))
    assert torch.equal(on.generate(ids[:2, :24], max_new_tokens=9),
                       off.generate(ids[:2, :24], max_new_tokens=9))
