"""GPT-Neo serving and the windowed cache routes, on the CPU.

- serving: 7 requests on 3 slots, on monolithic lanes and on a page pool
  (pages of 16), each equal to its solo ``generate()`` (the same
  ``prefill_chunk_size`` as the serving chunk), with a tiny GPT-Neo config
  (layers global / local, window 8);
- the windowed routes against the JAX registry's ``write_and_attend`` on
  the same inputs: a windowed decode on an int8 pool leaves the pool's
  payloads and scales bitwise JAX's unfused write (an all-zero row's
  scale 0.0 included) and attends at 2e-5; a windowed chunk on a pool
  equals JAX's gather-then-dense at 2e-5; a global layer of the same model
  on the same pool still runs K6 / K7, counted where a CUDA tensor would
  launch them;
- ``registry._write_cache`` reads nothing back to the host on a per-row
  write, and writes what it wrote before, bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.transformer import registry as jax_registry
import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.ops.transformer import paged_attention as pa
from deepspeed_tpu_torch.ops.transformer import registry as pt_registry

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=4,
           max_seq_len=64, dtype="float32", use_flash_attention=True,
           tie_word_embeddings=True, activation="gelu",
           attention_bias=False, attention_out_bias=True,
           attention_softmax_scale=1.0, attention_layers=("global", "local"),
           window_size=8, scan_layers=False)
SERVING = {"enabled": True, "num_slots": 3, "max_cache_len": 64,
           "prefill_chunk": 8, "prefill_token_budget": 16,
           "decode_block": 2, "page_size": 16}
N_REQ = 7
TOL = dict(rtol=2e-5, atol=2e-5)
H, D, KVH = 4, 16, 4


def random_tree(jmodel, seed=0):
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
        return 0.2 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def solo(eng, prompt, new):
    return eng.generate(torch.from_numpy(prompt[None]).long(),
                        max_new_tokens=new).numpy()[0]


@pytest.fixture(scope="module")
def setup():
    tree = random_tree(jt.Transformer(jt.TransformerConfig(**CFG)))
    sd = pt.params_from_flax(tree, pt.TransformerConfig(**CFG))
    eng = deepspeed_tpu_torch.init_inference(
        pt.Transformer(pt.TransformerConfig(**CFG)),
        config={"dtype": "float32", "prefill_chunk_size": 8,
                "serving": dict(SERVING)}, device="cpu")
    eng.set_params(sd)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 97, (int(n),)).astype(np.int32)
               for n in rng.integers(9, 25, (N_REQ,))]
    news = [int(x) for x in rng.integers(3, 13, (N_REQ,))]
    want = [solo(eng, p, n) for p, n in zip(prompts, news)]
    return dict(eng=eng, prompts=prompts, news=news, want=want)


@pytest.mark.parametrize("route", ["mono", "paged16"])
def test_serving_matches_solo_generate(setup, route):
    s = setup
    kw = dict(paged=True, page_size=16) if route != "mono" else {}
    srv = s["eng"].serve(**kw)
    assert srv.kernel_modes["decode"] == ("cuda_paged_decode" if kw
                                          else "cuda_decode")
    rids = [srv.submit(p, max_new_tokens=n)
            for p, n in zip(s["prompts"], s["news"])]
    outs = srv.drain()
    for rid, want in zip(rids, s["want"]):
        np.testing.assert_array_equal(outs[rid], want)
    assert srv.stats["completed"] == N_REQ
    srv.close()


def _int8_rows(rng, B, S):
    k = (rng.standard_normal((B, S, KVH, D)) * 3.0).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    return k, v


def _pools(int8, n_pages=12, page=8, L=2):
    """A pool of seeded rows in both packages' cache dicts: (numpy
    buffers, the port's tensors)."""
    rng = np.random.default_rng(7)
    shape = (L, n_pages, page, KVH * D)
    bufs = {"k": (rng.standard_normal(shape) * 3.0).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}
    if int8:
        bufs = {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(0.01, 0.05, shape[:-1] + (KVH,))
                .astype(np.float32),
                "v_scale": rng.uniform(0.01, 0.05, shape[:-1] + (KVH,))
                .astype(np.float32)}
    return bufs, {k: torch.from_numpy(v.copy()) for k, v in bufs.items()}


def _both(int8, q, k, v, positions, pages, layer, start, window=8):
    """One windowed write-and-attend through each registry on the same
    pool; returns (JAX output, JAX cache, port output, port cache)."""
    bufs, tcache = _pools(int8)
    jcfg = jt.TransformerConfig(**dict(CFG, kv_cache_quant=int8))
    tcfg = pt.TransformerConfig(**dict(CFG, kv_cache_quant=int8))
    jcache = {**{k_: jnp.asarray(b) for k_, b in bufs.items()},
              "pages": jnp.asarray(pages), "layer": layer}
    if start is None:
        jcache["per_row"] = True
    want, jnew = jax_registry.write_and_attend(
        jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), jcache, window=window)
    tcache["pages"] = torch.from_numpy(pages)
    got = pt_registry.write_and_attend(
        tcfg, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(positions).long(), tcache, layer, start=start,
        window=window)
    return np.asarray(want), jnew, got.numpy(), tcache


PAGES = np.asarray([[3, 7, 1, 10], [5, 2, 11, 8]], np.int32)


def test_windowed_paged_decode_writes_like_jax():
    """A windowed decode on an int8 pool: JAX writes unfused
    (``_quant_rows``, the raw scale 0.0 for an all-zero row) and runs B4's
    window over the gathered view; the port writes the same bits and runs
    K6-window over the table."""
    rng = np.random.default_rng(1)
    k, v = _int8_rows(rng, 2, 1)
    k[1] = 0.0                                   # an all-zero k row
    q = rng.standard_normal((2, 1, H, D)).astype(np.float32)
    positions = np.asarray([[13], [30]], np.int32)
    want, jnew, got, tcache = _both(True, q, k, v, positions, PAGES, 1, None)
    for key in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jnew[key]), err_msg=key)
    phys = PAGES[1, 30 // 8]
    assert (tcache["k_scale"].numpy()[1, phys, 30 % 8] == 0.0).all()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_windowed_paged_chunk_is_jax_gather_then_dense(int8):
    """A windowed 8-token chunk at positions 12..19 of a pool (across a
    page edge): the port's write through the table, then dense windowed
    attention over the layer's gathered view, equals JAX's gather route."""
    rng = np.random.default_rng(2)
    k, v = _int8_rows(rng, 2, 8)
    q = rng.standard_normal((2, 8, H, D)).astype(np.float32)
    positions = np.tile(np.arange(12, 20, dtype=np.int32), (2, 1))
    want, jnew, got, tcache = _both(int8, q, k, v, positions, PAGES, 0, 12)
    np.testing.assert_allclose(got, want, **TOL)
    for key in ("k", "v") + (("k_scale", "v_scale") if int8 else ()):
        np.testing.assert_array_equal(tcache[key].numpy(),
                                      np.asarray(jnew[key]), err_msg=key)


class _Counted:
    def __init__(self, fn):
        self.fn, self.windows = fn, []

    def __call__(self, *args, **kwargs):
        self.windows.append(kwargs.get("window"))
        return self.fn(*args, **kwargs)


def test_global_layer_on_the_same_pool_keeps_k6_k7(setup, monkeypatch):
    """A GPT-Neo model's chunk and decode steps on one pool: the global
    layer runs K7 (chunk) and K6 without a window, the local layer K6 with
    its window and, for the chunk, the dense gather route."""
    k6 = _Counted(pa.paged_decode_attention)
    k7 = _Counted(pa.paged_chunk_prefill_attention)
    gather = _Counted(pt_registry._gathered_attention)
    monkeypatch.setattr(pa, "paged_decode_attention", k6)
    monkeypatch.setattr(pa, "paged_chunk_prefill_attention", k7)
    monkeypatch.setattr(pt_registry, "_gathered_attention", gather)
    m = setup["eng"].module
    pool = m.init_paged_cache(9, 8)
    pool["pages"] = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]],
                                 dtype=torch.int32)
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 97, (2, 17)))
    with torch.no_grad():
        m.decode(ids[:, :16], pool, 0)
        m.decode(ids[:, 16:], pool, 16)
        m.decode(ids[:, 16:], pool, torch.tensor([16, 12]))
    assert k7.windows == [None]
    assert len(gather.windows) == 1
    assert k6.windows == [None, 8, None, 8]


def test_write_cache_reads_nothing_back(monkeypatch):
    """A per-row write (padded-prompt decode, serving lanes) into a
    stacked int8 cache: no ``.item()`` / ``int()`` / ``bool()`` /
    ``tolist()`` / numpy read of a tensor, and bitwise the rows a
    per-row loop writes."""
    rng = np.random.default_rng(6)
    L, B, S, F = 2, 3, 16, KVH * D
    cache = {"k": torch.zeros(L, B, S, F, dtype=torch.int8),
             "v": torch.zeros(L, B, S, F, dtype=torch.int8),
             "k_scale": torch.zeros(L, B, S, KVH),
             "v_scale": torch.zeros(L, B, S, KVH)}
    rows = {key: torch.from_numpy(rng.standard_normal(
        (B, 1) + tuple(buf.shape[3:])).astype(np.float32))
        for key, buf in cache.items()}
    positions = torch.tensor([[5], [15], [0]])
    want = {key: buf.clone() for key, buf in cache.items()}
    for key, new in rows.items():
        for b in range(B):
            want[key][1, b, int(positions[b, 0])] = new[b, 0].to(
                want[key].dtype)

    def refuse(*args, **kwargs):
        raise AssertionError("a host read of a tensor")

    for name in ("item", "tolist", "numpy", "__int__", "__bool__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    pt_registry._write_cache(cache, 1, rows, positions, None)
    monkeypatch.undo()
    for key in cache:
        assert torch.equal(cache[key], want[key]), key
