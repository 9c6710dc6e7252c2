"""Speculative serving of ``deepspeed_tpu_torch`` for two more model
families against the JAX package: a llama-tiny target on a page pool
(rope at the verify window's per-row multi-token positions) and a
GPT-Neo-tiny one on slot lanes (its windowed layers' verify chunks
attend dense, as in JAX).  5 mixed requests on 3 slots with eos probed
mid-stream, bitwise the JAX package's speculative server, the port's
solo ``generate()`` and its plain server, with the JAX server's
``spec_*`` stats (fp32, the CPU; the kernels' plain versions run).  The
helpers are ``test_torch_spec_serving.py``'s.
"""

import numpy as np
import pytest

from deepspeed_tpu_torch.models import opt as popt
from deepspeed_tpu_torch.models import transformer as pt
from test_torch_spec_serving import (  # noqa: F401  (fixtures)
    CFG, SELF, SPEC_STATS, _jax, engines, one_torch_thread, random_tree,
    serve_all, workload)

NEO = dict(CFG, activation="gelu", attention_bias=False,
           attention_out_bias=True, attention_softmax_scale=1.0,
           attention_layers=("global", "local"), window_size=8,
           scan_layers=False)


def _family(name):
    """A llama-tiny (paged) or GPT-Neo-tiny (lanes) target: the port's
    and JAX's speculative servers and the port's plain one."""
    jopt, jt = _jax()[3], _jax()[4]
    if name == "llama":
        over = dict(dtype="float32", scan_layers=False, num_layers=2)
        jcfg = jopt.llama_config("llama-tiny", **over)
        cfg = popt.llama_config("llama-tiny", **over)
        tree = random_tree(jcfg, std=0.1)
        kw = dict(paged=True, spec_k=3, **SELF)
    else:
        jcfg, cfg = jt.TransformerConfig(**NEO), pt.TransformerConfig(**NEO)
        tree = random_tree(jcfg, std=0.2)
        kw = dict(spec_k=2, **SELF)
    jeng, eng = engines(jcfg, cfg, tree)
    w = workload(eng, 7, 5, cfg.vocab_size)
    srv = eng.serve(**kw)
    got = serve_all(srv, w)
    jsrv = jeng.serve(**kw)
    jouts = serve_all(jsrv, w)
    plain = serve_all(eng.serve(paged=kw.get("paged", False)), w)
    return got, jouts, plain, w, srv.stats, {
        k: jsrv.stats[k] for k in SPEC_STATS}


@pytest.mark.parametrize("name", ["llama", "gpt_neo"])
def test_model_families_match_jax(name):
    """llama-tiny on a pool (rope at the window's per-row positions) and
    GPT-Neo-tiny on lanes (windowed layers' verify chunks dense): bitwise
    JAX's speculative server, solo and the plain server."""
    got, jouts, plain, w, stats, jstats = _family(name)
    for g, j, p, want in zip(got, jouts, plain, w["want"]):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, want)
    assert {k: stats[k] for k in jstats} == jstats
    assert stats["spec_committed_tokens"] > stats["spec_windows"]
