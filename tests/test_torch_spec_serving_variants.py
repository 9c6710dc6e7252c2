"""Speculative serving of ``deepspeed_tpu_torch`` against the JAX package
beyond the self-draft on slot lanes: a distinct random draft pair
converted from JAX, and the page pool (prefix sharing off:
``prefix_lookups`` stays 0).  Each serves the 7 mixed requests of
``test_torch_spec_serving.py`` on 3 slots with eos probed mid-stream,
bitwise the JAX package's speculative server and the port's solo
``generate()``, with the JAX server's ``spec_*`` stats (fp32, the CPU;
the kernels' plain versions run).  The helpers and the shared JAX
servers are that file's.
"""

import numpy as np

from deepspeed_tpu_torch.models import transformer as pt
from test_torch_spec_serving import (  # noqa: F401  (fixtures)
    SELF, jax_served, one_torch_thread, opt, serve_all)


def test_spec_random_draft_pair_matches_jax(opt):
    """A distinct random draft, converted from the JAX draft's tree: the
    accept rate drops, the outputs stay bitwise, and every count equals
    the JAX server's with the same draft."""
    srv = opt["eng"].serve(speculative=True, spec_k=2,
                           draft_module=pt.Transformer(opt["dcfg"]),
                           draft_params=opt["dsd"])
    got = serve_all(srv, opt["w"])
    jouts, jstats = jax_served((("speculative", True), ("spec_k", 2),
                                ("draft_pair", True)))
    for g, j, w in zip(got, jouts, opt["w"]["want"]):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)
    assert {k: srv.stats[k] for k in jstats} == jstats
    assert srv.stats["spec_accept_rate"] < 0.5
    assert srv.draft_module is not srv.module


def test_spec_paged_matches_jax(opt):
    """Over a page pool (verify through K7's route, dead lanes' rows on the
    trash page): bitwise JAX's paged speculative server and solo; prefix
    sharing stays off; every page comes back."""
    srv = opt["eng"].serve(paged=True, spec_k=2, **SELF)
    assert srv.stats["prefix_lookups"] == 0
    got = serve_all(srv, opt["w"])
    jouts, jstats = jax_served((("speculative", True), ("spec_k", 2),
                                ("spec_draft_model", "self"),
                                ("paged", True)))
    for g, j, w in zip(got, jouts, opt["w"]["want"]):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, w)
    assert {k: srv.stats[k] for k in jstats} == jstats
    assert srv.stats["prefix_lookups"] == srv.stats["prefix_hits"] == 0
    assert not srv._slot_pages and (srv._page_table == 0).all()
    assert srv.page_pool_utilization == 0.0
