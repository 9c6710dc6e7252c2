"""The port's paged-KV host bookkeeping (``PagePool``, ``PrefixIndex``)
against the JAX package's classes: the same operation sequences give the
same results and the same pool state at every step — the scripted
sequence of ``tests/unit/test_serving_paged.py``
``test_page_pool_and_prefix_index_unit`` and a seeded random one."""

import numpy as np
import pytest

from deepspeed_tpu.inference.serving import paging as jax_paging
from deepspeed_tpu_torch.inference.serving import paging as pt_paging


def _state(pool, idx):
    return (pool.free_count, pool.in_use, pool.allocatable,
            [pool.refcount(p) for p in range(pool.num_pages)],
            round(pool.utilization(), 12), len(idx))


def _scripted(m):
    """The JAX unit test's sequence; returns every result and state."""
    log = []
    pool = m.PagePool(6)                     # pages 1..5 allocatable
    idx = m.PrefixIndex()
    log.append(_state(pool, idx))
    got = pool.alloc(3)
    log += [got, pool.alloc(3), _state(pool, idx)]   # never a partial grab
    pool.incref(got[0])
    for p in got:
        pool.decref(p)
    log.append(_state(pool, idx))
    pool.decref(got[0])
    log.append(_state(pool, idx))
    toks = np.arange(32, dtype=np.int32)
    row = pool.alloc(2)
    log += [row, idx.register(toks, 16, row, pool, 2), _state(pool, idx)]
    for p in row:
        pool.decref(p)
    hit = idx.lookup(toks, 16, pool, 2)
    log += [hit, _state(pool, idx)]
    for p in hit:
        pool.decref(p)
    toks2 = toks.copy()
    toks2[20] = 96                           # diverge inside block 2
    hit2 = idx.lookup(toks2, 16, pool, 2)
    log += [hit2, _state(pool, idx)]
    for p in hit2:
        pool.decref(p)
    log += [idx.evict(pool, 1), _state(pool, idx)]   # leaf first
    idx.clear(pool)
    log.append(_state(pool, idx))
    pool.alloc(4)
    pool.reset()
    log.append(_state(pool, idx))
    return log


def test_scripted_sequence_matches_jax():
    assert _scripted(pt_paging) == _scripted(jax_paging)


def _random_walk(m, seed, steps=400):
    """Seeded random serving-like traffic: admissions look up a prefix,
    allocate private pages (evicting under pressure), register their full
    prompt blocks; retirements drop a slot's references."""
    rng = np.random.default_rng(seed)
    page, n_pages = 4, 24
    pool, idx = m.PagePool(n_pages), m.PrefixIndex()
    prefixes = [rng.integers(0, 50, 16).astype(np.int32) for _ in range(3)]
    slots, log = [], []
    for _ in range(steps):
        if slots and (rng.random() < 0.4 or len(slots) >= 5):
            row = slots.pop(int(rng.integers(len(slots))))
            for p in row:
                pool.decref(p)
            log.append(("retire", _state(pool, idx)))
            continue
        pre = prefixes[int(rng.integers(3))][:int(rng.integers(4, 17))]
        toks = np.concatenate([pre, rng.integers(0, 50, int(
            rng.integers(1, 9))).astype(np.int32)])
        P = len(toks)
        matched = idx.lookup(toks, page, pool, (P - 1) // page)
        need = m.pages_for(P + 4, page) - len(matched)
        got = pool.alloc(need)
        freed = None
        if got is None:
            freed = idx.evict(pool, need - pool.free_count)
            got = pool.alloc(need)
        if got is None:
            for p in matched:
                pool.decref(p)
            log.append(("stall", matched, freed, _state(pool, idx)))
            continue
        row = matched + got
        reg = idx.register(toks, page, row, pool, P // page)
        slots.append(row)
        log.append(("admit", matched, got, freed, reg, _state(pool, idx)))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_traffic_matches_jax(seed):
    got = _random_walk(pt_paging, seed)
    want = _random_walk(jax_paging, seed)
    assert got == want
    kinds = {e[0] for e in got}
    assert kinds == {"admit", "retire", "stall"}, kinds   # pressure reached


def test_pool_refuses_misuse():
    with pytest.raises(ValueError, match="trash"):
        pt_paging.PagePool(1)
    pool = pt_paging.PagePool(3)
    pool.decref(pt_paging.TRASH_PAGE)               # the trash page is pinned
    assert pool.refcount(pt_paging.TRASH_PAGE) == 1
    with pytest.raises(AssertionError):
        pool.decref(1)                              # never allocated
    assert pt_paging.pages_for(17, 8) == jax_paging.pages_for(17, 8) == 3
