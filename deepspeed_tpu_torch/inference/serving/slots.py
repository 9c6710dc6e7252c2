"""Slot programs of the continuous-batching serving engine, as plain
functions on tensors (port of ``deepspeed_tpu/inference/serving/
slots.py``, without the speculative programs).

Every piece of per-slot state — last token, write position, live flag,
steps remaining, eos id — is a ``[num_slots]`` tensor on the device
(:func:`init_slot_state`), so admissions, retirements and request churn
change only tensor contents and the host never reads the state back on
the dispatch path.  Where the JAX programs are jitted with the cache and
state donated, these update the cache and the state dict in place.

* :func:`decode_block` — ``block`` decode steps over every slot, per-row
  positions, in-program retirement.  Its per-step math is
  ``make_generate_fn``'s decode loop, so greedy serving tokens equal a
  solo ``generate()``'s.
* :func:`admit` — sample the first token from the prefill's logits, copy
  the prefilled single-lane cache into the slot's lane, write the slot's
  state.
* :func:`paged_chunk` / :func:`paged_admit` — the paged forms: a prefill
  chunk writes straight into the pool through the slot's table row, so
  the admit only samples and writes state.  :func:`decode_block` takes
  the block table for a paged pool and redirects inactive lanes' rows to
  the trash page (``safe_pages``).
"""

import torch


def init_slot_state(num_slots, device):
    """All lanes free.  ``eos = -1`` never matches a sampled token (ids are
    >= 0), so free lanes emit -1 and retire nothing."""
    kw = dict(dtype=torch.long, device=device)
    return {"token": torch.zeros(num_slots, **kw),
            "pos": torch.zeros(num_slots, **kw),
            "active": torch.zeros(num_slots, dtype=torch.bool,
                                  device=device),
            "remaining": torch.zeros(num_slots, **kw),
            "eos": torch.full((num_slots,), -1, **kw)}


@torch.no_grad()
def decode_block(module, cache, state, block, max_pos, sample_fn,
                 generator, pages=None):
    """``block`` decode steps of every slot; returns the emitted tokens
    ``[block, num_slots]`` and updates ``cache`` and ``state`` in place.

    Each step writes every slot's pending token at its own ``pos`` and
    attends (K2's fused write; K6 through the table for a paged pool),
    samples, emits the slot's ``eos`` for lanes already done, and retires
    a lane in-program when it emits its eos or exhausts ``remaining``.
    Retired and free lanes keep decoding masked no-ops until the host
    hands the slot on; ``pos`` is clamped to ``max_pos - 1`` and their
    token into the vocabulary, so their writes stay inside the lane and
    their inputs inside the model's tables.  With ``pages``
    ([num_slots, pages_per_slot] on the device) ``cache`` is the page
    pool: inactive lanes' table rows point at the trash page in-program
    (``safe_pages``), because a paged prefill writes the pool BEFORE its
    admit flips the lane live, and an unmasked zombie write would land in
    the newcomer's pages."""
    eos = state["eos"]
    tok, pos = state["token"], state["pos"]
    active, remaining = state["active"], state["remaining"]
    vocab = module.config.vocab_size
    toks = []
    for _ in range(block):
        step_cache = cache
        if pages is not None:
            safe_pages = torch.where(active[:, None], pages,
                                     torch.zeros_like(pages))
            step_cache = {**cache, "pages": safe_pages}
        # a retired lane feeds back its eos id (-1 for a free lane): clamp
        # it into the vocabulary as the JAX gather does (live lanes' tokens
        # are sampled ids, unchanged)
        logits, _ = module.decode(tok.clamp(0, vocab - 1)[:, None],
                                  step_cache, pos)
        nxt = sample_fn(logits[:, -1], generator)
        nxt = torch.where(active, nxt, eos)
        done_now = active & ((nxt == eos) | (remaining <= 1))
        active = active & ~done_now
        pos = torch.clamp(pos + 1, max=max_pos - 1)
        remaining = torch.clamp(remaining - 1, min=0)
        toks.append(nxt)
        tok = nxt
    state.update(token=tok, pos=pos, active=active, remaining=remaining)
    return torch.stack(toks)


def _write_state(state, slot, first, pos0, max_new, eos):
    """Flip slot ``slot`` live with its first token (a 0-d device tensor):
    inactive when the request already finished at admission (first token
    == eos, or ``max_new == 1``)."""
    state["token"][slot] = first
    state["pos"][slot] = pos0
    state["active"][slot] = (first != eos) & (max_new > 1)
    state["remaining"][slot] = max(max_new - 1, 0)
    state["eos"][slot] = eos


@torch.no_grad()
def admit(cache, state, lane, logits, slot, pos0, max_new, eos, sample_fn,
          generator):
    """Monolithic admission: sample the first token from the prefill's
    last-position logits ``[1, 1, V]`` (the decode step's rule), copy the
    prefilled lane ``[L, 1, S, KVH*D]`` into lane ``slot`` of the slot
    cache and write the slot's state.  Returns the first token (0-d, on
    the device; the host reads it one event later)."""
    first = sample_fn(logits[:, 0], generator)[0]
    for kk in cache:
        cache[kk][:, slot] = lane[kk][:, 0]
    _write_state(state, slot, first, pos0, max_new, eos)
    return first


@torch.no_grad()
def paged_admit(state, logits, slot, pos0, max_new, eos, sample_fn,
                generator):
    """Paged admission: the prompt's K/V already sits in the slot's pages,
    so admission is the first-token sample plus the state write."""
    first = sample_fn(logits[:, 0], generator)[0]
    _write_state(state, slot, first, pos0, max_new, eos)
    return first


@torch.no_grad()
def prefill_chunk(module, lane, chunk_ids, start, logits_at):
    """One admission-prefill chunk into a single-lane cache: ``chunk_ids``
    ``[1, C]`` at positions ``start ..`` (K3).  Returns the logits
    ``[1, 1, V]`` at chunk-local position ``logits_at`` ([1])."""
    logits, _ = module.decode(chunk_ids, lane, start, logits_at=logits_at)
    return logits


@torch.no_grad()
def paged_chunk(module, pool, pages, chunk_ids, start, logits_at):
    """One admission-prefill chunk written straight into the pool through
    the slot's table row ``pages [1, pages_per_slot]`` (K7).  Returns the
    logits ``[1, 1, V]`` at chunk-local position ``logits_at``."""
    logits, _ = module.decode(chunk_ids, {**pool, "pages": pages}, start,
                              logits_at=logits_at)
    return logits
