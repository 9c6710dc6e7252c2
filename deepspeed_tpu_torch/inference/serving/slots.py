"""Slot programs of the continuous-batching serving engine, as plain
functions on tensors (port of ``deepspeed_tpu/inference/serving/
slots.py``).

Every piece of per-slot state — last token, write position, live flag,
steps remaining, eos id — is a ``[num_slots]`` tensor on the device
(:func:`init_slot_state`), so admissions, retirements and request churn
change only tensor contents and the host never reads the state back on
the dispatch path.  Where the JAX programs are jitted with the cache and
state donated, these update the cache and the state tensors in place —
never rebinding them, so :func:`decode_block` can be captured as a CUDA
graph that later admissions (:func:`_write_state`) and replays see.

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
* Speculative decoding: :func:`draft_propose` (``k + 1`` greedy draft
  steps over the draft's own lanes), :func:`spec_verify` (one target
  forward over ``[token, d_1..d_k]`` per slot — over slot lanes, or a
  pool through its block table like :func:`decode_block` — then
  :func:`spec_commit`'s accept rule, all on the device),
  :func:`draft_chunk` / :func:`draft_admit` (the prompt into the draft's
  lanes).  Propose only reads the slot state; verify writes
  it in place, as :func:`decode_block` does, so both can be captured.
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
    # into the same tensors: a captured block's next replay and the
    # admissions between blocks read them
    for key, val in (("token", tok), ("pos", pos), ("active", active),
                     ("remaining", remaining)):
        state[key].copy_(val)
    return torch.stack(toks)


def reset_slot_state(state):
    """Every lane free again, in place (the values of
    :func:`init_slot_state`)."""
    for key in ("token", "pos", "active", "remaining"):
        state[key].zero_()
    state["eos"].fill_(-1)


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


# --------------------------------------------------------------------- #
# Speculative decoding: a draft model proposes k tokens per live slot,
# the target verifies the window in one batched forward, and the accepted
# prefix advances both caches.  The accept rule runs on the device, so
# one propose program and one verify program serve the whole server.
# Committed tokens are the target's samples over the committed history,
# which keeps greedy speculative serving equal to non-speculative serving.
# --------------------------------------------------------------------- #
def spec_commit(t, draft, state, k, max_pos):
    """The accept-and-commit rule (JAX ``_spec_commit``).  ``t`` ``[N,
    k+1]``: the target's sample at every window position (``t[:, i]``
    after feeding ``[token, d_1..d_i]``); ``draft`` ``[N, k]``.  Token
    ``t[:, i]`` is committed iff every earlier draft matched (the
    leading-match prefix), the slot had budget (``i < remaining``), no
    earlier committed token was its ``eos``, and the lane is live.
    Returns ``(tokens [k+1, N], accepted [N], new_state)``: uncommitted
    positions emit the slot's eos, lanes retire on eos or budget, dead
    lanes commit nothing.  Reads nothing back to the host."""
    eos, active = state["eos"], state["active"]
    remaining, pos = state["remaining"], state["pos"]
    match = (draft == t[:, :k]).long()
    n_match = torch.cumprod(match, dim=1).sum(dim=1)
    m_raw = 1 + n_match                                      # 1..k+1
    idx = torch.arange(k + 1, device=t.device)[None, :]
    base = (idx < m_raw[:, None]) & (idx < remaining[:, None]) \
        & active[:, None]
    eos_hit = base & (t == eos[:, None])
    # commit stops after the first committed eos (inclusive), the
    # per-step rule of decode_block folded over the window
    hits = eos_hit.long()
    committed = base & (torch.cumsum(hits, dim=1) - hits == 0)
    m_eff = committed.long().sum(dim=1)
    last = torch.gather(t, 1, (m_eff - 1).clamp(0, k)[:, None])[:, 0]
    done_now = active & (eos_hit.any(dim=1) | (remaining <= m_eff))
    new_state = {
        "token": torch.where(active, last, eos),
        # live lanes stay in bounds by submit()'s window reserve; the
        # clamp keeps dead lanes' positions inside the lane
        "pos": torch.clamp(pos + m_eff, max=max_pos - 1),
        "active": active & ~done_now,
        "remaining": torch.clamp(remaining - m_eff, min=0),
        "eos": eos,
    }
    toks = torch.where(committed, t, eos[:, None]).T
    return toks, m_eff, new_state


@torch.no_grad()
def draft_propose(draft_module, draft_cache, state, k, max_pos):
    """``k + 1`` greedy single-token draft steps over the draft's lanes
    (K2's fused write at each lane's ``pos``); returns the proposals
    ``[N, k]`` and updates ``draft_cache`` in place.  ``state`` is only
    read.  The last step only writes: a fully accepted window advances
    ``pos`` by ``k + 1``, and without it the draft cache would hold a
    hole at ``pos + k``.  The draft samples greedily whatever the serving
    sampling: its quality moves the accept rate, never the committed
    tokens."""
    eos, active = state["eos"], state["active"]
    tok, pos = state["token"], state["pos"]
    vocab = draft_module.config.vocab_size
    drafts = []
    for i in range(k + 1):
        # dead lanes feed back their eos (-1 for a free lane): clamp it
        # into the vocabulary, as the JAX gather does
        ids = tok.clamp(0, vocab - 1)[:, None]
        if i == k:
            # the write-only step: no vocabulary projection
            draft_module.hidden_states(ids, cache=draft_cache, start_pos=pos)
            break
        logits, _ = draft_module.decode(ids, draft_cache, pos)
        nxt = torch.argmax(logits[:, -1].float(), dim=-1)
        tok = torch.where(active, nxt, eos)
        pos = torch.clamp(pos + 1, max=max_pos - 1)
        drafts.append(tok)
    return torch.stack(drafts, dim=1)


@torch.no_grad()
def spec_verify(module, cache, state, draft, k, max_pos, sample_fn,
                generator, pages=None):
    """One target forward over ``[token, d_1..d_k]`` per slot from each
    lane's own ``pos`` (K3 over slot lanes, K7 through the block table
    ``pages`` over a pool), then :func:`spec_commit`; returns ``(tokens
    [k+1, N], accepted [N])`` and updates ``cache`` and ``state`` in
    place (JAX ``make_spec_verify_fn`` and, with ``pages``,
    ``make_paged_spec_verify_fn``).  K/V written for rejected positions is
    overwritten position by position by later windows before any query
    attends it.  A dead lane's window starts at most ``max_pos - 1 - k``,
    so its writes and reads stay inside the lane (and its positions inside
    the model's table); on a pool its table row is redirected to the trash
    page as well."""
    active = state["active"]
    vocab = module.config.vocab_size
    ids = torch.cat([state["token"][:, None], draft], dim=1)
    ids = ids.clamp(0, vocab - 1)
    start = torch.where(active, state["pos"],
                        state["pos"].clamp(max=max_pos - 1 - k))
    step_cache = cache
    if pages is not None:
        step_cache = {**cache, "pages": torch.where(
            active[:, None], pages, torch.zeros_like(pages))}
    logits, _ = module.decode(ids, step_cache, start)
    t = torch.stack([sample_fn(logits[:, i], generator)
                     for i in range(k + 1)], dim=1)
    toks, accepted, new_state = spec_commit(t, draft, state, k, max_pos)
    for key in ("token", "pos", "active", "remaining"):
        state[key].copy_(new_state[key])
    return toks, accepted


@torch.no_grad()
def draft_chunk(draft_module, lane, chunk_ids, start):
    """One admission-prefill chunk into a single-lane DRAFT cache (K3):
    speculation needs the prompt's K/V in the draft's cache too.  No
    vocabulary projection: the first token is the target's."""
    draft_module.hidden_states(chunk_ids, cache=lane, start_pos=start)


@torch.no_grad()
def draft_admit(draft_cache, lane, slot):
    """Copy the prefilled draft lane ``[L, 1, S, ...]`` into lane ``slot``
    of the draft cache; the target's admit samples and writes the
    state."""
    for kk in draft_cache:
        draft_cache[kk][:, slot] = lane[kk][:, 0]
