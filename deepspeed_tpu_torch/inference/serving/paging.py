"""Host-side paged-KV bookkeeping of the serving engine (port of
``deepspeed_tpu/inference/serving/paging.py``).

The device holds one page POOL (``Transformer.init_paged_cache``:
``[L, num_pages, page_size, KVH*D]``) shared by every slot; which physical
page backs which virtual position of which request is decided HERE, on
the host, and shipped to the device as a ``[num_slots, pages_per_slot]``
block table on every dispatch.

* :class:`PagePool` — the refcounted free-list mirror of the pool.  Page 0
  is the reserved TRASH page: never allocated, and every unmapped or
  retired table entry points at it, so zombie lanes (retired on the host,
  still decoding masked no-ops on the device) write their garbage there.
* :class:`PrefixIndex` — copy-on-write prefix sharing at page granularity:
  a hash-CHAIN index over page-aligned token blocks.  Requests whose
  leading blocks match map those table entries to the SAME physical pages
  (refcounted); the first token past the shared region lands in a private
  page, so a shared page is never written.  Unreferenced entries evict
  LRU, leaves first.

The serving engine allocates the pool itself (``_ensure_workspace``):
without donation, the JAX package's ``PagedPoolWorkspace`` has nothing to
reclaim.
"""

import hashlib
from collections import deque

import numpy as np

TRASH_PAGE = 0


def pages_for(virtual_len, page_size):
    """Physical pages needed to back ``virtual_len`` cache positions."""
    return -(-int(virtual_len) // int(page_size))


class PagePool:
    """Refcounted free-list mirror of the device page pool.  A page is
    freed only when the retirement that releases it has been PROCESSED
    (one event behind the device), and every dispatch after that carries
    a table that no longer maps it."""

    def __init__(self, num_pages):
        self.num_pages = int(num_pages)
        if self.num_pages < 2:
            raise ValueError(f"page pool needs >= 2 pages (1 trash + 1 "
                             f"allocatable), got {num_pages}")
        self._ref = np.zeros((self.num_pages,), np.int32)
        self._ref[TRASH_PAGE] = 1           # pinned forever
        self._free = deque(range(1, self.num_pages))

    @property
    def allocatable(self):
        """Pages a single request could ever hold (trash excluded)."""
        return self.num_pages - 1

    @property
    def free_count(self):
        return len(self._free)

    @property
    def in_use(self):
        return self.allocatable - len(self._free)

    def utilization(self):
        return self.in_use / max(self.allocatable, 1)

    def alloc(self, n):
        """``n`` fresh pages at refcount 1, or ``None`` when the free list
        is short (the caller evicts or waits — never a partial grab)."""
        if n > len(self._free):
            return None
        got = [self._free.popleft() for _ in range(n)]
        for p in got:
            self._ref[p] = 1
        return got

    def incref(self, page):
        assert self._ref[page] > 0, f"incref on free page {page}"
        self._ref[page] += 1

    def decref(self, page):
        p = int(page)
        if p == TRASH_PAGE:
            return
        assert self._ref[p] > 0, f"decref on free page {p}"
        self._ref[p] -= 1
        if self._ref[p] == 0:
            self._free.append(p)

    def refcount(self, page):
        return int(self._ref[int(page)])

    def reset(self):
        """All pages free (the pool buffer was just allocated)."""
        self._ref[:] = 0
        self._ref[TRASH_PAGE] = 1
        self._free = deque(range(1, self.num_pages))


class _PrefixEntry:
    __slots__ = ("page", "parent", "children", "last_use", "depth")

    def __init__(self, page, parent, depth):
        self.page = int(page)
        self.parent = parent                # key of the parent entry
        self.children = 0
        self.last_use = 0
        self.depth = depth


class PrefixIndex:
    """Hash-chain prefix index at page granularity.

    Key ``i`` of a token sequence is ``H(key_{i-1}, tokens[i*page :
    (i+1)*page])`` — a chain, so block ``i`` only ever matches behind an
    identical prefix.  Entries hold one pool reference each; a lookup
    increfs every matched page for the requesting slot.  Eviction is LRU
    over LEAF entries whose page nobody else references."""

    def __init__(self):
        self._entries = {}                  # key -> _PrefixEntry
        self._clock = 0

    def __len__(self):
        return len(self._entries)

    @staticmethod
    def _chain(tokens, page_size, upto_blocks):
        key = b"prefix"
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        for i in range(upto_blocks):
            block = tokens[i * page_size:(i + 1) * page_size]
            key = hashlib.sha1(key + block.tobytes()).digest()
            yield key

    def lookup(self, tokens, page_size, pool, max_blocks):
        """The longest indexed chain matching ``tokens``' leading full
        blocks (capped at ``max_blocks``); increfs and returns the matched
        physical pages (possibly empty)."""
        self._clock += 1
        matched = []
        full = min(len(tokens) // page_size, max_blocks)
        for key in self._chain(tokens, page_size, full):
            ent = self._entries.get(key)
            if ent is None:
                break
            ent.last_use = self._clock
            pool.incref(ent.page)
            matched.append(ent.page)
        return matched

    def register(self, tokens, page_size, row_pages, pool, upto_blocks):
        """Index ``tokens``' first ``upto_blocks`` full blocks as sharable,
        backed by ``row_pages`` (the slot's table row, whose prefill just
        wrote them).  Blocks already indexed keep their entry.  Each NEW
        entry takes one pool reference; returns how many were new."""
        self._clock += 1
        parent = None
        registered = 0
        for i, key in enumerate(self._chain(tokens, page_size,
                                            upto_blocks)):
            ent = self._entries.get(key)
            if ent is None:
                ent = _PrefixEntry(row_pages[i], parent, i)
                pool.incref(ent.page)
                self._entries[key] = ent
                if parent is not None:
                    self._entries[parent].children += 1
                registered += 1
            ent.last_use = self._clock
            parent = key
        return registered

    def evict(self, pool, need_pages):
        """Drop index references LRU-leaf-first until ``need_pages`` pages
        would land on the free list (an entry whose page is referenced
        elsewhere drops its reference without freeing the page).  Returns
        the number of pages actually freed."""
        freed = 0
        while freed < need_pages:
            victim_key, victim = None, None
            for key, ent in self._entries.items():
                if ent.children:
                    continue
                if victim is None or ent.last_use < victim.last_use:
                    victim_key, victim = key, ent
            if victim is None:
                break
            if pool.refcount(victim.page) == 1:
                freed += 1
            pool.decref(victim.page)
            if victim.parent is not None:
                self._entries[victim.parent].children -= 1
            del self._entries[victim_key]
        return freed

    def clear(self, pool):
        """Drop every entry and its pool reference."""
        for ent in self._entries.values():
            pool.decref(ent.page)
        self._entries.clear()

