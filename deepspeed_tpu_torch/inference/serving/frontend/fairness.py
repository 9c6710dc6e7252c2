"""Multi-tenant fairness (port of
``deepspeed_tpu/inference/serving/frontend/fairness.py``): per-``client_id``
token accounting on a decaying window.

:class:`FairnessTracker` charges each client for the work it consumes —
its prompt tokens when admission starts and each generated token as the
host mirror processes it — into an exponentially decaying balance (time
constant ``window_s``).  The serving engine refuses ``submit()`` with
``QueueFull`` (HTTP 429) from any client whose balance has reached
``tokens_per_s * window_s``; an over-quota client recovers as its balance
decays while the others keep flowing.

Host bookkeeping only.  The tracker has no lock of its own: it is reached
only through the engine's ``_fairness`` attribute, which is declared
lock-guarded (``inference/serving/concurrency.py``), so every read and
write runs under the engine lock (``window_usage()`` compacts the map in
place).  Its state rides preemption snapshots, so a restored server keeps
enforcing the same quotas.
"""

import math
import time


class FairnessTracker:
    """Decaying-window token accounting per client.

    ``usage(c)`` decays by ``1/e`` per ``window_s`` seconds, so the
    sustainable steady-state rate is exactly ``tokens_per_s`` and a
    silent client's balance is forgotten after a few windows.  Clients
    are keyed by ``str(client_id)`` (client ids are opaque and may be
    unhashable).  ``clock`` is injectable for deterministic tests."""

    def __init__(self, tokens_per_s, window_s=10.0, clock=time.monotonic):
        self.tokens_per_s = float(tokens_per_s)
        self.window_s = float(window_s)
        if self.tokens_per_s <= 0:
            raise ValueError(f"fairness_tokens_per_s={tokens_per_s}: "
                             f"need > 0 (0 disables fairness upstream)")
        if self.window_s <= 0:
            raise ValueError(f"fairness_window_s={window_s}: need > 0")
        self._clock = clock
        self._usage = {}                 # key -> [window_tokens, last_t]

    @property
    def budget(self):
        """The window budget: usage past it denies admission."""
        return self.tokens_per_s * self.window_s

    @staticmethod
    def key(client_id):
        return str(client_id)

    def _decayed(self, entry, now):
        tokens, t = entry
        if now > t:
            tokens *= math.exp(-(now - t) / self.window_s)
        return tokens

    def usage(self, client_id):
        """The client's current window-token balance (decayed to now)."""
        entry = self._usage.get(self.key(client_id))
        return self._decayed(entry, self._clock()) if entry else 0.0

    def allow(self, client_id):
        """Admission verdict: ``False`` while the client is over budget
        (the caller rejects with ``QueueFull`` — HTTP 429)."""
        return self.usage(client_id) < self.budget

    def charge(self, client_id, tokens):
        """Account ``tokens`` of consumed work (admitted prefill or
        generated tokens) to the client."""
        key = self.key(client_id)
        now = self._clock()
        entry = self._usage.get(key)
        balance = self._decayed(entry, now) if entry else 0.0
        self._usage[key] = [balance + float(tokens), now]

    def window_usage(self):
        """``{client_key: window_tokens}`` decayed to now (metrics and
        snapshots); near-zero balances are dropped so an old tenant set
        cannot grow the map forever."""
        now = self._clock()
        out = {}
        for key, entry in list(self._usage.items()):
            balance = self._decayed(entry, now)
            if balance < 1e-6:
                del self._usage[key]
                continue
            out[key] = balance
        return out

    def state_dict(self):
        """Snapshot payload: balances decayed to NOW.  Restore treats
        them as balances at restore time — decay during the downtime is
        deliberately not credited (conservative: a preempt/restore cycle
        never launders an over-quota client back under budget)."""
        return {"tokens_per_s": self.tokens_per_s,
                "window_s": self.window_s,
                "usage": self.window_usage()}

    def load_state(self, state):
        """Adopt a snapshot's balances (this tracker's own rate/window
        config wins — quotas are a server property, not snapshot
        payload)."""
        now = self._clock()
        for key, tokens in (state.get("usage") or {}).items():
            self._usage[str(key)] = [float(tokens), now]


__all__ = ["FairnessTracker"]
