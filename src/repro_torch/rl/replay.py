"""Fixed-size replay buffers (paper: size 1e4, minibatch 128); port of
``repro.rl.replay``, the same numpy code: both sample from
``default_rng(seed + c)``, so the port's samples equal the reference's."""
from __future__ import annotations

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int, state_dim: int, action_dim: int,
                 seed: int = 0):
        self.capacity = capacity
        self.s = np.zeros((capacity, state_dim), np.float32)
        self.a = np.zeros((capacity, action_dim), np.float32)
        self.r = np.zeros((capacity,), np.float32)
        self.s2 = np.zeros((capacity, state_dim), np.float32)
        self.d = np.zeros((capacity,), np.float32)
        self.ptr = 0
        self.full = False
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.capacity if self.full else self.ptr

    def add(self, s, a, r, s2, done):
        i = self.ptr
        self.s[i], self.a[i], self.r[i] = s, a, r
        self.s2[i], self.d[i] = s2, float(done)
        self.ptr = (self.ptr + 1) % self.capacity
        self.full = self.full or self.ptr == 0

    def sample(self, batch: int):
        n = len(self)
        idx = self.rng.integers(0, n, size=batch)
        return {"states": self.s[idx], "actions": self.a[idx],
                "rewards": self.r[idx], "next_states": self.s2[idx],
                "dones": self.d[idx]}


class StackedReplayBuffer:
    """C per-stream replay buffers as one (C, capacity, ...) array set.

    The bi-level control plane's low-level agents each keep their own
    experience; stacking the storage lets one ``sample`` call gather a
    (C, B, ...) batch for the stacked ``a2c.update_stacked``.
    Per-stream write cursors and per-stream ``default_rng(seed + c)``
    streams make stream c's contents AND sampling order bit-identical to
    a standalone ``ReplayBuffer(capacity, state_dim, action_dim,
    seed=seed + c)`` fed the same transitions: the contract the loop
    oracle of ``repro_torch.core.bilevel`` relies on.
    """

    def __init__(self, capacity: int, n_streams: int, state_dim: int,
                 action_dim: int, seed: int = 0):
        self.capacity = capacity
        self.C = n_streams
        self.s = np.zeros((n_streams, capacity, state_dim), np.float32)
        self.a = np.zeros((n_streams, capacity, action_dim), np.float32)
        self.r = np.zeros((n_streams, capacity), np.float32)
        self.s2 = np.zeros((n_streams, capacity, state_dim), np.float32)
        self.d = np.zeros((n_streams, capacity), np.float32)
        self.ptr = np.zeros(n_streams, np.int64)
        self.full = np.zeros(n_streams, bool)
        self.rngs = [np.random.default_rng(seed + c)
                     for c in range(n_streams)]

    def lens(self) -> np.ndarray:
        return np.where(self.full, self.capacity, self.ptr)

    def __len__(self):
        """Min per-stream fill — the train-gating view (streams fill in
        lockstep in the bi-level trainer, so min == max there)."""
        return int(self.lens().min()) if self.C else 0

    def add_stream(self, c: int, s, a, r, s2, done):
        i = self.ptr[c]
        self.s[c, i], self.a[c, i], self.r[c, i] = s, a, r
        self.s2[c, i], self.d[c, i] = s2, float(done)
        self.ptr[c] = (i + 1) % self.capacity
        self.full[c] = self.full[c] or self.ptr[c] == 0

    def add_batch(self, s, a, r, s2, done):
        """One transition per stream: s (C, S), a (C, A), r (C,), s2
        (C, S), done (C,)."""
        for c in range(self.C):
            self.add_stream(c, s[c], a[c], r[c], s2[c], done[c])

    def sample_stream(self, c: int, batch: int):
        n = int(self.lens()[c])
        idx = self.rngs[c].integers(0, n, size=batch)
        return {"states": self.s[c, idx], "actions": self.a[c, idx],
                "rewards": self.r[c, idx], "next_states": self.s2[c, idx],
                "dones": self.d[c, idx]}

    def sample(self, batch: int):
        """(C, B, ...) batch stack; consumes each stream's rng exactly as
        ``sample_stream(c, batch)`` for c = 0..C-1 would."""
        per = [self.sample_stream(c, batch) for c in range(self.C)]
        return {k: np.stack([p[k] for p in per]) for k in per[0]}
