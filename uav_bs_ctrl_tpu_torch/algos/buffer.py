"""Fixed-shape ring replay buffer for recurrent agents (counterpart of
``algos/buffer.py``).

Host NumPy storage: transitions accumulate into a chunk of ``max_seq_len``
steps; each completed chunk is written into preallocated ring storage, so a
sample is one fancy-index gather giving ``[B, T(+1), ...]`` batches. Sequence
fields (``obs``/``h``/``state``) store T+1 entries, the last being the *next*
obs/h/state after the final step; ``act``/``rew``/``done`` store T. The fused
trainers keep their ring on the device (:class:`DeviceRing`).
"""

import numpy as np
import torch

from uav_bs_ctrl_tpu_torch.parallel.dist import all_reduce_tree

SEQ_KEYS = ("obs", "h", "state")  # fields that carry the trailing next-value


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the layout of every chunk)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class SequenceReplayBuffer:
    """Ring buffer of fixed-length transition chunks (dict-valued fields)."""

    def __init__(self, capacity: int, max_seq_len: int):
        self.capacity = capacity
        self.max_seq_len = max_seq_len
        self._storage = None      # key -> tree of np arrays [capacity, T(+1), ...]
        self._size = 0
        self._write_ptr = 0
        self._chunk = []          # transition dicts of the current chunk

    def __len__(self):
        return self._size

    def push(self, transition: dict):
        """Store one transition: ``obs``/``h`` (trees), optional ``state``,
        ``act``, ``rew``, ``done``, plus ``next_obs``/``next_h``/
        [``next_state``], read only when the chunk completes."""
        self._chunk.append(transition)
        if len(self._chunk) == self.max_seq_len:
            self._commit_chunk()
            self._chunk = []

    def _commit_chunk(self):
        last = self._chunk[-1]
        chunk = {}
        for k in ("obs", "h", "state", "act", "rew", "done"):
            if k not in last:
                continue
            steps = [tr[k] for tr in self._chunk]
            if k in SEQ_KEYS:
                steps = steps + [last["next_" + k]]
            chunk[k] = tree_map(lambda *xs: np.stack(xs), *steps)
        if self._storage is None:
            self._storage = tree_map(
                lambda x: np.zeros((self.capacity,) + np.shape(x), np.asarray(x).dtype), chunk)
        idx = self._write_ptr
        tree_map(lambda store, x: store.__setitem__(idx, x), self._storage, chunk)
        self._write_ptr = (self._write_ptr + 1) % self.capacity
        self._size = min(self._size + 1, self.capacity)

    def push_chunks(self, chunks: dict):
        """Write a batch of completed chunks at once: a tree with leaves
        ``[B, T(+1), ...]``, the layout of ``algos.collect.collect_chunk``."""
        chunks = tree_map(np.asarray, chunks)
        n_new = tree_leaves(chunks)[0].shape[0]
        if self._storage is None:
            self._storage = tree_map(
                lambda x: np.zeros((self.capacity,) + x.shape[1:], x.dtype), chunks)
        idx = (self._write_ptr + np.arange(n_new)) % self.capacity
        tree_map(lambda store, x: store.__setitem__(idx, x), self._storage, chunks)
        self._write_ptr = (self._write_ptr + n_new) % self.capacity
        self._size = min(self._size + n_new, self.capacity)

    def sample(self, batch_size: int, rng=None) -> dict:
        """Chunks drawn uniformly without replacement -> leaves [B, T(+1), ...]."""
        rng = rng if rng is not None else np.random
        idx = rng.choice(self._size, size=batch_size, replace=False)
        return tree_map(lambda store: store[idx], self._storage)


class RingShard:
    """A dp rank's part of a device ring sharded by world.

    Each write of ``n`` worlds at the global slot ``ptr`` gives every dp rank
    its block of ``n / dp`` of them (the worlds it collected), stored at its
    local slots ``ptr / dp + [0, n / dp)``; ``owner`` and ``local`` map each
    global slot to its rank and local slot. A sample draws the single-rank
    trainer's global indices; rank r trains on rows ``[r B/dp, (r+1) B/dp)``
    of that batch, fetched from their owners by one all-reduce (per dtype)
    of a zero-filled global batch into which each owner writes its rows:
    every backend has it, and it moves the whole batch, about 0.5 MB a chunk
    at the exp3 8-UBS width (16 MB at B = 32)."""

    def __init__(self, capacity, dp, rank, group):
        self.dp, self.rank, self.group = dp, rank, group
        self.owner = torch.full((capacity,), -1, dtype=torch.long)
        self.local = torch.zeros((capacity,), dtype=torch.long)

    def rows(self, n):
        """``(lo, hi, n)``: this rank's block of ``n`` worlds."""
        b = n // self.dp
        return self.rank * b, (self.rank + 1) * b, n

    def record(self, ptr, total):
        """A write of ``total`` worlds (every rank's) at global slot ``ptr``."""
        per = total // self.dp
        j = torch.arange(total)
        self.owner[ptr:ptr + total] = j // per
        self.local[ptr:ptr + total] = ptr // self.dp + j % per

    def fetch(self, replay, idx):
        """This rank's rows of the batch at global slots ``idx``."""
        mine = (self.owner[idx] == self.rank).nonzero()[:, 0]
        device = tree_leaves(replay)[0].device
        src, dst = self.local[idx[mine]].to(device), mine.to(device)

        def fill(store):
            full = torch.zeros((len(idx),) + tuple(store.shape[1:]), dtype=store.dtype,
                               device=device)
            full[dst] = store[src]
            return full

        full = tree_map(fill, replay)
        summed = iter(all_reduce_tree(tree_leaves(full), self.group))
        lo, hi, _ = self.rows(len(idx))
        return tree_map(lambda _: next(summed)[lo:hi], full)


class DeviceRing:
    """The fused trainers' replay ring on the device, mixed into a trainer
    that sets ``capacity``, ``device``, ``generator`` (a CPU generator),
    ``learner`` and ``replay = None``, ``_ptr = _size = 0``, and, to shard
    the ring over dp, ``ring_shard`` (a :class:`RingShard`); ``_ptr`` and
    ``_size`` count global slots."""

    ring_shard = None

    def _write(self, chunk):
        """Write ``chunk`` (leaves [n, ...]; on a sharded ring this rank's n
        of the write's n·dp worlds) into the ring at ``ptr``."""
        n = tree_leaves(chunk)[0].shape[0]
        dp = 1 if self.ring_shard is None else self.ring_shard.dp
        if self.replay is None:
            self.replay = tree_map(
                lambda x: torch.zeros((self.capacity // dp,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=self.device), chunk)
        if self._ptr + n * dp > self.capacity:
            raise AssertionError("a ring write must not wrap")
        lo = self._ptr // dp
        tree_map(lambda store, x: store[lo:lo + n].copy_(x), self.replay, chunk)
        if self.ring_shard is not None:
            self.ring_shard.record(self._ptr, n * dp)
        self._size = min(self._size + n * dp, self.capacity)
        self._ptr = (self._ptr + n * dp) % self.capacity

    def sample_batch(self):
        """B chunks drawn with replacement from the ``size`` written ones (a
        sharded ring: this rank's rows of them)."""
        idx = torch.randint(0, self._size, (self.learner.batch_size,),
                            generator=self.generator)
        if self.ring_shard is not None:
            return self.ring_shard.fetch(self.replay, idx)
        idx = idx.to(self.device)
        return tree_map(lambda store: store[idx], self.replay)
