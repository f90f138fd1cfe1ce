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

from uav_bs_ctrl_tpu_torch import graphs as programs
from uav_bs_ctrl_tpu_torch.parallel.dist import all_reduce, all_reduce_tree

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
    of the global batch that each owner fills with its rows and zeros
    elsewhere (:meth:`fill`): every backend has it, and it moves the whole
    batch, about 0.5 MB a chunk at the exp3 8-UBS width (16 MB at B = 32).
    Each entry of the sum has one non-zero contribution, so it is exact.

    :meth:`fill` is a fixed-shape gather by mask, from ``owner`` and
    ``local`` kept on the device too (:meth:`books`, refreshed in place by
    every :meth:`record`, outside any graph), so a program can run it; the
    host then runs the all-reduce (:meth:`gathered`) between replays.
    :meth:`fetch` is the two in a row."""

    def __init__(self, capacity, dp, rank, group):
        self.dp, self.rank, self.group = dp, rank, group
        self.owner = torch.full((capacity,), -1, dtype=torch.long)
        self.local = torch.zeros((capacity,), dtype=torch.long)
        self._books = None            # (owner, local) on the device, for fill

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
        if self._books is not None:
            for book, host in zip(self._books, (self.owner, self.local)):
                book.copy_(host)

    def books(self, device):
        """``(owner, local)`` as tensors on ``device``, made once and kept
        up to date in place, so that a captured graph reads each record."""
        if self._books is None:
            self._books = (self.owner.to(device), self.local.to(device))
        return self._books

    def fill(self, replay, idx):
        """The batch at global slots ``idx`` [N] (on the device) with this
        rank's own chunks in their rows and zeros in every other row: summed
        over the ranks (:func:`all_reduce_tree`), the whole batch."""
        owner, local = self.books(idx.device)
        mine, src = owner[idx] == self.rank, local[idx]

        def rows(store):
            mask = mine.view((-1,) + (1,) * (store.dim() - 1))
            return torch.where(mask, store[src], store.new_zeros(()))

        return tree_map(rows, replay)

    def gathered(self, full, b):
        """``full``, this rank's fill of ``k b`` slots (``k`` batches of
        ``b``), summed over the ranks: this rank's rows of each batch."""
        summed = iter(all_reduce_tree(tree_leaves(full), self.group))
        full = tree_map(lambda _: next(summed), full)
        lo, hi, _ = self.rows(b)
        k = tree_leaves(full)[0].shape[0] // b
        return [tree_map(lambda x: x[j * b + lo:j * b + hi], full) for j in range(k)]

    def fetch(self, replay, idx):
        """This rank's rows of the batch at global slots ``idx`` (on the
        device)."""
        return self.gathered(self.fill(replay, idx), len(idx))[0]


class DeviceRing:
    """The fused trainers' replay ring on the device, mixed into a trainer
    that sets ``capacity``, ``device``, ``generator`` (a CPU generator),
    ``learner`` and ``replay = None``, ``_ptr = _size = 0``, and, to shard
    the ring over dp, ``ring_shard`` (a :class:`RingShard`); ``_ptr`` and
    ``_size`` count global slots."""

    ring_shard = None
    _fill = None                       # the sharded ring's fetch program (``_fetched``)

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
        idx = self._draw_sample().to(self.device)
        if self.ring_shard is not None:
            return self.ring_shard.fetch(self.replay, idx)
        return tree_map(lambda store: store[idx], self.replay)

    def _draw_sample(self):
        """A batch's ring slots [B], drawn on the host from ``generator``."""
        return torch.randint(0, self._size, (self.learner.batch_size,),
                             generator=self.generator)

    def _draw_rows(self, k):
        """``k`` batches' ring slots [k, B], drawn on the host in
        :meth:`sample_batch`'s order and copied to the device in one go."""
        rows = torch.stack([self._draw_sample() for _ in range(k)])
        if torch.device(self.device).type == "cuda":
            rows = rows.pin_memory()
        return rows.to(self.device, non_blocking=True)

    def _means(self, stats, losses=None):
        """Each stat's mean over the worlds (every rank's on a sharded ring),
        after the mean of ``losses`` as ``LossQ`` when given, brought to the
        host in one copy."""
        keys = (["LossQ"] if losses is not None else []) + list(stats)
        if self.ring_shard is None:
            means = torch.stack([v.mean() for v in stats.values()])
        else:
            sums = all_reduce(torch.stack([v.sum() for v in stats.values()]),
                              self.ring_shard.group)
            means = sums / (next(iter(stats.values())).numel() * self.ring_shard.dp)
        if losses is not None:
            means = torch.cat([losses.mean()[None], means])
        return dict(zip(keys, means.tolist()))

    # A program writes by slot index (a slice at the host's ``ptr`` would be
    # frozen into a captured graph): ``_claim`` keeps the books of a write of
    # ``n`` chunks as ``_write`` does and returns its slots, the program's
    # input, and ``_write_slots`` writes there. On a sharded ring the slots
    # are this rank's local ones and the books stay on the host
    # (``RingShard.record``); ``_fetched`` is the programs' ``sample_batch``.

    def _make_ring(self, layout):
        """The ring from ``layout``, a tree of ``(chunk shape, dtype)``: this
        rank's ``capacity / dp`` slots on a sharded ring."""
        dp = 1 if self.ring_shard is None else self.ring_shard.dp
        self.replay = tree_map(lambda spec: torch.zeros(
            (self.capacity // dp,) + tuple(spec[0]), dtype=spec[1], device=self.device), layout)

    def _claim(self, n):
        """The slots (int64, on the host) of a write of ``n`` chunks at
        ``ptr``: [n], or on a sharded ring this rank's local slots [n / dp]
        of its block (``ptr / dp + [0, n / dp)``); ``ptr`` and ``size``
        advance as ``_write``'s, in global slots."""
        if self._ptr + n > self.capacity:
            raise AssertionError("a ring write must not wrap")
        dp = 1 if self.ring_shard is None else self.ring_shard.dp
        slots = torch.arange(self._ptr // dp, (self._ptr + n) // dp)
        if self.ring_shard is not None:
            self.ring_shard.record(self._ptr, n)
        self._size = min(self._size + n, self.capacity)
        self._ptr = (self._ptr + n) % self.capacity
        return slots

    def _fetched(self, rows):
        """The batches at ring slots ``rows`` [k, B] (on the device) of a
        sharded ring, as :meth:`sample_batch` fetches them one by one: one
        fill program over all ``k B`` slots (``RingShard.fill``), then one
        all-reduce per dtype and this rank's rows of each batch
        (``RingShard.gathered``)."""
        if self._fill is None:
            self._fill = programs.Program(self._fill_body, self.device, name="ring fetch")
        return self.ring_shard.gathered(self._fill(rows), rows.shape[1])

    def _fill_body(self, rows):
        """The fetch's program: :meth:`RingShard.fill` of the flattened slots."""
        return self.ring_shard.fill(self.replay, rows.reshape(-1))

    def _write_slots(self, chunk, slots):
        """Write ``chunk`` (leaves [n, ...]) into the ring at ``slots`` [n]."""
        tree_map(lambda store, x: store.index_copy_(0, slots, x), self.replay, chunk)
