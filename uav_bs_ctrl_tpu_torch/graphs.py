"""Compiled device programs: the port of ``jax.jit`` with donated buffers.

The JAX package runs its update (``algos/core.py:113``), its fused iteration
(``algos/madrqn/fused.py:124-125``) and its test episode
(``algos/collect.py:117``) as jitted XLA programs: the host hands the device
one call and nothing else crosses the host boundary. On the card the
counterpart is a CUDA graph over static buffers: :class:`Program` captures a
function once per shape of its inputs and then replays it, after copying the
inputs into the buffers the graph reads.

A program draws nothing. Its caller makes every random draw the body consumes
before the replay, by the same generator calls in the same order as the eager
path, and passes the draws in as inputs; so a replay gives the eager call's
bits, and the generators end in the same state on both paths.

On a CPU device a program calls its function directly (the tests run the
bodies so). On a CUDA device the first call for a shape:

- runs the function once on a side stream, eagerly (the warm-up: kernels get
  built, lazily made state gets made), and that run is the call: its outputs
  are returned and its changes to the state stand;
- then captures the function into a ``torch.cuda.CUDAGraph`` with a private
  memory pool. A capture records the launches and runs none of them, so the
  state stays as the warm-up left it. A capture that fails raises: there is
  no eager fallback.

Every later call for that shape copies the inputs into the graph's static
buffers and replays the graph. So each call runs once on the card, as on the
eager path. A kernel wrapper counts the launches it makes, the warm-up's;
a replay passes no wrapper (``torch.profiler`` sees its kernels).

A replay returns the graph's own output tensors: the next replay of the same
shape overwrites them, so a caller that keeps an output clones it.
"""

import gc
import time
import weakref

import torch


def _flatten(tree):
    """``(leaves, spec)`` of a tree of dicts, lists, tuples (NamedTuples kept
    by their class, so that an env state comes back with its fields),
    tensors and None."""
    if isinstance(tree, dict):
        parts = [_flatten(v) for v in tree.values()]
        return [x for p in parts for x in p[0]], ("dict", tuple(tree), tuple(p[1] for p in parts))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        kind = type(tree) if hasattr(tree, "_fields") else type(tree).__name__
        return [x for p in parts for x in p[0]], (kind, tuple(p[1] for p in parts))
    if tree is None:
        return [], None
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"a program takes tensors, dicts, lists, tuples and None, "
                        f"not {type(tree).__name__}")
    return [tree], "tensor"


def _unflatten(leaves, spec):
    it = iter(leaves)

    def build(s):
        if s is None:
            return None
        if s == "tensor":
            return next(it)
        if s[0] == "dict":
            return {k: build(v) for k, v in zip(s[1], s[2])}
        items = [build(v) for v in s[1]]
        if isinstance(s[0], type):                   # a NamedTuple's class
            return s[0](*items)
        return items if s[0] == "list" else tuple(items)
    return build(spec)


class _Captured:
    """One shape's graph, the static inputs it reads and its outputs."""

    def __init__(self, graph, static, out, capture_s, pool_bytes):
        self.graph, self.static, self.out = graph, static, out
        self.capture_s, self.pool_bytes = capture_s, pool_bytes


class Program:
    """``fn(*inputs)`` as a program on ``device``: on a CPU device a direct
    call; on a CUDA device one captured graph per input shape, replayed.

    ``inputs`` are trees of tensors (dicts, lists, tuples, NamedTuples, None); a CPU input
    of a CUDA program is copied in from the host (pinned memory makes that
    copy asynchronous). ``extra`` are arguments fixed for the program, passed
    after the inputs. ``fn`` draws nothing and makes no host sync. It may be
    a bound method, held weakly so that a program kept by the method's
    object does not keep that object alive.
    """

    def __init__(self, fn, device, name=None, extra=()):
        self._fn = weakref.WeakMethod(fn) if hasattr(fn, "__self__") else (lambda: fn)
        self._extra = tuple(extra)
        self.device = torch.device(device)
        self.name = name or getattr(fn, "__name__", "program")
        self.captured = {}            # shape key -> _Captured

    @property
    def fn(self):
        fn = self._fn()
        if fn is None:
            raise RuntimeError(f"program {self.name}: its function's object is gone")
        return fn

    def __call__(self, *inputs):
        if self.device.type == "cpu":
            return self.fn(*inputs, *self._extra)
        leaves, spec = _flatten(inputs)
        key = (spec, tuple((tuple(x.shape), x.dtype) for x in leaves))
        cap = self.captured.get(key)
        if cap is None:
            out, self.captured[key] = self._first_call(leaves, spec)
            return out
        self._refill(cap, leaves)
        cap.graph.replay()
        return cap.out

    @staticmethod
    def _refill(cap, leaves):
        """Copy a call's inputs into the graph's static buffers."""
        for s, x in zip(cap.static, leaves):
            s.copy_(x, non_blocking=True)

    def _first_call(self, leaves, spec):
        """The call's eager run on a side stream, then the capture; returns
        the run's outputs and the captured graph."""
        static = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in leaves]
        for s, x in zip(static, leaves):
            s.copy_(x, non_blocking=True)
        args = _unflatten(static, spec)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self.fn(*args, *self._extra)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = self.fn(*args, *self._extra)
        capture_s = time.perf_counter() - t0
        pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        return out, _Captured(graph, static, captured, capture_s, pool_bytes)

    def drop(self):
        """Free every captured graph (and its memory pool, once no output of
        it is held elsewhere)."""
        self.captured.clear()

    def stats(self):
        """``{"graphs", "capture_s", "pool_bytes"}`` over the captured shapes."""
        caps = list(self.captured.values())
        return dict(graphs=len(caps), capture_s=sum(c.capture_s for c in caps),
                    pool_bytes=sum(c.pool_bytes for c in caps))


def clone_tree(tree):
    """A tree of tensors with each leaf cloned (a replay's outputs, kept)."""
    leaves, spec = _flatten(tree)
    return _unflatten([x.clone() for x in leaves], spec)
