"""Read and write the JAX package's ``checkpoint_epoch{N}.pt`` pickles without
JAX or optax.

A checkpoint pickles the parameter trees as nested dicts of numpy arrays, beside
optimizer state whose classes live in optax. The restricted unpickler resolves
numpy's array-rebuilding globals only and turns every other class into an inert
stub that keeps its constructor arguments (``args``, ``kwargs``) and pickled
``state``, so the checkpoint loads where optax is not installed, the optimizer
state can still be read (:func:`find_state`), and nothing in the file can name
a callable to run.

:func:`save` writes the same format. The three optax state classes of
``inject_hyperparams(adamw)`` are stood in for by tuple placeholders that the
writer names by optax's module and class, so the JAX package's loader rebuilds
optax's own NamedTuples from them while this package never imports optax.
"""

import importlib
import os
import pickle

import numpy as np

_NUMPY_GLOBALS = {"_reconstruct", "scalar", "ndarray", "dtype", "_frombuffer"}


class InertStub:
    """Stands in for any non-numpy class named in a checkpoint: it keeps what
    the pickle hands the class (an optax state is a NamedTuple, rebuilt from
    its fields) and has no behaviour."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.kwargs, obj.state = args, kwargs, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _NumpyOnlyUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "numpy" and name in _NUMPY_GLOBALS:
            try:
                return getattr(importlib.import_module(module), name)
            except ModuleNotFoundError:
                # A NumPy 2 pickle names numpy._core; NumPy 1 has numpy.core.
                alt = module.replace("numpy._core", "numpy.core", 1)
                return getattr(importlib.import_module(alt), name)
        return type(name, (InertStub,), {"__module__": module})


def load(path) -> dict:
    """The checkpoint dict at ``path``; non-numpy objects come back as stubs."""
    with open(path, "rb") as f:
        return _NumpyOnlyUnpickler(f).load()


def find_state(tree, class_name):
    """The first stub of class ``class_name`` in ``tree`` (stubs' args,
    tuples, lists and dict values, depth first); raises when there is none."""
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, InertStub):
            if type(node).__name__ == class_name:
                return node
            stack.extend(reversed(node.args))
        elif isinstance(node, (tuple, list)):
            stack.extend(reversed(node))
        elif isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
    raise KeyError(f"no {class_name} in the checkpoint's optimizer state")


class _OptaxState(tuple):
    """A tuple of fields that pickles as the optax NamedTuple of the same class
    name in module ``OPTAX_MODULE``, rebuilt from the fields as ``cls(*fields)``."""

    OPTAX_MODULE = None

    def __new__(cls, *fields):
        return super().__new__(cls, fields)

    def __reduce__(self):
        return type(self), tuple(self)


class InjectStatefulHyperparamsState(_OptaxState):
    """``(count, hyperparams, hyperparams_states, inner_state)``."""
    OPTAX_MODULE = "optax.schedules._inject"


class ScaleByAdamState(_OptaxState):
    """``(count, mu, nu)``."""
    OPTAX_MODULE = "optax._src.transform"


class EmptyState(_OptaxState):
    OPTAX_MODULE = "optax._src.base"


class _Writer(pickle._Pickler):
    """The pure-Python pickler (the C one cannot be told how to name a class)
    writing each placeholder class as a ``GLOBAL`` of its optax name."""

    def save_global(self, obj, name=None):
        if isinstance(obj, type) and issubclass(obj, _OptaxState):
            self.write(pickle.GLOBAL + f"{obj.OPTAX_MODULE}\n{obj.__name__}\n".encode())
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _to_numpy(tree):
    """Dicts, lists and tuples (placeholders keep their class) with every leaf
    as a numpy array, as the JAX writer's ``tree_map(np.asarray, ...)``."""
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, _OptaxState):
        return type(tree)(*map(_to_numpy, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(_to_numpy, tree))
    return np.asarray(tree)


def save(path, checkpoint: dict):
    """Write ``checkpoint`` (scalars, trees of arrays, optax placeholders) at
    ``path``, atomically through a temp file and ``os.replace``: the retry
    supervisor resumes from the newest checkpoint, so a crash mid-write must
    not leave a truncated one."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _Writer(f, pickle.DEFAULT_PROTOCOL).dump(_to_numpy(checkpoint))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path
