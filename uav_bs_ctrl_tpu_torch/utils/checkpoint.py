"""Read the JAX package's ``checkpoint_epoch{N}.pt`` pickles without JAX or optax.

A checkpoint pickles the parameter trees as nested dicts of numpy arrays, beside
optimizer state whose classes live in optax. The restricted unpickler resolves
numpy's array-rebuilding globals only and turns every other class into an inert
stub that keeps its constructor arguments (``args``, ``kwargs``) and pickled
``state``, so the checkpoint loads where optax is not installed, the optimizer
state can still be read (:func:`find_state`), and nothing in the file can name
a callable to run.
"""

import importlib
import pickle

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
