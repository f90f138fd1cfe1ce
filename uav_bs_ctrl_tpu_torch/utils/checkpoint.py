"""Read the JAX package's ``checkpoint_epoch{N}.pt`` pickles without JAX or optax.

A checkpoint pickles the parameter trees as nested dicts of numpy arrays, beside
optimizer state whose classes live in optax. The restricted unpickler resolves
numpy's array-rebuilding globals only and turns every other class into an inert
stub, so ``model_state_dict`` loads where optax is not installed, and nothing
in the file can name a callable to run.
"""

import importlib
import pickle

_NUMPY_GLOBALS = {"_reconstruct", "scalar", "ndarray", "dtype", "_frombuffer"}


class InertStub:
    """Stands in for any non-numpy class named in a checkpoint."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


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
