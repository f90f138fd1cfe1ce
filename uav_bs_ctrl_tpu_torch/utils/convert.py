"""Carry a JAX parameter tree into a port module and back, leaf by leaf.

The port keeps the JAX layout (``[in, out]`` weights under the same names), so
a tree's dotted paths are the module's ``state_dict`` keys and no leaf is
transposed.
"""

import numpy as np
import torch


def flatten(tree, prefix="") -> dict:
    """``{"enc.seen.fc_src.w": leaf, ...}`` for nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    flat = {}
    for key, sub in items:
        flat.update(flatten(sub, f"{prefix}.{key}" if prefix else str(key)))
    return flat


def params_from_jax(tree, module: torch.nn.Module) -> dict:
    """A ``state_dict`` for ``module`` from a JAX parameter tree of numpy arrays.

    Raises on a leaf the module has no parameter for, on a parameter no leaf
    fills, and on a shape mismatch.
    """
    flat = flatten(tree)
    own = module.state_dict()
    unused = sorted(flat.keys() - own.keys())
    missing = sorted(own.keys() - flat.keys())
    if unused or missing:
        raise KeyError(f"JAX tree and module disagree: leaves without a parameter "
                       f"{unused}, parameters without a leaf {missing}")
    out = {}
    for key, target in own.items():
        leaf = np.asarray(flat[key], dtype=np.float32)
        if tuple(leaf.shape) != tuple(target.shape):
            raise ValueError(f"{key}: JAX leaf has shape {leaf.shape}, parameter "
                             f"{tuple(target.shape)}")
        out[key] = torch.from_numpy(leaf.copy())
    return out


def learner_params_from_jax(tree, net: torch.nn.Module, mixer=None) -> dict:
    """``{"net": state_dict[, "mixer": state_dict]}`` from a JAX learner tree
    ``{"net": ..., "mixer": ...}`` (the mixer only when the learner has one)."""
    if (mixer is None) != ("mixer" not in tree):
        raise KeyError(f"the JAX tree has {sorted(tree)}, the learner "
                       f"{'has no' if mixer is None else 'has a'} mixer")
    out = {"net": params_from_jax(tree["net"], net)}
    if mixer is not None:
        out["mixer"] = params_from_jax(tree["mixer"], mixer)
    return out


def unflatten(flat: dict):
    """The inverse of :func:`flatten`: nested dicts from dotted keys, with a
    level whose keys are ``0 .. n-1`` as a list (an MLP's ``layers``)."""
    tree = {}
    for key, leaf in flat.items():
        node = tree
        *path, last = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and set(node) == {str(i) for i in range(len(node))}:
            return [node[str(i)] for i in range(len(node))]
        return node
    return listify(tree)


def params_to_jax(state_dict: dict):
    """A JAX parameter tree of float32 numpy arrays from a ``state_dict`` (or
    any ``{dotted name: tensor}``): the inverse of :func:`params_from_jax`."""
    return unflatten({k: v.detach().cpu().numpy().astype(np.float32, copy=True)
                      for k, v in state_dict.items()})


def learner_params_to_jax(state: dict) -> dict:
    """A JAX learner tree ``{"net": ...[, "mixer": ...]}`` from
    ``{"net": state_dict[, "mixer": state_dict]}``: the inverse of
    :func:`learner_params_from_jax`."""
    return {group: params_to_jax(sd) for group, sd in state.items()}
