"""Parameter specs: one tree of ``P(shape, axes)`` leaves (nested dicts and
lists) drives parameter and cache creation, as in the reference
(``repro.models.params``).

``init_params`` draws every normal leaf from one ``torch.Generator`` in
the tree's order. The reference folds ``hash()`` of each leaf's path into
its key, and Python salts string hashes per process, so its weights
cannot be re-derived: weights are carried across from the reference with
``params_from_reference`` instead, which keeps the reference's names,
nesting and stacked ``[n_super, ...]`` layout, and the optimizer state
with ``opt_state_from_reference``.

``flatten`` lists a tree's leaves in JAX's order (dict keys sorted, lists
and tuples in order), which numbers the leaves of a checkpoint
(``runtime/checkpoint.py``) as the reference numbers them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class P:
    shape: tuple
    axes: tuple                     # logical axis names (len == len(shape))
    init: str = "normal"            # normal | zeros | ones
    scale: float = 1.0              # stddev for normal init
    dtype: str = ""                 # "" -> model param dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in length")


def tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def unstack(tree, n: int) -> list:
    """``n`` trees, the i-th holding slice i of each leaf's first dim (one
    ``unbind`` a leaf)."""
    if isinstance(tree, dict):
        parts = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [unstack(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree.unbind(0))


def flatten(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples in JAX's flatten
    order: dict keys sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(like, leaves_in_order) -> object:
    """A tree shaped as ``like`` whose leaves are ``leaves_in_order``,
    taken in ``flatten``'s order."""
    it = iter(leaves_in_order)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def num_params(tree) -> int:
    """Elements over the ``P`` leaves of a spec tree."""
    return sum(int(np.prod(s.shape)) for s in leaves(tree))


def init_params(tree, generator: torch.Generator,
                default_dtype: str = "float32", device="cuda"):
    """Materialise a spec tree on ``device``: zeros, ones, or normal draws
    times ``scale`` made in f32 from ``generator`` (which must live on
    ``device``) and cast to the leaf's dtype."""
    def one(spec: P):
        dt = getattr(torch, spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * spec.scale).to(dt)

    return tree_map(one, tree)


def params_from_reference(tree, device="cpu"):
    """The reference's param tree with numpy leaves (``jax.tree.map(
    np.asarray, params)``) as torch tensors on ``device``: same names,
    nesting and dtypes."""
    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":      # ml_dtypes: exact through f32
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)

    return tree_map(one, tree)


def opt_state_from_reference(tree, device="cpu"):
    """The reference's AdamW state (``{"m", "v", "step"}`` and, when params
    are not f32, ``"master"``; numpy leaves) as torch tensors on
    ``device``: ``m``, ``v`` and ``master`` as ``params_from_reference``
    carries params, ``step`` as a 0-d int32 tensor."""
    extra = set(tree) - {"m", "v", "step", "master"}
    if extra or not {"m", "v", "step"} <= set(tree):
        raise ValueError(f"not an AdamW state: keys {sorted(tree)}")
    out = {k: params_from_reference(tree[k], device)
           for k in tree if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out
