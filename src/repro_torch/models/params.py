"""Parameter specs: one tree of ``P(shape, axes)`` leaves (nested dicts and
lists) drives parameter and cache creation, as in the reference
(``repro.models.params``).

``init_params`` draws every normal leaf from one ``torch.Generator`` in
the tree's order. The reference folds ``hash()`` of each leaf's path into
its key, and Python salts string hashes per process, so its weights
cannot be re-derived: weights are carried across from the reference with
``params_from_reference`` instead, which keeps the reference's names,
nesting and stacked ``[n_super, ...]`` layout.
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
