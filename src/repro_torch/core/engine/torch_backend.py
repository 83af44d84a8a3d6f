"""Torch execution backend: routes the engine's primitives through the
hand-written CUDA kernels in ``repro_torch.kernels``.

  * ``merge_runs`` and ``ingest_run`` -> K1 ``merge_pair``;
  * ``bloom_build`` -> K2, ``bloom_probe`` -> K5;
  * ``lookup_batch`` -> ``torch.searchsorted`` on the device.

Host bookkeeping stays numpy, so each primitive takes and returns numpy
arrays and moves its operands to ``device`` and back. Bloom filters stay
on the device for the life of their SSTable, as ``("torch", bool[128,
W])``. Keys and values are the engine's own int64 throughout. On a CPU
device every kernel wrapper runs its plain PyTorch version; that is the
only way a plain version is reached.

``launches`` is the kernel wrappers' own launch count (plain integers,
one per kernel, for the whole process). The fused read path
(``prepare_tier``/``lookup_fused``/``prepare_store``/``lookup_store_fused``)
needs the device page pool, which this package does not have yet: those
methods raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels._launch import LAUNCHES
from ...kernels.bloom import bloom as bloom_k
from ...kernels.merge import merge as merge_k
from .backend import (BLOOM_K_HASHES, ExecutionBackend, bloom_sizing,
                      register_backend)
from .numpy_backend import ingest_order

KERNELS = tuple(LAUNCHES)
_NO_FUSED = ("the fused read path needs the device page pool, which is "
             "not ported yet; keep device_pool_bytes=0")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA on a machine without a GPU
    (the store never carries on on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected 'cuda' "
                         f"or 'cpu'")
    return dev


class TorchBackend(ExecutionBackend):
    name = "torch"

    def __init__(self, *, device="cuda", k_hashes: int = BLOOM_K_HASHES):
        self.device = resolve_device(device)
        self.k_hashes = k_hashes
        self.launches = LAUNCHES

    def _to(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    # -- merge ---------------------------------------------------------------
    def merge_runs(self, runs):
        runs = [(np.asarray(k, np.int64), np.asarray(v, np.int64))
                for k, v in runs if len(k)]
        if not runs:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if len(runs) == 1:
            return runs[0]
        keys = self._to(np.concatenate([k for k, _ in runs]))
        vals = self._to(np.concatenate([v for _, v in runs]))
        keys, vals = merge_k.merge_runs(keys, vals, [len(k) for k, _ in runs])
        return keys.cpu().numpy(), vals.cpu().numpy()

    # -- write ingest --------------------------------------------------------
    def ingest_run(self, keys, vals):
        """Batch sort+dedup through K1: the canonical ingest order is
        computed on the host, the kernel merges the two halves of the
        ordered batch carrying batch positions, and values are gathered
        on the host from the surviving positions."""
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        if len(keys) == 0:
            return keys, vals, np.empty(0, np.int64)
        order = ingest_order(keys)
        ks, src = merge_k.ingest_run(self._to(keys[order]), self._to(order))
        src = src.cpu().numpy()
        return ks.cpu().numpy(), vals[src], src

    # -- bloom ---------------------------------------------------------------
    def bloom_build(self, keys):
        _, n_slots = bloom_sizing(len(keys))
        filt = bloom_k.bloom_build(self._to(keys), n_slots, self.k_hashes)
        return ("torch", filt)

    def bloom_probe(self, filt, keys):
        kind, f = filt
        if kind != "torch":
            raise TypeError(f"filter built by backend {kind!r}, not 'torch'")
        if len(keys) == 0:
            return np.zeros(0, bool)
        hit = bloom_k.bloom_probe(f, self._to(keys), self.k_hashes)
        return hit.cpu().numpy()

    # -- point lookups -------------------------------------------------------
    def lookup_batch(self, sorted_keys, queries):
        q = len(queries)
        n = len(sorted_keys)
        if q == 0:
            return np.zeros(0, np.int64), np.zeros(0, bool)
        if n == 0:
            return np.zeros(q, np.int64), np.zeros(q, bool)
        sk = self._to(sorted_keys)
        qk = self._to(queries)
        pos = torch.searchsorted(sk, qk)
        found = (pos < n) & (sk[pos.clamp(max=n - 1)] == qk)
        return pos.cpu().numpy(), found.cpu().numpy()

    # -- fused read path (device page pool: not in this package yet) ---------
    def prepare_tier(self, tables, bloom_fn):
        raise NotImplementedError(_NO_FUSED)

    def lookup_fused(self, view, queries):
        raise NotImplementedError(_NO_FUSED)

    def prepare_store(self, tiers, bloom_fn):
        raise NotImplementedError(_NO_FUSED)

    def lookup_store_fused(self, view, queries):
        raise NotImplementedError(_NO_FUSED)


register_backend("torch", TorchBackend)
