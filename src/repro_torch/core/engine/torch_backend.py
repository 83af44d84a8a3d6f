"""Torch execution backend: routes the engine's primitives through the
hand-written CUDA kernels in ``repro_torch.kernels``.

  * ``merge_runs`` and ``ingest_run`` -> K1's k-run form, one launch a
    call;
  * ``bloom_build`` -> K2, ``bloom_probe`` and ``bloom_probe_tier`` (the
    staged read path's Bloom gate of a whole tier) -> K5;
  * ``lookup_batch`` -> ``torch.searchsorted`` on the device;
  * ``lookup_fused`` -> K4 ``probe_tier``, ``lookup_store_fused`` -> K3
    ``probe_store``, over the device-resident views that ``prepare_tier``
    and ``prepare_store`` build.

Host bookkeeping stays numpy, so each primitive takes and returns numpy
arrays and moves its operands to ``device`` and back. Bloom filters stay
on the device for the life of their SSTable, as ``("torch", bool[128,
W])``. Keys and values are the engine's own int64 throughout, so no view
is ever refused. On a CPU device every kernel wrapper runs its plain
PyTorch version; that is the only way a plain version is reached.

``launches`` is the kernel wrappers' own launch count (plain integers,
one per kernel, for the whole process, each added to under one lock).

Threads. With ``maintenance_workers > 0`` the worker pool's threads call
``merge_runs`` and ``bloom_build`` on the same backend while the
foreground calls ``ingest_run``, ``merge_runs`` and the read primitives.
Three things keep that exact:

  * every thread packs its runs into staging buffers of its own
    (``_staging``, one ``merge_k.Staging`` per thread), so a worker's
    merge and the foreground's ingest never overwrite each other's
    packed input or result, and a grow never replaces a buffer another
    thread is still copying from;
  * ``merge_runs``, ``ingest_run`` and ``bloom_build`` make the
    backend's device the calling thread's current device (``_on_device``)
    and launch on that thread's current stream. The pool's threads set
    no stream, so their launches go to the device's default stream, as
    the foreground's do (the store sets none). K1's result comes back
    through a synchronous copy, so a merge handed across threads is a
    numpy array. A worker's filter is a device tensor, and the pool's
    ``take`` returns it only after ``bloom_build`` returned, that is
    after K2 was enqueued; the foreground's K5 is enqueued later on the
    same stream, so the stream runs it after K2, and the allocator, which
    tracks blocks per stream, never hands the filter's memory out while
    K5 may read it;
  * the launch counts are added to under one lock
    (``kernels._launch.count``).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ...kernels._launch import LAUNCHES
from ...kernels.bloom import bloom as bloom_k
from ...kernels.lookup import lookup as lookup_k
from ...kernels.merge import merge as merge_k
from .backend import (BLOOM_K_HASHES, ExecutionBackend, FusedLookup,
                      StoreLookup, StoreView, TierView, bloom_sizing,
                      register_backend)
from .numpy_backend import ingest_order

KERNELS = tuple(LAUNCHES)


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
        # The CUDA device index every thread sets before it launches (a
        # worker thread starts on device 0, whatever the foreground set).
        self._index = None
        if self.device.type == "cuda":
            self._index = (self.device.index if self.device.index is not None
                           else torch.cuda.current_device())
        self._local = threading.local()

    @property
    def _staging(self) -> merge_k.Staging:
        """The calling thread's staging buffers (see the module's
        docstring, Threads)."""
        st = getattr(self._local, "staging", None)
        if st is None:
            st = self._local.staging = merge_k.Staging(self.device)
        return st

    def _on_device(self):
        """Make the backend's device current in the calling thread for
        the span of one primitive (nothing to do on the CPU)."""
        if self._index is None:
            return contextlib.nullcontext()
        return torch.cuda.device(self._index)

    def _to(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(
            self.device)

    # -- merge ---------------------------------------------------------------
    def merge_runs(self, runs):
        """K1's k-run form: one copy in, one launch and one copy back
        whatever the number of runs (``merge_k.merge_runs_host``)."""
        runs = [(np.asarray(k, np.int64), np.asarray(v, np.int64))
                for k, v in runs if len(k)]
        if not runs:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if len(runs) == 1:
            return runs[0]
        with self._on_device():
            return merge_k.merge_runs_host(runs, self.device, self._staging)

    # -- write ingest --------------------------------------------------------
    def ingest_run(self, keys, vals):
        """Batch sort+dedup through K1: the canonical ingest order is
        computed on the host, one K1 call merges the two halves of the
        ordered batch carrying batch positions, and values are gathered
        on the host from the surviving positions."""
        keys = np.asarray(keys, np.int64)
        vals = np.asarray(vals, np.int64)
        if len(keys) == 0:
            return keys, vals, np.empty(0, np.int64)
        order = ingest_order(keys)
        ordered, h = keys[order], len(keys) // 2
        with self._on_device():
            ks, src = merge_k.merge_runs_host(
                [(ordered[:h], order[:h]), (ordered[h:], order[h:])],
                self.device, self._staging)
        return ks, vals[src], src

    # -- bloom ---------------------------------------------------------------
    def bloom_build(self, keys):
        _, n_slots = bloom_sizing(len(keys))
        with self._on_device():
            filt = bloom_k.bloom_build(self._to(keys), n_slots,
                                       self.k_hashes)
        return ("torch", filt)

    @staticmethod
    def _filter(filt) -> torch.Tensor:
        kind, f = filt
        if kind != "torch":
            raise TypeError(f"filter built by backend {kind!r}, not 'torch'")
        return f

    def bloom_probe(self, filt, keys):
        f = self._filter(filt)
        if len(keys) == 0:
            return np.zeros(0, bool)
        hit = bloom_k.bloom_probe(f, self._to(keys), self.k_hashes)
        return hit.cpu().numpy()

    def bloom_probe_tier(self, filts, keys, tidx):
        """K5's tier form: one launch for every table a batch reaches in a
        tier. The wrapper sends queries, table indices and the filters'
        addresses and slot counts to the card in one copy; the mask comes
        back in one."""
        if len(keys) == 0:
            return np.zeros(0, bool)
        hit = bloom_k.bloom_probe_tier(
            [self._filter(f) for f in filts],
            torch.from_numpy(np.ascontiguousarray(keys, np.int64)),
            torch.from_numpy(np.ascontiguousarray(tidx, np.int64)),
            self.k_hashes)
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

    # -- fused read path over device-resident views --------------------------
    def _view_payload(self, tables, lens, t_off, bloom_fn):
        """The ``lookup.View`` over ``tables`` (tier-major for a store;
        ``t_off`` [R + 1] each tier's first table, then T): the key and
        value runs concatenated, the filters as one flat bool concatenation
        (``torch.cat`` of the device-resident filters), and per table its
        slot offset, slot count, run offset, run length, min_key and
        max_key (``lookup.META_ROWS``). One host-to-device copy per run
        array, the per-table ones and ``t_off`` in one."""
        filts = [self._filter(bloom_fn(t)).reshape(-1) for t in tables]
        nslots = np.array([f.numel() for f in filts], np.int64)
        meta = np.stack([np.cumsum(nslots) - nslots, nslots,
                         np.cumsum(lens) - lens, lens,
                         [t.min_key for t in tables],
                         [t.max_key for t in tables]])
        return lookup_k.View(
            self._to(np.concatenate([t.keys for t in tables])),
            self._to(np.concatenate([t.vals for t in tables])),
            torch.cat(filts), meta, t_off)

    def prepare_tier(self, tables, bloom_fn):
        lens = np.array([t.num_entries for t in tables], np.int64)
        return TierView(
            backend=self.name,
            sst_ids=tuple(t.sst_id for t in tables),
            starts=np.array([t.min_key for t in tables], np.int64),
            ends=np.array([t.max_key for t in tables], np.int64),
            offs=np.cumsum(lens) - lens, lens=lens,
            payload=self._view_payload(tables, lens, [0, len(tables)],
                                       bloom_fn))

    def lookup_fused(self, view, queries):
        """K4: one launch for the whole tier, assignment included; the
        queries go to the card in one copy and the fields come back in
        one (``lookup.probe_host``). ``pos`` and ``ti`` come back as
        int32 and are widened here."""
        f = lookup_k.probe_host(view.payload, np.asarray(queries, np.int64),
                                self.k_hashes, self._staging, store=False)
        return FusedLookup(ti=f["ti"][0].astype(np.int64), ok=f["ok"][0],
                           positive=f["positive"][0],
                           pos=f["pos"][0].astype(np.int64),
                           hit=f["hit"][0], vals=f["vals"][0])

    def prepare_store(self, tiers, bloom_fn):
        tables = [t for tier in tiers for t in tier]
        counts = np.array([len(tier) for tier in tiers], np.int64)
        t_off = np.cumsum(counts) - counts
        lens = np.array([t.num_entries for t in tables], np.int64)
        offs = np.cumsum(lens) - lens
        payload = None
        if tables:
            payload = self._view_payload(tables, lens,
                                         np.append(t_off, len(tables)),
                                         bloom_fn)
        return StoreView(
            backend=self.name,
            key=tuple(tuple(t.sst_id for t in tier) for tier in tiers),
            tier_starts=tuple(np.array([t.min_key for t in tier], np.int64)
                              for tier in tiers),
            tier_ends=tuple(np.array([t.max_key for t in tier], np.int64)
                            for tier in tiers),
            tier_offs=tuple(offs[t_off[r]:t_off[r] + counts[r]]
                            for r in range(len(tiers))),
            tier_lens=tuple(lens[t_off[r]:t_off[r] + counts[r]]
                            for r in range(len(tiers))),
            payload=payload)

    def lookup_store_fused(self, view, queries):
        """K3: one launch for every tier of the store, assignment and
        newest-wins winner included, one copy in and one back
        (``lookup.probe_host``). ``R == 0`` returns the empty lookup
        without a launch."""
        q = np.asarray(queries, np.int64)
        R, K = view.num_tiers, len(q)
        if R == 0:
            return StoreLookup(
                ti=np.zeros((0, K), np.int64), ok=np.zeros((0, K), bool),
                positive=np.zeros((0, K), bool),
                pos=np.zeros((0, K), np.int64), hit=np.zeros((0, K), bool),
                vals=np.zeros((0, K), np.int64),
                win=np.full(K, -1, np.int64))
        f = lookup_k.probe_host(view.payload, q, self.k_hashes,
                                self._staging, store=True)
        return StoreLookup(ti=f["ti"].astype(np.int64), ok=f["ok"],
                           positive=f["positive"],
                           pos=f["pos"].astype(np.int64), hit=f["hit"],
                           vals=f["vals"], win=f["win"].astype(np.int64))


register_backend("torch", TorchBackend)
