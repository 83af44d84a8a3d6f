"""K4 and K3: the fused read path over a device-resident view
(``csrc/lookup.cu``).

A ``View`` is one lookup tier (R = 1), or every lookup tier of a tree
stacked tier-major, prepared once for the kernels:

  * ``keys``/``vals`` -- int64 ``[N]``: the tables' runs concatenated; each
    tier's segment is sorted (its tables are disjoint and min_key-ordered);
  * ``fbits`` -- bool ``[S]``: the tables' Bloom filters concatenated flat;
  * ``meta`` -- int64 ``[6 T + R + 1]``: per table (rows of ``META_ROWS``)
    its first slot in ``fbits`` and its slot count, its run's offset in
    ``keys`` and its length, its min_key and max_key; then ``t_off``,
    each tier's first table and T. It reaches the device in one copy.

The view is checked when it is made; a lookup checks only its queries.
Per (tier, query) the kernels assign the query its covering table of the
tier (``ti``, clipped into the tier, and ``ok``: exactly the host's
``assign_bounds``) and compute, from that table alone, ``positive`` (all
k Bloom slots set, with the table's own slot count as the modulus, the
hash math of ``kernels.bloom``), ``pos`` (the lower bound of the query in
the table's run, relative to the run), ``hit`` and ``val`` (0 where no
hit); K3 also ``win``, the lowest (newest) tier rank with a hit or -1.

Both return one int64 buffer of ``out_words(R, K, store)`` words
(``unpack``): val int64 ``[R, K]``, pos and ti int32 ``[R, K]``, win
int32 ``[K]`` (K3 only), then one byte a pair for each of positive, hit
and ok. On CUDA tensors the wrappers launch the kernels; on CPU tensors
they run the plain versions beside them.

``probe_host`` is the engine's call: the queries go in through a
grow-only pinned buffer, one launch, and one copy back into pinned host
memory, all in one call of the C entry.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import build
from .._launch import count, expect, on_card, stream_of
from ..bloom.bloom import bloom_slots_plain

META_ROWS = ("f_offs", "nslots", "offs", "lens", "starts", "ends")
# lookup.cu's kMaxHashes: the most Bloom hashes a probe takes.
MAX_HASHES = 16


class View:
    """The tensors of a view and what the kernels need of them, checked
    once: ``tables`` is host int64 ``[6, T]`` (``META_ROWS``), ``t_off``
    host int64 ``[R + 1]`` (0, each later tier's first table, T). The
    metadata goes to the keys' device in one copy."""

    def __init__(self, keys, vals, fbits, tables, t_off):
        tables = np.ascontiguousarray(tables, np.int64)
        t_off = np.ascontiguousarray(t_off, np.int64)
        expect(keys, "keys", torch.int64)
        expect(vals, "vals", torch.int64)
        expect(fbits, "fbits", torch.bool)
        self.on_card = on_card(keys, vals, fbits)
        N, S = len(keys), len(fbits)
        if len(vals) != N:
            raise ValueError(f"keys has {N} entries, vals {len(vals)}")
        if N >= 2**31:
            raise ValueError(f"{N} entries: runs must stay below 2**31")
        if tables.ndim != 2 or tables.shape[0] != len(META_ROWS):
            raise ValueError(f"tables: expected [{len(META_ROWS)}, T], got "
                             f"{tables.shape}")
        T, R = tables.shape[1], len(t_off) - 1
        f_offs, nslots, offs, lens = tables[:4]
        if R < 1 or t_off[0] != 0 or t_off[-1] != T \
                or (np.diff(t_off) < 1).any():
            raise ValueError(f"t_off {t_off.tolist()}: every tier needs a "
                             f"table and the tiers must cover all {T}")
        if (lens < 1).any() or (offs < 0).any() or (offs + lens > N).any():
            raise ValueError("a table's run is empty or outside keys")
        if (nslots < 1).any() or (nslots >= 2**31).any() \
                or (f_offs < 0).any() or (f_offs + nslots > S).any():
            raise ValueError("a table's filter is empty or outside fbits")
        self.keys, self.vals, self.fbits = keys, vals, fbits
        self.device = keys.device
        self.n_tables, self.n_tiers = T, R
        self.meta = torch.from_numpy(
            np.concatenate([tables.reshape(-1), t_off])).to(self.device)
        for r, name in enumerate(META_ROWS):
            setattr(self, name, self.meta[r * T:(r + 1) * T])
        self.t_off = self.meta[6 * T:]
        # The C entries' descriptor: keys, vals, fbits, meta, T, R.
        self.desc = np.array([keys.data_ptr(), vals.data_ptr(),
                              fbits.data_ptr(), self.meta.data_ptr(), T, R],
                             np.int64)
        self.desc_ptr = self.desc.ctypes.data

    @property
    def nbytes(self) -> int:
        """Device bytes held by the view's tensors."""
        return (self.keys.nbytes + self.vals.nbytes + self.fbits.nbytes
                + self.meta.nbytes)


# --------------------------- output layout -----------------------------------
# Fields of the output in order: name, bytes an element, per pair (else
# per query), torch and numpy types; the flags are bytes read as bool.
_LAYOUT = (("vals", 8, True, torch.int64, np.int64),
           ("pos", 4, True, torch.int32, np.int32),
           ("ti", 4, True, torch.int32, np.int32),
           ("win", 4, False, torch.int32, np.int32),
           ("positive", 1, True, torch.bool, np.bool_),
           ("hit", 1, True, torch.bool, np.bool_),
           ("ok", 1, True, torch.bool, np.bool_))


def out_bytes(R: int, K: int, store: bool) -> int:
    """Bytes of the fields of a lookup of R tiers and K queries: 19 a
    (tier, query) pair, and 4 a query for K3's winner."""
    return 19 * R * K + (4 * K if store else 0)


def out_words(R: int, K: int, store: bool) -> int:
    """Length of the int64 output buffer."""
    return (out_bytes(R, K, store) + 7) // 8


def unpack(out, R: int, K: int, store: bool) -> dict:
    """Views of each field of an output buffer ``out`` (a torch tensor or
    a numpy array), ``[R, K]`` or (``win``) ``[K]``; the flags as bool."""
    numpy = isinstance(out, np.ndarray)
    raw = out if numpy else out.view(torch.uint8)
    fields, at = {}, 0
    for name, width, pairs, tt, nt in _LAYOUT:
        if name == "win" and not store:
            continue
        shape, n = ((R, K), R * K) if pairs else ((K,), K)
        fields[name] = (np.ndarray(shape, nt, raw, at) if numpy else
                        raw[at:at + width * n].view(tt).reshape(shape))
        at += width * n
    return fields


# --------------------------- plain versions ----------------------------------
def _fields_plain(view, q, gti, seg_pos, k_hashes: int):
    """positive, pos, hit, val of each query against global table ``gti``
    (same shape as ``q``), given its lower bound ``seg_pos`` in the sorted
    segment of its tier."""
    keys = view.keys
    slots = bloom_slots_plain(q, view.nslots[gti], k_hashes)
    positive = view.fbits[view.f_offs[gti][..., None] + slots].all(dim=-1)
    lo = view.offs[gti]
    ln = view.lens[gti]
    abs_pos = torch.minimum(torch.maximum(seg_pos, lo), lo + ln)
    pos = abs_pos - lo
    safe = abs_pos.clamp(max=len(keys) - 1)
    hit = (pos < ln) & (keys[safe] == q)
    val = torch.where(hit, view.vals[safe], torch.zeros_like(safe))
    return positive, pos, hit, val


def _probe_plain(view, q, k_hashes: int, store: bool):
    """Plain version of both kernels: per tier, the covering table by
    ``searchsorted`` over the tier's starts (``assign_bounds``), the lower
    bound by ``searchsorted`` in the tier's sorted segment clipped to the
    table's run; then the winner. Padding bytes are zero."""
    R, K = view.n_tiers, len(q)
    out = torch.zeros(out_words(R, K, store), dtype=torch.int64,
                      device=q.device)
    f = unpack(out, R, K, store)
    t_off = view.t_off.tolist()
    offs, lens = view.offs.tolist(), view.lens.tolist()
    for r in range(R):
        a, b = t_off[r], t_off[r + 1]
        ti = torch.searchsorted(view.starts[a:b], q, right=True) - 1
        ok = ti >= 0
        ti = ti.clamp(0, b - a - 1)
        ok &= q <= view.ends[a + ti]
        e0, e1 = offs[a], offs[b - 1] + lens[b - 1]
        seg_pos = e0 + torch.searchsorted(view.keys[e0:e1], q)
        positive, pos, hit, val = _fields_plain(view, q, a + ti, seg_pos,
                                                k_hashes)
        for name, x in (("vals", val), ("pos", pos), ("ti", ti),
                        ("positive", positive), ("hit", hit), ("ok", ok)):
            f[name][r] = x
    if store:
        rank = torch.arange(R, dtype=torch.int32, device=q.device)[:, None]
        win = torch.where(f["hit"], rank, R).min(dim=0).values
        f["win"].copy_(torch.where(win == R, -1, win))
    return out


def probe_tier_plain(view, q, k_hashes: int):
    """Plain version of K4."""
    return _probe_plain(view, q, k_hashes, store=False)


def probe_store_plain(view, q, k_hashes: int):
    """Plain version of K3."""
    return _probe_plain(view, q, k_hashes, store=True)


# --------------------------- wrappers ----------------------------------------
def _probe(view, q, k_hashes: int, store: bool, out):
    expect(q, "q", torch.int64)
    if q.device != view.device:
        raise ValueError(f"q lies on {q.device}, the view on {view.device}")
    if not 1 <= k_hashes <= MAX_HASHES:
        raise ValueError(f"k_hashes {k_hashes} outside [1, {MAX_HASHES}]")
    if not store and view.n_tiers != 1:
        raise ValueError(f"probe_tier takes a one-tier view, not one of "
                         f"{view.n_tiers} tiers")
    if not view.on_card:
        return _probe_plain(view, q, k_hashes, store)
    K = len(q)
    words = out_words(view.n_tiers, K, store)
    if out is None:
        out = torch.empty(words, dtype=torch.int64, device=q.device)
    else:
        expect(out, "out", torch.int64)
        if len(out) < words or out.device != q.device:
            raise ValueError(f"out: {len(out)} words on {out.device}, not "
                             f"{words} on {q.device}")
    if K == 0:
        return out
    launch(store, view, q.data_ptr(), K, k_hashes, out.data_ptr())
    return out


def launch(store: bool, view, q: int, n: int, k_hashes: int, out: int,
           q_host=None, out_host=None) -> None:
    """Launch K3 (``store``) or K4 on checked arguments and count it:
    ``n`` queries at device address ``q``, the fields to device
    address ``out``. With ``q_host`` (a pinned host address) the C entry
    first copies the queries from there; with ``out_host`` it copies the
    fields back there and synchronises the stream."""
    name = "probe_store" if store else "probe_tier"
    rc = getattr(build.library(), name)(
        view.desc_ptr, k_hashes, q, n, out, stream_of(view.keys), q_host,
        out_host)
    build.check(rc, name)
    count(name)


def probe_tier(view, q, k_hashes: int, out=None):
    """Fused probe of int64 queries ``q`` [K] against a one-tier view.
    Returns int64 ``[out_words(1, K, False)]`` (``unpack``), in ``out``
    when given."""
    return _probe(view, q, k_hashes, False, out)


def probe_store(view, q, k_hashes: int, out=None):
    """Fused probe of int64 queries ``q`` [K] against every tier of a
    store view, and the winner. Returns int64 ``[out_words(R, K, True)]``
    (``unpack``), in ``out`` when given."""
    return _probe(view, q, k_hashes, True, out)


# --------------------------- the engine's call -------------------------------
def probe_host(view, queries, k_hashes: int, staging, store: bool) -> dict:
    """K4 (or K3 with ``store``) over host int64 ``queries``. On the card
    it is one C call: the queries copied in from the pinned staging buffer
    (``merge.Staging``) to its device buffer, one launch, the fields
    copied back into pinned host memory that the result owns, and one
    synchronisation. Returns numpy views of the fields (``unpack``)."""
    K, R = len(queries), view.n_tiers
    if not view.on_card or K == 0:
        q = torch.from_numpy(np.ascontiguousarray(queries, np.int64))
        out = _probe(view, q.to(view.device), k_hashes, store, None)
        return unpack(out.cpu().numpy(), R, K, store)
    w = out_words(R, K, store)
    buf, host = staging.take(K)
    host[:K] = queries
    dev = staging.take_device(K + w).data_ptr()
    res = torch.empty(w, dtype=torch.int64, pin_memory=True)
    launch(store, view, dev, K, k_hashes, dev + 8 * K, buf.data_ptr(),
           res.data_ptr())
    return unpack(res.numpy(), R, K, store)
