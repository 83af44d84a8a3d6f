"""Float32 arithmetic as XLA's CPU backend compiles the reference's jitted
tuner math, so the port's tuner reproduces it bit for bit.

The reference runs its derivatives, fit and cost model in float32
(``jax_enable_x64`` is off) through ``jax.jit`` on the CPU. XLA lowers
them to LLVM with three properties a plain float32 port would miss:

* multiplies feeding an add are contracted to fused multiply-adds
  (``fma32``);
* ``log`` is XLA's own polynomial (Cephes ``logf``, evaluated as below),
  not libm's, so ``torch.log`` and ``np.log`` differ from it in about 3%
  of inputs (``log32``);
* a sum is a loop whose order XLA and LLVM choose by K: a scalar loop
  from 0 for short sums; for a fused ``sum(a * b)`` of 13-32 terms, a
  vectorised loop whose layout depends on the computation (the plan
  tables below); above 32 terms, windows of 32 (the input padded evenly
  on both sides) summed first, then the windows (``sum32``,
  ``dot_sum32``).

Everything here is numpy float32 on the host: the tuner handles vectors
of K floats once per tuning cycle.

The log's constants and the plan tables were read from the IR that jax
and jaxlib 0.9.0 emit on an x86-64 host with AVX-512 (avx512f, bw, dq,
vl), where XLA:CPU compiles for the host's features with
``"prefer-vector-width"="256"`` (8 float32 lanes). LLVM picks its
layouts per target, so another jax version or an x86-64 host without
AVX-512, or an ARM host, may lay a sum out differently;
``tests/test_torch_tuner.py`` holds every K from 1 to 100 against XLA and
shows it.
"""
from __future__ import annotations

import struct

import numpy as np

F32 = np.float32

# XLA's tree-reduction rewriter splits a reduction longer than this into
# windows of this many elements.
REDUCE_WINDOW = 32


def _hexf(h: str) -> np.float32:
    """A float32 constant as LLVM IR prints it (a double's hex bits)."""
    return F32(struct.unpack(">d", bytes.fromhex(h))[0])


_LOG_P = [_hexf(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000",
    "BFBFCBA9E0000000", "3FC23D37E0000000", "BFC555CA00000000",
    "3FC999D580000000", "BFCFFFFF80000000", "3FD5555540000000")]
_SQRTHF = _hexf("3FE6A09E60000000")
_LOG_Q1 = _hexf("BF2BD01060000000")       # -2.12194440e-4
_LOG_Q2 = _hexf("3FE6300000000000")       # 0.693359375
_FLT_MIN = _hexf("3810000000000000")


def f32(v) -> np.ndarray:
    """float64 (or Python) values rounded to float32, as ``jnp.asarray(v,
    jnp.float32)`` rounds them."""
    return np.asarray(v, np.float64).astype(F32)


def fma32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 ``a * b + c`` (one rounding).

    The product of two float32 values is exact in float64; the float64
    sum is then rounded to odd (its error from the two-sum folded into the
    last bit), and round-to-odd at 53 bits followed by round-to-nearest at
    24 bits is a single correct rounding."""
    a = np.asarray(a, F32).astype(np.float64)
    b = np.asarray(b, F32).astype(np.float64)
    c = np.asarray(c, F32).astype(np.float64)
    p = a * b
    s = np.atleast_1d(p + c)
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact = (err != 0) & np.isfinite(s)
    if inexact.any():
        trunc = np.where(np.sign(err) == np.sign(s), s, np.nextafter(s, 0.0))
        odd = (trunc.view(np.int64) | 1).view(np.float64)
        s = np.where(inexact, odd, s)
    return s.astype(F32).reshape(np.shape(p))


def log32(x) -> np.ndarray:
    """Natural log as XLA:CPU emits it for float32 (Cephes ``logf`` with
    the multiply-adds it contracts; subnormal inputs read as zero, as
    XLA's CPU runtime sets denormals-are-zero)."""
    with np.errstate(all="ignore"):
        x = np.asarray(x, F32)
        x = np.where(np.abs(x) < _FLT_MIN, F32(0), x).astype(F32)
        xc = np.where(np.isnan(x) | (x <= _FLT_MIN), _FLT_MIN, x).astype(F32)
        bits = np.atleast_1d(xc).view(np.uint32)
        e = ((bits >> 23).astype(np.int32) - 127).astype(F32)
        m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)) \
            .view(F32)
        small = m < _SQRTHF
        e2 = (F32(1) + e) - np.where(small, F32(1), F32(0))
        xx = (m - F32(1)) + np.where(small, m, F32(0))
        z = xx * xx
        x3 = z * xx
        p = _LOG_P
        y1 = fma32(fma32(xx, p[0], p[1]), xx, p[2])
        y2 = fma32(fma32(xx, p[3], p[4]), xx, p[5])
        y3 = fma32(fma32(xx, p[6], p[7]), xx, p[8])
        y = fma32(x3, fma32(x3, y1, y2), y3)
        y = fma32(x3, y, e2 * _LOG_Q1)
        r = fma32(e2, _LOG_Q2, fma32(z, F32(-0.5), xx) + y)
        r = np.where(x == 0, F32(-np.inf), r)
        r = np.where(x == np.inf, F32(np.inf), r)
        r = np.where(np.isnan(x) | (x < 0), F32(np.nan), r)
        return r.astype(F32).reshape(np.shape(x))


def _seq_sum(terms) -> np.float32:
    acc = F32(0)
    for t in terms:
        acc = F32(acc + t)
    return acc


def sum32(terms) -> np.float32:
    """``jnp.sum`` of a float32 vector whose terms XLA materialises first
    (no multiply fused into the sum)."""
    terms = np.asarray(terms, F32).ravel()
    k = len(terms)
    if k <= REDUCE_WINDOW:
        return _seq_sum(terms)
    n_win = -(-k // REDUCE_WINDOW)
    lo = (n_win * REDUCE_WINDOW - k) // 2
    padded = np.zeros(n_win * REDUCE_WINDOW, F32)
    padded[lo:lo + k] = terms
    wins = [_seq_sum(padded[i:i + REDUCE_WINDOW])
            for i in range(0, len(padded), REDUCE_WINDOW)]
    return sum32(wins)


# How LLVM's loop vectoriser lays out a fused multiply-add reduction of K
# terms, read from the LLVM IR that XLA:CPU emits for each K in 13..32:
# (lanes, interleaved accumulators, tail, chained). The tail is "masked"
# (the last chunk masked), an int (a vector epilogue of that many lanes)
# or None (a scalar loop). "Chained" means the DAG combiner reassociated
# the other accumulators' multiply-adds into accumulator 0's chain instead
# of adding the accumulators. K absent from a table runs a scalar loop.
# The layout depends on the fused computation, so each jitted reduction of
# the reference has its own table.
WRITE_DERIVATIVE_PLANS = {
    **{k: (8, 1, "masked", False) for k in range(13, 16)},
    16: (8, 2, None, False), 17: (8, 2, None, False),
    18: (8, 2, 2, False), 19: (8, 2, 2, False),
    **{k: (4, 4, 4, False) for k in range(20, 24)},
    **{k: (8, 1, None, False) for k in range(24, 28)},
    **{k: (4, 2, None, False) for k in range(28, 32)},
    32: (8, 4, None, False)}
TOTAL_WRITE_COST_PLANS = {
    **{k: (8, 2, 2, False) for k in range(17, 20)},
    **{k: (4, 4, 4, False) for k in range(20, 24)},
    **{k: (8, 1, None, False) for k in range(24, 28)},
    **{k: (4, 2, None, True) for k in range(28, 32)},
    32: (8, 4, None, False)}


def _hsum(v) -> np.float32:
    """``llvm.vector.reduce.fadd`` with reassociation: halve and add."""
    while len(v) > 1:
        h = len(v) // 2
        v = (v[:h] + v[h:]).astype(F32)
    return F32(v[0])


def _vector_sum(a, b, start, vf, ic, masked, chained) -> np.float32:
    """One vectorised loop over all of ``a`` and ``b``: chunk c of ``vf``
    lanes goes to accumulator c % ic. Accumulator 0 starts at (start, -0,
    ...) and takes ``fma(a_c, b_c, acc)`` per chunk. Another accumulator
    starts as its first chunk's bare product; its next chunk is fused in as
    ``fma(a_first, b_first, round(a_c * b_c))``, later ones as multiply-adds.
    Unchained, the accumulators are then added from the last one in (one
    still a bare product is fused into the sum); chained, each one's chunks
    join accumulator 0's chain, its second chunk innermost, then its first,
    then the rest. Masked lanes keep their accumulator."""
    n = len(a)
    n_chunks = -(-n // vf) if masked else n // vf
    chunks = [[] for _ in range(ic)]
    for c in range(n_chunks):
        ta, tb = np.zeros(vf, F32), np.zeros(vf, F32)
        m = min(vf, n - c * vf)
        ta[:m], tb[:m] = a[c * vf:c * vf + m], b[c * vf:c * vf + m]
        chunks[c % ic].append((ta, tb, np.arange(vf) < m))
    acc = np.full(vf, -0.0, F32)
    acc[0] = start
    for ta, tb, live in chunks[0]:
        acc = np.where(live, fma32(ta, tb, acc), acc)
    for part in chunks[1:]:
        if not part:
            continue
        if chained:
            order = part[1::-1] + part[2:]
            for ta, tb, _ in order:
                acc = fma32(ta, tb, acc)
            continue
        (a0, b0, _), rest = part[0], part[1:]
        if not rest:                    # a bare product fused into the sum
            acc = fma32(a0, b0, acc)
            continue
        (a1, b1, _), rest = rest[0], rest[1:]
        pv = fma32(a0, b0, (a1 * b1).astype(F32))
        for ta, tb, _ in rest:
            pv = fma32(ta, tb, pv)
        acc = (pv + acc).astype(F32)
    return _hsum(acc)


def dot_sum32(a, b, plans) -> np.float32:
    """``jnp.sum(a * b)`` as XLA:CPU compiles a fused multiply-add
    reduction with the vectoriser layouts ``plans``: one term is a bare
    product; a scalar loop runs ``acc = fma(a_i, b_i, acc)`` from 0; a
    planned K runs the vectorised loop, then its tail (a vector epilogue
    starting at the loop's sum, then scalar multiply-adds); above 32 terms
    the products are rounded first, then summed as ``sum32`` does."""
    a = np.asarray(a, F32).ravel()
    b = np.asarray(b, F32).ravel()
    k = len(a)
    with np.errstate(all="ignore"):
        if k == 1:                      # a one-term reduce is a reshape
            return F32(a[0] * b[0])
        if k > REDUCE_WINDOW:
            return sum32(a * b)
        acc, done = F32(0), 0
        plan = plans.get(k)
        if plan is not None:
            vf, ic, tail, chained = plan
            if tail == "masked":
                return _vector_sum(a, b, acc, vf, ic, True, chained)
            done = k // (vf * ic) * vf * ic
            acc = _vector_sum(a[:done], b[:done], acc, vf, ic, False, chained)
            if tail is not None and k - done >= tail:
                end = done + (k - done) // tail * tail
                acc = _vector_sum(a[done:end], b[done:end], acc, tail, 1,
                                  False, False)
                done = end
        for i in range(done, k):
            acc = F32(fma32(a[i], b[i], acc))
        return acc
