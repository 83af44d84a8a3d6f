"""Shared, jax-free sizing helpers for the kernel entry points and the
execution backends.

These are the single source of truth for run/batch size bucketing and
Bloom slot counts: cross-backend bit-parity of Bloom false positives
depends on every caller agreeing on them.
"""
from __future__ import annotations


def next_pow2(n: int, lo: int = 16) -> int:
    """Smallest power of two >= max(n, lo). Used to bucket operand sizes
    so jitted kernels compile once per bucket, not once per exact shape."""
    m = lo
    while m < n:
        m <<= 1
    return m


def slots_for(n_keys: int, bits_per_key: int = 10) -> int:
    """Bloom slot count for ``n_keys`` keys, rounded up to the kernel's
    128-row filter layout."""
    return max(128, -(-n_keys * bits_per_key // 128) * 128)
