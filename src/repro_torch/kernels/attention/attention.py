"""K6: flash-attention forward (``csrc/attention.cu``).

``flash_attention(q, k, v, *, causal, window, softcap)`` computes the
function of the reference wrapper ``repro.kernels.attention.ops
.flash_attention`` over the TPU kernel ``flash_attention_bhsd``, on the
same ``[B, S, heads, hd]`` layout: q ``[B, Sq, H, hd]``, k and v ``[B, Sk,
KV, hd]`` with ``H % KV == 0`` (GQA), one dtype (bf16 or f32). Scores are
f32, scaled by ``hd ** -0.5``; a nonzero ``softcap`` c maps them to ``c *
tanh(s / c)``; with ``causal`` key ``kp`` is kept for query ``qp`` iff
``kp <= qp`` and, when ``window > 0``, ``kp > qp - window``, both counted
from 0 (top-left); masked keys score ``-2e38``. The softmax keeps f32
``m``, ``l`` and ``acc``, rounds ``p`` to the value dtype before ``p @ v``,
and the output ``acc / max(l, 1e-30)`` comes back in q's dtype.

On CUDA tensors the wrapper launches the kernel; on CPU tensors it runs
the plain version beside it. k and v may be views with any batch,
sequence and head strides (a row slice of the KV cache); each tensor's
last dim must be contiguous.
"""
from __future__ import annotations

import torch

from .. import build
from .._launch import count, on_card, stream_of

NEG_INF = -2.0e38
# Head dims the kernel is instantiated for: those of the configs (reduced
# 16, MiniCPM 64, Zamba2 80, the rest 128).
HEAD_DIMS = (16, 64, 80, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def keep_mask(sq: int, sk: int, window: int, device) -> torch.Tensor:
    """The causal (+ sliding window) keep mask ``[sq, sk]``, top-left."""
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(sk, device=device)[None, :]
    keep = kp <= qp
    if window > 0:
        keep &= kp > qp - window
    return keep


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0):
    """Plain version of K6: the same function in f32 over all keys at once
    (one key tile), with the KV heads repeated for GQA."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    s = q.float().transpose(1, 2) @ kf.transpose(2, 3)     # [B, H, Sq, Sk]
    s = s * hd ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        s = s.masked_fill(~keep_mask(sq, sk, window, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vf) / l.clamp_min(1e-30)
    return o.transpose(1, 2).to(q.dtype)


def _check(q, k, v, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v: expected [B, S, heads, hd] tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q, k, v: expected one dtype of {_DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [B,Sq,H,hd], "
                         f"[B,Sk,KV,hd]")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are no multiple of {k.shape[2]} "
                         f"KV heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("empty query or key sequence")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q ``[B, Sq, H, hd]``; k, v ``[B, Sk, KV, hd]`` -> ``[B, Sq, H, hd]``."""
    _check(q, k, v, window)
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if b * h >= 1 << 16 or max(sq, sk) >= 1 << 31:
        raise ValueError(f"too large for one launch: B*H {b * h}, Sq {sq}, "
                         f"Sk {sk}")
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    rc = build.library().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h,
        kvh, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], int(causal), int(window), float(softcap),
        hd ** -0.5, int(q.dtype == torch.bfloat16), stream_of(q))
    build.check(rc, "flash_attention")
    count("flash_attention")
    return o
