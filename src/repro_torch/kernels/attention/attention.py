"""K6: flash attention (``csrc/attention.cu``) and its backward
(``csrc/attention_bwd.cu``).

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

Training: where autograd needs a gradient of q, k or v, ``flash_attention``
goes through ``FlashAttention``, an ``autograd.Function`` whose forward is
K6 writing each row's log-sum-exp (``flash_attention_fwd``) and whose
backward is ``flash_attention_bwd``: three kernels (D = rowsum(dO * O),
dK/dV, dQ) that give the exact derivative of K6's function, with the
forward's rounding of p to the value dtype taken as the identity, as JAX's
VJP of ``astype`` takes it (``attention_bwd.cu`` has the formulas). Its
plain version ``flash_attention_bwd_plain`` is the same formula in torch;
the Function runs it only for CPU tensors. It never falls back to
autograd through the plain forward: what the kernels cannot take raises.
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
    return _plain(q, k, v, causal, window, softcap)[0]


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0):
    """Plain version of ``flash_attention_fwd``: (K6's output, each row's
    log-sum-exp m + log l [B, H, Sq] in f32)."""
    o, m, l = _plain(q, k, v, causal, window, softcap)
    return o, (m + torch.log(l)).squeeze(-1)


def _plain(q, k, v, causal, window, softcap):
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
    return o.transpose(1, 2).to(q.dtype), m, l


def _no_key_rows(sq: int, sk: int, causal: bool, window: int, device):
    """[sq] bool: the rows that keep no key (K6 gives them the mean of v)."""
    rows = torch.arange(sq, device=device)
    if not (causal and window > 0):
        return torch.zeros(sq, dtype=torch.bool, device=device)
    return rows >= sk - 1 + window


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True,
                              window: int = 0, softcap: float = 0.0):
    """Plain version of ``flash_attention_bwd``: (dq, dk, dv) in the inputs'
    dtypes, in f32 over all keys at once, the same formula as the kernels:
    P = exp(s - lse) on kept pairs, D = rowsum(dO * O), dS = P (dO.v - D)
    times the softcap's 1 - (s / c)^2, dK and dV summed over each KV head's
    query heads; a row that keeps no key has P = 1 / Sk and dS = 0. Written
    in place where it can, so that [B, H, Sq, Sk] f32 buffers stay few."""
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qf = q.float().transpose(1, 2)                          # [B, H, Sq, hd]
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    s = (qf @ kf.transpose(2, 3)).mul_(scale)               # [B, H, Sq, Sk]
    if softcap:
        t = s.div_(softcap).tanh_()
        p = torch.exp(t * softcap - lse.float()[..., None])
    else:
        t = None
        p = s.sub_(lse.float()[..., None]).exp_()
    drop = None
    if causal:
        drop = ~keep_mask(sq, sk, window, q.device)
        p.masked_fill_(drop, 0.0)
    none = _no_key_rows(sq, sk, causal, window, q.device)
    if bool(none.any()):
        p[:, :, none, :] = 1.0 / sk
    dv = p.transpose(2, 3) @ dof                            # [B, H, Sk, hd]
    ds = (dof @ vf.transpose(2, 3)).sub_(delta).mul_(p)
    del p
    if drop is not None:
        ds.masked_fill_(drop, 0.0)
    ds[:, :, none, :] = 0.0
    if t is not None:
        ds.mul_(t.square_().neg_().add_(1.0))
    del t
    dq = (ds @ kf).mul_(scale)
    dk = (ds.transpose(2, 3) @ qf).mul_(scale)
    del ds

    def heads(x):                      # [B, H, Sk, hd] -> [B, Sk, KV, hd]
        return x.view(b, kvh, g, sk, hd).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), heads(dk).to(k.dtype),
            heads(dv).to(v.dtype))


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


def _launchable(q, k) -> None:
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    if b * h >= 1 << 16 or max(sq, sk) >= 1 << 31:
        raise ValueError(f"too large for one launch: B*H {b * h}, Sq {sq}, "
                         f"Sk {sk}")


def _forward(q, k, v, causal, window, softcap, lse):
    """Launch K6; ``lse`` a [B, H, Sq] f32 buffer or None."""
    _launchable(q, k)
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    rc = build.library().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), b, sq, sk, h,
        kvh, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *o.stride()[:3], int(causal), int(window), float(softcap),
        hd ** -0.5, int(q.dtype == torch.bfloat16), stream_of(q))
    build.check(rc, "flash_attention")
    count("flash_attention")
    return o


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q ``[B, Sq, H, hd]``; k, v ``[B, Sk, KV, hd]`` -> ``[B, Sq, H, hd]``.
    Differentiable (through ``FlashAttention``) where autograd needs it."""
    _check(q, k, v, window)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    if not on_card(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    return _forward(q, k, v, causal, window, softcap, None)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """K6 with each row's log-sum-exp: (o ``[B, Sq, H, hd]``, lse ``[B, H,
    Sq]`` f32), the backward's inputs."""
    _check(q, k, v, window)
    if not on_card(q, k, v):
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
    b, sq, h, _ = q.shape
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    return _forward(q, k, v, causal, window, softcap, lse), lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of K6's function at (q, k, v), given its output ``o``,
    the ``lse`` of ``flash_attention_fwd`` and the output's gradient
    ``do``; dq ``[B, Sq, H, hd]`` and dk, dv ``[B, Sk, KV, hd]``,
    contiguous, in the inputs' dtype. Three launches on the card:
    ``flash_attention_bwd_prep`` (D), ``flash_attention_bwd_dkv`` and
    ``flash_attention_bwd_dq``."""
    _check(q, k, v, window)
    b, sq, h, hd = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.stride(-1) != 1:
            raise ValueError(f"{name}: expected q's shape and dtype with a "
                             f"contiguous head dim, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse: expected a contiguous f32 [B, H, Sq] = "
                         f"{(b, h, sq)}, got {lse.dtype} {tuple(lse.shape)}")
    if not on_card(q, k, v, o, lse, do):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, softcap=softcap)
    _launchable(q, k)
    delta = bwd_prep(o, do)
    kw = {"causal": causal, "window": window, "softcap": softcap}
    dk, dv = bwd_dkv(q, k, v, do, lse, delta, **kw)
    return bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv


def bwd_prep(o, do):
    """D = rowsum(dO * O) [B, H, Sq] in f32: ``flash_attention_bwd_prep``
    (card tensors, checked by ``flash_attention_bwd``)."""
    b, sq, h, hd = o.shape
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=o.device)
    rc = build.library().flash_attention_bwd_prep(
        o.data_ptr(), do.data_ptr(), delta.data_ptr(), b, sq, h, hd,
        *o.stride()[:3], *do.stride()[:3], int(o.dtype == torch.bfloat16),
        stream_of(o))
    build.check(rc, "flash_attention_bwd_prep")
    count("flash_attention_bwd_prep")
    return delta


def _bwd_args(q, k, v, do, lse, delta, causal, window, softcap):
    b, sq, h, hd = q.shape
    return ((q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr()),
            (b, sq, k.shape[1], h, k.shape[2], hd, *q.stride()[:3],
             *k.stride()[:3], *v.stride()[:3], *do.stride()[:3], int(causal),
             int(window), float(softcap), hd ** -0.5,
             int(q.dtype == torch.bfloat16), stream_of(q)))


def bwd_dkv(q, k, v, do, lse, delta, *, causal, window, softcap):
    """(dk, dv) [B, Sk, KV, hd]: ``flash_attention_bwd_dkv``."""
    ins, shape = _bwd_args(q, k, v, do, lse, delta, causal, window, softcap)
    dk = torch.empty((q.shape[0], k.shape[1], k.shape[2], q.shape[3]),
                     dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    rc = build.library().flash_attention_bwd_dkv(*ins, dk.data_ptr(),
                                                 dv.data_ptr(), *shape)
    build.check(rc, "flash_attention_bwd_dkv")
    count("flash_attention_bwd_dkv")
    return dk, dv


def bwd_dq(q, k, v, do, lse, delta, *, causal, window, softcap):
    """dq [B, Sq, H, hd]: ``flash_attention_bwd_dq``."""
    ins, shape = _bwd_args(q, k, v, do, lse, delta, causal, window, softcap)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    rc = build.library().flash_attention_bwd_dq(*ins, dq.data_ptr(), *shape)
    build.check(rc, "flash_attention_bwd_dq")
    count("flash_attention_bwd_dq")
    return dq


class FlashAttention(torch.autograd.Function):
    """K6 with its backward: ``flash_attention_fwd`` forward (saving q, k,
    v, o and the lse), ``flash_attention_bwd`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = {"causal": causal, "window": window, "softcap": softcap}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.kw)
        return dq, dk, dv, None, None, None
