"""State-space blocks, as in the reference (``repro.models.ssm``): the
chunked linear-recurrence helper and Mamba2.

The recurrence  h_t = a_t * h_{t-1} + u_t w_t^T,   y_t = h_t q_t
(per-step scalar decay a_t, outer-product updates, state [dv, dk]) covers
Mamba2's SSD (u = dt*x, w = B, q = C) and mLSTM's matrix memory (u = i*v,
w = k, q = q). It is evaluated chunkwise: inside a chunk with dense
products over a [chunk x chunk] decay mask, across chunks by a Python loop
that carries the state (the reference's ``lax.scan``). xLSTM
(``models/xlstm.py``) reuses ``chunked_decay_scan`` and
``decay_scan_step`` and comes in the next slice (ROADMAP Queue 1, "Rest of
the serving model stack").

The reference computes all of it with ``jnp`` outside any Pallas kernel,
so here it is plain torch ops and no kernel of its own. Each step keeps
the reference's dtypes, cast explicitly where ``jnp`` promotes mixed
dtypes and torch would not:

  * ``u = xh * dt``: dt (f32) is rounded to the compute dtype first;
  * ``qw``, written in the reference as a product in the compute dtype
    cast to f32, is a product of f32 operands: the reference's chunk body
    runs compiled inside ``lax.scan``, where XLA keeps that product in f32
    (its excess precision drops the round trip through bf16). Rounded to
    bf16, it would move 29% of a bf16 scan's outputs off the reference's;
    from f32 operands they are the reference's to the bit;
  * the intra- and inter-chunk outputs are f32, and each chunk's output
    comes back in ``u.dtype``;
  * in ``decay_scan_step`` the outer product ``u w^T`` is formed in the
    compute dtype, then cast to ``h.dtype``; ``y`` is f32 before its cast
    to ``u.dtype``.

The masked decay ``exp(cum_t - cum_s)`` is inf for some s > t before the
mask drops it, so the mask is a ``torch.where``: a multiply by a 0/1 mask
would give inf * 0 = nan.

``mamba2_block`` keeps the reference's three forms: no cache (``apply``:
zero conv padding, h0 = 0), a cache (prefill: the chunked scan from
``cache["h"]``) and a cache with one token (decode: ``decay_scan_step``).
It returns a new state; ``CausalLM`` copies it into the stacked cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .params import P


def chunked_decay_scan(log_a, u, w, q, h0, chunk: int):
    """Evaluate the recurrence above for all t.

    log_a: [B,H,S] per-step log decay (<= 0)
    u:     [B,H,S,dv]   w,q: [B,H,S,dk]   h0: [B,H,dv,dk]
    Returns (y [B,H,S,dv], h_final [B,H,dv,dk] in f32).
    """
    b, h, s = log_a.shape
    dv, dk = u.shape[-1], w.shape[-1]
    c = min(chunk, s)
    s_orig = s
    if s % c:                       # pad with identity steps (a=1, u=w=0)
        pad = c - s % c
        log_a = F.pad(log_a, (0, pad))
        u, w, q = (F.pad(t, (0, 0, 0, pad)) for t in (u, w, q))
        s = s + pad
    n = s // c
    la = log_a.reshape(b, h, n, c)
    uc = u.reshape(b, h, n, c, dv)
    wc = w.reshape(b, h, n, c, dk)
    qc = q.reshape(b, h, n, c, dk)
    keep = torch.ones(c, c, dtype=torch.bool, device=u.device).tril()
    hc = h0.float()
    ys = []
    for i in range(n):
        lai, ui, wi, qi = la[:, :, i], uc[:, :, i], wc[:, :, i], qc[:, :, i]
        cum = torch.cumsum(lai, dim=-1)             # [B,H,c] inclusive
        Ai = torch.exp(cum)                         # decay from chunk start
        # intra-chunk: M[t,s] = exp(cum_t - cum_s) for s<=t else 0
        M = torch.exp(cum[..., :, None] - cum[..., None, :])
        M = torch.where(keep, M, 0.0)
        qw = torch.einsum("bhtk,bhsk->bhts", qi.float(), wi.float())
        u32 = ui.float()
        y_intra = torch.einsum("bhts,bhsv->bhtv", qw * M, u32)
        y_inter = torch.einsum("bhvk,bhtk->bhtv", hc,
                               qi.float()) * Ai[..., None]
        # state update: h' = A_c h + sum_s exp(cum_c - cum_s) u_s w_s^T
        suffix = torch.exp(cum[..., -1:] - cum)     # [B,H,c]
        hc = hc * torch.exp(cum[..., -1])[..., None, None] + torch.einsum(
            "bhsv,bhsk->bhvk", u32 * suffix[..., None], wi.float())
        ys.append((y_intra + y_inter).to(u.dtype))
    y = torch.stack(ys, dim=2).reshape(b, h, s, dv)
    return y[:, :, :s_orig], hc


def decay_scan_step(log_a, u, w, q, h):
    """Single-step (decode) version. log_a:[B,H] u:[B,H,dv] w,q:[B,H,dk]."""
    h_new = h * torch.exp(log_a)[..., None, None].to(h.dtype) \
        + (u[..., :, None] * w[..., None, :]).to(h.dtype)
    y = torch.einsum("bhvk,bhk->bhv", h_new, q.to(h_new.dtype)).to(u.dtype)
    return y, h_new


# ----------------------------- Mamba2 block -----------------------------------
CONV_K = 4   # depthwise causal conv width


def mamba2_spec(cfg) -> dict:
    d = cfg.d_model
    di = cfg.ssm_expand * d                 # inner width
    hd = cfg.ssm_head_dim
    nh = di // hd                           # ssm heads
    ds = cfg.ssm_state
    s = d ** -0.5
    return {
        # in_proj -> [z (di), x (di), B (ds), C (ds), dt (nh)]
        "in_proj": P((d, 2 * di + 2 * ds + nh), ("embed", "ssm_in"), scale=s),
        "conv": P((CONV_K, di + 2 * ds), ("conv_k", "ssm_conv"), scale=0.3),
        "A_log": P((nh,), ("ssm_heads",), init="zeros"),
        "D": P((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": P((nh,), ("ssm_heads",), init="zeros"),
        "norm": P((di,), ("ssm_inner",), init="ones"),
        "out_proj": P((di, d), ("ssm_inner", "embed"), scale=di ** -0.5),
    }


def _mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return di, nh, cfg.ssm_head_dim, cfg.ssm_state


def mamba2_cache_spec(cfg, batch: int) -> dict:
    di, nh, hd, ds = _mamba_dims(cfg)
    return {
        "h": P((batch, nh, hd, ds),
               ("batch", "ssm_heads", "ssm_hd", "ssm_state"), init="zeros"),
        "conv": P((batch, CONV_K - 1, di + 2 * ds),
                  ("batch", "conv_k", "ssm_conv"), init="zeros"),
    }


def _causal_conv(x, kernel, conv_state=None):
    """Depthwise causal conv. x: [B,S,C], kernel: [K,C]. The reference's sum
    of K shifted products in x.dtype, in order 0..K-1 (not ``F.conv1d``:
    cuDNN would take f32 in TF32 on Hopper)."""
    k = kernel.shape[0]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                  # [B, S+K-1, C]
    out = sum(xp[:, i:i + x.shape[1], :] * kernel[i][None, None, :]
              for i in range(k))
    new_state = xp[:, -(k - 1):, :]
    return out, new_state


def silu(x):
    """``jax.nn.silu``'s own chain, x * (1 / (1 + exp(-x))), each op
    rounded to x.dtype as the reference rounds it in bf16 (``F.silu``
    rounds once, and differs from it in about 40% of bf16 elements)."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x):
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``: the same formula
    (max + log1p(exp(-|delta|))), where ``F.softplus`` computes
    log1p(exp(x)) and returns x above its threshold."""
    return torch.logaddexp(x, x.new_zeros(()))


def mamba2_block(cfg, p, x, cache=None):
    """x: [B,S,d]. cache: {"h","conv"} or None. Returns (out, new_cache):
    new tensors, which the caller copies into its cache."""
    dt_ = x.dtype
    di, nh, hd, ds = _mamba_dims(cfg)
    proj = x @ p["in_proj"].to(dt_)
    # jnp.split takes indices [di, 2di, 2di+ds, 2di+2ds]; torch takes sizes
    z, xin, Bc, Cc, dt_raw = torch.split(proj, [di, di, ds, ds, nh], dim=-1)
    conv_in = torch.cat([xin, Bc, Cc], dim=-1)
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv"].to(dt_), None if cache is None else cache["conv"])
    conv_out = silu(conv_out)
    xin, Bc, Cc = torch.split(conv_out, [di, ds, ds], dim=-1)
    dt = softplus(dt_raw.float() + p["dt_bias"].float())       # [B,S,nh]
    A = -torch.exp(p["A_log"].float())                         # [nh] (<0)
    log_a = (dt * A).transpose(1, 2)                           # [B,nh,S]
    b, s, _ = x.shape
    xh = xin.reshape(b, s, nh, hd).transpose(1, 2)             # [B,nh,S,hd]
    u = xh * dt.transpose(1, 2)[..., None].to(dt_)
    w = Bc[:, None].expand(b, nh, s, ds)
    q = Cc[:, None].expand(b, nh, s, ds)
    h0 = (x.new_zeros((b, nh, hd, ds), dtype=torch.float32) if cache is None
          else cache["h"].float())
    if s == 1 and cache is not None:
        y, h_fin = decay_scan_step(log_a[..., 0], u[..., 0, :],
                                   w[..., 0, :], q[..., 0, :], h0)
        y = y[:, :, None, :]
    else:
        y, h_fin = chunked_decay_scan(log_a, u, w, q, h0, cfg.ssm_chunk)
    y = y + xh.to(y.dtype) * p["D"].to(y.dtype)[None, :, None, None]
    y = y.transpose(1, 2).reshape(b, s, di)
    # gated RMSNorm (Mamba2) then out-projection
    y = y * silu(z)
    y32 = y.float()
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps) * p["norm"].float()).to(dt_)
    out = y @ p["out_proj"].to(dt_)
    new_cache = None if cache is None else {
        "h": h_fin.to(cache["h"].dtype),
        "conv": conv_state.to(cache["conv"].dtype)}
    return out, new_cache
