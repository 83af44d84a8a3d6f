"""Shared neural-net layers (pure functions over param dicts), as in the
reference (``repro.models.layers``). The tensor-parallel
``mlp_psum_bf16`` is not ported: it needs a mesh."""
from __future__ import annotations

import math

import torch

from .params import P


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / max(cap, 1e-6)) if cap > 0 else x


# -- RMSNorm -----------------------------------------------------------------
def rmsnorm_spec(d: int) -> dict:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


# -- gated MLP (SwiGLU) --------------------------------------------------------
def mlp_spec(d: int, ff: int) -> dict:
    s = d ** -0.5
    return {
        "wi_gate": P((d, ff), ("embed", "mlp"), scale=s),
        "wi_up": P((d, ff), ("embed", "mlp"), scale=s),
        "wo": P((ff, d), ("mlp", "embed"), scale=ff ** -0.5),
    }


def mlp(p, x, compute_dtype):
    g = x @ p["wi_gate"].to(compute_dtype)
    u = x @ p["wi_up"].to(compute_dtype)
    h = torch.nn.functional.silu(g) * u
    return h @ p["wo"].to(compute_dtype)


# -- embeddings (tied; sqrt(d) input scaling) ----------------------------------
def embed_spec(vocab: int, d: int) -> dict:
    return {"table": P((vocab, d), ("vocab", "embed"), scale=d ** -0.5)}


def embed(p, tokens, compute_dtype):
    d = p["table"].shape[-1]
    return p["table"].to(compute_dtype)[tokens.long()] * (d ** 0.5)


def unembed(p, x, compute_dtype):
    return x @ p["table"].to(compute_dtype).t()


# -- rotary position embedding ----------------------------------------------------
def rope(x, positions, theta: float = 10_000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].float() * freqs          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
