"""Attention: GQA with RoPE, sliding-window and score-softcap variants, and
KV-cache prefill/decode, as in the reference (``repro.models.attention``).

Every attention call of the block runs K6 (``kernels.attention
.flash_attention``), where the reference calls ``full_attention`` or, above
``chunked_attn_threshold`` keys, ``chunked_attention``. K6 takes no query
offset (its causal mask counts query and key indices from 0), so the block
reaches it in two forms that compute the reference's function exactly:

  * prefill (and ``apply``), queries at positions 0..S-1: causal over the
    whole cache (or the block's own k, v), with the layer's window;
  * decode, one query at ``pos``: non-causal over the cache rows the query
    keeps, ``max(0, pos - window + 1) .. pos`` (all of ``0 .. pos`` without
    a window). The reference attends over the whole cache with those rows
    kept, and its masked terms are ``exp(-2e38 - m) = 0`` exactly in f32.

The block is always causal; a non-causal (encoder) form waits for the
families that need it. Only the ``"sd"`` cache layout ``[B, S, KV, hd]``
is ported.
"""
from __future__ import annotations

import torch

from ..kernels.attention.attention import flash_attention
from .layers import P, rope


def padded_heads(cfg):
    """(h_pad, kv_pad): head counts padded to cfg.head_pad_to multiples.

    Padded heads are masked to zero after attention, so they are
    mathematically dead."""
    h, kv = cfg.num_heads, cfg.num_kv_heads
    m = cfg.head_pad_to
    if not m:
        return h, kv
    h_pad = -(-h // m) * m
    kv_pad = kv if h_pad % kv == 0 else -(-kv // m) * m
    return h_pad, kv_pad


def attn_spec(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = padded_heads(cfg)
    s = d ** -0.5
    return {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim"), scale=s),
        "wk": P((d, kv, hd), ("embed", "kv_heads", "head_dim"), scale=s),
        "wv": P((d, kv, hd), ("embed", "kv_heads", "head_dim"), scale=s),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed"),
                scale=(h * hd) ** -0.5),
    }


def _proj(x, w):
    """``einsum("bsd,dhk->bshk")`` as one matmul."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def qkv(cfg, p, x, positions):
    dt = x.dtype
    q = rope(_proj(x, p["wq"].to(dt)), positions, cfg.rope_theta)
    k = rope(_proj(x, p["wk"].to(dt)), positions, cfg.rope_theta)
    v = _proj(x, p["wv"].to(dt))
    return q, k, v


def attention_block(cfg, p, x, positions, pos0: int, *,
                    layer_window: int = 0, cache=None):
    """qkv -> K6 -> out-proj. ``positions`` [B, S] are the rows' positions
    (the same for every batch row) and ``pos0 = positions[0, 0]`` as a host
    int. With ``cache`` (dict k, v of [B, max_len, KV, hd]) k and v are
    written in place at ``pos0``, clamped as ``dynamic_update_slice``
    clamps its start, and the same dict is returned.

    Returns (out [B,S,d], cache).
    """
    dt = x.dtype
    q, k, v = qkv(cfg, p, x, positions)
    s = x.shape[1]
    if cache is not None:
        if cfg.kv_layout != "sd":
            raise NotImplementedError(
                f"kv_layout {cfg.kv_layout!r} is not ported (ROADMAP Queue 1, "
                f"\"Rest of the serving model stack\": only 'sd' is on the "
                f"serving path)")
        ck, cv = cache["k"], cache["v"]
        max_len = ck.shape[1]
        if not 0 <= pos0 < max_len:
            raise ValueError(f"position {pos0} outside a cache of {max_len}")
        start = min(pos0, max_len - s)
        ck[:, start:start + s] = k.to(ck.dtype)
        cv[:, start:start + s] = v.to(cv.dtype)
        if s == 1:                              # decode
            lo = max(0, pos0 - layer_window + 1) if layer_window > 0 else 0
            out = flash_attention(q, ck[:, lo:pos0 + 1].to(dt),
                                  cv[:, lo:pos0 + 1].to(dt), causal=False,
                                  softcap=cfg.attn_softcap)
        elif pos0 == 0:                         # prefill from position 0
            out = flash_attention(q, ck.to(dt), cv.to(dt), causal=True,
                                  window=layer_window,
                                  softcap=cfg.attn_softcap)
        else:
            raise NotImplementedError(
                "a prefill that extends a cache at a position > 0 needs a "
                "query offset, which K6 does not take")
    else:
        out = flash_attention(q, k, v, causal=True, window=layer_window,
                              softcap=cfg.attn_softcap)
    if cfg.head_pad_to and q.shape[2] != cfg.num_heads:
        # padded heads are dead: zero them
        mask = (torch.arange(q.shape[2], device=x.device)
                < cfg.num_heads).to(out.dtype)
        out = out * mask[None, None, :, None]
    h, hd = out.shape[2], out.shape[3]
    out = out.reshape(*out.shape[:2], h * hd) @ p["wo"].to(dt).reshape(
        h * hd, -1)
    return out, cache
