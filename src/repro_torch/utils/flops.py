"""Analytical MODEL_FLOPS estimates (MFU's numerator), as in the reference
(``repro.utils.flops``).

Dense train: 6*N*D; MoE: 6*N_active*D; inference forward: 2*N_active per
token. Attention adds 12*B*Sq*Skv*H*hd per layer for training (4 for
inference), with causal halving and sliding-window capping for local
layers.
"""
from __future__ import annotations

from ..configs.base import ModelConfig, ShapeConfig
from ..models.params import num_params
from ..models.zoo import build_model


def _slot_names(cfg: ModelConfig) -> list:
    """The reference's ``block_slots`` for every family (the port's own
    refuses the families it does not run yet; counting needs no model)."""
    if cfg.family == "hybrid" and cfg.attn_every:
        return ["mamba"] * cfg.attn_every
    if cfg.xlstm:
        return ["mlstm", "slstm"]
    if cfg.family == "moe":
        return ["attn_moe"] * max(1, len(cfg.attn_types))
    return [f"attn:{t}" for t in cfg.attn_types]


def active_param_fraction(cfg: ModelConfig) -> float:
    if not cfg.num_experts:
        return 1.0
    spec = build_model(cfg).param_specs()
    total = num_params(spec)
    expert = 0
    for blk in spec["blocks"]:
        moe = blk.get("moe")
        if moe:
            for k in ("wi_gate", "wi_up", "wo"):
                n = 1
                for d in moe[k].shape:
                    n *= d
                expert += n
    active = total - expert + expert * cfg.top_k / cfg.num_experts
    return active / total


def attention_layer_count(cfg: ModelConfig):
    """Returns [(count, window)] attention layer groups."""
    out = []
    if cfg.family == "encdec":
        out.append((cfg.enc_layers + 2 * cfg.dec_layers, 0))
        return out
    slots = _slot_names(cfg)
    n_super = cfg.num_layers // len(slots)
    n_global = sum(1 for s in slots if s in ("attn:global", "attn_moe")) \
        * n_super
    n_local = sum(1 for s in slots if s == "attn:local") * n_super
    if cfg.family == "hybrid" and cfg.attn_every:
        n_global += n_super            # shared attention applications
    if n_global:
        out.append((n_global, 0))
    if n_local:
        out.append((n_local, cfg.window))
    return out


def model_flops(cfg: ModelConfig, shape: ShapeConfig, n_params: int) -> float:
    B, S = shape.global_batch, shape.seq_len
    act = active_param_fraction(cfg)
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if shape.kind == "train":
        tokens = B * S
        flops = 6.0 * act * n_params * tokens
        for count, window in attention_layer_count(cfg):
            kv_span = min(S / 2, window) if window else S / 2
            flops += 12.0 * B * S * kv_span * h * hd * count
        return flops
    if shape.kind == "prefill":
        tokens = B * S
        flops = 2.0 * act * n_params * tokens
        for count, window in attention_layer_count(cfg):
            kv_span = min(S / 2, window) if window else S / 2
            flops += 4.0 * B * S * kv_span * h * hd * count
        return flops
    # decode: one token per sequence against a cache of length S
    flops = 2.0 * act * n_params * B
    for count, window in attention_layer_count(cfg):
        kv_span = min(S, window) if window else S
        flops += 4.0 * B * kv_span * h * hd * count
    return flops
