"""The 10 architectures of the reference package (``repro.configs.archs``),
copied so that the port imports nothing of it.

Each is registered under its public id and selectable via ``--arch <id>``.
``reduced()`` returns a family-preserving small config for CPU smoke tests.
"""
from __future__ import annotations

from .base import ModelConfig, register

# -- hybrid: Mamba2 backbone + shared attention blocks [arXiv:2411.15242] ----
zamba2_2p7b = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
    num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6, head_dim=80))

# -- vlm: InternViT stub + InternLM2 backbone [arXiv:2404.16821] --------------
internvl2_2b = register(ModelConfig(
    name="internvl2-2b", family="vlm", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=8, d_ff=8192, vocab_size=92553, head_dim=128,
    frontend="vit_stub", frontend_tokens=256))

# -- dense: pruned nemotron [arXiv:2407.14679] ---------------------------------
minitron_4b = register(ModelConfig(
    name="minitron-4b", family="dense", num_layers=32, d_model=3072,
    num_heads=24, num_kv_heads=8, d_ff=9216, vocab_size=256000,
    head_dim=128))

# -- dense: WSD schedule, llama-like [arXiv:2404.06395] -------------------------
minicpm_2b = register(ModelConfig(
    name="minicpm-2b", family="dense", num_layers=40, d_model=2304,
    num_heads=36, num_kv_heads=36, d_ff=5760, vocab_size=122753,
    head_dim=64))

# -- dense: llama-arch GQA [arXiv:2403.04652] -----------------------------------
yi_6b = register(ModelConfig(
    name="yi-6b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=4, d_ff=11008, vocab_size=64000,
    head_dim=128))

# -- dense: local+global alternating, logit softcap [arXiv:2408.00118] -----------
gemma2_27b = register(ModelConfig(
    name="gemma2-27b", family="dense", num_layers=46, d_model=4608,
    num_heads=32, num_kv_heads=16, d_ff=36864, vocab_size=256000,
    head_dim=128, attn_types=("local", "global"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0))

# -- moe: 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]
arctic_480b = register(ModelConfig(
    name="arctic-480b", family="moe", num_layers=35, d_model=7168,
    num_heads=56, num_kv_heads=8, d_ff=4864, vocab_size=32000, head_dim=128,
    num_experts=128, top_k=2, moe_dense_ff=4864,
    # 480B params: fp32 optimizer states would not fit one pod's memory
    param_dtype="bfloat16", optstate_dtype="bfloat16"))

# -- moe: 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base] ------------
granite_moe_1b = register(ModelConfig(
    name="granite-moe-1b-a400m", family="moe", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=8, d_ff=512, vocab_size=49155, head_dim=64,
    num_experts=32, top_k=8))

# -- ssm: sLSTM + mLSTM blocks [arXiv:2405.04517] ---------------------------------
xlstm_350m = register(ModelConfig(
    name="xlstm-350m", family="ssm", num_layers=24, d_model=1024,
    num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=50304, xlstm=True,
    head_dim=256))

# -- audio: enc-dec, multimodal [arXiv:2308.11596] ---------------------------------
seamless_m4t_medium = register(ModelConfig(
    name="seamless-m4t-medium", family="encdec", num_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=256206,
    head_dim=64, enc_layers=12, dec_layers=12,
    frontend="audio_stub", frontend_tokens=1024))


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving tiny config for CPU smoke tests."""
    kw = dict(
        num_layers=max(2, cfg.layer_period * 2), d_model=64,
        num_heads=4, num_kv_heads=min(4, max(1, cfg.num_kv_heads)),
        d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=256, head_dim=16,
        window=32, frontend_tokens=8 if cfg.frontend else 0,
        param_dtype="float32", optstate_dtype="float32",
        compute_dtype="float32",
        attn_chunk_q=16, attn_chunk_kv=16, ssm_chunk=8,
        chunked_attn_threshold=64)
    if cfg.num_experts:
        kw.update(num_experts=4, top_k=min(2, cfg.top_k), d_ff=64,
                  moe_dense_ff=64 if cfg.moe_dense_ff else 0,
                  capacity_factor=8.0)   # no token drops at smoke scale
    if cfg.family == "hybrid":
        kw.update(attn_every=3, num_layers=6, ssm_state=8, ssm_head_dim=8,
                  head_dim=16)
    if cfg.xlstm:
        kw.update(num_heads=2, num_kv_heads=2, head_dim=32)
    if cfg.family == "encdec":
        kw.update(enc_layers=2, dec_layers=2, num_layers=4)
    return cfg.with_(name=cfg.name + "-smoke", **kw)
