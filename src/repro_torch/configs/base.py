"""Model/run configuration + registry for the architectures: a copy of
``repro.configs.base``, so that the port imports nothing of the reference."""
from __future__ import annotations

from dataclasses import dataclass, replace

_REGISTRY: dict = {}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # attention variants
    attn_types: tuple = ("global",)   # cycled per layer ("local","global")
    window: int = 4096                # sliding window for local layers
    attn_softcap: float = 0.0         # gemma2: softcap on attention scores
    logit_softcap: float = 0.0        # gemma2: softcap on final logits
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_dense_ff: int = 0        # arctic: dense residual FFN beside the MoE
    capacity_factor: float = 1.25

    # SSM / hybrid (zamba2-style: shared attention block every N ssm layers)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0          # 0 -> no interleaved shared attention

    # xLSTM (alternating mLSTM/sLSTM)
    xlstm: bool = False

    # encoder-decoder
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stub: tokens are replaced/prefixed by embeddings
    frontend: str = ""           # "" | "vit_stub" | "audio_stub"
    frontend_tokens: int = 0     # patch/frame positions supplied as embeddings

    # numerics / training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optstate_dtype: str = "float32"
    norm_eps: float = 1e-5
    remat: str = "full"          # full | dots | none
    fsdp: bool = True            # shard params over the data axis (ZeRO-3)
    scan_layers: bool = True

    # serving
    attn_chunk_q: int = 2048     # chunked-attention block sizes (long seq)
    attn_chunk_kv: int = 1024
    chunked_attn_threshold: int = 8192
    ssm_chunk: int = 256         # mamba2/mLSTM SSD chunk length

    # perf knobs (§Perf hillclimbing; defaults = paper-faithful baseline)
    seq_shard_attn: bool = False  # shard attention over seq on the model
    #                               axis (fixes head-indivisible TP waste)
    kv_layout: str = "sd"         # "sd" [B,S,KV,hd] | "ds" [B,KV,hd,S]
    #                               | "paged" (page-pool + page-table gather)
    kv_page_tokens: int = 64      # tokens per KV page (paged layout)
    head_pad_to: int = 0          # pad attention heads to a multiple (TP
    #                               divisibility); padded heads are masked
    #                               dead, so the math is unchanged
    mlp_psum_bf16: bool = False   # manual-collective TP MLP (shard_map +
    #                               bf16 psum) — halves TP all-reduce bytes
    fuse_moe_dense_ar: bool = False  # arctic: fuse the dense-residual MLP
    #                                  reduction into the MoE psum (1 AR)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so logits/embeddings shard
        evenly over the model axis (standard production practice)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def layer_period(self) -> int:
        """Layers per scan super-block (alternating structures)."""
        if self.family == "hybrid" and self.attn_every:
            return self.attn_every
        if self.xlstm:
            return 2
        return max(1, len(self.attn_types))

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs where long_500k applies (sub-quadratic decoding)
LONG_CONTEXT_OK = {"zamba2-2.7b", "xlstm-350m"}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # import the arch modules lazily so registration runs
        from . import archs  # noqa: F401
    return _REGISTRY[name]


def all_archs() -> list:
    from . import archs  # noqa: F401
    return sorted(_REGISTRY)


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells; skips filtered unless requested."""
    out = []
    for a in all_archs():
        for s in SHAPES.values():
            skip = ""
            if s.name == "long_500k" and a not in LONG_CONTEXT_OK:
                skip = "full-attention arch: long_500k needs sub-quadratic attention"
            out.append((a, s.name, skip))
    return out if include_skips else [(a, s) for a, s, sk in out if not sk]
