"""CausalLM for the dense, moe and hybrid families, as in the reference
(``repro.models.transformer``): the same param and cache trees (per-slot
params stacked ``[n_super, ...]``), with the layer stack run as a Python
loop over the stacked params (no ``scan``, and no mesh to constrain to).
A moe slot is an
attention block followed by ``moe_block`` on one shard, plus the dense
residual FFN where ``moe_dense_ff`` is set. The hybrid family (Zamba2) is
groups of ``attn_every`` Mamba2 slots, each group followed by one
attention + MLP block whose weights all groups share (``shared_attn``,
one tree, not stacked) and whose KV cache each group has of its own
(stacked ``[n_super, ...]``).

Attention writes its K and V into the cache in place; ``mamba2_block``
returns a new state, which ``_apply_slot`` copies into the stacked
cache's views, or prefill state would never reach decode.

Training differentiates ``apply`` (no cache, so no write in place on the
autograd path) on the params as they are held, casting each weight to the
compute dtype per call as the reference does (``compute_params`` is for
serving). ``cfg.remat == "full"`` runs each super-block under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable`` around its scan body): its activations are
recomputed in the backward, so K6's forward runs twice a layer per step.

The other families (ssm, i.e. xLSTM, encdec, vlm) are not ported yet
(ROADMAP Queue 1, "Rest of the serving model stack").
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import attention_block, attn_spec, padded_heads
from .layers import (P, embed, embed_spec, mlp, mlp_spec, rmsnorm,
                     rmsnorm_spec, softcap, unembed)
from .moe import moe_block, moe_spec
from .params import tree_map, unstack
from .ssm import mamba2_block, mamba2_cache_spec, mamba2_spec

# Leaves that the reference's forward reads in f32 whatever the compute
# dtype, so that ``compute_params`` keeps them in f32: the RMSNorm scales
# (``layers.rmsnorm``) and Mamba2's ``A_log``, ``dt_bias`` and gated-norm
# ``norm`` (``models/ssm.py``, ``mamba2_block``). xLSTM's ``norm``, ``bf``
# and ``b`` join them with its slice. Every other leaf the forward casts
# to the compute dtype per call (Mamba2's ``D`` to ``y.dtype``, which is
# the compute dtype), so casting it once at load gives the same values.
F32_LEAVES = ("scale", "A_log", "dt_bias", "norm")


# ----------------------------- slot layout -----------------------------------
def block_slots(cfg) -> list:
    if cfg.family == "hybrid" and cfg.attn_every:
        return ["mamba"] * cfg.attn_every          # + shared attn per group
    if cfg.xlstm or cfg.family not in ("dense", "moe", "hybrid"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP Queue 1, \"Rest "
            f"of the serving model stack\")")
    if cfg.family == "moe":
        return ["attn_moe"] * max(1, len(cfg.attn_types))
    return [f"attn:{t}" for t in cfg.attn_types]


def n_super(cfg) -> int:
    period = len(block_slots(cfg))
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.num_layers} layers do not fill slots of "
                         f"{period}")
    return cfg.num_layers // period


def _slot_spec(cfg, slot: str) -> dict:
    d = cfg.d_model
    if slot == "mamba":
        return {"ln": rmsnorm_spec(d), "mamba": mamba2_spec(cfg)}
    if slot == "attn_moe":
        spec = {"ln": rmsnorm_spec(d), "attn": attn_spec(cfg),
                "ln2": rmsnorm_spec(d), "moe": moe_spec(cfg)}
        if cfg.moe_dense_ff:
            spec["mlp"] = mlp_spec(d, cfg.moe_dense_ff)
        return spec
    return {"ln": rmsnorm_spec(d), "attn": attn_spec(cfg),
            "ln2": rmsnorm_spec(d), "mlp": mlp_spec(d, cfg.d_ff)}


def _slot_cache_spec(cfg, slot: str, batch: int, max_len: int):
    if slot == "mamba":
        return mamba2_cache_spec(cfg, batch)
    kv, hd = padded_heads(cfg)[1], cfg.resolved_head_dim
    if cfg.kv_layout != "sd":
        raise NotImplementedError(
            f"kv_layout {cfg.kv_layout!r} is not ported (ROADMAP Queue 1, "
            f"\"Rest of the serving model stack\": only 'sd' is on the "
            f"serving path)")
    shape = (batch, max_len, kv, hd)
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": P(shape, axes, init="zeros", dtype=cfg.compute_dtype),
            "v": P(shape, axes, init="zeros", dtype=cfg.compute_dtype)}


def _apply_slot(cfg, slot, p, x, positions, pos0, cache):
    if slot == "mamba":
        y, nc = mamba2_block(cfg, p["mamba"],
                             rmsnorm(p["ln"], x, cfg.norm_eps), cache)
        if cache is not None:                   # the new state, in place
            for name, t in nc.items():
                cache[name].copy_(t)
        return x + y, cache
    window = cfg.window if slot == "attn:local" else 0
    h_in = rmsnorm(p["ln"], x, cfg.norm_eps)
    y, nc = attention_block(cfg, p["attn"], h_in, positions, pos0,
                            layer_window=window, cache=cache)
    x = x + y
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if slot == "attn_moe":
        return x + moe_block(cfg, p["moe"], h, dense_mlp=p.get("mlp")), nc
    return x + mlp(p["mlp"], h, x.dtype), nc


def _stack(n: int, tree):
    return tree_map(lambda s: P((n,) + s.shape, ("layers",) + s.axes,
                                init=s.init, scale=s.scale, dtype=s.dtype),
                    tree)


# ----------------------------- the model --------------------------------------
class CausalLM:
    """Decoder-only LM of the dense, moe and hybrid families."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.slots = block_slots(cfg)
        self.n_super = n_super(cfg)
        self.shared_attn = cfg.family == "hybrid" and cfg.attn_every > 0

    # -- specs ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        spec = {
            "embed": embed_spec(cfg.padded_vocab, cfg.d_model),
            "final_norm": rmsnorm_spec(cfg.d_model),
            "blocks": [_stack(self.n_super, _slot_spec(cfg, s))
                       for s in self.slots],
        }
        if self.shared_attn:
            spec["shared_attn"] = _slot_spec(cfg, "attn:global")
        return spec

    def cache_specs(self, batch: int, max_len: int) -> dict:
        cache = {"blocks": [
            _stack(self.n_super, _slot_cache_spec(self.cfg, s, batch,
                                                  max_len))
            for s in self.slots]}
        if self.shared_attn:
            cache["shared_attn"] = _stack(self.n_super, _slot_cache_spec(
                self.cfg, "attn:global", batch, max_len))
        return cache

    def compute_params(self, params) -> dict:
        """A copy of ``params`` with each weight that the forward casts to
        the compute dtype cast once: every leaf but those of
        ``F32_LEAVES``, which the forward reads in f32. Same values as the
        reference's per-call ``.astype``; the same tensors when the dtypes
        agree."""
        dt = getattr(torch, self.cfg.compute_dtype)

        def walk(tree, key=""):
            if isinstance(tree, dict):
                return {k: walk(v, k) for k, v in tree.items()}
            if isinstance(tree, list):
                return [walk(v, key) for v in tree]
            return tree if key in F32_LEAVES else tree.to(dt)

        return walk(params)

    # -- forward ------------------------------------------------------------------
    def _super_block(self, params, blocks, x, positions, pos0: int, cache,
                     li: int):
        """Super-block ``li``: its group's slots on ``blocks`` (one tree a
        slot, this layer's params), then (hybrid) the shared attention
        block on ``params["shared_attn"]`` with the group's own KV cache.
        Every slot writes its cache views in place."""
        def view(tree):
            return {n: t[li] for n, t in tree.items()}

        for i, slot in enumerate(self.slots):
            c = None if cache is None else view(cache["blocks"][i])
            x, _ = _apply_slot(self.cfg, slot, blocks[i], x, positions, pos0,
                               c)
        if self.shared_attn:
            c = None if cache is None else view(cache["shared_attn"])
            x, _ = _apply_slot(self.cfg, "attn:global", params["shared_attn"],
                               x, positions, pos0, c)
        return x

    def _run_blocks(self, params, x, positions, pos0: int, cache):
        """The super-blocks in order; with a gradient to take and
        ``cfg.remat == "full"``, each one under ``torch.utils.checkpoint``.
        The stacked params are split into layers by one ``unbind`` a leaf:
        its backward stacks the layers' gradients once, where indexing
        each layer would add a zero-filled [n_super, ...] gradient per
        layer."""
        remat = (cache is None and torch.is_grad_enabled()
                 and self.cfg.remat != "none")
        if remat and self.cfg.remat != "full":
            raise NotImplementedError(
                f"remat {self.cfg.remat!r} (save the matmuls' outputs) is not "
                f"ported; 'full' and 'none' are (ROADMAP Queue 1 item 4)")
        layers = unstack(params["blocks"], self.n_super)
        for li in range(self.n_super):
            if remat:
                x = checkpoint(self._super_block, params, layers[li], x,
                               positions, pos0, None, li, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._super_block(params, layers[li], x, positions, pos0,
                                      cache, li)
        return x

    def _logits(self, params, x):
        cfg = self.cfg
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = softcap(unembed(params["embed"], x, x.dtype).float(),
                         cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:   # mask vocab padding
            pad = torch.arange(cfg.padded_vocab, device=x.device) \
                >= cfg.vocab_size
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _positions(self, b: int, s: int, pos0: int, device):
        return (pos0 + torch.arange(s, device=device))[None, :].expand(b, s)

    def apply(self, params, tokens, frontend_embeds=None):
        """Teacher-forcing forward: tokens [B,S] -> logits [B,S,V]. As in
        the reference, ``frontend_embeds`` is read only by a config with a
        frontend, and the one such decoder family (vlm) is not ported
        (``block_slots`` refuses it), so it is not read here."""
        x = embed(params["embed"], tokens,
                  getattr(torch, self.cfg.compute_dtype))
        b, s, _ = x.shape
        x = self._run_blocks(params, x, self._positions(b, s, 0, x.device),
                             0, None)
        return self._logits(params, x)

    def prefill(self, params, tokens, cache):
        """Prompt tokens [B,S] -> (last-position logits [B,1,V], cache);
        the cache is written in place."""
        x = embed(params["embed"], tokens,
                  getattr(torch, self.cfg.compute_dtype))
        b, s, _ = x.shape
        x = self._run_blocks(params, x, self._positions(b, s, 0, x.device),
                             0, cache)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, token, cache, pos: int):
        """token: [B,1]; pos: host int position. One decode step; the
        cache is written in place."""
        x = embed(params["embed"], token,
                  getattr(torch, self.cfg.compute_dtype))
        positions = self._positions(x.shape[0], 1, pos, x.device)
        x = self._run_blocks(params, x, positions, pos, cache)
        return self._logits(params, x), cache
