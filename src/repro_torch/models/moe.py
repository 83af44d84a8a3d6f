"""Mixture-of-Experts block, as in the reference (``repro.models.moe``):
capacity-bounded, sort-based dispatch of each token's top-k experts with
static shapes. Used by arctic-480b (top-2 of 128 + dense residual) and
granite-moe (top-8 of 32).

Only the reference's no-mesh branch is ported: one shard holds every
expert. Its expert-parallel branch (``shard_map`` over the ``model`` axis,
one psum, and ``fuse_moe_dense_ar``) needs a mesh and waits for the
training and sharding slice on ``torch.distributed`` (ROADMAP Queue 1,
"Training and the rest"); ``_moe_local`` keeps its ``(e_start, e_local)``
signature for it. The reference computes all of this outside any Pallas
kernel, so here it is plain torch ops; the expert products are ``bmm``.

Each step keeps the reference's order and dtype, because one flipped
expert or one other dropped pair moves the output by far more than
rounding does:

  * router logits in ``x.dtype``, softmax in f32, the renormalised gates
    cast to ``x.dtype``;
  * top-k as ``jax.lax.top_k`` orders it: descending, the lower expert id
    first among equal gates (a stable descending sort, not ``topk``,
    whose order among ties is unspecified);
  * pairs sorted stably by local expert id, segment starts searched on
    the left, and every pair past ``cap`` (or outside the shard) written
    to the one drop slot ``e_local * cap``, which is discarded;
  * the combine: each token's k gated outputs, in ``x.dtype``, summed by
    one ``sum`` over its pairs in rank order, not by ``index_add_``,
    whose CUDA atomics add in no fixed order: the combine is
    deterministic on the card as on the CPU, in every dtype. The
    reference's scatter-add rounds after each add, in ascending expert
    order; ``sum`` accumulates bf16 in f32 and rounds once, so the two
    differ by rounding only (1e-5 in f32 in the tests).
"""
from __future__ import annotations

import torch

from .layers import P, mlp


def moe_spec(cfg) -> dict:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    s = d ** -0.5
    return {
        "router": P((d, e), ("embed", "experts_r"), scale=s),
        "wi_gate": P((e, d, ff), ("experts", "embed", "mlp"), scale=s),
        "wi_up": P((e, d, ff), ("experts", "embed", "mlp"), scale=s),
        "wo": P((e, ff, d), ("experts", "mlp", "embed"), scale=ff ** -0.5),
    }


def _capacity(cfg, tokens: int) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor
              / max(cfg.num_experts, 1))
    return max(8, -(-cap // 8) * 8)        # round up to a multiple of 8


def router_logits(p, x):
    """``x @ router``, taken in x.dtype: [T, E]."""
    return x @ p["router"].to(x.dtype)


def router_gates(p, x):
    """Softmax over experts, in f32, of ``router_logits``: [T, E]."""
    return torch.softmax(router_logits(p, x).float(), dim=-1)


def top_k(gates, k: int):
    """(values, ids) [T, k] of the k largest gates per row, ordered as
    ``jax.lax.top_k``: descending, the lower id first among ties."""
    ids = torch.argsort(gates, dim=-1, descending=True, stable=True)[:, :k]
    return gates.gather(-1, ids), ids


def dispatch(eid, cap: int, e_start: int, e_local: int):
    """Sort the flattened (token, rank) pairs ``eid`` [T*k] by local expert
    id, stably: (order, slot). ``slot`` is each
    sorted pair's row in the [e_local * cap + 1] dispatch buffer, the
    last row being the drop slot of pairs past ``cap`` or outside the
    shard."""
    le = eid - e_start
    valid = (le >= 0) & (le < e_local)
    le_sort = torch.where(valid, le, torch.full_like(le, e_local))
    order = torch.argsort(le_sort, stable=True)
    le_s = le_sort[order]
    seg_start = torch.searchsorted(
        le_s, torch.arange(e_local + 1, device=eid.device), right=False)
    pos = torch.arange(eid.numel(), device=eid.device) - seg_start[le_s]
    keep = (le_s < e_local) & (pos < cap)
    slot = torch.where(keep, le_s * cap + pos,
                       torch.full_like(pos, e_local * cap))
    return order, slot


def _moe_local(cfg, p, x, e_start: int, e_local: int):
    """Route the tokens x [T, d] to the experts ``e_start ..
    e_start + e_local - 1``, whose weights ``p`` holds ([e_local, ...]; the
    router is whole). Returns their contribution [T, d]."""
    t, d = x.shape
    k = cfg.top_k
    cap = _capacity(cfg, t)
    gate_k, eid_k = top_k(router_gates(p, x), k)
    gate_k = gate_k / gate_k.sum(-1, keepdim=True).clamp_min(1e-9)
    gate = gate_k.reshape(-1).to(x.dtype)
    order, slot = dispatch(eid_k.reshape(-1), cap, e_start, e_local)
    tok_s = order // k                  # pair t * k + j belongs to token t
    # Receive-side dispatch: scatter token ids into the slots, then gather
    # rows (the drop slot's entry is discarded).
    src = torch.full((e_local * cap + 1,), t, dtype=torch.long,
                     device=x.device)
    src[slot] = tok_s
    x_pad = torch.cat([x, x.new_zeros(1, d)])
    h = x_pad[src[:-1]].view(e_local, cap, d)
    g = torch.bmm(h, p["wi_gate"].to(x.dtype))
    u = torch.bmm(h, p["wi_up"].to(x.dtype))
    o = torch.bmm(torch.nn.functional.silu(g) * u, p["wo"].to(x.dtype))
    o_flat = torch.cat([o.reshape(e_local * cap, d), x.new_zeros(1, d)])
    # Each pair's slot back in pair order (token t's pairs are rows
    # t*k .. t*k + k-1), then one sum over each token's k pairs.
    pair_slot = torch.empty_like(slot)
    pair_slot[order] = slot
    part = o_flat[pair_slot] * gate[:, None]                    # [T*k, d]
    return part.view(t, k, d).sum(1)


def moe_block(cfg, p, x, dense_mlp=None):
    """x: [B, S, d] through every expert on one shard; with ``dense_mlp``
    (arctic's dense residual FFN) its output is added."""
    b, s, d = x.shape
    y = _moe_local(cfg, p, x.reshape(b * s, d), 0, cfg.num_experts)
    y = y.reshape(b, s, d)
    if dense_mlp is not None:
        y = y + mlp(dense_mlp, x, x.dtype)
    return y
