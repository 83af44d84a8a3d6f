"""Training: loss, AdamW (+WSD schedule), grad clipping, microbatch
accumulation and the mixed-precision policy, as in the reference
(``repro.runtime.training``), on one device.

Gradients come from ``torch.autograd`` through ``CausalLM.apply``, whose
attention runs K6 forward and backward (``kernels/attention``). Each step
keeps the reference's order of operations and dtypes: the f32 AdamW
arithmetic per leaf, the schedule in f32 from an int32 ``step``, and with
``microbatches > 1`` the gradients accumulated in a bf16 buffer with an
f32 error-feedback buffer. With ``param_dtype`` other than f32 an f32
``master`` copy lives in the optimizer state (unless ``optstate_dtype`` is
bf16 too).

``make_train_step(model, tcfg)`` returns a function of (params, opt,
batch) that leaves its inputs as they are, as the reference's does; with
``donate=True`` it writes the new params and state into the input tensors
instead (what ``jax.jit(..., donate_argnums=(0, 1))`` gives the
reference's entry point), so that a full-width step holds one copy of
them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.params import P, flatten, tree_map, unflatten


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    schedule: str = "wsd"            # wsd | cosine | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1          # WSD: last 10% decays
    final_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    microbatches: int = 1            # gradient accumulation steps


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule_lr(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int tensor), in f32."""
    s = step.to(torch.float32)
    peak = tcfg.learning_rate
    warm = peak * (s + 1) / max(tcfg.warmup_steps, 1)
    if tcfg.schedule == "constant":
        return torch.minimum(warm, _f32(peak, s))
    total = float(tcfg.total_steps)
    if tcfg.schedule == "cosine":
        frac = torch.clip((s - tcfg.warmup_steps)
                          / max(total - tcfg.warmup_steps, 1), 0, 1)
        lr = peak * (tcfg.final_lr_frac + (1 - tcfg.final_lr_frac)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.minimum(warm, lr)
    if tcfg.schedule != "wsd":
        raise ValueError(f"unknown schedule {tcfg.schedule!r}")
    # WSD (minicpm): warmup -> stable -> decay over the last decay_frac
    decay_start = total * (1.0 - tcfg.decay_frac)
    frac = torch.clip((s - decay_start) / max(total - decay_start, 1), 0, 1)
    lr = peak * (1.0 - (1.0 - tcfg.final_lr_frac) * frac)
    return torch.minimum(warm, lr)


def cross_entropy(logits, labels, mask=None):
    """logits [B,S,V] (f32), labels [B,S] int. Returns (loss, n_tok)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.float32)
    mask = mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / n, n


# ----------------------------- optimizer -------------------------------------
def opt_state_specs(param_specs_tree, cfg) -> dict:
    """AdamW state specs mirroring the param tree (same logical axes)."""
    def like(s):
        return P(s.shape, s.axes, init="zeros", dtype=cfg.optstate_dtype)

    state = {
        "m": tree_map(like, param_specs_tree),
        "v": tree_map(like, param_specs_tree),
        "step": P((), (), init="zeros", dtype="int32"),
    }
    if cfg.param_dtype != "float32" and cfg.optstate_dtype == "float32":
        state["master"] = tree_map(
            lambda s: P(s.shape, s.axes, init=s.init, scale=s.scale,
                        dtype="float32"), param_specs_tree)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves (JAX's order) of their f32 squares."""
    total = None
    for x in flatten(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(params, grads, opt, tcfg: TrainConfig, *,
                 donate: bool = False):
    """One AdamW step. Returns (params, opt, {"lr", "grad_norm"}); with
    ``donate`` the new values are written into ``params`` and ``opt``."""
    step = opt["step"] + 1
    lr = schedule_lr(tcfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(tcfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1, b2 = tcfg.b1, tcfg.b2
    has_master = "master" in opt
    master = opt["master"] if has_master else params
    sf = step.to(torch.float32)
    bc1 = 1 - _f32(b1, sf) ** sf
    bc2 = 1 - _f32(b2, sf) ** sf

    def upd(p_master, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        upd_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + tcfg.eps)
        p32 = p_master.float()
        p_new = p32 - lr * (upd_ + tcfg.weight_decay * p32)
        return p_new, m32.to(m.dtype), v32.to(v.dtype)

    leaves_p = flatten(params)
    out_master, out_p, out_m, out_v = [], [], [], []
    for pm, p, g, m, v in zip(flatten(master), leaves_p, flatten(grads),
                              flatten(opt["m"]), flatten(opt["v"])):
        p_new, m_new, v_new = upd(pm, g, m, v)
        if donate:                   # one leaf's temporaries at a time
            m.copy_(m_new)
            v.copy_(v_new)
            if has_master:
                pm.copy_(p_new)
            p.copy_(p_new.to(p.dtype))
        else:
            out_master.append(p_new)
            out_p.append(p_new.to(p.dtype))
            out_m.append(m_new)
            out_v.append(v_new)
    if donate:
        opt["step"].copy_(step)
        return params, opt, {"lr": lr, "grad_norm": gnorm}
    new_opt = {"m": unflatten(opt["m"], out_m),
               "v": unflatten(opt["v"], out_v), "step": step}
    if has_master:
        new_opt["master"] = unflatten(opt["master"], out_master)
    return unflatten(params, out_p), new_opt, {"lr": lr, "grad_norm": gnorm}


# ----------------------------- train step ------------------------------------
def loss_and_grads(model, params, batch, microbatches: int = 1):
    """(loss, grads): the mean loss over ``batch`` and its gradient, a tree
    shaped as ``params`` (each leaf in its param's dtype). With
    ``microbatches`` > 1 the batch's leading dim is split and the grads
    accumulate in bf16 with an f32 error-feedback buffer, in the
    reference's order; they come back in f32 over ``microbatches``."""
    leaves = [t.detach().requires_grad_() for t in flatten(params)]
    live = unflatten(params, leaves)

    def one(mb):
        with torch.enable_grad():
            logits = model.apply(live, mb["tokens"],
                                 frontend_embeds=mb.get("frontend_embeds"))
            loss, _ = cross_entropy(logits, mb["labels"], mb.get("mask"))
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    a = microbatches
    if a == 1:
        loss, grads = one(batch)
        return loss, unflatten(params, list(grads))
    mbs = [{k: x.reshape((a, x.shape[0] // a) + x.shape[1:])[i]
            for k, x in batch.items()} for i in range(a)]
    gacc = [torch.zeros_like(t, dtype=torch.bfloat16) for t in leaves]
    err = [torch.zeros_like(t, dtype=torch.float32) for t in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for mb in mbs:
        loss, g = one(mb)
        # error-feedback bf16 accumulation (grad "compression")
        for i, gi in enumerate(g):
            gi = gi.float() + err[i]
            acc2 = (gacc[i].float() + gi).to(torch.bfloat16)
            err[i] = (gacc[i].float() + gi) - acc2.float()
            gacc[i] = acc2
        loss_sum = loss_sum + loss
    return loss_sum / a, unflatten(params, [g.float() / a for g in gacc])


def make_train_step(model, tcfg: TrainConfig, *, donate: bool = False):
    """Returns train_step(params, opt, batch) -> (params, opt, metrics):
    ``loss_and_grads`` then ``adamw_update``.

    batch: {"tokens": [B,S], "labels": [B,S], "mask": [B,S]} tensors
           (+ "frontend_embeds": [B,F,d] for archs with a frontend).
    """
    def train_step(params, opt, batch):
        loss, grads = loss_and_grads(model, params, batch, tcfg.microbatches)
        with torch.no_grad():
            params, opt, om = adamw_update(params, grads, opt, tcfg,
                                           donate=donate)
        return params, opt, {"loss": loss, **om}

    return train_step
