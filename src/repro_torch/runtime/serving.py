"""Serving steps: prefill (builds the KV cache) and decode (one token), as
in the reference (``repro.runtime.serving``). Sampling is greedy argmax.
PyTorch runs eagerly, so the steps are plain functions (no ``jit``); the
cache is updated in place and returned."""
from __future__ import annotations

import torch


def make_prefill_step(model):
    def prefill_step(params, cache, batch):
        logits, cache = model.prefill(params, batch["tokens"], cache)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, token, pos: int):
        """token [B,1] int, pos host int -> (next_token [B], cache)."""
        logits, cache = model.decode_step(params, token, cache, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, cache

    return serve_step


def greedy_generate(model, params, cache, prompt, steps: int,
                    governor=None):
    """Prefill ``prompt`` [B,S] and decode to ``steps`` tokens [B, steps].

    ``governor`` is an optional ``MemoryGovernor`` (e.g. the HBM split's
    ``runtime.hbm_tuner.HBMGovernor``) observed once per decode step."""
    prefill = make_prefill_step(model)
    step = make_serve_step(model)
    tok, cache = prefill(params, cache, {"tokens": prompt})
    out = [tok]
    pos = prompt.shape[1]
    for i in range(steps - 1):
        tok, cache = step(params, cache, tok[:, None], pos + i)
        out.append(tok)
        if governor is not None:
            governor.observe(None)     # no storage service in this loop
    return torch.stack(out, dim=1), cache
