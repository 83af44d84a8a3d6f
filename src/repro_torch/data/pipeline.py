"""Deterministic, resumable synthetic data pipeline, as in the reference
(``repro.data.pipeline``).

Each global step's batch is a pure function of (seed, step), made with
numpy exactly as the reference makes it, so both packages see the same
arrays for the same (seed, step), and a restart at step N reproduces the
batches a failed run would have seen. ``sharded_batch`` becomes a move of
the batch to one explicit device (the multi-device path waits for its
slice, ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0
    d_model: int = 0


class SyntheticLM:
    """Markov-ish token stream: next token = (a*tok + b + noise) % V, so a
    model can actually reduce loss on it (examples/train_lm_torch.py)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        f = cfg.frontend_tokens
        text = s - f if f else s
        toks = np.empty((b, text + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, b)
        noise = rng.random((b, text)) < 0.05
        rnd = rng.integers(0, cfg.vocab_size, (b, text))
        for t in range(text):
            nxt = (toks[:, t] * 31 + 7) % cfg.vocab_size
            toks[:, t + 1] = np.where(noise[:, t], rnd[:, t], nxt)
        out = {
            "tokens": toks[:, :-1],
            "labels": np.pad(toks[:, 1:], ((0, 0), (f, 0))),
            "mask": np.pad(np.ones((b, text), np.float32), ((0, 0), (f, 0))),
        }
        if f:
            out["frontend_embeds"] = rng.normal(
                size=(b, f, cfg.d_model)).astype(np.float32)
        return out

    def device_batch(self, step: int, device) -> dict:
        """``batch(step)`` as torch tensors on ``device``."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch(step).items()}
