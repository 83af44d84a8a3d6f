"""Model zoo: build an architecture from its config. Only the dense family
is ported (ROADMAP Queue 1, item 9 brings the others)."""
from __future__ import annotations

from .transformer import CausalLM


def build_model(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported (ROADMAP Queue 1, item 9)")
    return CausalLM(cfg)
