"""Model zoo: build an architecture from its config. The dense and moe
families are ported; ``CausalLM`` refuses the others (ROADMAP Queue 1,
"Rest of the serving model stack" brings them)."""
from __future__ import annotations

from .transformer import CausalLM


def build_model(cfg):
    return CausalLM(cfg)
