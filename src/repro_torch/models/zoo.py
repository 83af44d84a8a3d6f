"""Model zoo: build an architecture from its config. The dense, moe and
hybrid (Zamba2: Mamba2 groups with a shared attention block) families are
ported; ``CausalLM`` refuses the others, ssm (xLSTM), vlm and encdec
(ROADMAP Queue 1, "Rest of the serving model stack" brings them)."""
from __future__ import annotations

from .transformer import CausalLM


def build_model(cfg):
    return CausalLM(cfg)
