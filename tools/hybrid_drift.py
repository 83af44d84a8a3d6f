#!/usr/bin/env python3
"""How far Zamba2-2.7B's residual stream drifts with depth under rounding
alone, on the CPU: the basis of ``chip_smoke.hybrid_model_phase``'s
design (each slot fed the CPU's input) and of its depth's time estimate.

    PYTHONPATH=src python tools/hybrid_drift.py [--seed 0] [--groups 9]

Runs the port's Zamba2 at full width (54 Mamba2 layers in 9 groups, each
followed by the shared attention + MLP block) on a batch of 4 x 48
tokens, one layer's random weights at a time (drawn from ``--seed``, so
that about 2.5 GB is held at once), and prints one JSON line per group:

  * ``f32_vs_f64``: the RMS of the difference between the f32 stream and
    the f64 one, each run free from the same embedded tokens;
  * ``perturbed``: the same between two f64 streams, one started from
    inputs perturbed by a relative 1e-7 (how the model amplifies a
    difference, without rounding);
  * ``slot_logits``: each slot run in f32 on the f64 stream's input, its
    output against the f64 slot's in logits (both through the model's
    head in f32): the largest RMS and max-abs difference in the group;
  * ``stream_rms``: the f64 stream's RMS.

Then one line of CPU seconds: one Mamba2 layer and the shared block, at
prefill (4 x 48) and at a decode step (4 x 1), in f32 and bf16.

The f64 runs are made under ``chip_smoke.float64_mode``:
``Tensor.float`` keeps float64 (the port casts to f32 where the
reference reads f32) and K6's wrapper, which takes f32 and bf16 only, is
replaced by its plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from chip_smoke import float64_mode  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model, init_params  # noqa: E402
from repro_torch.models.layers import embed_spec, rmsnorm_spec  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.ssm import mamba2_cache_spec  # noqa: E402
from repro_torch.models.transformer import (_apply_slot,  # noqa: E402
                                            _slot_spec)

ARCH = "zamba2-2.7b"
BATCH, PROMPT = 4, 48


def _rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def run_slot(cfg, slot, p, x, pos):
    """One slot as the model runs it at prefill (Mamba2 from a zero
    cache of x's dtype, as prefill does)."""
    cache = None
    if slot == "mamba":
        cache = {k: torch.zeros(s.shape, dtype=x.dtype)
                 for k, s in mamba2_cache_spec(cfg, x.shape[0]).items()}
    return _apply_slot(cfg, slot, p, x, pos, 0, cache)[0]


def drift(seed: int, groups: int) -> None:
    base = get_config(ARCH)
    c32 = base.with_(compute_dtype="float32")
    c64 = base.with_(compute_dtype="float64")
    model = build_model(c32)
    gen = torch.Generator().manual_seed(seed)
    head = {"embed": init_params(embed_spec(base.padded_vocab, base.d_model),
                                 gen, "float32", "cpu"),
            "final_norm": init_params(rmsnorm_spec(base.d_model), gen,
                                      "float32", "cpu")}
    shared = init_params(_slot_spec(base, "attn:global"), gen, "float32",
                         "cpu")
    shared64 = tree_map(lambda t: t.double(), shared)
    tokens = torch.randint(0, base.vocab_size, (BATCH, PROMPT),
                           generator=gen)
    x32 = head["embed"]["table"][tokens] * base.d_model ** 0.5
    x64 = x32.double()
    y64 = x64 * (1 + 1e-7 * torch.randn(x64.shape, generator=gen,
                                        dtype=torch.float64))
    pos = torch.arange(PROMPT)[None].expand(BATCH, PROMPT)
    for g in range(groups):
        worst = {"rms_err": 0.0, "max_abs_err": 0.0}
        for i in range(base.attn_every + 1):
            slot = "mamba" if i < base.attn_every else "attn:global"
            p = (init_params(_slot_spec(base, "mamba"), gen, "float32",
                             "cpu") if slot == "mamba" else shared)
            p64 = (tree_map(lambda t: t.double(), p) if slot == "mamba"
                   else shared64)
            anchored = run_slot(c32, slot, p, x64.float(), pos)
            x32 = run_slot(c32, slot, p, x32, pos)
            with float64_mode():
                x64 = run_slot(c64, slot, p64, x64, pos)
                y64 = run_slot(c64, slot, p64, y64, pos)
            d = (model._logits(head, anchored)
                 - model._logits(head, x64.float()))
            worst["rms_err"] = max(worst["rms_err"], _rms(d))
            worst["max_abs_err"] = max(worst["max_abs_err"],
                                       float(d.abs().max()))
        print(json.dumps({"group": g + 1,
                          "f32_vs_f64": _rms(x32.double() - x64),
                          "perturbed": _rms(y64 - x64),
                          "slot_logits": worst,
                          "stream_rms": _rms(x64)}), flush=True)


def cpu_seconds(seed: int) -> None:
    base = get_config(ARCH)
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for dname in ("float32", "bfloat16"):
        cfg = base.with_(compute_dtype=dname)
        m = build_model(cfg)
        dt = getattr(torch, dname)
        for slot in ("mamba", "attn:global"):
            p = m.compute_params(init_params(_slot_spec(cfg, slot), gen,
                                             "float32", "cpu"))
            for s in (PROMPT, 1):
                x = torch.randn(BATCH, s, base.d_model, generator=gen).to(dt)
                pos = torch.arange(s)[None].expand(BATCH, s)
                t0 = time.perf_counter()
                run_slot(cfg, slot, p, x, pos)
                out[f"{slot}/{dname}/s{s}"] = time.perf_counter() - t0
    print(json.dumps({"cpu_seconds": out, "threads":
                      torch.get_num_threads()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", type=int, default=9)
    args = ap.parse_args(argv)
    drift(args.seed, args.groups)
    cpu_seconds(args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
