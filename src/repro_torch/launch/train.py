"""Training entry point: config -> (restore) -> loop -> checkpoints, as
``repro.launch.train``, on one device. Every attention call runs K6 forward
and its backward kernels on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --reduced --device cpu --steps 50 --batch 8 --seq 64 --ckpt /tmp/ck

Weights and optimizer state are random, drawn from ``--seed`` with a
``torch.Generator`` on the device; the data is the reference's
``SyntheticLM`` stream (numpy, seed 0), so both packages see the same
batches. Params are updated in place (the reference's entry point
donates them to its jitted step). It prints the reference's lines and, on a card,
one ``[train] card`` line of JSON: the median step ms (host clock, each
step ends in a synchronising read of its loss; the first step is left
out), tokens/s, peak device bytes, the caching allocator's retries in
the run (each frees cached blocks and synchronises) and MFU, the model
FLOPs of a step (``utils.flops.model_flops``) over the step time and the
card's dense bf16 peak. Only ``--mesh 1x1`` runs: the multi-device mesh
waits for its slice (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ShapeConfig, get_config, reduced as make_reduced
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import build_model, init_params, num_params
from repro_torch.runtime.checkpoint import Checkpointer
from repro_torch.runtime.elastic import Preemption, StragglerMonitor
from repro_torch.runtime.training import (TrainConfig, make_train_step,
                                          opt_state_specs)
from repro_torch.utils.flops import model_flops

# NVIDIA H100 SXM, dense bf16 tensor-core peak (data sheet, 700 W).
H100_SXM_BF16_DENSE_FLOPS = 989e12


def _retries() -> int:
    return torch.cuda.memory_stats().get("num_alloc_retries", 0)


def card_stats(step_s: list, cfg, batch: int, seq: int, n_params: int,
               retries0: int):
    """The card's numbers of a run: median step ms over ``step_s`` but the
    first, tokens/s, peak device bytes, allocator retries since
    ``retries0`` and MFU."""
    steady = step_s[1:] or step_s
    med = float(np.median(steady))
    flops = model_flops(cfg, ShapeConfig("train", seq, batch, "train"),
                        n_params)
    return {"steps_timed": len(steady), "step_ms_median": med * 1e3,
            "tokens_per_s": batch * seq / med,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "alloc_retries": _retries() - retries0,
            "model_flops_per_step": flops,
            "mfu": flops / med / H100_SXM_BF16_DENSE_FLOPS,
            "mfu_peak": "H100 SXM dense bf16, 989 TFLOP/s"}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; the mesh "
            f"waits for its slice (ROADMAP Queue 1 item 4)")
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU; pass --device cpu to "
                           "run on the CPU")
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        retries0 = _retries()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(cfg)
    pspec = model.param_specs()
    ospec = opt_state_specs(pspec, cfg)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       warmup_steps=max(2, args.steps // 20),
                       microbatches=args.microbatches)
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, frontend_tokens=cfg.frontend_tokens,
        d_model=cfg.d_model))
    ck = Checkpointer(args.ckpt) if args.ckpt else None
    mon = StragglerMonitor()
    pre = Preemption()

    params = init_params(pspec, torch.Generator(dev).manual_seed(args.seed),
                         cfg.param_dtype, dev)
    opt = init_params(ospec, torch.Generator(dev).manual_seed(args.seed + 1),
                      cfg.optstate_dtype, dev)
    start = 0
    if ck and ck.latest_step() is not None:
        restored, start = ck.restore({"params": params, "opt": opt})
        params, opt = restored["params"], restored["opt"]
        print(f"[train] restored checkpoint at step {start}")
    step_fn = make_train_step(model, tcfg, donate=True)
    losses, step_s = [], []
    for step in range(start, args.steps):
        t0 = time.time()
        batch = data.device_batch(step, dev)
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = time.time() - t0
        step_s.append(dt)
        if mon.observe(dt):
            print("[train] straggler monitor tripped: checkpoint+restart")
            break
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms")
        if ck and ((step + 1) % args.ckpt_every == 0 or pre.requested):
            ck.save(step + 1, {"params": params, "opt": opt})
        if pre.requested:
            print("[train] preemption requested: exiting cleanly")
            break
    if ck:
        ck.save(args.steps, {"params": params, "opt": opt})
        ck.wait()
    print(f"[train] done. first loss={losses[0]:.4f} "
          f"last loss={losses[-1]:.4f}")
    if on_card and step_s:
        print("[train] card " + json.dumps(card_stats(
            step_s, cfg, args.batch, args.seq, num_params(pspec),
            retries0)))
    return losses


if __name__ == "__main__":
    main()
