"""Serving entry point: batched requests over a paged KV pool with the adaptive
HBM split (KV pool vs prefix cache) driven by the paper's memory tuner, as
``repro.launch.serve``. Every attention call runs K6 on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

Weights are random, drawn from ``--seed`` with a ``torch.Generator`` on the
device; the prompts come from numpy's generator seeded 0, as in the
reference, so the pool and tuner see the reference's stream. Params are
held in ``param_dtype``; one compute-dtype copy of the weights is made at
load (``CausalLM.compute_params``).
"""
from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch

from repro_torch.configs import get_config, reduced as make_reduced
from repro_torch.models import build_model, init_params
from repro_torch.runtime.hbm_tuner import HBMGovernor, HBMTunerConfig
from repro_torch.runtime.kvcache import KVPoolConfig, PagedKVPool
from repro_torch.runtime.serving import make_prefill_step, make_serve_step


def chunk_hashes(tokens: np.ndarray, page_tokens: int):
    out = []
    for i in range(0, len(tokens) - len(tokens) % page_tokens, page_tokens):
        out.append(zlib.crc32(tokens[i:i + page_tokens].tobytes()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--shared-prefix-frac", type=float, default=0.6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a GPU; pass --device cpu to "
                           "run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(model.param_specs(), gen, cfg.param_dtype, dev)
    cparams = model.compute_params(params)
    prefill = make_prefill_step(model)
    decode = make_serve_step(model)

    pool = PagedKVPool(KVPoolConfig(page_tokens=16, total_pages=1024,
                                    pool_pages=512, policy="opt"))
    # the HBM split is governed through the same MemoryGovernor interface
    # the LSM StorageService uses (observe-per-step -> MemoryPlan)
    governor = HBMGovernor(pool, HBMTunerConfig(ops_cycle=256))

    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab_size, args.prompt_len // 2)
    max_len = args.prompt_len + args.gen
    total_tokens = 0
    for r in range(0, args.requests, args.batch):
        b = min(args.batch, args.requests - r)
        prompts = []
        for i in range(b):
            if rng.random() < args.shared_prefix_frac:
                head = shared
            else:
                head = rng.integers(0, cfg.vocab_size, args.prompt_len // 2)
            tail = rng.integers(0, cfg.vocab_size,
                                args.prompt_len - len(head))
            prompts.append(np.concatenate([head, tail]))
        prompts = np.stack(prompts).astype(np.int32)
        # prefix-cache accounting (host metadata; device prefill recomputes
        # missed chunks — here the whole prompt for simplicity)
        for i in range(b):
            for h in chunk_hashes(prompts[i], pool.cfg.page_tokens):
                pool.lookup_prefix(h)
        cache = init_params(model.cache_specs(b, max_len), gen,
                            cfg.param_dtype, dev)
        tok, cache = prefill(cparams, cache,
                             {"tokens": torch.from_numpy(prompts).to(dev)})
        name = f"req{r}"
        pool.append_tokens(name, args.prompt_len * b)
        for g in range(args.gen):
            tok, cache = decode(cparams, cache, tok[:, None],
                                args.prompt_len + g)
            pool.append_tokens(name, b)
            plan = governor.observe()
            if plan:
                rec = governor.records[-1]
                print(f"[governor] pool={int(rec['x'])}->{int(rec['x_next'])} "
                      f"pages miss_rate={rec['miss_rate']:.2f} "
                      f"offload/op={rec['offload_per_op']:.3f}")
        pool.finish_stream(name)
        total_tokens += b * (args.prompt_len + args.gen)
    st = pool.stats
    hit = st["prefix_hits"] / max(1, st["prefix_hits"] + st["prefix_misses"])
    print(f"[serve] tokens={total_tokens} prefix_hit_rate={hit:.2f} "
          f"offload_pages={st['offload_pages']} "
          f"pool_pages={pool.cfg.pool_pages} "
          f"tuner_steps={len(governor.records)}")
    return st


if __name__ == "__main__":
    main()
