#!/usr/bin/env python3
"""K6's bf16 checks against faults run in the kernel's place, on one GPU.

    python3 tools/k6_faults.py [--seeds N] [--out FILE]

Builds the kernel library from ``src/repro_torch/csrc`` as it is
("sound"), and once for each entry of ``FAULTS`` from a copy of those
sources in a temporary directory with one fault put into the tensor-core
kernel of ``attention.cu``. Each variant runs every bf16 case of
``chip_smoke.py``'s ``ATTN_CASES`` and ``ATTN_EDGES`` on the same seeded
inputs, against the plain version. Prints one JSON line per variant:
per case, the largest over the seeds of the max abs and the relative RMS
difference (``chip_smoke.attention_error``), and at ``P_ROUNDING_CASES``
the p-rounding reading (``chip_smoke.p_rounding``). ``chip_smoke.py``'s
``ATTN_REL_RMS`` lies between the sound kernel's readings and the
faults'. ``--out`` also writes every reading of every seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Each fault: its edits of attention.cu, (text, replacement) pairs. Every
# text must occur in the source exactly once.
FAULTS = {
    # p kept in f32: P.V as two bf16 products, of p rounded and of what
    # the rounding left, so p enters the sum to about 2^-17.
    "p_unrounded": [
        ("      uint32_t pa[MT][4];\n",
         "      uint32_t pa[MT][4], pl[MT][4];\n"),
        ("        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], "
         "s[mt][2 * kk + 1][3]);\n",
         "        pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], "
         "s[mt][2 * kk + 1][3]);\n"
         "#define LO_(x) ((x) - __bfloat162float(__float2bfloat16_rn(x)))\n"
         "        pl[mt][0] = pack_bf16(LO_(s[mt][2 * kk][0]), "
         "LO_(s[mt][2 * kk][1]));\n"
         "        pl[mt][1] = pack_bf16(LO_(s[mt][2 * kk][2]), "
         "LO_(s[mt][2 * kk][3]));\n"
         "        pl[mt][2] = pack_bf16(LO_(s[mt][2 * kk + 1][0]), "
         "LO_(s[mt][2 * kk + 1][1]));\n"
         "        pl[mt][3] = pack_bf16(LO_(s[mt][2 * kk + 1][2]), "
         "LO_(s[mt][2 * kk + 1][3]));\n"),
        ("          mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb4[2], vb4[3]);\n",
         "          mma_bf16(acc[mt][2 * dp + 1], pa[mt], vb4[2], vb4[3]);\n"
         "          mma_bf16(acc[mt][2 * dp], pl[mt], vb4[0], vb4[1]);\n"
         "          mma_bf16(acc[mt][2 * dp + 1], pl[mt], vb4[2], vb4[3]);\n")],
    # The key tile before a block's last one is skipped, where a block's
    # keys span more than two tiles: keys late in a long row that every
    # row of the block keeps.
    "late_tile_dropped": [
        ("    const bf16* vb = vsm + buf * BN * LD;\n",
         "    const bf16* vb = vsm + buf * BN * LD;\n"
         "    if (k_end - k_begin > 2 * BN && kt + BN < k_end &&\n"
         "        kt + 2 * BN >= k_end)\n"
         "      continue;\n")],
    # The online softmax never rescales m, l and acc to a new row max.
    "corr_one": [
        ("        const float corr = exp2_approx((m[mt][hr] - mx) * sl);\n",
         "        const float corr = 1.f;\n")],
}


def apply_fault(source: str, name: str) -> str:
    """``source`` (the text of attention.cu) with fault ``name`` put in."""
    for old, new in FAULTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"fault {name}: {old!r} occurs "
                             f"{source.count(old)} times in attention.cu")
        source = source.replace(old, new)
    return source


def _readings(cs, attn_k, torch, seeds: int) -> dict:
    """Every bf16 case of cs.ATTN_CASES and cs.ATTN_EDGES, per seed."""
    out = {}
    cases = [*cs.ATTN_CASES, *cs.ATTN_EDGES]
    for i, (name, shape) in enumerate(cases):
        for seed in range(seeds):
            gen = torch.Generator(device="cuda").manual_seed(1000 * seed + i)
            q, k, v = cs._attn_inputs(shape, torch.bfloat16, gen)
            kw = cs._attn_kw(shape)
            got = attn_k.flash_attention(q, k, v, **kw)
            want = attn_k.flash_attention_plain(q, k, v, **kw)
            r = cs.attention_error(got, want)
            if name in cs.P_ROUNDING_CASES:
                r["p_rounding"] = cs.p_rounding(
                    got, want, cs._p_unrounded(q, k, v, **kw))
            out.setdefault(name, []).append(r)
            del q, k, v, got, want
        torch.cuda.empty_cache()
    return out


def _summary(variant: str, readings: dict) -> dict:
    """The largest reading over the seeds, per case."""
    line = {"variant": variant, "max_abs_err": {}, "rel_rms": {},
            "p_rounding": {}}
    for name, rs in readings.items():
        line["max_abs_err"][name] = max(r["max_abs_err"] for r in rs)
        line["rel_rms"][name] = max(r["rel_rms"] for r in rs)
        if "p_rounding" in rs[0]:
            line["p_rounding"][name] = {
                "rms_vs_plain": max(r["p_rounding"]["rms_vs_plain"]
                                    for r in rs),
                "rms_plain_vs_unrounded": min(
                    r["p_rounding"]["rms_plain_vs_unrounded"] for r in rs),
                "ok": all(r["p_rounding"]["ok"] for r in rs)}
    return line


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", help="write every reading here as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("tools/k6_faults.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from variants import use, use_variant
    from repro_torch.kernels.attention import attention as attn_k

    sound_csrc, sound_build = build.CSRC, build.BUILD_DIR
    every = {}
    with tempfile.TemporaryDirectory() as tmp:
        for variant in ["sound", *FAULTS]:
            if variant == "sound":
                lib = use(build, sound_csrc, sound_build)
            else:
                text = (sound_csrc / "attention.cu").read_text()
                lib = use_variant(build, sound_csrc, Path(tmp) / variant, {
                    "attention.cu": apply_fault(text, variant)})
            readings = _readings(cs, attn_k, torch, args.seeds)
            every[variant] = readings
            line = _summary(variant, readings)
            line["library"] = Path(lib).name
            print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(every))
    return 0


if __name__ == "__main__":
    sys.exit(main())
