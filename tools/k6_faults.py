#!/usr/bin/env python3
"""K6's checks against faults run in the kernels' place, on one GPU.

    python3 tools/k6_faults.py [--seeds N] [--out FILE]

Builds the kernel library from ``src/repro_torch/csrc`` as it is
("sound"), and once for each fault from a copy of those sources in a
temporary directory with the fault put in. Three families, each read
where it can show:

* ``FAULTS``: the forward's tensor-core kernel of ``attention.cu`` (bf16):
  every bf16 case of ``chip_smoke.py``'s ``ATTN_CASES`` and
  ``ATTN_EDGES``;
* ``F32_FAULTS``: the forward's CUDA-core kernel (f32): every f32 case;
* ``BWD_FAULTS``: the backward (``attention_bwd.cu``) and the forward's
  log-sum-exp: every case of ``BWD_CASES`` and ``BWD_EDGES`` in both
  dtypes.

Every variant runs on the same seeded inputs, against the plain
versions; the sound library is read everywhere. Prints one JSON line per
variant: per case, the largest over the seeds of the forward's max abs
and relative RMS difference (``chip_smoke.attention_error``) and, at
``P_ROUNDING_CASES``, the p-rounding reading (``chip_smoke.p_rounding``);
of the backward, the largest over the gradients of the max difference
over the plain gradient's largest value and of the relative RMS
(``chip_smoke._grad_errors``), and the lse's max abs error.
``chip_smoke.py``'s ``ATTN_TOL``, ``ATTN_REL_RMS``, ``BWD_TOL`` and
``LSE_TOL`` lie between the sound kernels' readings and the faults'.
``--out`` also writes every reading of every seed.
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


# The CUDA-core kernel of attention.cu (f32, and misaligned bf16).
F32_FAULTS = {
    # The online softmax never rescales m, l and acc to a new row max.
    "simt_corr_one": [
        ("      const float corr = expf(m[r] - m_new);\n",
         "      const float corr = 1.f;\n")],
    # The key tile before a block's last one is skipped, where a block's
    # keys span more than two tiles.
    "simt_late_tile_dropped": [
        ("  for (int kt = k_begin; kt < k_end; kt += kBK) {\n",
         "  for (int kt = k_begin; kt < k_end; kt += kBK) {\n"
         "    if (k_end - k_begin > 2 * kBK && kt + kBK < k_end &&\n"
         "        kt + 2 * kBK >= k_end)\n"
         "      continue;\n")],
}

# The backward's kernels (attention_bwd.cu) and the log-sum-exp that the
# forward writes for it (attention.cu): name -> (file, edits).
BWD_FAULTS = {
    # dQ leaves out the diagonal key's term.
    "bwd_dq_diagonal_dropped": ("attention_bwd.cu", [
        ("        const float ds = dss[(warp * kRowsPerWarp + r) * (kBK + 1) "
         "+ j];\n",
         "        const float ds = k0 + j == r0 + warp * kRowsPerWarp + r\n"
         "            ? 0.f : dss[(warp * kRowsPerWarp + r) * (kBK + 1) + j];"
         "\n")]),
    # dK and dV of the last key tile are not written (zeros).
    "bwd_dkv_last_tile_dropped": ("attention_bwd.cu", [
        ("        gk[base + d] = from_f32<T>(dk[r][t] * a.scale);\n"
         "        gv[base + d] = from_f32<T>(dv[r][t]);\n",
         "        gk[base + d] = from_f32<T>(k0 + kBK >= a.sk ? 0.f\n"
         "                                   : dk[r][t] * a.scale);\n"
         "        gv[base + d] = from_f32<T>(k0 + kBK >= a.sk ? 0.f : dv[r][t]);"
         "\n")]),
    # The forward writes m for the lse, without log l, in both kernels.
    "lse_without_log_l": ("attention.cu", [
        ("= m[r] + logf(l[r]);", "= m[r];"),
        ("(capped ? m[mt][hr] : m[mt][hr] * a.scale) + logf(lt);",
         "(capped ? m[mt][hr] : m[mt][hr] * a.scale);")]),
}


def edits_of(name: str):
    """(source file, edits) of fault ``name`` of any family."""
    if name in FAULTS:
        return "attention.cu", FAULTS[name]
    if name in F32_FAULTS:
        return "attention.cu", F32_FAULTS[name]
    return BWD_FAULTS[name]


def apply_fault(source: str, name: str) -> str:
    """``source`` (the text of the file ``edits_of(name)`` names) with fault
    ``name`` put in."""
    file, edits = edits_of(name)
    for old, new in edits:
        if source.count(old) != 1:
            raise ValueError(f"fault {name}: {old!r} occurs "
                             f"{source.count(old)} times in {file}")
        source = source.replace(old, new)
    return source


def _readings(cs, attn_k, torch, seeds: int, dtypes) -> dict:
    """Every case of cs.ATTN_CASES and cs.ATTN_EDGES in ``dtypes``, per
    seed."""
    out = {}
    cases = [*cs.ATTN_CASES, *cs.ATTN_EDGES]
    for dname in dtypes:
        for i, (name, shape) in enumerate(cases):
            for seed in range(seeds):
                gen = torch.Generator(device="cuda").manual_seed(
                    1000 * seed + i)
                q, k, v = cs._attn_inputs(shape, getattr(torch, dname), gen)
                kw = cs._attn_kw(shape)
                got = attn_k.flash_attention(q, k, v, **kw)
                want = attn_k.flash_attention_plain(q, k, v, **kw)
                r = cs.attention_error(got, want)
                r.setdefault("rel_rms", cs._rms(got.float() - want.float())
                             / cs._rms(want))
                if name in cs.P_ROUNDING_CASES and dname == "bfloat16":
                    r["p_rounding"] = cs.p_rounding(
                        got, want, cs._p_unrounded(q, k, v, **kw))
                key = name if dname == "bfloat16" else f"{name}/{dname}"
                out.setdefault(key, []).append(r)
                del q, k, v, got, want
            torch.cuda.empty_cache()
    return out


def _bwd_readings(cs, attn_k, torch, seeds: int) -> dict:
    """Every case of cs.BWD_CASES and cs.BWD_EDGES in both dtypes, per
    seed: the backward on the kernel forward's o and lse against its plain
    version on the same, and the lse against the plain forward's."""
    out = {}
    cases = [*cs.BWD_CASES, *cs.BWD_EDGES]
    for dname in ("bfloat16", "float32"):
        for i, (name, shape) in enumerate(cases):
            for seed in range(seeds):
                gen = torch.Generator(device="cuda").manual_seed(
                    1000 * seed + i)
                q, k, v, do = cs._bwd_inputs(shape, dname, gen)
                kw = cs._attn_kw(shape)
                o, lse = attn_k.flash_attention_fwd(q, k, v, **kw)
                lse_plain = attn_k.flash_attention_fwd_plain(q, k, v, **kw)[1]
                kept = lse_plain > -1e30
                got = attn_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                want = attn_k.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                        **kw)
                e = cs._grad_errors(got, want)
                out.setdefault(f"{name}/{dname}", []).append({
                    "max_rel": max(x["max_rel"] for x in e.values()),
                    "rel_rms": max(x["rel_rms"] for x in e.values()),
                    "lse_max_err": float((lse - lse_plain)[kept].abs()
                                         .max())})
                del q, k, v, do, o, lse, lse_plain, got, want
            torch.cuda.empty_cache()
    return out


def _summary(variant: str, readings: dict, bwd: dict) -> dict:
    """The largest reading over the seeds, per case."""
    line = {"variant": variant, "max_abs_err": {}, "rel_rms": {},
            "p_rounding": {}, "bwd": {}}
    for name, rs in bwd.items():
        line["bwd"][name] = {k: max(r[k] for r in rs)
                             for k in ("max_rel", "rel_rms", "lse_max_err")}
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
    # What each variant is read on: forward dtypes, and the backward.
    plan = {"sound": (("bfloat16", "float32"), True),
            **{f: (("bfloat16",), False) for f in FAULTS},
            **{f: (("float32",), False) for f in F32_FAULTS},
            **{f: ((), True) for f in BWD_FAULTS}}
    with tempfile.TemporaryDirectory() as tmp:
        for variant, (dtypes, backward) in plan.items():
            if variant == "sound":
                lib = use(build, sound_csrc, sound_build)
            else:
                file = edits_of(variant)[0]
                text = (sound_csrc / file).read_text()
                lib = use_variant(build, sound_csrc, Path(tmp) / variant, {
                    file: apply_fault(text, variant)})
            readings = _readings(cs, attn_k, torch, args.seeds, dtypes)
            bwd = (_bwd_readings(cs, attn_k, torch, args.seeds)
                   if backward else {})
            every[variant] = {"forward": readings, "backward": bwd}
            line = _summary(variant, readings, bwd)
            line["library"] = Path(lib).name
            print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(every))
    return 0


if __name__ == "__main__":
    sys.exit(main())
