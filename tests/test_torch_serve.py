"""The serving path on the CPU against the reference: the model (reduced
Yi-6B, reduced Gemma-2-27B with local/global layers, window 32 and both
softcaps, reduced Yi-6B with padded heads and a padded vocab, reduced
MiniCPM-2B and Minitron-4B, the moe
family: reduced Granite-3.0-1B-A400M and reduced Arctic-480B with its
dense residual FFN, and the hybrid family: reduced Zamba2-2.7B, two groups
of three Mamba2 layers, each followed by the shared attention block) with
the reference's own weights carried across, the
tuner's Newton step, the KV pool with its HBM tuner, and the serve entry
point.

The model runs in f32 (``reduced()`` sets the compute dtype), where K6's
function equals the reference's ``full_attention``/``chunked_attention``
up to summation order, so logits must agree to 1e-4 abs. A prompt of 48
tokens and 32 generated tokens fill a cache of 80 rows: above the reduced
``chunked_attn_threshold`` of 64, so the reference's prefill takes
``chunked_attention`` (chunks of 16), and past the window of 32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.core.tuner.tuner import TunerConfig as RefTunerConfig  # noqa: E402
from repro.core.tuner.tuner import newton_step as ref_newton  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.runtime import hbm_tuner as ref_hbm  # noqa: E402
from repro.runtime import kvcache as ref_kv  # noqa: E402
from repro.runtime.serving import greedy_generate as ref_greedy  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.tuner.tuner import TunerConfig, newton_step  # noqa: E402
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (build_model, init_params,  # noqa: E402
                                params_from_reference)
from repro_torch.runtime import hbm_tuner, kvcache  # noqa: E402
from repro_torch.runtime.serving import greedy_generate  # noqa: E402

PROMPT, GEN, BATCH = 48, 32, 2
LOGIT_TOL = 1e-4


# Reduced configs; "padded" adds dead heads (head_pad_to) and a vocab that
# is padded to 256 with masked logits.
PADDED = {"head_pad_to": 8, "vocab_size": 250}


@pytest.fixture(scope="module", params=["yi-6b", "gemma2-27b",
                                        "yi-6b:padded",
                                        "granite-moe-1b-a400m",
                                        "arctic-480b", "zamba2-2.7b",
                                        "minicpm-2b", "minitron-4b"])
def pair(request):
    """(reference model, its params, port model, the same params)."""
    arch, _, variant = request.param.partition(":")
    kw = PADDED if variant else {}
    cfg = reduced(get_config(arch)).with_(**kw)
    ref_cfg = ref_reduced(ref_get_config(arch)).with_(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    ref_model = ref_build(ref_cfg)
    ref_params = ref_init(ref_model.param_specs(), jax.random.key(0),
                          ref_cfg.param_dtype)
    model = build_model(cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def _prompt(vocab):
    rng = np.random.default_rng(3)
    return rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_TOL)


def test_params_carry_across_unchanged(pair):
    ref_model, ref_params, model, params = pair
    flat_ref = jax.tree_util.tree_leaves_with_path(ref_params)
    assert len(flat_ref) == len(jax.tree.leaves(model.param_specs(),
                                                is_leaf=lambda s: hasattr(
                                                    s, "axes")))
    for path, leaf in flat_ref:
        t = params
        for k in path:
            t = t[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_apply_logits_match_reference(pair):
    ref_model, ref_params, model, params = pair
    tokens = _prompt(model.cfg.vocab_size)
    want = ref_model.apply(ref_params, jnp.asarray(tokens))
    got = model.apply(params, torch.from_numpy(tokens))
    _close(got, want)


def test_prefill_and_every_decode_step_match_reference(pair):
    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    tokens = _prompt(cfg.vocab_size)
    max_len = PROMPT + GEN
    assert max_len > cfg.chunked_attn_threshold and max_len % 16 == 0
    ref_cache = ref_init(ref_model.cache_specs(BATCH, max_len),
                         jax.random.key(1), cfg.param_dtype)
    cache = init_params(model.cache_specs(BATCH, max_len), None,
                        cfg.param_dtype, "cpu")
    want, ref_cache = jax.jit(ref_model.prefill)(ref_params,
                                                 jnp.asarray(tokens),
                                                 ref_cache)
    before = dict(LAUNCHES)
    got, cache = model.prefill(params, torch.from_numpy(tokens), cache)
    _close(got, want)
    step = jax.jit(ref_model.decode_step)
    for pos in range(PROMPT, max_len):
        tok = np.asarray(jnp.argmax(want[:, -1], axis=-1)).astype(np.int32)
        want, ref_cache = step(ref_params, jnp.asarray(tok[:, None]),
                               ref_cache, jnp.int32(pos))
        got, cache = model.decode_step(params, torch.from_numpy(tok[:, None]),
                                       cache, pos)
        _close(got, want)
    assert LAUNCHES == before          # the CPU path launches nothing


def test_greedy_tokens_match_reference(pair):
    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    tokens = _prompt(cfg.vocab_size)
    ref_cache = ref_init(ref_model.cache_specs(BATCH, PROMPT + GEN),
                         jax.random.key(1), cfg.param_dtype)
    want, _ = ref_greedy(ref_model, ref_params, ref_cache,
                         jnp.asarray(tokens), GEN)
    cache = init_params(model.cache_specs(BATCH, PROMPT + GEN), None,
                        cfg.param_dtype, "cpu")
    got, _ = greedy_generate(model, params, cache, torch.from_numpy(tokens),
                             GEN)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_params_keeps_norm_scales_in_f32():
    cfg = get_config("yi-6b").with_(num_layers=1, d_model=64, num_heads=4,
                                    num_kv_heads=2, head_dim=16, d_ff=128,
                                    vocab_size=256)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = init_params(model.param_specs(), gen, cfg.param_dtype, "cpu")
    cp = model.compute_params(params)
    assert cp["final_norm"]["scale"].dtype == torch.float32
    assert cp["blocks"][0]["ln"]["scale"].dtype == torch.float32
    assert cp["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["embed"]["table"].dtype == torch.bfloat16
    assert torch.equal(cp["blocks"][0]["mlp"]["wo"],
                       params["blocks"][0]["mlp"]["wo"].to(torch.bfloat16))


# ----------------------------- the tuner's step --------------------------------
def _newton_cases():
    """(history_x, history_cp, x, cp, total, sim, cfg kwargs): each branch
    (fixed step on a short history, Newton on A > 0, fixed step on A <= 0)
    and each clamp (shrink caps lo/hi, min_write_mem at both ends), then
    seeded random ones."""
    cases = [
        ([100.0, 200.0], [-3.0, -1.0], 200.0, -1.0, 1000.0, 0.0, {}),
        ([100.0, 200.0, 300.0], [-3.0, -1.0, 1.0], 300.0, 0.5, 1000.0,
         0.0, {}),
        ([100.0, 200.0, 300.0], [3.0, 1.0, -1.0], 300.0, -1.0, 1000.0,
         0.0, {}),
        ([100.0, 200.0, 300.0], [-3.0, -1.0, 1.0], 300.0, 50.0, 1000.0,
         0.0, {}),                                      # lo (shrink cap)
        ([100.0, 200.0, 300.0], [-3.0, -1.0, 1.0], 300.0, -50.0, 1000.0,
         0.0, {}),                                      # hi (cache cap)
        ([70.0, 80.0, 90.0], [1.0, 2.0, 3.0], 70.0, 3.0, 1000.0, 0.0,
         {"min_write_mem": 68}),                        # min clamp
        ([900.0, 910.0, 920.0], [-3.0, -2.0, -1.0], 920.0, -3.0, 1000.0,
         10.0, {"min_write_mem": 64}),                  # max clamp
        ([5.0, 5.0, 5.0], [1.0, 2.0, 3.0], 5.0, 1.0, 1000.0, 0.0,
         {"min_write_mem": 0}),                         # var == 0
    ]
    rng = np.random.default_rng(11)
    for _ in range(40):
        n = int(rng.integers(1, 6))
        total = float(rng.integers(1 << 20, 1 << 32))
        xs = list(rng.uniform(0.05, 0.9, n) * total)
        cps = list(rng.normal(0, 1e-6, n))
        cases.append((xs, cps, xs[-1], cps[-1], total,
                      float(rng.uniform(0, 0.05) * total),
                      {"min_write_mem": int(rng.integers(0, 1 << 24))}))
    return cases


@pytest.mark.parametrize("case", range(len(_newton_cases())))
def test_newton_step_matches_reference(case):
    hx, hcp, x, cp, total, sim, kw = _newton_cases()[case]
    want = ref_newton(hx, hcp, x, cp, total, sim, RefTunerConfig(**kw))
    got = newton_step(hx, hcp, x, cp, total, sim, TunerConfig(**kw))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


# ----------------------------- KV pool and HBM tuner ----------------------------
def _drive_pool(kv, hbm, policy: str, seed: int):
    pool = kv.PagedKVPool(kv.KVPoolConfig(page_tokens=4, total_pages=256,
                                          pool_pages=160, sim_pages=48,
                                          policy=policy, rate_window=64))
    gov = hbm.HBMGovernor(pool, hbm.HBMTunerConfig(ops_cycle=48))
    rng = np.random.default_rng(seed)
    snaps = []
    for step in range(1500):
        op = rng.random()
        name = f"s{int(rng.integers(0, 6))}"
        if op < 0.45:
            pool.append_tokens(name, int(rng.integers(1, 24)))
        elif op < 0.9:
            pool.lookup_prefix(int(rng.integers(0, 120)))
        elif op < 0.97:
            pool.finish_stream(name)
        else:
            pool.set_regions(int(rng.integers(64, 200)),
                             int(rng.integers(64, 160)))
        plan = gov.observe()
        if plan is not None:
            snaps.append(plan.note)
        if step % 100 == 0:
            snaps.append(sorted((s.name, list(s.pages), s.tokens, s.allocated,
                                 s.offloaded)
                                for s in pool.streams.values()))
    return {"stats": dict(pool.stats), "free": list(pool.free),
            "cfg": dataclasses.asdict(pool.cfg), "records": gov.records,
            "snaps": snaps, "prefix": len(pool.prefix)}


@pytest.mark.parametrize("policy", ["opt", "mem", "lsn"])
def test_kv_pool_and_hbm_tuner_match_reference(policy):
    want = _drive_pool(ref_kv, ref_hbm, policy, seed=7)
    got = _drive_pool(kvcache, hbm_tuner, policy, seed=7)
    assert len(want["records"]) > 5
    assert got == want


# ----------------------------- the entry point ----------------------------------
def _serve_both(argv, capsys):
    """Both packages' serve entry points on ``argv``: (stats, output)."""
    want = ref_serve.main(argv)
    want_out = capsys.readouterr().out
    got = serve.main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    assert got == want
    assert got_out == want_out
    assert "[serve]" in got_out
    return got, got_out


@pytest.mark.parametrize("requests", [8, 64])
def test_serve_main_matches_reference(requests, capsys):
    _, out = _serve_both(["--reduced", "--requests", str(requests)], capsys)
    if requests == 64:
        assert "[governor]" in out


def test_serve_main_moe_matches_reference(capsys):
    _, out = _serve_both(["--reduced", "--arch", "granite-moe-1b-a400m"],
                         capsys)
    assert "[governor]" in out


def test_serve_main_hybrid_matches_reference(capsys):
    _, out = _serve_both(["--reduced", "--arch", "zamba2-2.7b"], capsys)
    assert "[governor]" in out
