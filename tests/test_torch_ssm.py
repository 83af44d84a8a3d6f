"""The port's state-space code (``repro_torch.models.ssm``) and the hybrid
family (Zamba2: groups of Mamba2 layers, each followed by one attention +
MLP block whose weights all groups share) on the CPU against the reference
(``repro.models.ssm`` and ``repro.models.CausalLM``), on the same numpy
inputs, with the reference's weights carried across by
``params_from_reference``.

Tolerances, f32: the scans and the reduced block to 1e-5 abs (summation
order only: ``cumsum``, the einsums), the full-width block to 5e-5 (its
products sum 2560 and 5120 terms); the model's logits to 1e-4 abs, its
caches to 1e-5. bf16 (the port rounds where the reference rounds,
``ssm.silu`` included): each output of the block and its conv state within
``BF16_REL_RMS`` of the reference's RMS and ``BF16_MAX`` abs, the carried
state ``h`` within ``BF16_H_REL_RMS``. At full width ``ssm_chunk`` is 256,
so the serve's 48-token prompt is one chunk on the card; the carry across
chunks is held here (``s = 300``, one padded second chunk, and the reduced
config's chunk of 8 at prompts that are no multiple of 8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.models import (build_model, init_params,  # noqa: E402
                                params_from_reference)
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.transformer import F32_LEAVES  # noqa: E402

ARCH = "zamba2-2.7b"
SCAN_TOL = 1e-5
FULL_TOL = 5e-5         # the full-width block read at most 1.6e-5
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5
# bf16 limits of the Mamba2 block: relative RMS of an output or of the
# conv state (by width), its largest difference, relative RMS of the state
# h. Over seeds 0-2 the sound port read at most 2.6e-5, 2^-9 and 1e-8 at
# reduced width, 1.6e-3, 2^-6 and 3.3e-5 at full width (where the in_proj
# sums 2560 terms before its bf16 rounding); with A_log, dt_bias and norm
# rounded to bf16 it read 3.0e-3 to 5.7e-3 and 5.0e-3 to 7.7e-3 (h).
BF16_REL_RMS = {False: 2e-4, True: 2.5e-3}
BF16_MAX = 2 ** -5
BF16_H_REL_RMS = 2e-4
# The Mamba2 leaves that compute_params must keep in f32.
MAMBA_F32 = ("A_log", "dt_bias", "norm")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=tol)


def _rel_rms(got, want) -> float:
    g, w = _np(got), _np(want)
    return float(np.sqrt(((g - w) ** 2).mean() / (w ** 2).mean()))


def _cfgs(full: bool, **kw):
    cfg, ref_cfg = get_config(ARCH), ref_get_config(ARCH)
    if not full:
        cfg, ref_cfg = reduced(cfg), ref_reduced(ref_cfg)
    return cfg.with_(**kw), ref_cfg.with_(**kw)


# ----------------------------- the scans --------------------------------------
def _scan_inputs(rng, b, h, s, dv, dk, h0: bool):
    """As ``tests/test_ssm_math.py``'s ``rand_inputs``; ``h0`` False gives
    a zero initial state."""
    log_a = -np.abs(rng.normal(size=(b, h, s))).astype(np.float32) * 0.5
    u = rng.normal(size=(b, h, s, dv)).astype(np.float32)
    w = rng.normal(size=(b, h, s, dk)).astype(np.float32)
    q = rng.normal(size=(b, h, s, dk)).astype(np.float32)
    st = rng.normal(size=(b, h, dv, dk)).astype(np.float32)
    return log_a, u, w, q, st if h0 else np.zeros_like(st)


@pytest.mark.parametrize("h0", [False, True], ids=["h0_zero", "h0_random"])
@pytest.mark.parametrize("s,chunk", [(16, 4), (17, 4), (32, 32), (8, 16),
                                     (64, 8)])
def test_chunked_decay_scan_matches_reference(s, chunk, h0):
    args = _scan_inputs(np.random.default_rng(s * 31 + chunk), 2, 3, s, 5, 4,
                        h0)
    want_y, want_h = ref_ssm.chunked_decay_scan(
        *(jnp.asarray(a) for a in args), chunk)
    y, hf = ssm.chunked_decay_scan(*(_t(a) for a in args), chunk)
    assert y.shape == want_y.shape and y.dtype == torch.float32
    assert hf.dtype == torch.float32
    _close(y, want_y, SCAN_TOL)
    _close(hf, want_h, SCAN_TOL)


@pytest.mark.parametrize("s,chunk", [(17, 4), (64, 8)])
def test_chunked_decay_scan_bf16_matches_reference(s, chunk):
    """u, w, q in bf16 (the block's compute dtype): the chunk outputs come
    back in bf16, the state stays f32."""
    la, u, w, q, h0 = _scan_inputs(np.random.default_rng(s), 2, 3, s, 5, 4,
                                   True)
    ref_b = [jnp.asarray(a).astype(jnp.bfloat16) for a in (u, w, q)]
    want_y, want_h = ref_ssm.chunked_decay_scan(jnp.asarray(la), *ref_b,
                                                jnp.asarray(h0), chunk)
    got_b = [_t(a).to(torch.bfloat16) for a in (u, w, q)]
    y, hf = ssm.chunked_decay_scan(_t(la), *got_b, _t(h0), chunk)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    assert _rel_rms(y, want_y) <= BF16_REL_RMS[False]
    assert _rel_rms(hf, want_h) <= BF16_H_REL_RMS


def test_masked_decay_overflow_stays_out_of_the_output():
    """A decay of -60 a step makes exp(cum_t - cum_s) overflow to inf for
    s > t inside a chunk of 8; the mask must drop it (``where``), not
    multiply it by 0 (nan)."""
    la, u, w, q, h0 = _scan_inputs(np.random.default_rng(5), 1, 2, 16, 3, 3,
                                   True)
    la = np.full_like(la, -60.0)
    assert 60 * 7 > np.log(np.finfo(np.float32).max)     # exp overflows
    want_y, want_h = ref_ssm.chunked_decay_scan(
        *(jnp.asarray(a) for a in (la, u, w, q, h0)), 8)
    y, hf = ssm.chunked_decay_scan(*(_t(a) for a in (la, u, w, q, h0)), 8)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    _close(y, want_y, SCAN_TOL)
    _close(hf, want_h, SCAN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decay_scan_step_matches_reference(dtype):
    la, u, w, q, h0 = _scan_inputs(np.random.default_rng(7), 2, 3, 1, 5, 4,
                                   True)
    la, u, w, q = la[..., 0], u[:, :, 0], w[:, :, 0], q[:, :, 0]
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want_y, want_h = ref_ssm.decay_scan_step(
        jnp.asarray(la), *(jnp.asarray(a).astype(jd) for a in (u, w, q)),
        jnp.asarray(h0))
    y, hn = ssm.decay_scan_step(_t(la), *(_t(a).to(td) for a in (u, w, q)),
                                _t(h0))
    assert y.dtype == td and hn.dtype == torch.float32
    if dtype == "float32":
        _close(y, want_y, SCAN_TOL)
    else:
        assert _rel_rms(y, want_y) <= BF16_REL_RMS[False]
    _close(hn, want_h, SCAN_TOL)


def test_decode_step_continues_the_chunked_scan():
    """s - 1 chunked steps then one decode step equal the whole scan."""
    la, u, w, q, h0 = (_t(a) for a in _scan_inputs(
        np.random.default_rng(0), 2, 2, 12, 4, 4, True))
    y_full, h_full = ssm.chunked_decay_scan(la, u, w, q, h0, 4)
    _, h_pre = ssm.chunked_decay_scan(la[..., :11], u[:, :, :11],
                                      w[:, :, :11], q[:, :, :11], h0, 4)
    y_last, h_last = ssm.decay_scan_step(la[..., 11], u[:, :, 11],
                                         w[:, :, 11], q[:, :, 11], h_pre)
    _close(y_last, y_full[:, :, 11], 2e-5)
    _close(h_last, h_full, 2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True], ids=["no_state", "state"])
def test_causal_conv_matches_reference(state, dtype):
    """The sum of CONV_K shifted products, in x.dtype and in order: equal
    to the reference's to the bit, with and without a carried state."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    k = (0.3 * rng.normal(size=(ssm.CONV_K, 24))).astype(np.float32)
    st = rng.normal(size=(2, ssm.CONV_K - 1, 24)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want, want_st = ref_ssm._causal_conv(
        jnp.asarray(x).astype(jd), jnp.asarray(k).astype(jd),
        jnp.asarray(st) if state else None)
    got, got_st = ssm._causal_conv(_t(x).to(td), _t(k).to(td),
                                   _t(st) if state else None)
    assert got.dtype == td and got_st.shape == (2, ssm.CONV_K - 1, 24)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_st), _np(want_st))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_and_softplus_follow_jax(dtype):
    """``ssm.silu`` rounds as ``jax.nn.silu`` does (to the bit in bf16);
    ``ssm.softplus`` is ``jax.nn.softplus`` in f32, past F.softplus's
    threshold of 20 too."""
    x = np.random.default_rng(2).normal(size=4096).astype(np.float32) * 8
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    got = ssm.silu(_t(x).to(td))
    want = jax.nn.silu(jnp.asarray(x).astype(jd))
    _close(got, want, 0.0 if dtype == "bfloat16" else 1e-6)
    z = np.concatenate([x * 4, [0.0, -30.0, 25.0, 90.0]]).astype(np.float32)
    _close(ssm.softplus(_t(z)), jax.nn.softplus(jnp.asarray(z)), 1e-6)


# ----------------------------- the Mamba2 block --------------------------------
def _mamba_params(cfg, rng, random_f32_leaves: bool = False):
    """Numpy weights for one Mamba2 block of ``cfg``: the normal leaves
    drawn at their spec's scale; with ``random_f32_leaves``, A_log, D,
    dt_bias and norm drawn as Mamba2 initialises them (A in [1, 16], dt
    log-uniform in [1e-3, 1e-1], the bias its inverse softplus), D and norm
    around their init, else at their init (zeros and ones)."""
    out = {}
    for name, sp in ssm.mamba2_spec(cfg).items():
        if sp.init == "normal":
            a = rng.normal(size=sp.shape) * sp.scale
        elif not random_f32_leaves:
            a = np.full(sp.shape, 0.0 if sp.init == "zeros" else 1.0)
        elif name == "A_log":
            a = np.log(rng.uniform(1, 16, sp.shape))
        elif name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), sp.shape))
            a = dt + np.log(-np.expm1(-dt))
        elif name == "norm":
            a = 1 + 0.1 * rng.normal(size=sp.shape)
        else:                                   # D
            a = rng.normal(size=sp.shape)
        out[name] = a.astype(np.float32)
    return out


def _block_runs(cfg, ref_cfg, pn, cp, x, s: int, n_decode: int):
    """The block on ``x`` [B, s + n_decode, d] in its three forms, in both
    packages: apply (no cache) over the first s tokens, prefill of those s
    tokens from a zero cache, then ``n_decode`` one-token steps. Returns
    [(form, got, want)] with the caches after the last step."""
    b = x.shape[0]
    jd = jnp.dtype(cfg.compute_dtype)
    xj = jnp.asarray(x).astype(jd)
    xt = _t(x).to(getattr(torch, cfg.compute_dtype))
    rp = {k: jnp.asarray(v) for k, v in pn.items()}
    spec = ssm.mamba2_cache_spec(cfg, b)
    rc = {k: jnp.zeros(v.shape, jnp.float32) for k, v in spec.items()}
    c = {k: torch.zeros(v.shape) for k, v in spec.items()}
    out = [("apply", ssm.mamba2_block(cfg, cp, xt[:, :s])[0],
            ref_ssm.mamba2_block(ref_cfg, rp, xj[:, :s])[0])]
    want, rc = ref_ssm.mamba2_block(ref_cfg, rp, xj[:, :s], rc)
    got, c = ssm.mamba2_block(cfg, cp, xt[:, :s], c)
    out.append(("prefill", got, want))
    for t in range(s, s + n_decode):
        want, rc = ref_ssm.mamba2_block(ref_cfg, rp, xj[:, t:t + 1], rc)
        got, c = ssm.mamba2_block(cfg, cp, xt[:, t:t + 1], c)
        out.append((f"decode{t}", got, want))
    out.append(("h", c["h"], rc["h"]))
    out.append(("conv", c["conv"], rc["conv"]))
    return out


@pytest.mark.parametrize("full,s", [(False, 45), (False, 48), (True, 48),
                                    (True, 300)],
                         ids=["reduced_s45", "reduced_s48", "full_s48",
                              "full_s300"])
def test_mamba2_block_matches_reference(full, s):
    """f32, all three forms. Reduced: chunk 8, so s = 45 pads a last chunk
    and s = 48 fills six. Full width (d_model 2560, 80 heads of 64, state
    64, chunk 256): s = 48 is one chunk, s = 300 one full chunk and one
    padded second chunk, so the state crosses a chunk."""
    cfg, ref_cfg = _cfgs(full, compute_dtype="float32")
    rng = np.random.default_rng(s)
    pn = _mamba_params(cfg, rng, random_f32_leaves=True)
    x = rng.normal(size=(1 if full else 2, s + 2, cfg.d_model)).astype(
        np.float32)
    runs = _block_runs(cfg, ref_cfg, pn, {k: _t(v) for k, v in pn.items()},
                       x, s, 2)
    for form, got, want in runs:
        assert got.shape == tuple(want.shape), form
        assert torch.isfinite(got).all(), form
        _close(got, want, FULL_TOL if full else SCAN_TOL)


def test_compute_params_keeps_mamba2_f32_leaves():
    """Reduced Zamba2's whole tree, A_log, dt_bias, norm and D drawn at
    random in every layer and carried across from numpy: ``compute_params``
    keeps the first three (and the norm scales) in f32, the same tensors,
    as the reference reads them in f32; it casts D and the other weights,
    which the reference casts to the compute dtype per call."""
    cfg, ref_cfg = _cfgs(False, compute_dtype="bfloat16")
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(np.asarray, ref_init(
        ref_build(ref_cfg).param_specs(), jax.random.key(0), "float32"))
    for blk in tree["blocks"]:
        layers = [_mamba_params(cfg, rng, True) for _ in range(model.n_super)]
        blk["mamba"] = {k: np.stack([p[k] for p in layers])
                        for k in layers[0]}
    params = params_from_reference(tree)
    cp = model.compute_params(params)
    assert set(MAMBA_F32) | {"scale"} <= set(F32_LEAVES)
    for i in range(len(model.slots)):
        m, cm = params["blocks"][i]["mamba"], cp["blocks"][i]["mamba"]
        for name in MAMBA_F32:
            assert cm[name].dtype == torch.float32
            assert cm[name] is m[name]
        for name in ("D", "in_proj", "conv", "out_proj"):
            assert cm[name].dtype == torch.bfloat16
            assert torch.equal(cm[name], m[name].to(torch.bfloat16))
        assert cp["blocks"][i]["ln"]["scale"].dtype == torch.float32
    assert cp["shared_attn"]["ln"]["scale"].dtype == torch.float32
    assert cp["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_mamba2_block_bf16_holds_with_random_f32_leaves(full):
    """bf16 compute, A_log, dt_bias, norm and D drawn at random, the block's
    weights passed through ``compute_params``: its three forms and its
    states within the bf16 limits of the reference's. With the three
    leaves rounded to bf16 instead, h moves past ``BF16_H_REL_RMS`` by far,
    so this check sees that rounding (the init's zeros and ones would not
    show it: bf16 holds them exactly)."""
    cfg, ref_cfg = _cfgs(full, compute_dtype="bfloat16")
    rng = np.random.default_rng(0)
    pn = _mamba_params(cfg, rng, random_f32_leaves=True)
    layer = build_model(cfg).compute_params(
        {"mamba": params_from_reference(pn)})["mamba"]
    assert {k for k, v in layer.items() if v.dtype == torch.float32} == \
        set(MAMBA_F32)
    x = rng.normal(size=(1 if full else 2, 48, cfg.d_model)).astype(
        np.float32)
    for form, got, want in _block_runs(cfg, ref_cfg, pn, layer, x, 45, 3):
        if form == "h":
            assert _rel_rms(got, want) <= BF16_H_REL_RMS
            continue
        assert got.dtype == (torch.float32 if form == "conv"
                             else torch.bfloat16), form
        assert _rel_rms(got, want) <= BF16_REL_RMS[full], form
        assert float(np.abs(_np(got) - _np(want)).max()) <= BF16_MAX, form
    rounded = {k: v.to(torch.bfloat16) for k, v in layer.items()}
    (_, h, want_h), = [r for r in _block_runs(cfg, ref_cfg, pn, rounded, x,
                                              45, 3) if r[0] == "h"]
    assert _rel_rms(h, want_h) > 10 * BF16_H_REL_RMS


# ----------------------------- the reduced model --------------------------------
@pytest.fixture(scope="module")
def zamba():
    """Reduced Zamba2 (6 Mamba2 layers in 2 groups of 3, chunk 8, f32) in
    both packages, the reference's weights carried across."""
    cfg, ref_cfg = _cfgs(False)
    ref_model = ref_build(ref_cfg)
    ref_params = ref_init(ref_model.param_specs(), jax.random.key(0),
                          ref_cfg.param_dtype)
    model = build_model(cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params))
    return ref_model, ref_params, model, params


def test_hybrid_layout_matches_reference(zamba):
    ref_model, _, model, _ = zamba
    assert model.slots == ref_model.slots == ["mamba"] * 3
    assert model.n_super == ref_model.n_super == 2
    assert model.shared_attn and ref_model.shared_attn
    specs = model.cache_specs(2, 64)
    ref_specs = ref_model.cache_specs(2, 64)
    got = {k: (v.shape, v.init) for k, v in specs["shared_attn"].items()}
    want = {k: (tuple(v.shape), v.init)
            for k, v in ref_specs["shared_attn"].items()}
    assert got == want and got["k"][0] == (2, 2, 64, 4, 16)
    for blk, ref_blk in zip(specs["blocks"], ref_specs["blocks"]):
        assert {k: v.shape for k, v in blk.items()} == \
            {k: tuple(v.shape) for k, v in ref_blk.items()}
    # the shared block's weights are one tree, not stacked per group
    assert model.param_specs()["shared_attn"]["attn"]["wq"].shape == \
        (64, 4, 16)


@pytest.mark.parametrize("prompt", [45, 13])
def test_prefill_and_decode_caches_match_reference(zamba, prompt):
    """A prompt that is no multiple of the chunk of 8: logits of the
    prefill and of every decode step, and then every cache the model wrote
    in place (each group's h and conv state, each group's shared-attention
    K and V) in the dict that was passed in."""
    ref_model, ref_params, model, params = zamba
    b, gen = 2, 6
    max_len = prompt + gen
    tokens = np.random.default_rng(prompt).integers(
        0, model.cfg.vocab_size, (b, prompt)).astype(np.int32)
    ref_cache = ref_init(ref_model.cache_specs(b, max_len),
                         jax.random.key(1), "float32")
    cache = init_params(model.cache_specs(b, max_len), None, "float32",
                        "cpu")
    want, ref_cache = ref_model.prefill(ref_params, jnp.asarray(tokens),
                                        ref_cache)
    before = dict(LAUNCHES)
    got, out = model.prefill(params, _t(tokens), cache)
    assert out is cache
    _close(got, want, LOGIT_TOL)
    step = jax.jit(ref_model.decode_step)
    for pos in range(prompt, max_len):
        tok = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        assert np.array_equal(got[:, -1].argmax(-1).numpy(), tok)
        want, ref_cache = step(ref_params, jnp.asarray(tok[:, None]),
                               ref_cache, jnp.int32(pos))
        got, _ = model.decode_step(params, _t(tok[:, None]), cache, pos)
        _close(got, want, LOGIT_TOL)
    assert LAUNCHES == before
    for i in range(len(model.slots)):
        for name in ("h", "conv"):
            assert float(cache["blocks"][i][name].abs().max()) > 0
            _close(cache["blocks"][i][name], ref_cache["blocks"][i][name],
                   CACHE_TOL)
    for name in ("k", "v"):
        _close(cache["shared_attn"][name], ref_cache["shared_attn"][name],
               CACHE_TOL)
        # each group's rows 0..max_len-1 were written
        assert bool((cache["shared_attn"][name].abs().sum((0, 1, 3, 4)) > 0)
                    .all())


def test_chip_smoke_hybrid_model_phase_on_the_cpu(capsys):
    """``chip_smoke.hybrid_model_phase`` end to end on reduced Zamba2 with
    ``dev="cpu"`` (CPU against CPU): the free run read after every group
    of each step and at the logits, equal to the CPU's while the CPU's
    own drift from the f64 run is nonzero; every slot of the anchored
    sound run held and equal; every fault of ``MODEL_FAULTS`` breaking a
    limit at a slot, and the short run's decode fault too; and
    ``param_bytes`` counts Zamba2's 2,340,466,848 params, the compute copy
    without the f32 leaves."""
    import json

    import chip_smoke as cs

    cfg = reduced(get_config(ARCH))
    row = cs.hybrid_model_phase(cfg, layers=6, batch=2, prompt=13,
                                fault_prompt=5, steps=3, dev="cpu")
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert out == [json.loads(json.dumps(row))]
    assert row["groups"] == 2
    for dname in ("float32", "bfloat16"):
        res = row["residual_rms_by_group"][dname]
        assert res["rms_err"] == [0.0, 0.0] and res["ratio"] == [0.0, 0.0]
        assert all(r > 0 for r in res["f64_rms_err"] + res["stream_rms"])
        assert len(row["free_logits"][dname]) == 4
        assert all(p["rms_err"] == 0 < p["f64_rms_err"]
                   for p in row["free_logits"][dname])
        held = row["slot_logits"][dname]
        assert held["calls"] == 2 * 4 * 4 and not held["breaks"]
        assert held["max_abs_err"] == [0.0] * 8
        faults = row["fault_slots"][dname]
        assert faults["attention_dropped"]["breaks"]
        assert faults["decode_skips_oldest_key"]["breaks"]
        # the attention slots (the 4th and 8th of a step) see the faults
        bad = faults["attention_dropped"]["max_abs_err"]
        assert bad[3] > 0 and bad[7] > 0
    short = row["short_fault"]
    assert (short["compute_dtype"], short["prompt"]) == ("bfloat16", 5)
    assert not short["sound"]["breaks"] and short["sound"]["calls"] == 32
    assert short["decode_skips_oldest_key"]["breaks"]
    for r in row["runs"]:
        assert all(s["max_abs_err"] == 0 for s in r["steps"])
    full = get_config(ARCH)
    sizes = cs.param_bytes(full)
    assert sizes["param_bytes"] == 4 * 2_340_466_848
    di, nh = 2 * full.d_model, 2 * full.d_model // full.ssm_head_dim
    n_f32 = full.num_layers * (2 * nh + di + full.d_model) \
        + 3 * full.d_model                   # the shared block's and final
    assert sizes["compute_copy_bytes"] == 2 * (2_340_466_848 - n_f32)
