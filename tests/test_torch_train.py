"""The training path on the CPU against the reference: ``SyntheticLM``
batches, ``schedule_lr``, one and four train steps of the port's
``make_train_step`` against ``repro.runtime.training.make_train_step`` on
the same params and optimizer state (reduced minicpm-2b, yi-6b with GQA,
gemma2-27b with local/global layers and both softcaps,
granite-moe-1b-a400m and zamba2-2.7b), microbatch accumulation, bf16
params with an f32 master copy, the flops count, the entry point, and
twins of ``tests/test_runtime.py``'s checkpoint/restart, crash-safety,
elastic-restart and straggler tests.

Weights and optimizer state are drawn with numpy and handed to both
packages (the reference's ``init_params`` folds the salted ``hash()`` of
each leaf's path into its key, so its weights change from process to
process). Reduced configs compute in f32. Tolerances:

* loss 1e-5 relative, grad norm and lr 1e-5 relative: summation order;
* ``m`` and ``v`` (which carry the gradients and their squares) per leaf
  within 1e-5 of the leaf's largest value after one step, 1e-4 after
  four (the params then differ as below, and so do the gradients);
* params 5e-4 absolute, half the learning rate: AdamW's
  ``g / (|g| + eps)`` turns the gradients' rounding (about 1e-11) on
  elements whose gradient is within a few ``eps`` of 0 into update
  differences of up to a tenth of the learning rate (1.02e-4 read on
  reduced zamba2), while a flipped sign on a real gradient moves an
  element by twice the learning rate. The gradients themselves are held
  through ``m`` and ``v``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data.pipeline import DataConfig as RefData  # noqa: E402
from repro.data.pipeline import SyntheticLM as RefSynthetic  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import num_params as ref_num_params  # noqa: E402
from repro.models.params import P as RefP  # noqa: E402
from repro.runtime import training as ref_training  # noqa: E402
from repro.utils import flops as ref_flops  # noqa: E402
from repro_torch.configs import ShapeConfig, get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import (build_model, init_params,  # noqa: E402
                                num_params, opt_state_from_reference,
                                params_from_reference)
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.runtime import training  # noqa: E402
from repro_torch.runtime.checkpoint import Checkpointer  # noqa: E402
from repro_torch.runtime.elastic import (StragglerMonitor,  # noqa: E402
                                         run_elastic)
from repro_torch.utils import flops  # noqa: E402

ARCHS = ["minicpm-2b", "yi-6b", "gemma2-27b", "granite-moe-1b-a400m",
         "zamba2-2.7b"]
LOSS_RTOL = 1e-5
NORM_RTOL = 1e-5
OPT_TOL = {1: 1e-5, 4: 1e-4}
PARAM_ATOL = 5e-4
TCFG = dict(learning_rate=1e-3, warmup_steps=2, total_steps=50)
SEQ, BATCH = 32, 4


def draw(spec_tree, rng, default_dtype):
    """The reference's spec tree materialised from numpy's generator:
    zeros, ones or normal * scale (f32, then the leaf's dtype)."""
    def one(s):
        dt = jnp.dtype(s.dtype or default_dtype)
        if s.init == "zeros":
            return jnp.zeros(s.shape, dt)
        if s.init == "ones":
            return jnp.ones(s.shape, dt)
        return jnp.asarray((rng.standard_normal(s.shape) * s.scale)
                           .astype(np.float32)).astype(dt)
    return jax.tree.map(one, spec_tree, is_leaf=lambda x: isinstance(x, RefP))


def setup(arch, seed=0, **kw):
    """(ref model, ref params, ref opt, port model, params, opt, ref data)
    at the reduced config with ``kw`` overrides, the same values in both."""
    cfg = reduced(get_config(arch)).with_(**kw)
    ref_cfg = ref_reduced(ref_get_config(arch)).with_(**kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    rm = ref_build(ref_cfg)
    rng = np.random.default_rng(seed)
    rp = draw(rm.param_specs(), rng, ref_cfg.param_dtype)
    ro = draw(ref_training.opt_state_specs(rm.param_specs(), ref_cfg), rng,
              ref_cfg.optstate_dtype)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    data = RefSynthetic(RefData(vocab_size=ref_cfg.vocab_size, seq_len=SEQ,
                                global_batch=BATCH))
    return (rm, rp, ro, build_model(cfg), params_from_reference(host(rp)),
            opt_state_from_reference(host(ro)), data)


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def close_rel(got, want, rtol):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), \
        (float(got), float(want))


def hold_state(rp, ro, pp, po, steps):
    for a, c in zip(jax.tree.leaves(rp), flatten(pp)):
        np.testing.assert_allclose(as_np(c), as_np(a), rtol=0,
                                   atol=PARAM_ATOL)
    assert int(po["step"]) == int(ro["step"])
    for key in ("m", "v", "master"):
        if key not in ro:
            assert key not in po
            continue
        for a, c in zip(jax.tree.leaves(ro[key]), flatten(po[key])):
            a, c = as_np(a), as_np(c)
            tol = (OPT_TOL[steps] if key != "master" else PARAM_ATOL)
            scale = float(np.abs(a).max()) if key != "master" else 1.0
            np.testing.assert_allclose(c, a, rtol=0, atol=tol * scale)


def run_both(arch, steps, *, microbatches=1, norm_rtol=NORM_RTOL, **kw):
    rm, rp, ro, pm, pp, po, data = setup(arch, **kw)
    rstep = jax.jit(ref_training.make_train_step(
        rm, ref_training.TrainConfig(**TCFG, microbatches=microbatches)))
    pstep = training.make_train_step(
        pm, training.TrainConfig(**TCFG, microbatches=microbatches))
    for i in range(steps):
        b = data.batch(i)
        rp, ro, rmet = rstep(rp, ro, jax.tree.map(jnp.asarray, b))
        pp, po, pmet = pstep(pp, po, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        close_rel(pmet["loss"], rmet["loss"], LOSS_RTOL)
        close_rel(pmet["grad_norm"], rmet["grad_norm"], norm_rtol)
        close_rel(pmet["lr"], rmet["lr"], 1e-6)
    return rp, ro, pp, po


@pytest.mark.parametrize("steps", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch, steps):
    rp, ro, pp, po = run_both(arch, steps)
    hold_state(rp, ro, pp, po, steps)


def test_microbatch_accumulation_matches_reference():
    """Two microbatches: bf16 accumulation with f32 error feedback. Each
    gradient rounds to bf16 in both packages, so an f32 rounding difference
    that flips a rounding moves one element by a bf16 ulp: m and v within
    1e-2 of the leaf's largest value (2^-8 relative of one accumulated
    term), params as above."""
    rp, ro, pp, po = run_both("minicpm-2b", 2, microbatches=2)
    for key in ("m", "v"):
        for a, c in zip(jax.tree.leaves(ro[key]), flatten(po[key])):
            a, c = as_np(a), as_np(c)
            np.testing.assert_allclose(c, a, rtol=0,
                                       atol=1e-2 * float(np.abs(a).max()))
    for a, c in zip(jax.tree.leaves(rp), flatten(pp)):
        np.testing.assert_allclose(as_np(c), as_np(a), rtol=0,
                                   atol=PARAM_ATOL)


def test_bf16_params_keep_an_f32_master():
    """param_dtype bf16: the params are the master rounded to bf16 after
    each step, and grads come in bf16 (a flipped rounding is one bf16 ulp:
    m and v within 1e-2 of the leaf's largest value, the grad norm within
    1e-3 relative, 2.1e-5 read). The master is held as params are, and the
    bf16 params to one bf16 ulp of 1 (2^-7) beyond it."""
    rp, ro, pp, po = run_both("minicpm-2b", 2, param_dtype="bfloat16",
                              norm_rtol=1e-3)
    assert "master" in po and all(
        t.dtype == torch.bfloat16 for t in flatten(pp))
    for a, c in zip(jax.tree.leaves(ro["master"]), flatten(po["master"])):
        np.testing.assert_allclose(as_np(c), as_np(a), rtol=0,
                                   atol=PARAM_ATOL)
    for key in ("m", "v"):
        for a, c in zip(jax.tree.leaves(ro[key]), flatten(po[key])):
            a, c = as_np(a), as_np(c)
            np.testing.assert_allclose(c, a, rtol=0,
                                       atol=1e-2 * float(np.abs(a).max()))
    for a, c in zip(jax.tree.leaves(rp), flatten(pp)):
        np.testing.assert_allclose(as_np(c), as_np(a), rtol=2 ** -7,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("schedule", ["wsd", "cosine", "constant"])
def test_schedule_lr_matches_reference(schedule):
    kw = dict(learning_rate=3e-4, schedule=schedule, warmup_steps=10,
              total_steps=100)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: ref_training.schedule_lr(
        ref_training.TrainConfig(**kw), s))(jnp.asarray(steps)))
    got = training.schedule_lr(training.TrainConfig(**kw),
                               torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_cross_entropy_and_global_norm_match_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.float32)
    want, n = ref_training.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels),
                                         jnp.asarray(mask))
    got, m = training.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels),
                                    torch.from_numpy(mask))
    close_rel(got, want, 1e-6)
    assert float(m) == float(n)
    tree = {"b": [logits, labels.astype(np.float32)], "a": mask}
    close_rel(training.global_norm(jax.tree.map(torch.from_numpy, tree)),
              ref_training.global_norm(jax.tree.map(jnp.asarray, tree)),
              1e-6)


@pytest.mark.parametrize("frontend", [0, 8])
def test_synthetic_batches_equal_reference(frontend):
    kw = dict(vocab_size=1000, seq_len=40, global_batch=3, seed=5,
              frontend_tokens=frontend, d_model=16 if frontend else 0)
    ref, port = RefSynthetic(RefData(**kw)), SyntheticLM(DataConfig(**kw))
    for step in (0, 1, 17):
        a, b = ref.batch(step), port.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        dev = port.device_batch(step, "cpu")
        np.testing.assert_array_equal(dev["tokens"].numpy(), a["tokens"])


@pytest.mark.parametrize("arch", ARCHS + ["arctic-480b"])
def test_flops_and_param_counts_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    n = num_params(build_model(cfg).param_specs())
    assert n == ref_num_params(ref_build(ref_cfg).param_specs())
    assert flops.attention_layer_count(cfg) == \
        ref_flops.attention_layer_count(ref_cfg)
    assert flops.active_param_fraction(cfg) == \
        ref_flops.active_param_fraction(ref_cfg)
    for kind, seq, b in (("train", 64, 8), ("prefill", 4096, 2),
                         ("decode", 4096, 4)):
        assert flops.model_flops(cfg, ShapeConfig("s", seq, b, kind), n) == \
            ref_flops.model_flops(ref_cfg, RefShape("s", seq, b, kind), n)


def test_minicpm_full_width_counts():
    """The slice's model: 2,725,173,504 params and 8.39e12 model FLOPs in a
    step at the entry point's defaults (batch 8, seq 64)."""
    cfg = get_config("minicpm-2b")
    n = num_params(build_model(cfg).param_specs())
    assert n == 2_725_173_504
    assert abs(flops.model_flops(cfg, ShapeConfig("t", 64, 8, "train"), n)
               - 8.39e12) < 0.01e12


def test_train_entry_point_runs_on_cpu_and_needs_a_gpu_otherwise(capsys):
    losses = port_train.main(["--arch", "minicpm-2b", "--reduced",
                              "--device", "cpu", "--steps", "4",
                              "--log-every", "1"])
    assert len(losses) == 4 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert out.count("[train] step=") == 4 and "[train] done." in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a GPU"):
            port_train.main(["--arch", "minicpm-2b", "--reduced",
                             "--steps", "1"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        port_train.main(["--reduced", "--device", "cpu", "--mesh", "2x2"])


def test_remat_modes():
    """remat "full" and "none" give the same gradients; "dots" raises,
    naming ROADMAP."""
    cfg = reduced(get_config("minicpm-2b"))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ,
        global_batch=BATCH)).batch(0).items()}
    params = init_params(build_model(cfg).param_specs(),
                         torch.Generator().manual_seed(0), "float32", "cpu")
    out = {}
    for remat in ("full", "none"):
        out[remat] = training.loss_and_grads(
            build_model(cfg.with_(remat=remat)), params, batch)
    assert float(out["full"][0]) == float(out["none"][0])
    for a, b in zip(flatten(out["full"][1]), flatten(out["none"][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        training.loss_and_grads(build_model(cfg.with_(remat="dots")),
                                params, batch)


# ------------- twins of tests/test_runtime.py (checkpoint, elastic) ----------
def tiny_setup():
    cfg = reduced(get_config("minicpm-2b"))
    model = build_model(cfg)
    params = init_params(model.param_specs(),
                         torch.Generator().manual_seed(0), cfg.param_dtype,
                         "cpu")
    opt = init_params(training.opt_state_specs(model.param_specs(), cfg),
                      torch.Generator().manual_seed(1), cfg.optstate_dtype,
                      "cpu")
    tcfg = training.TrainConfig(learning_rate=1e-3, warmup_steps=2,
                                total_steps=50)
    step = training.make_train_step(model, tcfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))
    return cfg, model, params, opt, step, data


def run_steps(step, params, opt, data, steps, start=0):
    loss = None
    for i in range(start, start + steps):
        params, opt, m = step(params, opt, data.device_batch(i, "cpu"))
        loss = float(m["loss"])
    return params, opt, loss


def test_train_checkpoint_restart_determinism(tmp_path):
    _, _, params, opt, step, data = tiny_setup()
    p4, o4, _ = run_steps(step, params, opt, data, 4)
    p2, o2, _ = run_steps(step, params, opt, data, 2)
    ck = Checkpointer(tmp_path / "ckpt", keep=2, async_save=True)
    ck.save(2, {"params": p2, "opt": o2})
    ck.wait()
    restored, at = ck.restore({"params": p2, "opt": o2})
    assert at == 2
    pr, orr, _ = run_steps(step, restored["params"], restored["opt"], data,
                           2, start=2)
    for a, b in zip(flatten(p4), flatten(pr)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_checkpoint_crash_safety_and_keep(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=False)
    state = {"w": torch.arange(8.0)}
    for s in (1, 2, 3):
        ck.save(s, state)
    assert ck.all_steps() == [2, 3]          # keep-N garbage collection
    torn = tmp_path / "step_9"               # no MANIFEST_DONE: ignored
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ck.latest_step() == 3
    restored, at = ck.restore(state)
    assert at == 3
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(8.0))


def test_run_elastic_restarts_after_failure(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    calls = {"n": 0}

    def make_state():
        return {"w": torch.zeros(4)}

    def train_loop(state, start):
        calls["n"] += 1
        for s in range(start, 6):
            state = {"w": state["w"] + 1}
            ck.save(s + 1, state)
            ck.wait()
            if calls["n"] == 1 and s == 2:
                raise RuntimeError("simulated node failure")
        return state

    out = run_elastic(make_state, train_loop, ck)
    assert calls["n"] == 2
    np.testing.assert_array_equal(out["w"].numpy(), np.full(4, 6.0))


def test_straggler_monitor():
    mon = StragglerMonitor(threshold=2.0, patience=3)
    assert not any(mon.observe(1.0) for _ in range(10))
    assert not mon.observe(5.0)
    assert not mon.observe(5.0)
    assert mon.observe(5.0)                  # third consecutive slow step
