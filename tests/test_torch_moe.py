"""The MoE block on the CPU against the reference (``repro.models.moe``),
with the reference's weights carried across, in f32: each token's top-k
expert ids (exact), which (token, expert) pairs keep their capacity slot
(exact) and the block's output (1e-5 abs; the expert products sum in
another order). The reference's ids and kept pairs are read where its
``_moe_local`` computes them (``jax.lax.top_k``, ``jnp.argsort`` and the
``jnp.where`` that picks each pair's slot), by wrapping those functions
for the call; the reference itself is not changed.

Cases: reduced Granite (top-2 of 4) and reduced Arctic (with the dense
residual FFN), capacity factor 1.0 at 64 tokens (pairs dropped; the
reduced configs set 8.0, which drops none), a zero router (every gate
ties, so experts 0..k-1 are chosen, with and without drops), and one
shard of two experts out of four (``e_start`` > 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.layers import mlp_spec as ref_mlp_spec  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model, params_from_reference  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models import moe  # noqa: E402

OUT_TOL = 1e-5
GRANITE, ARCTIC = "granite-moe-1b-a400m", "arctic-480b"

# name: (arch, config overrides, tokens as (B, S), zero router, shard as
# (e_start, e_local) or None for moe_block over every expert)
CASES = {
    "granite": (GRANITE, {}, (2, 24), False, None),
    "arctic_dense_residual": (ARCTIC, {}, (2, 24), False, None),
    "drops": (GRANITE, {"capacity_factor": 1.0}, (2, 32), False, None),
    "ties": (GRANITE, {}, (2, 24), True, None),
    "ties_drops": (GRANITE, {"capacity_factor": 1.0}, (2, 32), True, None),
    "shard": (GRANITE, {}, (2, 24), False, (2, 2)),
    "shard_drops": (GRANITE, {"capacity_factor": 1.0}, (2, 32), False,
                    (1, 2)),
}


class _Spy:
    """``module`` with the calls named in ``names`` logged as (name,
    args, result)."""

    def __init__(self, module, names, log):
        self._module, self._names, self._log = module, names, log

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in self._names:
            return fn

        def logged(*a, **kw):
            out = fn(*a, **kw)
            self._log.append((name, a, out))
            return out
        return logged


def _reference(monkeypatch, fn):
    """Run ``fn()`` (one reference ``_moe_local`` call, eagerly) and read
    its top-k ids and, per (token, rank) pair, whether it kept a slot."""
    log = []
    monkeypatch.setattr(ref_moe, "jnp", _Spy(jnp, {"argsort", "where"}, log))
    monkeypatch.setattr(jax.lax, "top_k",
                        _Spy(jax.lax, {"top_k"}, log).top_k)
    out = fn()
    monkeypatch.undo()
    ids = np.asarray(next(o for n, _, o in log if n == "top_k")[1])
    order = np.asarray(next(o for n, _, o in log if n == "argsort"))
    keep_sorted = np.asarray([a for n, a, _ in log if n == "where"][-1][0])
    keep = np.empty_like(keep_sorted)
    keep[order] = keep_sorted
    return np.asarray(out), ids, keep


def _port_routing(cfg, p, x, e_start, e_local):
    cap = moe._capacity(cfg, x.shape[0])
    _, ids = moe.top_k(moe.router_gates(p, x), cfg.top_k)
    order, slot = moe.dispatch(ids.reshape(-1), cap, e_start, e_local)
    keep = torch.empty_like(slot, dtype=torch.bool)
    keep[order] = slot < e_local * cap
    return ids.numpy(), keep.numpy()


def _setup(name):
    arch, kw, (b, s), zero_router, shard = CASES[name]
    cfg = reduced(get_config(arch)).with_(**kw)
    ref_cfg = ref_reduced(ref_get_config(arch)).with_(**kw)
    spec = {"moe": ref_moe.moe_spec(ref_cfg)}
    if ref_cfg.moe_dense_ff:
        spec["mlp"] = ref_mlp_spec(ref_cfg.d_model, ref_cfg.moe_dense_ff)
    # Weights from numpy's seeded generator, not the reference's
    # init_params, which salts each leaf's key with a per-process hash().
    rng = np.random.default_rng(5)
    ref_p = jax.tree.map(lambda sp: jnp.asarray(
        rng.normal(size=sp.shape).astype(np.float32) * sp.scale), spec,
        is_leaf=lambda sp: hasattr(sp, "axes"))
    if zero_router:
        ref_p["moe"]["router"] = jnp.zeros_like(ref_p["moe"]["router"])
    if shard:
        lo, n = shard
        ref_p["moe"] = {k: v if k == "router" else v[lo:lo + n]
                        for k, v in ref_p["moe"].items()}
    p = params_from_reference(jax.tree.map(np.asarray, ref_p))
    x = np.random.default_rng(9).normal(size=(b, s, cfg.d_model)).astype(
        np.float32)
    return cfg, ref_cfg, ref_p, p, x, shard


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_matches_reference(name, monkeypatch):
    cfg, ref_cfg, ref_p, p, x, shard = _setup(name)
    b, s, d = x.shape
    t, k = b * s, cfg.top_k
    xt = torch.from_numpy(x)
    if shard:
        e_start, e_local = shard
        want, ref_ids, ref_keep = _reference(monkeypatch, lambda: (
            ref_moe._moe_local(ref_cfg, ref_p["moe"], jnp.asarray(x).reshape(
                t, d), e_start, e_local)))
        got = moe._moe_local(cfg, p["moe"], xt.reshape(t, d), e_start,
                             e_local)
    else:
        e_start, e_local = 0, cfg.num_experts
        want, ref_ids, ref_keep = _reference(monkeypatch, lambda: (
            ref_moe.moe_block(ref_cfg, ref_p["moe"], jnp.asarray(x),
                              dense_mlp=ref_p.get("mlp"))))
        got = moe.moe_block(cfg, p["moe"], xt, dense_mlp=p.get("mlp"))
    ids, keep = _port_routing(cfg, p["moe"], xt.reshape(t, d), e_start,
                              e_local)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(keep, ref_keep)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=OUT_TOL)
    in_shard = (ids >= e_start) & (ids < e_start + e_local)
    assert (keep <= in_shard.reshape(-1)).all()
    if name.startswith("ties"):
        assert (ids == np.arange(k)).all()
    dropped = in_shard.reshape(-1) & ~keep
    assert dropped.any() == name.endswith("drops")
    if name == "ties_drops":      # experts 0 and 1 keep the first cap tokens
        cap = moe._capacity(cfg, t)
        assert (keep.reshape(t, k)[:cap]).all()
        assert not keep.reshape(t, k)[cap:].any()
        assert not got.reshape(t, d)[cap:].any()


@pytest.mark.parametrize("k", [1, 2, 8])
def test_top_k_orders_ties_as_lax_top_k(k):
    rng = np.random.default_rng(k)
    gates = rng.integers(0, 4, (64, 32)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(gates), k)
    got_v, got_i = moe.top_k(torch.from_numpy(gates), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 8.0])
def test_capacity_matches_reference(capacity_factor):
    for arch in (GRANITE, ARCTIC):
        cfg = get_config(arch).with_(capacity_factor=capacity_factor)
        ref_cfg = ref_get_config(arch).with_(capacity_factor=capacity_factor)
        for tokens in (1, 4, 7, 48, 64, 192, 1000, 4096):
            assert moe._capacity(cfg, tokens) == ref_moe._capacity(
                ref_cfg, tokens)


@pytest.mark.parametrize("arch", [GRANITE, ARCTIC])
def test_moe_spec_matches_reference(arch):
    got = moe.moe_spec(get_config(arch))
    want = ref_moe.moe_spec(ref_get_config(arch))
    assert {n: (s.shape, s.axes, s.init, s.scale) for n, s in got.items()} \
        == {n: (s.shape, s.axes, s.init, s.scale) for n, s in want.items()}


def test_compute_params_casts_the_moe_leaves():
    """The router too goes to the compute dtype, as the reference's
    ``p["router"].astype(x.dtype)``; norm scales stay f32."""
    cfg = get_config(ARCTIC).with_(num_layers=2, d_model=64, num_heads=4,
                                   num_kv_heads=2, head_dim=16, d_ff=32,
                                   moe_dense_ff=32, num_experts=4,
                                   vocab_size=256, param_dtype="float32")
    model = build_model(cfg)
    params = init_params(model.param_specs(), torch.Generator().manual_seed(0),
                         cfg.param_dtype, "cpu")
    cp = model.compute_params(params)
    blk, cblk = params["blocks"][0], cp["blocks"][0]
    for name in ("router", "wi_gate", "wi_up", "wo"):
        assert cblk["moe"][name].dtype == torch.bfloat16
        assert torch.equal(cblk["moe"][name],
                           blk["moe"][name].to(torch.bfloat16))
    assert cblk["moe"]["router"].shape == (model.n_super, 64, 4)
    assert cblk["mlp"]["wo"].dtype == torch.bfloat16
    assert cblk["ln2"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["internvl2-2b", "xlstm-350m",
                                  "seamless-m4t-medium"])
def test_families_not_yet_ported_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError,
                       match="Rest of the serving model stack"):
        build_model(reduced(get_config(arch)))


# ---------------------- chip_smoke's routing rule, rehearsed ------------------
def test_route_agreement_excuses_only_flips_inside_the_margin():
    """Three tokens over 4 experts, top-2: the card agrees on token 0,
    swaps token 1's 2nd expert for its 3rd (relative gate gap 1e-3) and
    token 2's 1st for its 3rd (relative gap 0.2 / 0.3): with a margin
    only the first is excused. At capacity 2 the card's three picks of
    expert 1 drop one pair; the CPU's drop none."""
    import chip_smoke as cs

    g = torch.tensor([[0.4, 0.3, 0.2, 0.1],
                      [0.4, 0.2, 0.1998, 0.2002],
                      [0.1, 0.2, 0.4, 0.3]])
    cpu = torch.tensor([[0, 1], [0, 3], [2, 3]])
    card = torch.tensor([[1, 0], [1, 0], [1, 3]])
    logits = g.log()
    rec = cs.route_agreement(g, logits, cpu, logits, card, margin=1e-2,
                             cap=2)
    assert rec["choices"] == 6 and rec["agree"] == 4
    assert [f["token"] for f in rec["flips"]] == [1, 2]
    assert [f["excused"] for f in rec["flips"]] == [True, False]
    assert rec["flips"][0]["gap"] == pytest.approx(0.0002 / 0.2002, rel=1e-4)
    assert rec["flips"][1]["gap"] == pytest.approx(0.2 / 0.3, rel=1e-4)
    assert rec["dropped_pairs"] == [0, 1]
    assert rec["router_logits"] == {"max_abs_err": 0.0, "rms_err": 0.0}


@pytest.mark.parametrize("moved, excused", [
    ((0.0, 0.0), False),        # the card's logits equal the CPU's
    ((-2 ** -6, 2 ** -6), False),   # they moved half the gap of 2**-4
    ((-2 ** -5, 2 ** -5), True),    # the whole gap: a tie
    ((-2 ** -5, 2 ** -4), True),    # past it
])
def test_route_agreement_excuses_a_flip_its_logits_explain(moved, excused):
    """Margin None (bf16): token 0 over 4 experts, top-2, where the CPU
    chose experts 0 and 1 and the card 0 and 2. The flip crosses the
    CPU's logit gap l_1 - l_2 = 2**-4; it is excused only where the
    card's logits of experts 1 and 2 moved by that much between them."""
    import chip_smoke as cs

    l_cpu = torch.tensor([[1.0, 0.5625, 0.5, -1.0]])
    l_card = l_cpu.clone()
    l_card[0, 1] += moved[0]
    l_card[0, 2] += moved[1]
    rec = cs.route_agreement(torch.softmax(l_cpu, -1), l_cpu,
                             torch.tensor([[0, 1]]), l_card,
                             torch.tensor([[0, 2]]), margin=None, cap=8)
    (flip,) = rec["flips"]
    assert flip["logit_gap"] == 2 ** -4 and flip["logits"] == [0.5625, 0.5]
    assert flip["beyond"] == 2 ** -4 - sum(map(abs, moved))
    assert flip["excused"] == excused
    assert rec["router_logits"]["max_abs_err"] == max(map(abs, moved))


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_check_routing_holds_the_router_logits_to_model_tol(dname):
    """Held steps pass with router logits inside MODEL_TOL and no
    unexcused flip; one step's router logits past either limit fail."""
    import chip_smoke as cs

    tol = cs.MODEL_TOL[dname]

    def step(**router):
        return {"calls": 2, "unexcused": [],
                "router_logits": {"max_abs_err": tol["max"] / 2,
                                  "rms_err": tol["rms"] / 2, **router}}
    cs.check_routing({dname: [step(), step()]}, steps=2, layers=2)
    for past in ({"max_abs_err": tol["max"] * 1.01},
                 {"rms_err": tol["rms"] * 1.01}):
        with pytest.raises(AssertionError, match="router logits outside"):
            cs.check_routing({dname: [step(), step(**past)]}, steps=2,
                             layers=2)


def test_chip_smoke_moe_model_phase_on_the_cpu(capsys):
    """``chip_smoke.moe_model_phase`` end to end on reduced Granite with
    ``dev="cpu"`` (CPU against CPU): every MoE call held, all choices
    agreed, every fault breaking a limit."""
    import json

    import chip_smoke as cs

    cfg = reduced(get_config(GRANITE))
    row = cs.moe_model_phase(cfg, layers=2, batch=2, prompt=16, steps=3,
                             dev="cpu")
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    assert out == [json.loads(json.dumps(row))]
    for dname in ("float32", "bfloat16"):
        steps = row["routing"][dname]
        assert [s["calls"] for s in steps] == [2] * 4
        assert all(s["agree_share"] == 1.0 and s["flips"] == 0
                   for s in steps)
    assert all(s["max_abs_err"] == 0 for r in row["runs"] for s in r["steps"])
