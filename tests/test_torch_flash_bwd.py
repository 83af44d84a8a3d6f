"""K6's backward on the CPU: ``flash_attention_bwd_plain`` (the formula of
the kernels in ``csrc/attention_bwd.cu``) against ``torch.autograd``
through ``flash_attention_plain`` (K6's forward) and against ``jax.vjp``
of the reference's ``full_attention``, which the reference differentiates
to train; the log-sum-exp of ``flash_attention_fwd_plain``; and the
``FlashAttention`` function that the model's attention goes through when
a gradient is needed. Causal top-left masks, windows, softcaps, GQA, rows
that keep no key, non-causal, f32 and bf16, head dims 16, 64, 80 and 128.

Tolerances (largest difference over the largest value of the reference
gradient):

* f32 against autograd through the plain forward: 2e-6 (summation
  order);
* f32 against ``jax.vjp``: 1e-5 (the reference sums in another order and
  takes D from its unrounded softmax);
* bf16 against autograd through the plain forward in bf16: 2e-2, and in
  relative RMS 5e-3 (autograd rounds dO.V^T and every gradient product to
  bf16, the formula only its outputs);
* bf16 against ``jax.vjp``: 5e-2, and in relative RMS 2e-2 (the
  reference also rounds its scores to bf16 before the softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import full_attention  # noqa: E402
from repro_torch.kernels.attention import attention as attn_k  # noqa: E402

TOL = {("autograd", "float32"): (2e-6, None),
       ("jax", "float32"): (1e-5, None),
       ("autograd", "bfloat16"): (2e-2, 5e-3),
       ("jax", "bfloat16"): (5e-2, 2e-2)}

# (name, b, sq, sk, h, kv, hd, causal, window, softcap)
CASES = [
    ("causal_h_eq_kv_hd16", 2, 37, 37, 4, 4, 16, True, 0, 0.0),
    ("causal_gqa2_hd64_window_softcap", 2, 100, 100, 8, 4, 64, True, 16,
     30.0),
    ("causal_gqa3_hd80_sq_lt_sk", 2, 70, 90, 6, 2, 80, True, 0, 0.0),
    ("sq_gt_sk_window_rows_without_keys", 2, 64, 32, 4, 2, 64, True, 8,
     0.0),
    ("gqa8_hd128_sq_gt_sk_window_softcap", 1, 80, 40, 16, 2, 128, True, 20,
     50.0),
    ("minicpm_heads_hd64", 2, 64, 64, 6, 6, 64, True, 0, 0.0),
    ("gemma_local_hd128", 1, 96, 96, 4, 2, 128, True, 24, 50.0),
    ("non_causal_softcap", 2, 5, 40, 4, 2, 64, False, 0, 50.0),
]


def _inputs(case, dtype, seed=0):
    _, b, sq, sk, h, kv, hd = case[:7]
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return mk(b, sq, h, hd), mk(b, sk, kv, hd), mk(b, sk, kv, hd), \
        mk(b, sq, h, hd)


def _kw(case):
    return {"causal": case[7], "window": case[8], "softcap": case[9]}


def _t(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _plain_bwd(q, k, v, do, kw):
    o, lse = attn_k.flash_attention_fwd_plain(q, k, v, **kw)
    return attn_k.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)


def _err(got, want, what, tol):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol[0] * top, what
    if tol[1] is not None:
        rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want ** 2))
        assert rel <= tol[1], (what, rel)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_plain_matches_autograd_through_the_forward(case, dtype):
    qn, kn, vn, don = _inputs(case, dtype)
    q, k, v = (_t(x, dtype).requires_grad_() for x in (qn, kn, vn))
    do = _t(don, dtype)
    out = attn_k.flash_attention_plain(q, k, v, **_kw(case))
    want = torch.autograd.grad(out, (q, k, v), do)
    got = _plain_bwd(q.detach(), k.detach(), v.detach(), do, _kw(case))
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == w.dtype and g.shape == w.shape
        _err(g, w.float().numpy(), f"d{name}", TOL[("autograd", dtype)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_plain_matches_jax_vjp_of_full_attention(case, dtype):
    qn, kn, vn, don = _inputs(case, dtype)
    b, sq, sk = case[1], case[2], case[3]
    kw = _kw(case)
    jdt = getattr(jnp, dtype)
    qp = jnp.broadcast_to(jnp.arange(sq)[None], (b, sq))
    kp = jnp.broadcast_to(jnp.arange(sk)[None], (b, sk))

    def f(q, k, v):
        return full_attention(None, q, k, v, qp, kp, window=kw["window"],
                              softcap_val=kw["softcap"], causal=kw["causal"])

    _, vjp = jax.vjp(f, *(jnp.asarray(x).astype(jdt) for x in (qn, kn, vn)))
    want = vjp(jnp.asarray(don).astype(jdt))
    got = _plain_bwd(*(_t(x, dtype) for x in (qn, kn, vn, don)), kw)
    for g, w, name in zip(got, want, "qkv"):
        _err(g, w, f"d{name}", TOL[("jax", dtype)])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_forward_lse_is_the_rows_log_sum_exp(case):
    """lse = m + log l of the kept scores (1e-6 relative); a row that keeps
    no key scores -2e38 everywhere, as K6 does."""
    qn, kn, vn, _ = _inputs(case, "float32")
    q, k, v = (_t(x, "float32") for x in (qn, kn, vn))
    kw = _kw(case)
    o, lse = attn_k.flash_attention_fwd_plain(q, k, v, **kw)
    assert torch.equal(o, attn_k.flash_attention_plain(q, k, v, **kw))
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    s = q.transpose(1, 2) @ k.repeat_interleave(g, 2).permute(0, 2, 3, 1)
    s = s * hd ** -0.5
    if kw["softcap"]:
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    if kw["causal"]:
        s = s.masked_fill(~attn_k.keep_mask(sq, k.shape[1], kw["window"],
                                            "cpu"), attn_k.NEG_INF)
    want = torch.logsumexp(s, -1)
    kept = want > -1e30
    torch.testing.assert_close(lse[kept], want[kept], rtol=1e-6, atol=1e-6)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_runs_the_plain_pair_on_the_cpu(dtype):
    """``flash_attention`` with a gradient to take goes through
    ``FlashAttention``: the plain forward's output, and the plain
    backward's gradients to the bit, on k and v row views of a cache."""
    case = CASES[1]
    qn, kn, vn, don = _inputs(case, dtype)
    q = _t(qn, dtype).requires_grad_()
    cache_k = torch.cat([_t(kn, dtype), _t(kn, dtype)], 1).requires_grad_()
    cache_v = torch.cat([_t(vn, dtype), _t(vn, dtype)], 1).requires_grad_()
    sk = kn.shape[1]
    k, v = cache_k[:, 3:3 + sk], cache_v[:, 3:3 + sk]
    do = _t(don, dtype)
    out = attn_k.flash_attention(q, k, v, **_kw(case))
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out.detach(), attn_k.flash_attention_plain(
        q.detach(), k.detach(), v.detach(), **_kw(case)))
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    want = _plain_bwd(q.detach(), k.detach(), v.detach(), do, _kw(case))
    for g, w in zip((dq, dk, dv), want):
        assert torch.equal(g, w)


def test_function_raises_where_the_kernels_cannot_differentiate():
    """No fallback to autograd through the plain forward: a dtype or head
    dim the kernels do not take raises, with or without a gradient."""
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    with pytest.raises(ValueError, match="head dim"):
        attn_k.flash_attention(q, q.detach(), q.detach())
    q64 = torch.randn(1, 8, 2, 16, dtype=torch.float64, requires_grad=True)
    with pytest.raises(ValueError, match="dtype"):
        attn_k.flash_attention(q64, q64.detach(), q64.detach())
    q = torch.randn(1, 8, 2, 16)
    o, lse = attn_k.flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="lse"):
        attn_k.flash_attention_bwd(q, q, q, o, lse[:, :, :4], o)
