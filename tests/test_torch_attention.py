"""K6 on the CPU: the port's ``flash_attention`` (its plain version, reached
through the wrapper) against the reference wrapper over the Pallas kernel
in interpret mode, over the sweep of ``test_kernel_attention.py`` (GQA,
window, softcap, head dims 64/80/128, f32/bf16) and top-left causal masks
with Sq != Sk; the decode form the model uses (non-causal over the rows a
query keeps) against the reference's ``full_attention`` over a whole
zero-padded cache; the port's ``attention_block`` against the reference's. Tolerances: 1e-5 in f32 (summation order only), 2e-2
in bf16 (the reference pads hd 80 to 128 and rounds the pre-scaled q, and
p is rounded to bf16 per key tile)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config, reduced  # noqa: E402
from repro.kernels.attention.ops import flash_attention as ref_flash  # noqa: E402
from repro.models.attention import attention_block as ref_block  # noqa: E402
from repro.models.attention import full_attention as ref_full  # noqa: E402
from repro_torch.configs import get_config as port_get_config  # noqa: E402
from repro_torch.configs import reduced as port_reduced  # noqa: E402
from repro_torch.kernels._launch import LAUNCHES  # noqa: E402
from repro_torch.kernels.attention import attention as attn_k  # noqa: E402
from repro_torch.models import attention as port_attn  # noqa: E402

F32, BF16 = "float32", "bfloat16"
TOL = {F32: 1e-5, BF16: 2e-2}


def _qkv(rng, b, sq, sk, h, kv, hd):
    return (rng.normal(size=(b, sq, h, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32),
            rng.normal(size=(b, sk, kv, hd)).astype(np.float32))


def _both(arrays, dtype):
    """The same inputs for JAX and torch, rounded once to ``dtype``."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
          for a in jx]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("b,sq,sk,h,kv,hd,dtype,window,softcap", [
    (1, 128, 128, 2, 2, 64, F32, 0, 0.0),
    (2, 256, 256, 4, 2, 128, F32, 0, 0.0),
    (1, 256, 256, 4, 1, 128, BF16, 0, 0.0),
    (1, 128, 128, 2, 2, 80, F32, 0, 0.0),
    (1, 256, 256, 2, 2, 64, F32, 64, 0.0),
    (1, 256, 256, 2, 2, 64, F32, 0, 30.0),
    (1, 256, 256, 2, 2, 64, F32, 128, 50.0),
    (1, 128, 128, 4, 2, 80, BF16, 32, 50.0),
    (4, 48, 64, 4, 2, 16, F32, 0, 0.0),       # top-left causal, Sq < Sk
    (2, 48, 64, 4, 1, 16, F32, 16, 30.0),
    (2, 64, 32, 4, 2, 16, F32, 8, 0.0),       # Sq > Sk: some rows keep no key
])
def test_flash_matches_pallas_reference(b, sq, sk, h, kv, hd, dtype, window,
                                        softcap):
    rng = np.random.default_rng(sq * 7 + sk + hd + window)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, b, sq, sk, h, kv, hd), dtype)
    want = ref_flash(jq, jk, jv, causal=True, window=window, softcap=softcap,
                     interpret=True)
    before = dict(LAUNCHES)
    got = attn_k.flash_attention(tq, tk, tv, causal=True, window=window,
                                 softcap=softcap)
    assert LAUNCHES == before          # the CPU path launches nothing
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_non_causal_matches_pallas_reference(dtype):
    rng = np.random.default_rng(5)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 2, 1, 48, 8, 2, 64), dtype)
    want = ref_flash(jq, jk, jv, causal=False, softcap=50.0, interpret=True)
    got = attn_k.flash_attention(tq, tk, tv, causal=False, softcap=50.0)
    _close(got, want, TOL[dtype])


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


@pytest.mark.parametrize("sq,sk,causal", [(48, 64, True), (1, 48, False),
                                          (1, 64, False)])
def test_p_rounding_is_visible_at_the_serving_shapes(sq, sk, causal):
    """Calibration of the card's p-rounding check (chip_smoke.py): at the
    serving path's prefill and decode shapes in bf16 (Yi-6B heads, one key
    tile holding every key), the plain version and the unrounded control
    (p kept in f32 before p @ v) differ by an RMS of at least 2e-4 (about
    half the smallest reading, 4.3e-4), while the Pallas kernel, which
    rounds p as the function says, stays within a tenth of that gap of
    the plain version: far inside the card check's half."""
    rng = np.random.default_rng(sq + sk)
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(rng, 4, sq, sk, 32, 4, 128),
                                       BF16)
    plain = attn_k.flash_attention_plain(tq, tk, tv, causal=causal)
    control = attn_k.flash_attention_plain(
        tq.float(), tk.float(), tv.float(), causal=causal).to(tq.dtype)
    pallas = np.asarray(ref_flash(jq, jk, jv, causal=causal, interpret=True),
                        np.float32)
    gap = _rms(plain.float().numpy() - control.float().numpy())
    assert gap >= 2e-4
    assert _rms(pallas - plain.float().numpy()) < 0.1 * gap


@pytest.mark.parametrize("pos,window", [(0, 0), (5, 0), (47, 0), (79, 0),
                                        (5, 32), (40, 32), (79, 32)])
def test_decode_form_matches_full_attention_over_cache(pos, window):
    """Non-causal K6 over rows max(0, pos-w+1)..pos == the reference's
    full_attention over the whole cache (rows past pos are zeros) at
    q_pos = pos."""
    cfg = reduced(get_config("yi-6b"))
    b, L, h, kv, hd = 2, 80, 4, 2, 16
    rng = np.random.default_rng(pos + window)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    ck = np.zeros((b, L, kv, hd), np.float32)
    cv = np.zeros((b, L, kv, hd), np.float32)
    ck[:, :pos + 1] = rng.normal(size=(b, pos + 1, kv, hd))
    cv[:, :pos + 1] = rng.normal(size=(b, pos + 1, kv, hd))
    q_pos = np.full((b, 1), pos, np.int32)
    k_pos = np.broadcast_to(np.arange(L)[None], (b, L))
    want = ref_full(cfg, jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                    jnp.asarray(q_pos), jnp.asarray(k_pos), window=window)
    lo = max(0, pos - window + 1) if window else 0
    tk, tv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = attn_k.flash_attention(torch.from_numpy(q), tk[:, lo:pos + 1],
                                 tv[:, lo:pos + 1], causal=False)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("window,softcap,cached", [
    (0, 0.0, False), (16, 30.0, False), (0, 0.0, True), (16, 50.0, True)])
def test_attention_block_matches_reference(window, softcap, cached):
    """The port's ``attention_block`` (K6 in its prefill and decode forms)
    against the reference's, on the same f32 weights: without a cache, and
    with a cache as the model uses it (a 24-token prefill from position 0
    into 40 rows, then decode steps past the window)."""
    cfg = reduced(get_config("yi-6b")).with_(attn_softcap=softcap)
    port_cfg = port_reduced(port_get_config("yi-6b")).with_(
        attn_softcap=softcap)
    rng = np.random.default_rng(window + int(softcap) + cached)
    params = {k: (rng.normal(size=s.shape) * s.scale).astype(np.float32)
              for k, s in port_attn.attn_spec(port_cfg).items()}
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    tp = {k: torch.from_numpy(a) for k, a in params.items()}
    b, prompt, rows = 2, 24, 40
    d, kv, hd = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim
    steps = [(0, prompt)] + ([(p, 1) for p in range(prompt, rows)]
                             if cached else [])
    jc = ({"k": jnp.zeros((b, rows, kv, hd)),
           "v": jnp.zeros((b, rows, kv, hd))} if cached else None)
    tc = ({"k": torch.zeros(b, rows, kv, hd),
           "v": torch.zeros(b, rows, kv, hd)} if cached else None)
    for pos0, s in steps:
        x = rng.normal(size=(b, s, d)).astype(np.float32)
        pos = np.broadcast_to(pos0 + np.arange(s)[None], (b, s))
        want, jc = ref_block(cfg, jp, jnp.asarray(x), jnp.asarray(pos),
                             layer_window=window, cache=jc)
        got, tc = port_attn.attention_block(
            port_cfg, tp, torch.from_numpy(x),
            torch.from_numpy(np.ascontiguousarray(pos)), pos0,
            layer_window=window, cache=tc)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("bad", ["dtype", "heads", "head_dim", "empty",
                                 "strided", "window"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    v = torch.zeros(1, 8, 2, 16)
    kw = {}
    if bad == "dtype":
        q = q.half()
    elif bad == "heads":
        k, v = torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(*t.shape[:3], 24) for t in (q, k, v))
    elif bad == "empty":
        k, v = k[:, :0], v[:, :0]
    elif bad == "strided":
        k = torch.zeros(1, 8, 2, 32)[..., ::2]
    else:
        kw["window"] = -1
    with pytest.raises(ValueError):
        attn_k.flash_attention(q, k, v, **kw)
