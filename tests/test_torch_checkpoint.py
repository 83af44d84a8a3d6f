"""The port's checkpoints against the reference's
(``repro.runtime.checkpoint``): the same layout, leaves numbered in JAX's
flatten order with byte-identical ``.npy`` files (f32, int32 and bf16),
``manifest.json`` equal but for ``time``, each package
restoring the other's checkpoint exactly, keep-N, torn steps ignored, and
the train state of a reduced model carried across both ways.

A bf16 leaf crosses one way only: the reference writes it with descr
``<V2`` (ml_dtypes' bfloat16) and cannot read it back (``np.load`` gives
a 2-byte void array that does not cast to bf16, also for its own files),
so the port writes the same bytes and restores both packages' bf16 files,
and the port-to-reference tests hold f32 and int32 states."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime.checkpoint import Checkpointer as RefCheckpointer  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model, init_params  # noqa: E402
from repro_torch.models.params import flatten, tree_map  # noqa: E402
from repro_torch.runtime.checkpoint import Checkpointer  # noqa: E402
from repro_torch.runtime.training import opt_state_specs  # noqa: E402


def _state(rng, bf16: bool = True):
    """A tree of numpy leaves with the shapes and dtypes of a train state:
    nested dicts (keys out of order), a list, a 0-d int32 step and, with
    ``bf16``, a bf16 leaf."""
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    master = f32(6)
    return {"params": {"zeta": f32(3, 4), "blocks": [
                {"w": f32(2, 5), "b": f32(5)}, {"w": f32(2, 5), "b": f32(5)}],
                "alpha": f32(7)},
            "opt": {"step": np.array(3, np.int32), "m": {"x": f32(4, 2)},
                    "v": {"x": f32(4, 2)},
                    "master": {"x": master.astype(ml_dtypes.bfloat16)
                               if bf16 else master}}}


def _to_torch(tree):
    def one(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return tree_map(one, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _write_both(tmp_path, rng, bf16: bool = True):
    state = _state(rng, bf16)
    ref = RefCheckpointer(tmp_path / "ref", keep=3, async_save=False)
    port = Checkpointer(tmp_path / "port", keep=3, async_save=False)
    ref.save(5, _to_jax(state))
    port.save(5, _to_torch(state))
    return state, ref, port


def test_leaf_files_are_byte_identical(tmp_path):
    _, _, _ = _write_both(tmp_path, np.random.default_rng(0))
    a, b = tmp_path / "ref" / "step_5", tmp_path / "port" / "step_5"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "MANIFEST_DONE" in names and "manifest.json" in names
    leaves = [n for n in names if n.startswith("leaf_")]
    assert len(leaves) == 10
    for n in leaves + ["MANIFEST_DONE"]:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_manifests_differ_only_in_time(tmp_path):
    """The tree's structure is written as JAX writes a ``PyTreeDef``, so of
    the manifest only the wall-clock ``time`` differs."""
    _write_both(tmp_path, np.random.default_rng(1))
    ma = json.loads((tmp_path / "ref" / "step_5" / "manifest.json").read_text())
    mb = json.loads((tmp_path / "port" / "step_5" / "manifest.json").read_text())
    assert set(ma) == set(mb) == {"step", "time", "treedef", "leaves"}
    for k in ("step", "treedef", "leaves"):
        assert ma[k] == mb[k], k


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state, ref, _ = _write_both(tmp_path, np.random.default_rng(2))
    like = tree_map(torch.zeros_like, _to_torch(state))
    got, at = Checkpointer(tmp_path / "ref").restore(like)
    assert at == 5
    for g, w in zip(flatten(got), flatten(_to_torch(state))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state, _, port = _write_both(tmp_path, np.random.default_rng(3),
                                 bf16=False)
    like = _to_jax(jax.tree.map(np.zeros_like, state))
    got, at = RefCheckpointer(tmp_path / "port").restore(like)
    assert at == 5
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_train_state_crosses_both_ways(tmp_path, writer):
    """A reduced MiniCPM's params and AdamW state, written by one package,
    restored by the other to the bit; from the reference with bf16 params
    and an f32 master."""
    dtype = "bfloat16" if writer == "reference" else "float32"
    cfg = reduced(get_config("minicpm-2b")).with_(param_dtype=dtype)
    spec = build_model(cfg).param_specs()
    gen = torch.Generator().manual_seed(0)
    state = {"params": init_params(spec, gen, cfg.param_dtype, "cpu"),
             "opt": init_params(opt_state_specs(spec, cfg), gen,
                                cfg.optstate_dtype, "cpu")}
    as_np = tree_map(lambda t: (t.float().numpy().astype(ml_dtypes.bfloat16)
                                if t.dtype == torch.bfloat16 else t.numpy()),
                     state)
    if writer == "reference":
        RefCheckpointer(tmp_path, async_save=False).save(1, _to_jax(as_np))
        got, _ = Checkpointer(tmp_path).restore(tree_map(torch.zeros_like,
                                                         state))
        for g, w in zip(flatten(got), flatten(state)):
            assert g.dtype == w.dtype and torch.equal(g, w)
    else:
        port = Checkpointer(tmp_path, async_save=True)
        port.save(1, state)
        port.wait()
        ck = RefCheckpointer(tmp_path)
        got, _ = ck.restore(_to_jax(jax.tree.map(np.zeros_like, as_np)))
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(as_np)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(np.asarray(g), w)


def test_keep_n_and_torn_steps_as_the_reference(tmp_path):
    """keep=2 over steps 1..4, then a torn step (no MANIFEST_DONE) and a
    leftover temporary directory: both packages list the same steps and
    restore the same one."""
    rng = np.random.default_rng(4)
    states = [_state(rng) for _ in range(4)]
    ref = RefCheckpointer(tmp_path / "ref", keep=2, async_save=False)
    port = Checkpointer(tmp_path / "port", keep=2, async_save=True)
    for i, st in enumerate(states, start=1):
        ref.save(i, _to_jax(st))
        port.save(i, _to_torch(st))
    port.wait()
    for d in ("ref", "port"):
        torn = tmp_path / d / "step_9"
        torn.mkdir()
        (torn / "manifest.json").write_text("{}")
        (tmp_path / d / ".tmp_step_10_1").mkdir()
    assert ref.all_steps() == port.all_steps() == [3, 4]
    assert Checkpointer(tmp_path / "ref").latest_step() == \
        RefCheckpointer(tmp_path / "port").latest_step() == 4
    like = tree_map(torch.zeros_like, _to_torch(states[0]))
    got, at = port.restore(like)
    assert at == 4
    for g, w in zip(flatten(got), flatten(_to_torch(states[3]))):
        assert torch.equal(g, w)
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(like)
