"""Fault-tolerant checkpointing: async, atomic, keep-N, as in the reference
(``repro.runtime.checkpoint``), with its on-disk layout.

Layout: ``<dir>/step_<N>/`` with one ``leaf_<i>.npy`` per leaf and a
``manifest.json`` (step, time, the tree's structure as JAX prints its
``PyTreeDef``, each leaf's shape and dtype). Leaves are numbered in JAX's
flatten order (``models.params.flatten``), and each ``.npy`` holds the
bytes numpy writes for the reference's array (a bf16 leaf as ml_dtypes
writes it: descr ``<V2``), so a checkpoint either package writes
restores in the other (the reference reads no bf16 leaf back, its own
included: ``np.load`` gives a void array it cannot cast). Writes go to a
temporary directory and an atomic rename; a step without
``MANIFEST_DONE`` is ignored on restore (crash safety). Restore casts each
leaf to the dtype of the tree it restores into and puts it on that
tree's device. Resharding to another mesh waits for the multi-device
slice (ROADMAP Queue 1 item 4).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..models.params import flatten, unflatten

# What ml_dtypes' bfloat16 writes as a .npy descr (numpy has no bf16).
BF16_DESCR = "<V2"


def treedef_str(tree) -> str:
    """The tree's structure written as JAX writes a ``PyTreeDef`` (keys in
    flatten order, ``*`` for a leaf)."""
    def fmt(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {fmt(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(fmt(v) for v in t) + "]"
        if isinstance(t, tuple):
            return "(" + ", ".join(fmt(v) for v in t) + \
                ("," if len(t) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({fmt(tree)})"


def to_host(t: torch.Tensor):
    """(numpy array of the leaf's bytes, dtype name): a bf16 leaf as its
    uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return bits, "bfloat16"
    arr = t.numpy()
    if not arr.flags.c_contiguous:     # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    return arr, str(arr.dtype)


def save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    """``np.save`` of the reference's array: bf16 bits under the descr
    ml_dtypes writes, anything else as numpy writes it."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": BF16_DESCR, "fortran_order": False,
            "shape": tuple(arr.shape)})
        f.write(arr.tobytes(order="C"))


def load_npy(path: Path) -> torch.Tensor:
    """A leaf file as a tensor on the CPU; a 2-byte void array (a bf16 leaf,
    read without ml_dtypes) or an ml_dtypes bf16 array as bf16."""
    arr = np.load(path)
    if arr.dtype.itemsize == 2 and (arr.dtype.kind == "V"
                                    or arr.dtype.name == "bfloat16"):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


class Checkpointer:
    def __init__(self, directory, keep: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state) -> None:
        # copy to the host BEFORE the async write (the next step may write
        # into the device tensors)
        host = [to_host(x) for x in flatten(state)]
        treedef = treedef_str(state)
        if self._thread is not None:
            self._thread.join()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, treedef), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, treedef)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step, host_leaves, treedef) -> None:
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "treedef": treedef,
                    "leaves": []}
        for i, (arr, dtype) in enumerate(host_leaves):
            save_npy(tmp / f"leaf_{i}.npy", arr, dtype)
            manifest["leaves"].append({"i": i, "shape": list(arr.shape),
                                       "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "MANIFEST_DONE").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- restore ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "MANIFEST_DONE").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None):
        """Restore into the structure of ``state_like`` (a tree of tensors):
        each leaf cast to its dtype, on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        d = self.dir / f"step_{step}"
        out = []
        for i, like in enumerate(flatten(state_like)):
            t = load_npy(d / f"leaf_{i}.npy")
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"leaf {i}: shape {tuple(t.shape)} in the "
                                 f"checkpoint, {tuple(like.shape)} here")
            out.append(t.to(device=like.device, dtype=like.dtype))
        return unflatten(state_like, out), step
