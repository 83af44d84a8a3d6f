"""The port stands alone: every module of ``repro_torch`` imports with jax
and the reference package ``repro`` blocked, loads neither, and no source
file of the port (or ``chip_smoke.py``) imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, importlib.abc, json, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "repro"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_import_loads_no_jax_and_no_reference_module():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    for mod in ("repro_torch.core.engine.torch_backend",
                "repro_torch.core.service.service",
                "repro_torch.kernels.merge.merge",
                "repro_torch.kernels.bloom.bloom",
                "repro_torch.kernels.build",
                "repro_torch.kernels.attention.attention",
                "repro_torch.models.transformer",
                "repro_torch.launch.serve",
                "repro_torch.core.tuner.f32",
                "repro_torch.core.tuner.derivatives",
                "repro_torch.core.tuner.tuner",
                "repro_torch.core.lsm.cost_model",
                "repro_torch.core.service.governor",
                "repro_torch.core.shard.router",
                "repro_torch.core.shard.sharded",
                "repro_torch.core.engine.scheduler",
                "repro_torch.core.engine.workers",
                "repro_torch.core.durability.checkpoint",
                "repro_torch.core.durability.recovery",
                "repro_torch.runtime.hbm_arbiter",
                "repro_torch.core.storage_io.format",
                "repro_torch.core.storage_io.wal_files",
                "repro_torch.core.storage_io.pages",
                "repro_torch.core.storage_io.manifest_files",
                "repro_torch.core.storage_io.plane"):
        assert mod in got["modules"]


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_neither_jax_nor_reference(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path
