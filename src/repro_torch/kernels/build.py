"""Build and load the package's CUDA kernels.

The sources under ``repro_torch/csrc/`` are compiled with ``nvcc`` for
Hopper (``sm_90a``) into one shared library with a plain C interface and
loaded with ``ctypes``. The build runs at first use, one ``nvcc`` per
source started together, and lands in ``repro_torch/build/`` under a name
that hashes the sources, their shared headers (``*.cuh``) and the flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I64, _I32, _INT, _F32 = (ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int32, ctypes.c_int, ctypes.c_float)
# C entry points: argument types, each returning cudaGetLastError().
SIGNATURES = {
    "merge_runs": [_P, _INT, _I64, _P, _P, _P],
    "bloom_build": [_P, _I64, _I32, _INT, _P, _P],
    "bloom_probe": [_P, _I32, _INT, _P, _I64, _P, _P],
    "bloom_probe_tier": [_P, _I64, _INT, _P, _P, _I64, _P, _P],
    "probe_tier": [_P, _INT, _P, _I64, _P, _P, _P, _P],
    "probe_store": [_P, _INT, _P, _I64, _P, _P, _P, _P],
    "probe_floor": [_P, _I64, _P],
    "flash_attention": [_P] * 5 + [_I64] * 18 + [_INT, _INT, _F32, _F32,
                                                 _INT, _P],
    "flash_attention_bwd_prep": [_P] * 3 + [_I64] * 10 + [_INT, _P],
    "flash_attention_bwd_dkv": [_P] * 8 + [_I64] * 18 + [_INT, _INT, _F32,
                                                         _F32, _INT, _P],
    "flash_attention_bwd_dq": [_P] * 7 + [_I64] * 18 + [_INT, _INT, _F32,
                                                        _F32, _INT, _P],
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels can only be built where the CUDA "
            "toolkit is installed")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every source (in parallel) and link the shared library;
    a no-op when the library for these sources already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for src, _, p in procs:
            log, _ = p.communicate()
            if verbose and log:
                print(log, end="")
            if p.returncode != 0:
                failed.append(f"{src.name} (rc {p.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(staged),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(staged, out)         # atomic: concurrent builders agree
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
