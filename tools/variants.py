"""What the tools that read altered copies of the kernel sources share.

``tools/bloom_paths.py``, ``tools/merge_paths.py`` and ``tools/k6_faults.py``
build the kernel library from copies of ``src/repro_torch/csrc`` with a
constant changed or a fault put in, load each copy in turn and read it on
one GPU. This module holds the copying, building and loading, the edit of
a source's named constant, the card's name and the timers. It imports no
part of the package, so a tool may still point ``sys.path`` at another
checkout before it does.
"""
from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def _pattern(name: str) -> str:
    return rf"(constexpr \w+ {name} = )(\d+);"


def constant(text: str, name: str) -> int:
    """The value of ``constexpr <type> name = <digits>;`` in ``text``,
    which must declare it exactly once."""
    found = re.findall(_pattern(name), text)
    if len(found) != 1:
        raise ValueError(f"{name} is declared {len(found)} times, not once")
    return int(found[0][1])


def with_constant(text: str, name: str, value: int) -> str:
    """``text`` with the one declaration of constant ``name`` set to
    ``value``."""
    constant(text, name)
    return re.sub(_pattern(name), rf"\g<1>{value};", text)


def use(build, csrc: Path, build_dir: Path) -> Path:
    """Point the kernel build (the module ``repro_torch.kernels.build``)
    at the sources ``csrc``, build and load them; the library's path."""
    build.CSRC, build.BUILD_DIR = Path(csrc), Path(build_dir)
    build.library.cache_clear()
    build.library()
    return build.library_path()


def use_variant(build, original: Path, dest: Path, edits: dict) -> Path:
    """Copy the sources ``original`` to ``dest``/csrc, replace the text of
    each file named in ``edits`` (name -> text), then build and load the
    copy (``use``) into ``dest``/build."""
    csrc = Path(dest) / "csrc"
    shutil.copytree(original, csrc)
    for name, text in edits.items():
        (csrc / name).write_text(text)
    return use(build, csrc, Path(dest) / "build")


def cuda_ms(fn, reps: int = 25) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms_per_call(fn, reps: int) -> float:
    """Device time of one call of ``fn`` in a stream of back-to-back
    calls: ``reps`` calls captured in a CUDA graph, whose replay is timed
    between CUDA events (median of 5)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def profiled_ms_per_call(fn, reps: int) -> float:
    """Device time of one call of ``fn``: every device event under the
    CUDA profiler over ``reps`` calls, divided by ``reps``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages())
    return us / reps / 1e3
