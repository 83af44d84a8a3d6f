#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit and builds the CUDA kernels
   from ``src/repro_torch/csrc``.
2. Kernel phase: holds each kernel (K1 merge_pair, K2 bloom_build, K5
   bloom_probe, K4 probe_tier, K3 probe_store) against its plain PyTorch
   version on the card, with exact integer equality, at the main path's
   shapes (K1 in its pair form and its k-run form ``merge_runs`` at the
   timed pairs, at tile edges, with empty and one-element runs, 2**16 +
   2**16 equal keys, k = 3, 6 and 12 runs of about 100, on both of the
   k-run form's other routes, and on an 11-run level merge and the ingest
   of 2048 and 4096 keys through the engine's call, see
   ``check_merge_runs``; K2 at 256, 2048, 16384 and 2**20 keys, on both
   sides of its two paths; K5 on one filter and, in its tier form, on a
   tier of 512 tables of 2048 keys, a one-table tier and a tier of five
   slot counts; K4 on a tier of 512 tables of 2048 keys, K3 on a store of
   six tiers and 512 tables; 4096 queries, half present; K4 and K3 also
   at the pool phase's median calls (``POOL_LOOKUPS``) and at the edge
   shapes of ``_lookup_edges``, with each lane count a pair, their
   ``ti``/``ok`` against ``assign_bounds``), and times kernel, plain
   version and a library yardstick with CUDA events (K1 through its one
   C entry, ``merge_runs``, on the timed pair packed as two runs and at
   a scan's shape; K4 and K3 beside an empty kernel on the same grid);
   then the host nanoseconds of each part of a K2 call, of the staged
   path's K5 call, of K1's engine call at a scan's shape and at a
   2048-key ingest, and of K4's and K3's engine calls at their timed
   shapes (``host_split``). Then K6
   (flash_attention) against its plain version in bf16 (2e-2) and f32
   (1e-5) at the serving path's prefill and decode shapes (Yi-6B heads,
   and Granite-3.0-1B-A400M's and Zamba2-2.7B's shared attention's at
   prefill and the last decode position),
   a 4096-token Yi-6B prefill and a Gemma-2-27B local layer (8192 tokens,
   window 4096, softcap 50), timed beside SDPA with the same mask; in
   bf16 also the relative RMS difference (``ATTN_REL_RMS``), and at the
   serving shapes the p-rounding check (``P_ROUNDING_CASES``); and,
   checked but not timed, the edges of its paths (``ATTN_EDGES``).
3. Staged service phase: ``StorageService`` at the paper's geometry
   (StoreConfig defaults: 16 KB pages, 1 KB entries, 512 MB memory, 128 MB
   write memory, device pool off), partitioned memory component, OPT
   flush policy, two trees with 90/10 write skew; the log cap is raised so
   that no log-triggered flush runs (see ``SERVICE_MAX_LOG_BYTES``). Loads
   2**20 distinct keys in Put batches of 4096, then runs
   ``SERVICE_MIXED`` = 128 YCSB-A submits (cut from 256 for the run's
   time limit; 2048 Gets + 2048 Puts, zipfian 0.99, plus 64 Deletes and 16
   Scans of 100). Every Get and Scan is checked against a dict oracle,
   and K1, K2 and K5 must have launched in this phase (the wrappers'
   launch counts are zeroed just before it); K5 runs in its tier form,
   one launch per (tier, Get batch), and its launches per submit are
   printed. K1 must have launched at most once per ``merge_runs`` or
   ``ingest_run`` call (``"k1"``: calls, launches, the calls by route).
4. Pool service phase: the same stream with a 2 GiB device page pool and
   store-scope fused reads, then a read-only tail of 32 submits of 4096
   zipfian Gets (YCSB C). Every Get, Scan, IOStats counter (but the
   ``fused_*`` ones) and buffer-cache count of the mixed part must equal
   the staged phase's; K3 and K4 must have launched exactly once per
   backend call with queries (the calls' (R, K, tables) are printed as
   ``lookup_shapes``), and the tail must have been served by the
   one-launch store path. (K5 does not run here:
   a store-view miss admits every page of the tree before the per-tier
   loop.)
5. Adaptive phase: the staged phase's store and stream (2**20 keys, 128
   YCSB-A submits) over a ``ShardedStore`` of 4 hash-routed shards under
   ``AdaptiveGovernor(TunerConfig())``, the §5 memory tuner moving the
   write-memory/buffer-cache boundary of the one shared arena. Every Get
   and Scan against the dict oracle; K1, K2 and K5 must launch, K1 at most
   once per engine merge call; the tuner must run at least one cycle.
   Prints its trajectory (x, x_next in MiB, stop reason, cost'), the plans
   applied, the host time per tuning cycle, the keys on each shard, and
   the mixed part's submits per second beside the staged phase's.
6. Arbiter phase: ``HBMArbiter`` leasing one 2 GiB budget across the pool
   phase's store (2**20 keys, store-scope fused reads, a device pool of
   256 MiB at first) and a Yi-6B ``PagedKVPool`` (1 MiB pages of 16
   tokens) with its prefix cache, a decision every 2,048 operations:
   phase A, 32 read-only submits of 4096 zipfian Gets; phase B, 16,384
   one-page appends over 16 streams with a 32-Get submit every 64. Every
   Get against the oracle; the leases sum to 2 GiB byte for byte after
   every decision, the pool's budget ends at the device lease, some bytes
   must move, and K3 and K4 must launch exactly once per backend call
   with queries. Prints the lease trajectory and the device lease's
   change over each phase.
7. Card-vs-CPU phase: one seeded stream of about 60k operations on a small
   store with a 192 KB log cap, replayed with device="cuda" and
   device="cpu", with the pool off, then on (32 MB) in each fused scope:
   fingerprint, every result, IOStats, the WAL bytes and the pool's
   counters must be identical, every replay must run log-triggered
   flushes, and the card's replays must launch the kernels of their path
   (K5 with the pool on: the tier-scope replay's cold tiers). Then the
   same stream under the tuner (``REPLAY_TUNER``,
   ``examples/multi_tenant_store.py``'s settings) over a ``ShardedStore``
   of 1 shard and of 4 shards: every ``TuneRecord`` must
   be identical too, the tuner must actuate at least twice, and the card
   must launch K1, K2 and K5 (``"phase": "adaptive_replay"``). The three
   new phases' seconds follow (``"new_phase_seconds"``).
8. Recovery phase: the WAL and the manifest cloned after the staged
   phase's load, after its mixed part and after the adaptive phase's
   mixed part (``on_part``, between the timed parts), each recovered on the
   card through ``StorageService.recover`` (the adaptive one over 4
   shards, its router rebuilt from the manifest). Each recovered store
   must equal the live one at its point (fingerprint,
   ``RECOVERY_EXACT_COUNTERS``, log position, write memory, the WAL's
   encoded records), answer held Get and Scan submits as the oracle says,
   and launch K1, K2 and K5. Prints the recovery's wall seconds,
   ``recovery_info``, replayed keys per second, K1's launches in the
   replay and the first held submit's seconds (cold filters).
9. Recovery replay phase: the card-vs-CPU replay's stream over 1 and 4
   shards on the card, crashed after ten spread submits and once in the
   middle of a tick (its flushes run, its truncation not yet); each
   point recovered on the card and on the CPU, both equal to the live
   store at that point; some point must recover from a checkpoint.
10. Workers phase: K1 and K2 from 4 threads at once through one backend,
    equal to the same calls made alone and every launch counted; then
    the staged phase's stream again with 2 maintenance workers, its load
    and first ``FILES_SUBMITS`` mixed submits (the cut, under
    ``reduced``), held to the staged phase's results, fingerprint,
    IOStats (but ``bg_*``), buffer-cache counts and WAL bytes at that
    submit; the pool must consume prepares and no prepare may raise.
    Prints the pool's counts, ``bg_segments``, ``bg_overlap_us``, the
    launches and the mixed submits per second beside the staged phase's.
    Then ``WORKERS_REPLAY_SUBMITS`` submits of the replay stream with 0
    and 4 workers on the card and 4 on the CPU, all three identical. The
    three
    phases' seconds follow (``"recovery_workers_seconds"``).
11. Files phase (``"phase": "files"``), in a fresh temporary directory
    removed at its end; every row names the card and the filesystem
    (type, mount point). ``stream``: the staged phase's configuration on
    ``storage_medium="files"`` (``per_batch``), its load and its first
    ``FILES_SUBMITS`` of 128 mixed submits (the files' cut, listed under
    ``reduced``), every Get and Scan against the oracle; results, IOStats
    (but fsyncs) and cache counts equal the staged phase's after that
    submit, and so does the store's state (taken in the staged phase's
    ``"mark"`` part, outside its timed window); K1, K2 and K5 launch, K3,
    K4 and K6 do not. Prints submits/s, load s, fsyncs per 1k ops, commit
    p50/p99, page bytes, WAL segments and SST files. ``reopen``: the
    store closed, its plane reopened (``open_plane``) and recovered on the
    card through ``StorageService.recover``, equal to the live store, then
    held Gets and Scans. ``sigkill``: one child per ``FILES_KILLS`` point
    (``tests/torch_crash_child.py``, all started together) runs the kill
    workload on the card on files and SIGKILLs itself; each plane
    recovered on the card equals the memory-medium oracle at its
    boundary. ``policies``: the replay store (192 KB log cap,
    ``FILES_POLICY_SUBMITS`` submits) under
    ``per_record``, ``per_batch`` and ``group`` on the card and on the
    CPU: state, results and every byte of the plane after ``sync()``
    equal (the checkpoints' fsync clock aside, ``plane_digest``), fsync
    counts too under the first two. ``"files_seconds"`` times the four
    parts against ``FILES_BOX_S``.
12. Serve phase: ``repro_torch.launch.serve.main`` at Yi-6B's full width
   (32 layers, f32 params, bf16 compute, random weights from seed 0) with
   the reference's defaults: 64 requests in batches of 4, 48 prompt
   tokens, 16 generated. K6 must launch exactly 32 x 17 x 16 = 8,704
   times and every logits tensor must be finite; prints step times and
   tokens/s (CUDA events only, no profiler attached), memory, the pool's
   stats, the governor's records and the entry point's lines. A second,
   short run (8 requests) is profiled over 5 decode steps.
13. MoE phases (``"serve_moe"``, ``"model_moe"``, then ``"moe_seconds"``
   against ``MOE_BOX_S``): the serve entry point at Granite-3.0-1B-A400M's
   full width (24 layers, 32 experts, top-8; the same defaults), K6
   exactly 24 x 17 x 16 = 6,528 times at head dim 64 and GQA 2, every
   logits tensor finite; then ``compare_model`` on Granite at all
   ``MOE_MODEL_LAYERS`` = 24 layers, as in 15, with each MoE call's
   router logits held to ``MODEL_TOL`` and its top-k experts on the card
   to the CPU's (``ROUTE_MARGIN``, ``route_agreement``): per step the
   share of agreed (token, expert) choices, the router logits'
   difference, the flips and their gaps, and the pairs past capacity.
14. Hybrid phases (``"serve_hybrid"``, ``"model_hybrid"``, then
   ``"hybrid_seconds"`` against ``HYBRID_BOX_S``): the serve entry point
   at Zamba2-2.7B's full width (54 Mamba2 layers in 9 groups of 6, each
   group followed by the one shared attention + MLP block, K6 at head dim
   80 with 32 heads and 32 KV heads; the same defaults), K6 exactly 9 x
   17 x 16 = 2,448 times, every logits tensor finite, and a profiled
   short run; then ``hybrid_model_phase`` on Zamba2 at all
   ``HYBRID_MODEL_LAYERS`` = 54 layers, batch 4, prompt 48, 8 decode
   steps, the same weights on the card and the CPU: an f64 run on the
   card gives the greedy tokens all are fed and the exact stream; the
   free card run, after each group and at the logits, within
   ``HYBRID_DRIFT_MULT`` times the CPU's own drift from f64
   (``residual_rms_by_group``, ``free_logits``); the sound run and the
   faults with every slot (each Mamba2 layer and each shared attention
   block) fed the CPU's input of that slot, each slot's output held in
   logits, through the model's own head, to ``MODEL_TOL``
   (``slot_logits``), as are the final logits; each fault must break a
   limit at a slot or at the logits, the bf16 decode fault at a prompt
   of ``HYBRID_FAULT_PROMPT`` = 16 (``short_fault``;
   ``hybrid_model_phase`` says why).
15. Card-vs-CPU model phase: Yi-6B at full width but 2 layers, batch 4,
   prompt 48, 8 decode steps, the same seeded weights on the card and on
   the CPU, in f32 and bf16 compute: the largest and the RMS logits
   difference within ``MODEL_TOL`` at every step, greedy tokens equal
   wherever the CPU's top-2 gap exceeds twice the largest; each fault of
   ``MODEL_FAULTS`` run on the card in place of K6 must break a limit.
16. Train phase (``"kernels_attention_bwd"``, ``"train"``,
   ``"train_compare"``, ``"train_checkpoint"``, then ``"train_seconds"``
   against ``TRAIN_BOX_S``): K6's forward with its log-sum-exp and its
   backward (``flash_attention_bwd_prep``, ``_dkv``, ``_dq``) against
   their plain versions in bf16 and f32 (``BWD_TOL``, ``LSE_TOL``; the
   forward's output with the lse equal to the serving call's) at every
   causal ``ATTN_CASES`` shape and MiniCPM-2B's training shapes (timed:
   the whole backward's call, each kernel's call and device time, their
   bounds, the plain version and SDPA's backward) and every causal
   ``ATTN_EDGES`` case; ``launch.train.main`` at MiniCPM-2B's full width
   (40 layers, f32 params, bf16 compute, remat "full") at the entry
   point's defaults (batch 8 x 64, 8 steps) and at one 4096-token sequence (4
   steps), every loss finite and each kernel launched as the layers and
   remat say, its last step profiled; one train step card vs CPU at full
   width cut to 2 layers in f32 and bf16 (``TRAIN_F32_TOL``,
   ``TRAIN_BF16_MULT`` against an f64 run on the CPU, in bf16 the grad
   norm against the norm of the card's own gradients, the update within
   ``TRAIN_UPDATE_TOL`` of AdamW on the card's gradients), and each of
   ``TRAIN_FAULTS`` in place of the backward breaking the f32 limits;
   and at reduced width a checkpoint restart equal to the straight run
   (``CKPT_TOL``), restored on the CPU to the bit.

Prints JSON lines; the ``kernels`` line lists each kernel with its launch
count on its main path (K1, K2, K5: the staged service phase; K3 and K4:
the pool phase; K6: the serve phase, ``launches_serve_moe`` the
serve_moe phase, ``launches_serve_hybrid`` the serve_hybrid phase and
``launches_train`` the train phase's default run; K6's backward kernels:
that run, and ``launches_train_seq4096`` the 4096-token run), its time,
its bound and its
yardsticks (K5's at its tier form's timed shape; the backward's at
MiniCPM-2B's default shape, ``BWD_REPORTED``). The last line is
``{"ok": true, "device": {...}}``. Exits non-zero without a GPU, and when
any phase fails.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (AdaptiveGovernor, Delete, Get,  # noqa: E402
                              LSMStore, Put, Scan, ShardedStore,
                              StorageService, StoreConfig, TunerConfig)
from repro_torch.core.durability import recover  # noqa: E402
from repro_torch.core.durability import (  # noqa: E402
    RECOVERY_EXACT_COUNTERS)
from repro_torch.core.durability.wal import encode_record  # noqa: E402
from repro_torch.core.engine.backend import (  # noqa: E402
    assign_bounds, bloom_sizing)
from repro_torch.core.engine.numpy_backend import (  # noqa: E402
    merge_runs_numpy)
from repro_torch.core.engine.scheduler import enforce_wal  # noqa: E402
from repro_torch.core.engine.workers import (  # noqa: E402
    MaintenanceWorkerPool)
from repro_torch.core.engine.torch_backend import TorchBackend  # noqa: E402
from repro_torch.core.lsm.sstable import (  # noqa: E402
    TOMBSTONE, partition_run, reset_sst_ids, sstable_from_run)
from repro_torch.core.storage_io import (  # noqa: E402
    FSYNC_POLICIES, open_plane)
from repro_torch.core.storage_io.format import read_frames  # noqa: E402
from repro_torch.core.storage_io.manifest_files import (  # noqa: E402
    TAG_CHECKPOINT)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels._launch import (  # noqa: E402
    LAUNCHES, expect, stream_of)
from repro_torch.kernels.attention import attention as attn_k  # noqa: E402
from repro_torch.kernels.bloom import bloom as bloom_k  # noqa: E402
from repro_torch.kernels.lookup import lookup as lookup_k  # noqa: E402
from repro_torch.kernels.merge import merge as merge_k  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_entry  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import build_model, init_params  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.transformer import CausalLM, F32_LEAVES  # noqa: E402
from repro_torch.runtime.hbm_arbiter import (  # noqa: E402
    HBMArbiter, HBMArbiterConfig)
from repro_torch.runtime.hbm_tuner import HBMGovernor  # noqa: E402
from repro_torch.runtime.kvcache import KVPoolConfig, PagedKVPool  # noqa: E402
from repro_torch.runtime import training  # noqa: E402
from repro_torch.runtime.checkpoint import Checkpointer  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.utils.flops import attention_layer_count  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
OPS_PER_S = 67e12                # H100 SXM peak outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
K_HASHES = 7
KB, MB = 1 << 10, 1 << 20
# The service phase raises the transaction-log cap above the bytes it
# writes (under 1.5 GiB), so no log-triggered flush runs. A log-triggered
# partial flush (PartitionedMemComponent.flush_min_lsn) moves the min-LSN
# SSTable of a memory level to disk while an overlapping SSTable of an
# OLDER memory level keeps older versions of some of its keys in memory, and
# reads then return those older versions. The reference package does the
# same, bit for bit, so the fault is the reference's and is filed in
# ROADMAP.md (Queue 3). The card-vs-CPU replay below needs no oracle, so
# it runs that path on purpose with a small cap (REPLAY_MAX_LOG_BYTES).
SERVICE_MAX_LOG_BYTES = 4 << 30
# Mixed submits of the staged stream, which the pool, adaptive, workers
# and files phases run again: cut from 256 to 128 so that the whole script
# stays near half of its 1200 s limit as model families are added.
SERVICE_MIXED = 128
REPLAY_MAX_LOG_BYTES = 192 << 10
SOURCES = {
    "merge_pair": ("src/repro_torch/csrc/merge.cu",
                   "src/repro/kernels/merge/merge.py:68"),
    "bloom_build": ("src/repro_torch/csrc/bloom.cu",
                    "src/repro/kernels/bloom/bloom.py:64"),
    "bloom_probe": ("src/repro_torch/csrc/bloom.cu",
                    "src/repro/kernels/bloom/bloom.py:212"),
    "probe_tier": ("src/repro_torch/csrc/lookup.cu",
                   "src/repro/kernels/bloom/bloom.py:118"),
    "probe_store": ("src/repro_torch/csrc/lookup.cu",
                    "src/repro/kernels/bloom/bloom.py:179"),
    "flash_attention": ("src/repro_torch/csrc/attention.cu",
                        "src/repro/kernels/attention/flash.py:66"),
    **{k: ("src/repro_torch/csrc/attention_bwd.cu",
           "jax.vjp of repro.models.attention.full_attention "
           "(src/repro/models/attention.py:224; no Pallas backward)")
       for k in ("flash_attention_bwd_prep", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")},
}
# K2 is held exactly at these key counts, on both sides of the size at
# which bloom.cu leaves its shared path for its global one
# (kSharedMaxSlots): 256, the engine's tables (2,048), the largest filter
# one block's shared memory could hold (16,384) and 2**20.
BLOOM_BUILD_KEYS = (256, 2048, 16384, 1 << 20)
# K5's tier form on a tier of tables of these sizes (several slot counts).
MIXED_TABLE_KEYS = (100, 300, 1000, 2048, 5000, 17, 700)
# K1's k-run form at a scan's shape (about 100 entries a run over the
# memory component and the tiers, 3.9 runs a call in the staged phase):
# the timed shape and the host split's.
SCAN_RUNS = (100, 100, 100, 100)
# K1 is held exactly at output sizes on both sides of one merge-path tile
# and of eight.
K1_TILE_EDGES = tuple(m * merge_k.TILE + d for m in (1, 8) for d in (-1, 0, 1))
# The pool service phase: a device page pool of 2 GiB of logical 16 KB
# pages (131,072), room for every disk table of the 2**20-key store.
POOL_BYTES = 2 << 30
# K4's and K3's median calls in the pool phase (its ``lookup_shapes``:
# 560 queries; K4 over 75 tables, K3 over two tiers of 512 tables), held
# and timed beside the timed shapes: name -> (tables a tier, queries).
POOL_LOOKUPS = {"probe_tier_pool": ([75], 560),
                "probe_store_pool": ([50, 462], 560)}
# The adaptive phase: the staged phase's store and stream over a
# ShardedStore of this many hash-routed shards, under the §5 tuner with
# TunerConfig's defaults.
ADAPTIVE_SHARDS = 4
# The card-vs-CPU replay of the tuner: examples/multi_tenant_store.py's
# tuner settings over ShardedStores of 1 and 4 shards.
REPLAY_TUNER = dict(min_step_bytes=256 << 10, ops_cycle=15_000,
                    min_write_mem=1 * MB, min_rel_gain=0.0002)
REPLAY_SHARDS = (1, 4)
# Its store: the replay's geometry with a buffer cache smaller than the
# data (40,000 keys of 256 B) and the log cap above the bytes the stream
# writes, so reads miss, merges run and flushes are memory-triggered:
# cost'(x) is nonzero and the tuner moves.
REPLAY_TUNED_STORE = dict(total_memory_bytes=10 * MB,
                          write_memory_bytes=2 * MB, max_log_bytes=64 * MB)
REPLAY_TUNED_KEYS = 40_000
# The arbiter phase: one 2 GiB device budget leased across the store's
# device page pool (256 MiB at first) and a Yi-6B KV pool and prefix
# cache (the rest, split evenly); a KV page is 16 tokens of Yi-6B's keys
# and values in bf16 (1 MiB). Phase A: 32 read-only submits of 4096
# zipfian Gets; phase B: ARBITER_APPENDS one-page appends over 16
# streams, a 32-Get batch every 64 appends (benchmarks/kv_serving.py's
# arbiter_flip shape).
ARBITER_DEVICE_LEASE = 256 << 20
ARBITER_OPS_CYCLE = 2048
ARBITER_APPENDS = 16384
ARBITER_STREAMS = 16
# The service phases' two trees; the first takes 90% of the writes.
TREES = ("hot", "cold")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def zero_counts() -> None:
    """Zero the kernels' launch counts and K1's route counts."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for r in merge_k.ROUTES:
        merge_k.ROUTES[r] = 0


# --------------------------- timing ------------------------------------------
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


def bound(nbytes: int, nops: int, ops_per_s: float = OPS_PER_S) -> dict:
    """Least time the card could take: the bytes that must move at the
    memory rate, or the operations at the peak rate, whichever is longer."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nops / ops_per_s * 1e3
    if by_bytes >= by_ops:
        return {"bound_ms": by_bytes, "bound_by": "bytes"}
    return {"bound_ms": by_ops, "bound_by": "operations"}


def device_us(fn) -> tuple[dict, float]:
    """Run ``fn()`` under the CUDA profiler. Returns device microseconds by
    event name (kernels, copies, memsets) and the host wall microseconds
    of the call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e6
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if us > 0:
            out[e.key] = out.get(e.key, 0.0) + us
    return out, wall


def kernel_device_ms(fn, kernel: str, reps: int = 20):
    """Device time of one launch of ``kernel`` over ``reps`` calls of
    ``fn`` (profiler): the kernel's device time over the launches the
    profiler recorded, which can be fewer than the calls. None when it
    reports no device time for the kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, launches = 0.0, 0
    for e in prof.key_averages():
        if kernel in e.key and getattr(e, "self_device_time_total", 0) > 0:
            us += e.self_device_time_total
            launches += e.count
    return us / launches / 1e3 if launches else None


# --------------------------- kernel phase ------------------------------------
def _runs_with_dups(rng, na: int, nb: int):
    """Sorted int64 runs A (newer) and B (older) with keys beyond int32,
    a few in-run duplicates and about a quarter of B's keys also in A."""
    a = np.sort(rng.integers(-2**40, 2**40, na))
    shared = rng.choice(a, nb // 4) if na else np.zeros(0, np.int64)
    b = np.sort(np.concatenate([shared,
                                rng.integers(-2**40, 2**40, nb - len(shared))]))
    return (a, rng.integers(0, 2**62, na), b, rng.integers(0, 2**62, nb))


def _max_abs_err(xs, ys) -> int:
    err = 0
    for x, y in zip(xs, ys):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} vs {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def _lookup_tiers(rng, sizes, table_keys: int):
    """Newest-first lookup tiers of ``sizes[r]`` tables of ``table_keys``
    int64 keys (beyond int32), drawn from one key space so that newer
    tiers shadow part of the older ones; the newest tier also holds a
    negative key, 2**31 + 5 and ``TOMBSTONE``."""
    universe = _key_of(np.arange(4 * sum(sizes) * table_keys))
    tiers = []
    for r, n in enumerate(sizes):
        k = rng.choice(universe, n * table_keys, replace=False)
        if r == 0:
            k[:3] = [-7, 2**31 + 5, TOMBSTONE]
        k = np.unique(k)
        v = rng.integers(0, 2**62, len(k))
        v[::97] = TOMBSTONE
        tiers.append(partition_run(k, v, 0, 0, 1024, 16 * KB,
                                   table_keys * 1024))
    return tiers


def _lookup_queries(rng, tables, n_queries: int):
    """Half present keys of ``tables``, half keys outside the key space
    (misses, Bloom false positives and keys beyond every table)."""
    present = rng.choice(np.concatenate([t.keys for t in tables]),
                         n_queries // 2)
    absent = _key_of(rng.integers(1 << 30, 1 << 31,
                                  n_queries - n_queries // 2))
    return np.concatenate([present, absent]).astype(np.int64)


def _hold_lookup(view, q, store: bool, what: str) -> int:
    """One K3 (``store``) or K4 call on ``view`` against its plain version,
    field by field, and against ``assign_bounds`` for ``ti``/``ok``.
    Returns the largest difference."""
    kern = lookup_k.probe_store if store else lookup_k.probe_tier
    plain = lookup_k.probe_store_plain if store else lookup_k.probe_tier_plain
    R, K = view.n_tiers, len(q)
    got = lookup_k.unpack(kern(view, q, K_HASHES), R, K, store)
    want = lookup_k.unpack(plain(view, q, K_HASHES), R, K, store)
    err = _max_abs_err(list(got.values()), list(want.values()))
    t_off = view.t_off.tolist()
    qn = q.cpu().numpy()
    for r in range(R):
        a, b = t_off[r], t_off[r + 1]
        ti, ok = assign_bounds(view.starts[a:b].cpu().numpy(),
                               view.ends[a:b].cpu().numpy(), qn)
        if not (np.array_equal(got["ti"][r].cpu().numpy(), ti)
                and np.array_equal(got["ok"][r].cpu().numpy(), ok)):
            raise AssertionError(f"{what}: ti/ok differ from assign_bounds "
                                 f"in tier {r}")
    if err:
        raise AssertionError(f"{what}: differs from its plain version "
                             f"({err})")
    return err


# K3's and K4's edge shapes beside the timed ones: (tier sizes in tables,
# keys a table, queries). One table; R = 1 and R = 8; a tier of 4,097
# tables alone and with two more tiers; query counts no multiple of a
# block's queries. With the timed and pool shapes they give each kernel
# every lane count of lookup.cu's rule (by pairs, R x queries): K4 32
# (1,001), 16 (2,999, 4,096), 8 (9,001), 4 (16,385); K3 32 (1,001,
# 1,120), 16 (8,008), 8 (8,997, 9,001), 4 (16,385, 24,576).
def _lookup_edges():
    return [("one_table", [1], 2048, 1001),
            ("r1", [64], 2048, 9001),
            ("r8", [2, 2, 4, 8, 16, 32, 64, 128], 2048, 1001),
            ("many_tables", [4097], 16, 16385),
            ("many_tables_store", [3, 40, 4097], 16, 2999)]


def check_lookup(dev, *, tier_tables: int, table_keys: int, store_sizes,
                 n_queries: int, pool_shapes=None, edges=None,
                 seed: int = 0) -> dict:
    """Hold K4 (``probe_tier``) and K3 (``probe_store``) against their plain
    versions on views built by ``TorchBackend`` on ``dev``: the timed
    shapes (one tier of ``tier_tables`` tables, a store of
    ``len(store_sizes)`` tiers; ``n_queries`` queries, half present), each
    of ``pool_shapes`` (name -> (tier sizes, queries): the pool phase's
    calls, timed too; a name that starts with ``probe_store`` is K3's),
    then each edge of ``edges`` (``_lookup_edges()`` by default) on both
    kernels: K4 on each of its tiers, K3 on the whole store."""
    rng = np.random.default_rng(seed)
    tb = TorchBackend(device=dev)
    bloom = lambda s: tb.bloom_build(s.keys)  # noqa: E731
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)  # noqa: E731
    reset_sst_ids()
    tier = _lookup_tiers(rng, [tier_tables], table_keys)[0]
    tv = tb.prepare_tier(tier, bloom)
    view = tv.payload
    q = T(_lookup_queries(rng, tier, n_queries))
    err = {"probe_tier": _hold_lookup(view, q, False, "probe_tier")}
    out = lookup_k.unpack(lookup_k.probe_tier(view, q, K_HASHES), 1,
                          n_queries, False)
    if not bool(out["hit"][0, : n_queries // 2].all()):
        raise AssertionError("probe_tier missed a present key")
    timed = {"probe_tier": (tv, q, out["ti"][0].long())}
    tiers = _lookup_tiers(rng, store_sizes, table_keys)
    sv = tb.prepare_store(tiers, bloom)
    sview = sv.payload
    q = T(_lookup_queries(rng, [t for tr in tiers for t in tr], n_queries))
    err["probe_store"] = _hold_lookup(sview, q, True, "probe_store")
    out = lookup_k.unpack(lookup_k.probe_store(sview, q, K_HASHES),
                          len(tiers), n_queries, True)
    win = out["win"]
    if not bool((win[: n_queries // 2] >= 0).all()) \
            or not bool((win > 0).any()):
        raise AssertionError("probe_store missed a present key")
    timed["probe_store"] = (sv, q, out["ti"].long())
    for name, (sizes, k) in (pool_shapes or {}).items():
        store = name.startswith("probe_store")
        tiers = _lookup_tiers(rng, sizes, table_keys)
        bv = (tb.prepare_store(tiers, bloom) if store
              else tb.prepare_tier(tiers[0], bloom))
        q = T(_lookup_queries(rng, [t for tr in tiers for t in tr], k))
        kind = "probe_store" if store else "probe_tier"
        err[kind] = max(err[kind], _hold_lookup(bv.payload, q, store,
                                                name))
        kern = getattr(lookup_k, kind)
        out = lookup_k.unpack(kern(bv.payload, q, K_HASHES), len(tiers), k,
                              store)
        timed[name] = (bv, q, out["ti"].long())
    cases = {}
    for what, sizes, keys, k in (_lookup_edges() if edges is None
                                 else edges):
        tiers = _lookup_tiers(rng, sizes, keys)
        q = T(_lookup_queries(rng, [t for tr in tiers for t in tr], k))
        sv = tb.prepare_store(tiers, bloom).payload
        e = _hold_lookup(sv, q, True, f"probe_store ({what})")
        err["probe_store"] = max(err["probe_store"], e)
        for tr in tiers:
            e = _hold_lookup(tb.prepare_tier(tr, bloom).payload, q, False,
                             f"probe_tier ({what})")
            err["probe_tier"] = max(err["probe_tier"], e)
        cases[what] = {"tiers": sizes, "table_keys": keys, "queries": k}
    return {"err": err, "timed": timed, "cases": cases,
            "view_bytes": {"probe_tier": view.nbytes,
                           "probe_store": sview.nbytes}}


# --------------------------- K1: the k-run form ------------------------------
def _sorted_run(rng, n: int, pool) -> np.ndarray:
    """``n`` sorted int64 keys in +-2**40 (beyond int32, negative ones
    too), a quarter drawn from ``pool`` (keys of newer runs), and every
    ninth key a copy of the one before it (in-run duplicates)."""
    k = rng.integers(-2**40, 2**40, n)
    if len(pool) and n >= 4:
        k[: n // 4] = rng.choice(pool, n // 4)
    k[1::9] = k[0::9][: len(k[1::9])]
    return np.sort(k)


def _k_runs(rng, lens):
    """Newest-first runs of ``lens`` keys (``_sorted_run``) with values."""
    runs, pool = [], np.zeros(0, np.int64)
    for n in lens:
        k = _sorted_run(rng, n, pool)
        runs.append((k, rng.integers(-2**62, 2**62, n)))
        pool = np.concatenate([pool, k])
    return runs


def _level_runs(rng, n_keys: int, n_olds: int):
    """A level merge: a victim table, then ``n_olds`` tables of the next
    level, adjacent and disjoint (each with in-run duplicates), about
    ``n_keys`` keys in all; half the victim's keys overwrite old ones."""
    n_v = n_keys // (n_olds + 1)
    old = np.unique(rng.integers(-2**40, 2**40, n_keys - n_v))
    olds = []
    for c in np.array_split(old, n_olds):
        c = np.sort(np.concatenate([c, c[1:len(c) // 50 + 1]]))
        olds.append((c, rng.integers(-2**62, 2**62, len(c))))
    victim = _sorted_run(rng, n_v, old)
    return [(victim, rng.integers(-2**62, 2**62, n_v))] + olds


def _packed(runs, dev):
    """``runs`` packed for ``merge_runs`` as they are (no joining), on
    ``dev``: (packed, k, n)."""
    offs = np.cumsum([0] + [len(k) for k, _ in runs]).astype(np.int64)
    buf = np.empty(len(offs) + 2 * int(offs[-1]), np.int64)
    merge_k.pack_runs(runs, offs, buf)
    return torch.from_numpy(buf).to(dev), len(runs), int(offs[-1])


def _hold_k_run(runs, dev, what: str):
    """K1's k-run form against ``merge_runs_plain`` on the runs as they
    are; raises on any difference. Returns the error and the route."""
    p, k, n = _packed(runs, dev)
    before = dict(merge_k.ROUTES)
    got = merge_k.merge_runs(p, k, n)
    route = [r for r in merge_k.ROUTE_NAMES
             if merge_k.ROUTES[r] != before[r]]
    e = _max_abs_err(merge_k.unpack(got, n),
                     merge_k.unpack(merge_k.merge_runs_plain(p, k, n), n))
    if e:
        raise AssertionError(f"merge_runs differs from its plain version "
                             f"({what}, k={k}, n={n}): {e}")
    return e, (route[0] if route else None)


def _hold_pair(a, av, b, bv, dev, what: str) -> int:
    """K1's pair form (the pair packed for ``merge_runs``) against
    ``merge_pair_plain``."""
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)  # noqa: E731
    args = tuple(map(T, (a, av, b, bv)))
    e = _max_abs_err(merge_k.merge_pair(*args),
                     merge_k.merge_pair_plain(*args))
    if e:
        raise AssertionError(f"merge_pair differs from its plain version "
                             f"({what}, {len(a)}+{len(b)}): {e}")
    return e


def _ingest_oracle(keys, vals):
    """Unique keys, the value and the batch position of each key's last
    occurrence (the ingest semantics)."""
    rev = keys[::-1]
    u, first = np.unique(rev, return_index=True)
    src = len(keys) - 1 - first
    return u, vals[src], src


def check_merge_runs(dev, *, merge_shapes, seed: int = 3) -> dict:
    """Hold K1's new forms exactly against their plain versions on ``dev``:
    the pair form (packed on the card) and the k-run form at the timed pair
    shapes, at tile edges, with an empty run, one-element runs and 2**16 +
    2**16 equal keys; the k-run form at k = 3, 6 and 12 (a scan's shape),
    at sizes that take its global route, and on an 11-run level merge of
    2**17 keys as it is (k = 11) and through the engine's call (the last 10
    tables joined, k = 2), held to ``merge_runs_numpy``; and the engine's
    ingest of batches of 2,048 and 4,096 keys, held to the card-free
    oracle and to the CPU backend. Keys beyond int32, negative keys and
    in-run duplicates throughout. Returns the largest error, each case's
    route and the timed scan runs."""
    rng = np.random.default_rng(seed)
    err, cases = 0, {}

    def hold(name, runs):
        nonlocal err
        e, route = _hold_k_run(runs, dev, name)
        if len(runs) == 2:
            (a, av), (b, bv) = runs
            e = max(e, _hold_pair(a, av, b, bv, dev, name))
        err = max(err, e)
        cases[name] = {"runs": [len(k) for k, _ in runs], "route": route}

    for na, nb in merge_shapes:
        hold(f"pair_{na}+{nb}", _k_runs(rng, (na, nb)))
    for m in K1_TILE_EDGES:
        hold(f"tile_edge_{m}", _k_runs(rng, (m * 3 // 5, m - m * 3 // 5)))
    hold("empty_newer", _k_runs(rng, (0, 3000)))
    hold("empty_older", _k_runs(rng, (3000, 0)))
    hold("empty_middle", _k_runs(rng, (100, 0, 100)))
    hold("one_one", _k_runs(rng, (1, 1)))
    hold("pair_small", _k_runs(rng, (130, 120)))
    hold("one_newer", _k_runs(rng, (1, 20000)))
    hold("one_older", _k_runs(rng, (20000, 1)))
    hold("twelve_ones", _k_runs(rng, (1,) * 12))
    eq = np.full(1 << 16, -(2**35) - 3, np.int64)
    hold("equal_2^16+2^16", [(eq, rng.integers(-2**62, 2**62, 1 << 16)),
                              (eq.copy(), rng.integers(-2**62, 2**62,
                                                       1 << 16))])
    for k in (3, 6, 12):
        hold(f"scan_k{k}", _k_runs(rng, rng.integers(90, 111, k)))
    hold("global_k3", _k_runs(rng, (1 << 15,) * 3))
    hold("global_k5_uneven", _k_runs(rng, (40000, 17, 9000, 1, 70000)))
    hold("single_run", _k_runs(rng, (50000,)))
    level = _level_runs(rng, 1 << 17, 10)
    hold("level_k11_as_is", level)
    tb, cpu = TorchBackend(device=dev), TorchBackend(device="cpu")
    before = dict(merge_k.ROUTES)
    got = tb.merge_runs(level)
    joined = {r: merge_k.ROUTES[r] - before[r] for r in merge_k.ROUTE_NAMES}
    for g, w in zip(got, merge_runs_numpy(level)):
        if not np.array_equal(g, w):
            raise AssertionError("the engine's level merge differs from "
                                 "merge_runs_numpy")
    k_joined = len(merge_k.run_offsets(level)) - 1
    if k_joined != 2:
        raise AssertionError(f"the level merge's tables joined to "
                             f"{k_joined} runs, not 2")
    cases["level_k11_engine"] = {"runs": [len(k) for k, _ in level],
                                 "runs_joined": k_joined, "routes": joined}
    for n in (2048, 4096):
        keys = np.concatenate([_key_of(rng.integers(0, n // 2, n - 2)),
                               [-5, 2**33 + 1]])
        rng.shuffle(keys)
        vals = rng.integers(-2**62, 2**62, n)
        before = dict(merge_k.ROUTES)
        got = tb.ingest_run(keys, vals)
        route = [r for r in merge_k.ROUTE_NAMES
                 if merge_k.ROUTES[r] != before[r]]
        for g, w, c in zip(got, _ingest_oracle(keys, vals),
                           cpu.ingest_run(keys, vals)):
            if not (np.array_equal(g, w) and np.array_equal(g, c)):
                raise AssertionError(f"ingest_run of {n} keys differs")
        cases[f"ingest_{n}"] = {"keys": n, "unique": len(got[0]),
                                "route": route[0] if route else None}
    return {"err": err, "cases": cases, "scan": _k_runs(rng, SCAN_RUNS)}


def check_kernels(dev, *, merge_shapes, ingest_n: int, sst_keys: int,
                  n_queries: int, lookup_kw: dict, seed: int = 0) -> dict:
    """Hold every kernel against its plain version on ``dev`` at the main
    path's shapes; raises on any difference. Returns the inputs of the
    timed shape of each kernel and the error seen."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)  # noqa: E731
    err = dict.fromkeys(LAUNCHES, 0)
    timed = {}
    for na, nb in merge_shapes:
        args = tuple(map(T, _runs_with_dups(rng, na, nb)))
        e = _max_abs_err(merge_k.merge_pair(*args),
                         merge_k.merge_pair_plain(*args))
        err["merge_pair"] = max(err["merge_pair"], e)
        if e:
            raise AssertionError(f"merge_pair differs at {na}+{nb}: {e}")
        timed["merge_pair"] = args
    k1 = check_merge_runs(dev, merge_shapes=merge_shapes, seed=seed + 3)
    err["merge_pair"] = max(err["merge_pair"], k1["err"])
    timed["merge_runs"] = k1["scan"]
    # Ingest shape: a batch with in-batch duplicates, in ingest order.
    keys = rng.integers(0, ingest_n // 2, ingest_n)
    order = np.lexsort((-np.arange(ingest_n), keys))
    ok, op = T(keys[order]), T(order)
    h = ingest_n // 2
    e = _max_abs_err(merge_k.merge_pair(ok[:h], op[:h], ok[h:], op[h:]),
                     merge_k.merge_pair_plain(ok[:h], op[:h], ok[h:], op[h:]))
    err["merge_pair"] = max(err["merge_pair"], e)
    if e:
        raise AssertionError(f"merge_pair differs on the ingest batch: {e}")
    # Bloom: one SSTable's keys, including keys beyond int32, a negative
    # key and the tombstone payload as a key. K2 at sizes on both sides
    # of its two paths.
    for n in BLOOM_BUILD_KEYS:
        k = T(bloom_keys(rng, n))
        _, n_slots = bloom_sizing(len(k))
        e = _max_abs_err([bloom_k.bloom_build(k, n_slots, K_HASHES)],
                         [bloom_k.bloom_build_plain(k, n_slots, K_HASHES)])
        err["bloom_build"] = max(err["bloom_build"], e)
        if e:
            raise AssertionError(f"bloom_build differs from its plain "
                                 f"version at {n} keys")
    sk = T(bloom_keys(rng, sst_keys))
    _, n_slots = bloom_sizing(len(sk))
    f = bloom_k.bloom_build(sk, n_slots, K_HASHES)
    fp = bloom_k.bloom_build_plain(sk, n_slots, K_HASHES)
    e = _max_abs_err([f], [fp])
    if e:
        raise AssertionError("bloom_build differs from its plain version")
    q = torch.cat([sk[: n_queries // 2],
                   T(rng.integers(-2**40, 2**40, n_queries - n_queries // 2))])
    p = bloom_k.bloom_probe(f, q, K_HASHES)
    pp = bloom_k.bloom_probe_plain(fp, q, K_HASHES)
    err["bloom_probe"] = _max_abs_err([p], [pp])
    if err["bloom_probe"] or not bool(p[: n_queries // 2].all()):
        raise AssertionError("bloom_probe differs or gave a false negative")
    timed["bloom_build"] = (sk, n_slots)
    timed["bloom_probe_single"] = (f, q)
    bt = check_bloom_tier(dev, n_queries=n_queries, seed=seed + 2,
                          tier_tables=lookup_kw["tier_tables"],
                          table_keys=lookup_kw["table_keys"])
    err["bloom_probe"] = max(err["bloom_probe"], bt["err"])
    timed["bloom_probe"] = bt["timed"]
    lk = check_lookup(dev, n_queries=n_queries, seed=seed + 1, **lookup_kw)
    err.update(lk["err"])
    timed.update(lk["timed"])
    return {"err": err, "timed": timed, "view_bytes": lk["view_bytes"],
            "k1_cases": k1["cases"], "lookup_cases": lk["cases"]}


def bloom_keys(rng, n: int) -> np.ndarray:
    """About ``n`` distinct int64 keys of one SSTable: keys beyond int32,
    a negative key and the tombstone payload as a key."""
    return np.unique(np.concatenate([rng.integers(0, 2**40, n - 3),
                                     [2**31 + 5, -7, TOMBSTONE]]))


def _tier_inputs(dev, tb, tables, q):
    """K5's tier form over ``tables``: their filters (built by ``tb``),
    the queries and each query's covering table (``assign_bounds``,
    clipped), on ``dev``."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev)  # noqa: E731
    filts = [tb.bloom_build(t.keys)[1] for t in tables]
    ti, _ = assign_bounds(np.array([t.min_key for t in tables]),
                          np.array([t.max_key for t in tables]), q)
    return filts, T(q), T(ti)


def check_bloom_tier(dev, *, tier_tables: int, table_keys: int,
                     n_queries: int, seed: int = 0) -> dict:
    """Hold K5's tier form (``bloom_probe_tier``) against its plain version
    on a tier of ``tier_tables`` tables of ``table_keys`` keys (half the
    queries present; the timed shape), on a one-table tier, and on a tier
    whose tables have different slot counts."""
    rng = np.random.default_rng(seed)
    tb = TorchBackend(device=dev)
    tier = _lookup_tiers(rng, [tier_tables], table_keys)[0]
    # Tables of 100 to 5000 keys: five slot counts, 2,560 to 81,920.
    k, v = _lookup_run(rng, sum(MIXED_TABLE_KEYS))
    cuts = np.cumsum([0, *MIXED_TABLE_KEYS])
    mixed = [sstable_from_run(k[a:b], v[a:b], 0, 0, 1024, 16 * KB)
             for a, b in zip(cuts[:-1], cuts[1:])]
    err, timed = 0, None
    for what, tables in (("tier", tier), ("one table", tier[:1]),
                         ("mixed slot counts", mixed)):
        q = _lookup_queries(rng, tables, n_queries)
        filts, qd, ti = _tier_inputs(dev, tb, tables, q)
        got = bloom_k.bloom_probe_tier(filts, qd, ti, K_HASHES)
        want = bloom_k.bloom_probe_tier_plain(filts, qd, ti, K_HASHES)
        e = _max_abs_err([got], [want])
        err = max(err, e)
        if e or not bool(got[: n_queries // 2].all()):
            raise AssertionError(f"bloom_probe_tier differs or gave a false "
                                 f"negative ({what})")
        if timed is None:
            timed = (filts, qd, ti)
    return {"err": err, "timed": timed}


def _lookup_run(rng, n: int):
    """One sorted run of ``n`` distinct keys beyond int32 and its values."""
    k = np.sort(rng.choice(_key_of(np.arange(4 * n)), n, replace=False))
    return k, rng.integers(0, 2**62, n)


def time_kernels(timed: dict) -> dict:
    out = {}
    ak, av, bk, bv = timed["merge_pair"]
    n = len(ak) + len(bk)
    cat = torch.cat([ak, bk])
    # The engine's entry on the pair packed as the engine packs two runs.
    # Bytes: the packed offsets, keys and values read, key, value and flag
    # written. Operations: the compares of each element's binary search
    # in the other run.
    p2 = merge_k.pack_pair(ak, av, bk, bv)
    searches = (len(ak) * len(bk).bit_length()
                + len(bk) * len(ak).bit_length())
    out["merge_pair"] = {
        "ms": cuda_ms(lambda: merge_k.merge_runs(p2, 2, n)),
        "plain_ms": cuda_ms(lambda: merge_k.merge_runs_plain(p2, 2, n)),
        **bound(p2.nbytes + n * 17, searches + n),
        "library_ms": cuda_ms(lambda: torch.sort(cat, stable=True)),
        "device_ms": kernel_device_ms(lambda: merge_k.merge_runs(p2, 2, n),
                                      "merge_path_kernel"),
        "shape": [len(ak), len(bk)]}
    # The engine's k-run call at a scan's shape, on the card's copy of the
    # packed runs. Bytes: the packed offsets, keys and values read, keys,
    # values and flags written. Operations: each element's binary search
    # in every other run. Yardstick: a stable sort of the keys.
    runs = timed["merge_runs"]
    p, k, n = _packed(runs, ak.device)
    keys = p[k + 1:k + 1 + n]
    lens = [len(x) for x, _ in runs]
    steps = sum(a * max(b, 1).bit_length() for i, a in enumerate(lens)
                for j, b in enumerate(lens) if i != j)
    out["merge_runs_scan"] = {
        "ms": cuda_ms(lambda: merge_k.merge_runs(p, k, n)),
        "plain_ms": cuda_ms(lambda: merge_k.merge_runs_plain(p, k, n)),
        **bound(p.nbytes + n * 17, steps + n),
        "library_ms": cuda_ms(lambda: torch.sort(keys, stable=True)),
        "device_ms": kernel_device_ms(lambda: merge_k.merge_runs(p, k, n),
                                      "merge_rank_kernel"),
        "shape": lens}
    # K2 and K5: the filter (one byte a slot, 20 KB at 2048 keys) stays in
    # L2 after its first touch, so what must cross device memory is the
    # keys, the filter once and the probe results.
    sk, n_slots = timed["bloom_build"]
    bslots = bloom_k.bloom_slots_plain(sk, n_slots, K_HASHES).reshape(-1)
    out["bloom_build"] = {
        "ms": cuda_ms(lambda: bloom_k.bloom_build(sk, n_slots, K_HASHES)),
        "plain_ms": cuda_ms(
            lambda: bloom_k.bloom_build_plain(sk, n_slots, K_HASHES)),
        **bound(len(sk) * 8 + n_slots, len(sk) * K_HASHES),
        "library_ms": cuda_ms(lambda: torch.zeros(
            n_slots, dtype=torch.bool, device=sk.device).index_fill_(
                0, bslots, True)),
        "device_ms": kernel_device_ms(
            lambda: bloom_k.bloom_build(sk, n_slots, K_HASHES),
            "bloom_build_kernel"),
        "shape": [len(sk), n_slots]}
    f, q = timed["bloom_probe_single"]
    slots = bloom_k.bloom_slots_plain(q, f.numel(), K_HASHES).reshape(-1)
    flat = f.reshape(-1)
    out["bloom_probe_single"] = {
        "ms": cuda_ms(lambda: bloom_k.bloom_probe(f, q, K_HASHES)),
        "plain_ms": cuda_ms(lambda: bloom_k.bloom_probe_plain(f, q, K_HASHES)),
        **bound(len(q) * 8 + f.numel() + len(q), len(q) * K_HASHES),
        "library_ms": cuda_ms(
            lambda: torch.gather(flat, 0, slots).view(-1, K_HASHES).all(-1)),
        "device_ms": kernel_device_ms(
            lambda: bloom_k.bloom_probe(f, q, K_HASHES), "bloom_probe_kernel"),
        "shape": [len(q), f.numel()]}
    # K5's tier form, the staged path's: a tier's filters (20 KB a table)
    # stay in L2, so what must cross device memory is the queries, their
    # table indices and the filters' table (an address and a slot count a
    # filter), read once, and the results. The yardstick gathers each
    # query's slots, precomputed, from the filters concatenated.
    filts, q, ti = timed["bloom_probe"]
    ns = torch.tensor([x.numel() for x in filts], device=q.device)
    slots = (bloom_k.bloom_slots_plain(q, ns[ti], K_HASHES)
             + (torch.cumsum(ns, 0) - ns)[ti][:, None]).reshape(-1)
    flat = torch.cat([x.reshape(-1) for x in filts])

    def tier():
        return bloom_k.bloom_probe_tier(filts, q, ti, K_HASHES)
    out["bloom_probe"] = {
        "ms": cuda_ms(tier),
        "plain_ms": cuda_ms(lambda: bloom_k.bloom_probe_tier_plain(
            filts, q, ti, K_HASHES)),
        **bound(q.nbytes + ti.nbytes + 16 * len(filts) + len(q),
                len(q) * K_HASHES),
        "library_ms": cuda_ms(
            lambda: torch.gather(flat, 0, slots).view(-1, K_HASHES).all(-1)),
        "device_ms": kernel_device_ms(tier, "bloom_probe_kernel"),
        "shape": [len(q), len(filts)]}
    out.update(time_lookup(timed))
    return out


def time_lookup(timed: dict) -> dict:
    """K4 and K3 at their timed shapes and at the pool phase's
    (``POOL_LOOKUPS``): each ``probe_tier*`` and ``probe_store*`` entry
    of ``timed``. The view's keys, values and
    filters stay in L2 across calls (printed as view_bytes), so what must
    cross device memory is the queries and each table's min_key and
    max_key read once, and the fields written once at their widths (19 B
    a pair, 4 B a query for K3's winner). Operations: k Bloom slots and
    ceil(log2 len) binary search steps per (tier, query), len that of the
    assigned table. The floor: an empty kernel on the same grid, launched
    the same way."""
    lib = build.library()
    out = {}
    for name in [n for n in timed if n.startswith(("probe_tier",
                                                     "probe_store"))]:
        kind = "probe_store" if name.startswith("probe_store") \
            else "probe_tier"
        store = kind == "probe_store"
        bview, q, ti = timed[name]
        view = bview.payload
        kern = getattr(lookup_k, kind)
        plain = getattr(lookup_k, kind + "_plain")
        gti = view.t_off[:-1, None] + ti.reshape(view.n_tiers, -1)
        lens = view.lens[gti].cpu().numpy()
        steps = int(np.ceil(np.log2(np.maximum(lens, 1))).sum())
        st = stream_of(q)

        def floor():
            build.check(lib.probe_floor(view.desc_ptr, len(q), st),
                        "probe_floor")
        out[name] = {
            "ms": cuda_ms(lambda: kern(view, q, K_HASHES)),
            "plain_ms": cuda_ms(lambda: plain(view, q, K_HASHES)),
            **bound(q.nbytes + 16 * view.n_tables
                    + lookup_k.out_bytes(view.n_tiers, len(q), store),
                    lens.size * K_HASHES + steps),
            "library_ms": None,
            "device_ms": kernel_device_ms(lambda: kern(view, q, K_HASHES),
                                          "probe_kernel"),
            "floor_ms": cuda_ms(floor),
            "floor_device_ms": kernel_device_ms(floor, "empty_kernel"),
            "shape": [view.n_tiers, len(q), view.n_tables]}
    return out


def _median_ns(fn, reps: int = 500) -> float:
    """Median host nanoseconds of one call of ``fn`` (perf_counter_ns)."""
    fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter_ns()
        fn()
        ts.append(time.perf_counter_ns() - t)
    torch.cuda.synchronize()
    return float(np.median(ts))


def host_split(timed: dict) -> dict:
    """Host nanoseconds of each part of a K2 call (the timed 2,048 keys)
    and of the staged path's K5 call (``TorchBackend.bloom_probe_tier`` on
    the timed tier, host keys), beside the whole call; then K4's and K3's
    (``lookup_host_split``) and K1's (``k1_host_split``) engine calls. ``removed`` holds
    the parts the wrappers no longer take, timed the same way: a
    zero-filled filter and a ``torch.cuda.Stream`` object per call; and
    one single-table backend probe, as the per-table staged loop made."""
    from repro_torch.kernels._launch import on_card
    lib = build.library()
    sk, n_slots = timed["bloom_build"]
    shape = (128, n_slots // 128)
    filt = torch.empty(shape, dtype=torch.bool, device=sk.device)
    st = stream_of(sk)
    k2 = {
        "checks": _median_ns(lambda: (expect(sk, "keys", torch.int64),
                                      bloom_k._check_slots(n_slots))),
        "on_card": _median_ns(lambda: on_card(sk)),
        "alloc_empty": _median_ns(lambda: torch.empty(
            shape, dtype=torch.bool, device=sk.device)),
        "stream_raw": _median_ns(lambda: stream_of(sk)),
        "library_attr": _median_ns(lambda: build.library().bloom_build),
        "ctypes_launch": _median_ns(lambda: lib.bloom_build(
            sk.data_ptr(), len(sk), n_slots, K_HASHES, filt.data_ptr(), st)),
        "check_and_count": _median_ns(lambda: build.check(0, "bloom_build")),
        "whole": _median_ns(lambda: bloom_k.bloom_build(sk, n_slots,
                                                        K_HASHES)),
        "removed": {
            "alloc_zeros": _median_ns(lambda: torch.zeros(
                shape, dtype=torch.bool, device=sk.device)),
            "stream_object": _median_ns(
                lambda: torch.cuda.current_stream(sk.device).cuda_stream)}}
    filts, q, ti = timed["bloom_probe"]
    dev = q.device
    tb = TorchBackend(device=dev)
    tuples = [("torch", f) for f in filts]
    qn, tn = q.cpu().numpy(), ti.cpu().numpy()
    qh, th = torch.from_numpy(qn), torch.from_numpy(tn)
    table = bloom_k.tier_table(filts)
    n, t = len(qn), len(table)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    packed = torch.cat([torch.from_numpy(np.array(table, np.int64)), qh,
                        th]).to(dev)
    first = tn == 0
    k5 = {
        "tables": len(filts), "queries": n,
        "unwrap": _median_ns(lambda: [tb._filter(f) for f in tuples]),
        "host_tensors": _median_ns(lambda: (
            torch.from_numpy(np.ascontiguousarray(qn, np.int64)),
            torch.from_numpy(np.ascontiguousarray(tn, np.int64)))),
        "checks_and_table": _median_ns(lambda: (
            expect(qh, "keys", torch.int64), expect(th, "tidx", torch.int64),
            bloom_k.tier_table(filts), on_card(filts[0]))),
        "pack_and_copy": _median_ns(lambda: torch.cat([
            torch.from_numpy(np.array(table, np.int64)), qh, th]).to(dev)),
        "alloc_empty": _median_ns(lambda: torch.empty(
            n, dtype=torch.bool, device=dev)),
        "ctypes_launch": _median_ns(lambda: lib.bloom_probe_tier(
            packed[:t].data_ptr(), len(filts), K_HASHES,
            packed[t:t + n].data_ptr(), packed[t + n:].data_ptr(), n,
            out.data_ptr(), st)),
        "copy_back": _median_ns(lambda: out.cpu().numpy()),
        "whole": _median_ns(lambda: tb.bloom_probe_tier(tuples, qn, tn),
                            reps=200),
        "removed": {
            "single_table_call": _median_ns(
                lambda: tb.bloom_probe(tuples[0], qn[first]), reps=200),
            "single_table_queries": int(first.sum())}}
    return {"bloom_build": k2, "bloom_probe_tier": k5,
            "lookup_fused": lookup_host_split(*timed["probe_tier"][:2],
                                              store=False),
            "lookup_store_fused": lookup_host_split(
                *timed["probe_store"][:2], store=True),
            "merge_runs_scan": k1_host_split(dev, timed["merge_runs"]),
            "ingest_run_2048": k1_host_split(
                dev, *_ingest_batch(np.random.default_rng(5), 2048))}


def lookup_host_split(bview, q, *, store: bool, reps: int = 200) -> dict:
    """Host nanoseconds of each step of K4's (K3's with ``store``) engine
    call on the timed view and queries (``lookup.probe_host``: the queries
    into the pinned staging buffer, the device buffer and the pinned
    result, the one C call that copies in, launches, copies back and
    synchronises, and the unpacking with ``pos``/``ti`` widened as the
    backend does), medians of the steps stamped in turn inside whole
    calls, beside the whole backend call (``lookup_fused`` or
    ``lookup_store_fused``). ``removed`` times what the call no longer
    does: the host's assignment (``assign_bounds`` per tier), a pageable
    copy in of the queries and the (R + 1) K assigned tables, and a
    ``.cpu()`` of the former int64 [4 R + 1, K] output; and, as
    yardsticks, the same round trip made of PyTorch calls: the queries
    in with ``.to(non_blocking=True)``, the fields back with ``copy_``
    into the pinned result."""
    view = bview.payload
    dev = view.device
    tb = TorchBackend(device=dev)
    qn = q.cpu().numpy()
    R, K = view.n_tiers, len(qn)
    w = lookup_k.out_words(R, K, store)
    steps = ("stage", "buffers", "call", "unpack")
    ns = {s: [] for s in steps}
    for _ in range(reps + 1):
        t = [time.perf_counter_ns()]
        buf, host = tb._staging.take(K)
        host[:K] = qn
        t.append(time.perf_counter_ns())
        d = tb._staging.take_device(K + w).data_ptr()
        res = torch.empty(w, dtype=torch.int64, pin_memory=True)
        t.append(time.perf_counter_ns())
        lookup_k.launch(store, view, d, K, K_HASHES, d + 8 * K,
                        buf.data_ptr(), res.data_ptr())
        t.append(time.perf_counter_ns())
        f = lookup_k.unpack(res.numpy(), R, K, store)
        f["ti"].astype(np.int64), f["pos"].astype(np.int64)
        t.append(time.perf_counter_ns())
        for s, a, b in zip(steps, t, t[1:]):
            ns[s].append(b - a)
    starts = [np.asarray(x) for x in (bview.tier_starts if store
                                      else [bview.starts])]
    ends = [np.asarray(x) for x in (bview.tier_ends if store
                                    else [bview.ends])]
    old_in = torch.from_numpy(np.zeros((R + 1, K), np.int64))
    old_out = torch.zeros((4 * R + 1, K), dtype=torch.int64, device=dev)
    dbuf = tb._staging.take_device(K + w)
    whole = ((lambda: tb.lookup_store_fused(bview, qn)) if store
             else (lambda: tb.lookup_fused(bview, qn)))
    return {
        "tiers": R, "queries": K, "tables": view.n_tables,
        **{s: float(np.median(v[1:])) for s, v in ns.items()},
        "whole": _median_ns(whole, reps=reps),
        "removed": {
            "assign_bounds": _median_ns(lambda: [
                assign_bounds(a, b, qn) for a, b in zip(starts, ends)]),
            "pageable_copy_in": _median_ns(lambda: old_in.to(dev)),
            "copy_back_cpu": _median_ns(lambda: old_out.cpu().numpy()),
            "torch_copy_in": _median_ns(
                lambda: buf[:K].to(dev, non_blocking=True)),
            "torch_copy_back": _median_ns(
                lambda: res.copy_(dbuf[K:K + w]))}}


def _ingest_batch(rng, n: int):
    """The two halves of a write batch of ``n`` keys (about half of them
    repeated) in ingest order, with batch positions as values, and the
    batch itself (keys, values)."""
    keys = _key_of(rng.integers(0, n // 2, n))
    vals = rng.integers(-2**62, 2**62, n)
    order = np.lexsort((-np.arange(n), keys))
    ok = keys[order]
    return [(ok[:n // 2], order[:n // 2]), (ok[n // 2:], order[n // 2:])], (
        keys, vals)


def k1_host_split(dev, runs, batch=None, reps: int = 200) -> dict:
    """Host nanoseconds of each step of K1's engine call on ``runs``
    (``merge_k.merge_runs_host``: joining, taking the staging buffer,
    packing, the one copy in, the launch, the one copy back, which waits
    for the copy in and the kernel, and the host compaction), medians of
    the steps stamped in turn inside whole calls, beside the whole backend
    call (``TorchBackend.merge_runs``, or ``ingest_run`` of ``batch``,
    whose halves ``runs`` are). ``removed`` times the parts the call no
    longer takes: one pairwise fold step (a launch, then the boolean-mask
    indexing of keys and values, each a synchronising nonzero), that
    indexing alone, a pageable copy in of one array and a copy back with
    ``.cpu()``."""
    tb = TorchBackend(device=dev)
    steps = ("join", "take", "pack", "copy_in", "launch", "copy_back",
             "compact")
    ns = {s: [] for s in steps}
    for _ in range(reps + 1):
        t = [time.perf_counter_ns()]
        offs = merge_k.run_offsets(runs)
        k, n = len(offs) - 1, int(offs[-1])
        m, w = k + 1 + 2 * n, merge_k.out_words(n)
        t.append(time.perf_counter_ns())
        buf, host = tb._staging.take(m + w)
        t.append(time.perf_counter_ns())
        merge_k.pack_runs(runs, offs, host[:m])
        t.append(time.perf_counter_ns())
        packed = buf[:m].to(dev, non_blocking=True)
        t.append(time.perf_counter_ns())
        out = merge_k.merge_runs(packed, k, n)
        t.append(time.perf_counter_ns())
        buf[m:m + w].copy_(out)
        t.append(time.perf_counter_ns())
        merge_k.compact(host[m:m + w], n)
        t.append(time.perf_counter_ns())
        for s, a, b in zip(steps, t, t[1:]):
            ns[s].append(b - a)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)  # noqa: E731
    (a, av), (b, bv) = runs[:2]
    pair = merge_k.pack_pair(*map(T, (a, av, b, bv)))
    n2 = len(a) + len(b)
    mk, mv, keep = merge_k.unpack(merge_k.merge_runs(pair, 2, n2), n2)

    def fold_step():
        x, y, f = merge_k.unpack(merge_k.merge_runs(pair, 2, n2), n2)
        return x[f], y[f]

    whole = ((lambda: tb.ingest_run(*batch)) if batch is not None
             else (lambda: tb.merge_runs(runs)))
    return {
        "runs": len(runs), "runs_joined": k, "keys": n,
        **{s: float(np.median(v[1:])) for s, v in ns.items()},
        "whole": _median_ns(whole, reps=reps),
        "removed": {
            "fold_step": _median_ns(fold_step),
            "mask_indexing": _median_ns(lambda: (mk[keep], mv[keep])),
            "pageable_copy_in": _median_ns(lambda: T(a)),
            "copy_back_cpu": _median_ns(lambda: mk.cpu().numpy())}}


# --------------------------- service phases ----------------------------------
PRIMITIVES = ("ingest_run", "merge_runs", "bloom_build", "bloom_probe",
              "bloom_probe_tier", "lookup_batch", "prepare_tier",
              "lookup_fused", "prepare_store", "lookup_store_fused")
# The device pool's residency checks: each walks the page ids of a tier
# (``acquire``) or of every tier of a tree (``acquire_store``) through the
# clock when no prepared view is cached, and includes the prepare_* call
# it makes.
POOL_CALLS = ("acquire", "acquire_store")


@contextlib.contextmanager
def timed_calls(acc: dict, obj, names):
    """Calls of, and host seconds inside, the methods ``names`` of ``obj``,
    added to ``acc[name]`` (a backend primitive copies to the card,
    launches, and copies back, so this includes the waits on the
    device). The maintenance workers call primitives from their own
    threads, so the sums are added to under a lock."""
    lock = threading.Lock()

    def wrap(name, fn):
        def timed(*a):
            t = time.perf_counter()
            try:
                return fn(*a)
            finally:
                dt = time.perf_counter() - t
                with lock:
                    acc[name][0] += 1
                    acc[name][1] += dt
        return timed

    for n in names:
        acc[n] = [0, 0.0]
        setattr(obj, n, wrap(n, getattr(obj, n)))
    try:
        yield acc
    finally:
        for n in names:
            delattr(obj, n)


@contextlib.contextmanager
def lookup_shapes(acc: dict, backend):
    """(R, K, tables) of every K4 (``lookup_fused``, R = 1) and K3
    (``lookup_store_fused``) call of ``backend``, listed in ``acc`` under
    the kernel's name."""
    def wrap(name, fn, store):
        def rec(view, queries):
            lens = (np.concatenate(view.tier_lens) if store else view.lens)
            acc[name].append((view.num_tiers if store else 1, len(queries),
                              view.num_tables,
                              float(np.median(lens)) if len(lens) else 0))
            return fn(view, queries)
        return rec

    for prim, name, store in (("lookup_fused", "probe_tier", False),
                              ("lookup_store_fused", "probe_store", True)):
        acc[name] = []
        setattr(backend, prim, wrap(name, getattr(backend, prim), store))
    try:
        yield acc
    finally:
        for prim in ("lookup_fused", "lookup_store_fused"):
            backend.__dict__.pop(prim, None)


def shape_summary(shapes: dict) -> dict:
    """Per kernel: calls, the calls that must launch it (a query and a
    tier), the calls by R, and the least, median and largest query and
    table counts of its calls and of the median keys a table of each."""
    out = {}
    for name, rows in shapes.items():
        if not rows:
            out[name] = {"calls": 0, "launching_calls": 0}
            continue
        r, k, t, n = np.array(rows).T
        q3 = lambda x: [int(x.min()), float(np.median(x)), int(x.max())]  # noqa: E731
        out[name] = {"calls": len(rows),
                     "launching_calls": int(((r > 0) & (k > 0)).sum()),
                     "by_tiers": {int(a): int(b) for a, b in
                                  zip(*np.unique(r, return_counts=True))},
                     "queries": q3(k), "tables": q3(t), "table_keys": q3(n)}
    return out


def _key_of(ids):
    """Distinct sparse int64 keys beyond int32: an odd multiplier is a
    bijection modulo 2**40."""
    return (np.asarray(ids, np.int64) * 0x9E3779B97) & ((1 << 40) - 1)


class Zipf:
    """YCSB scrambled zipfian over ``n`` items (theta 0.99)."""

    def __init__(self, n: int, rng, theta: float = 0.99):
        w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** theta
        self.cdf = np.cumsum(w) / w.sum()
        self.perm = rng.permutation(n)
        self.rng = rng

    def __call__(self, size: int) -> np.ndarray:
        r = np.searchsorted(self.cdf, self.rng.random(size), side="right")
        return self.perm[np.minimum(r, len(self.perm) - 1)]


def _last_wins(ids, vals):
    """Keep the last occurrence of each id (the ingest semantics)."""
    rev_ids = ids[::-1]
    u, first = np.unique(rev_ids, return_index=True)
    return u, vals[::-1][first]


class _Window:
    """One run of submits: host seconds inside ``submit`` for the
    unprofiled ones, and the device's busy share over the first
    ``n_profile`` ones (CUDA only), which run under the profiler."""

    def __init__(self, svc, n_profile: int):
        self.svc, self.n_profile = svc, n_profile
        self.n = 0
        self.submit_s = 0.0
        self.dev: dict = {}
        self.wall = 0.0

    def submit(self, reqs):
        self.n += 1
        if self.n > self.n_profile:
            t = time.perf_counter()
            res = self.svc.submit_strict(reqs)
            self.submit_s += time.perf_counter() - t
            return res
        box = []
        by_name, wall = device_us(
            lambda: box.append(self.svc.submit_strict(reqs)))
        for k, v in by_name.items():
            self.dev[k] = self.dev.get(k, 0.0) + v
        self.wall += wall
        return box[0]

    def report(self) -> dict:
        n_timed = self.n - min(self.n_profile, self.n)
        top = sorted(self.dev.items(), key=lambda kv: -kv[1])[:8]
        return {"submits": self.n, "submit_s": self.submit_s,
                "submits_per_s": (n_timed / self.submit_s
                                  if self.submit_s else None),
                "profiled_submits": min(self.n_profile, self.n),
                "device_busy_share": (sum(self.dev.values()) / self.wall
                                      if self.wall else None),
                "device_us_top": [[k[:120], v] for k, v in top]}


def _state(svc, prim) -> dict:
    """Counters of the store at one point of the run: IOStats, the buffer
    cache, the device pool and the device bytes its live views hold, and
    the backend primitives' calls and host seconds so far."""
    pool = svc.store.device_pool
    return {"iostats": vars(svc.store.disk.stats).copy(),
            "cache": [svc.store.disk.cache.hits, svc.store.disk.cache.misses],
            "pool": pool.stats(),
            "view_bytes": sum(v.payload.nbytes for v in pool._views.values()
                              if v.payload is not None),
            "primitives": {p: [c, t] for p, (c, t) in prim.items()}}


def _part(before: dict, after: dict) -> dict:
    """What one part of the run added: primitive calls and seconds and the
    fused counters; pool state and view bytes as they stand at its end."""
    st0, st1 = before["iostats"], after["iostats"]
    return {"primitives": {
                p: {"calls": c - before["primitives"][p][0],
                    "s": t - before["primitives"][p][1]}
                for p, (c, t) in after["primitives"].items()},
            "fused": {k: st1[k] - st0[k] for k in st1
                      if k.startswith("fused_")},
            "pool": after["pool"], "view_bytes": after["view_bytes"]}


def _stores(store) -> list:
    """The LSMStores of a store: its shards', or itself."""
    return [sh.store for sh in store.shards] if hasattr(store, "shards") \
        else [store]


def run_service(dev, *, n_keys: int, batch: int, n_mixed: int, gets: int,
                puts: int, deletes: int, scans: int, n_tail: int = 0,
                cfg_kw=None, profile_submits: int = 0, seed: int = 0,
                shards: int | None = None, governor=None,
                on_part=None, mark_at: int | None = None) -> dict:
    """Load ``n_keys`` distinct keys, run ``n_mixed`` mixed submits, then
    ``n_tail`` read-only submits of ``2 * gets`` zipfian Gets; every Get
    and Scan is held against a dict oracle. ``shards`` puts a
    ``ShardedStore`` of that many hash-routed shards under the service,
    and ``governor`` replaces its default governor. ``on_part(part, svc,
    oracle)`` is called at the end of the load, the mixed part and the
    tail, with the kernels still counted (``oracle``: ``_Oracle``), and
    with part ``"mark"`` after mixed submit ``mark_at`` (outside the
    timed window). Returns counts, wall times, a digest of every Get and
    Scan result of the mixed part, the store's counters at the end of
    each part, and under ``"mark"`` the digest, IOStats and cache counts
    after submit ``mark_at``. The first
    ``profile_submits`` submits of the mixed part and of the tail (CUDA
    only) run under the profiler, which gives the device's busy share."""
    rng = np.random.default_rng(seed)
    cfg = StoreConfig(scheme="partitioned", flush_policy="opt", device=dev,
                      **(cfg_kw or {}))
    store = ShardedStore(cfg, shards=shards) if shards else LSMStore(cfg)
    svc = StorageService(store, governor=governor)
    backend = _stores(store)[0].backend      # one backend per device
    prim: dict = {}
    shapes: dict = {}
    tuned: dict = {}
    controller = getattr(svc.governor, "controller", None)
    with lookup_shapes(shapes, backend), \
            timed_calls(prim, backend, PRIMITIVES), \
            timed_calls(prim, store.device_pool, POOL_CALLS), \
            (timed_calls(tuned, controller, ("tune_now",))
             if controller is not None else contextlib.nullcontext()):
        try:
            out = _drive(svc, prim, rng, n_keys=n_keys, batch=batch,
                         n_mixed=n_mixed, gets=gets, puts=puts,
                         deletes=deletes, scans=scans, n_tail=n_tail,
                         profile_submits=profile_submits, on_part=on_part,
                         mark_at=mark_at)
        finally:
            store.arena.workers.close()
    out["lookup_shapes"] = shape_summary(shapes)
    if controller is not None:
        out["tuner"] = tuner_report(svc, tuned["tune_now"])
    if shards:
        out["shard_tree_stats"] = store.shard_tree_stats()
    return out


def tuner_report(svc, tune_now) -> dict:
    """The tuner's cycles: the trajectory of every record (x and x_next in
    MiB, the stop reason, cost'), the plans the service applied, and the host
    seconds of the tuning cycles (``tune_now``: statistics, derivatives,
    the Newton step and its actuation)."""
    recs = svc.governor.records
    stops: dict = {}
    for r in recs:
        stops[r.stopped or "step"] = stops.get(r.stopped or "step", 0) + 1
    return {"cycles": len(recs),
            "moves": sum(r.x_next != r.x for r in recs),
            "stops": stops,
            "trajectory": [[r.x / MB, r.x_next / MB, r.stopped or "step",
                            r.cost_prime] for r in recs],
            "plans": [[p.write_memory_bytes, p.note] for p in svc.plans],
            "write_memory_bytes": svc.store.write_memory_bytes,
            "tune_calls": tune_now[0], "tune_s": tune_now[1],
            "tune_ms_per_cycle": (1e3 * tune_now[1] / tune_now[0]
                                  if tune_now[0] else None)}


def _check_get(g, live, val, ids, what):
    want_found = live[ids]
    bad = (g.found != want_found) | (want_found & (g.vals != val[ids]))
    if bad.any():
        i = np.flatnonzero(bad)[:5]
        raise AssertionError(
            f"Get mismatch in {what}: {int(bad.sum())} keys; ids "
            f"{ids[i].tolist()} found {g.found[i].tolist()} want "
            f"{want_found[i].tolist()} vals {g.vals[i].tolist()} want "
            f"{val[ids[i]].tolist()}")


class _Oracle:
    """The dict oracle of a service run: per tree the loaded ids, each id's
    value and liveness, and the tree's zipfian id sampler."""

    def __init__(self, ids, val, live, zipf):
        self.ids, self.val, self.live, self.zipf = ids, val, live, zipf

    def get(self, svc, tree, n: int, what: str) -> None:
        """One submit of ``n`` zipfian Gets on ``tree``, held to the
        oracle."""
        g_ids = self.ids[tree][self.zipf[tree](n)]
        g = svc.submit_strict([Get(tree, _key_of(g_ids))])[0]
        _check_get(g, self.live[tree], self.val[tree], g_ids, what)

    def scan(self, svc, tree, n: int, rng, what: str) -> None:
        """One submit of ``n`` Scans of 100 keys on ``tree`` from loaded
        keys drawn with ``rng``, each count held to the oracle."""
        lo = _key_of(self.ids[tree][rng.integers(0, len(self.ids[tree]),
                                                 n)])
        res = svc.submit_strict([Scan(tree, int(x), 100) for x in lo])
        present = np.sort(_key_of(np.flatnonzero(self.live[tree])))
        want = (np.searchsorted(present, lo + 100)
                - np.searchsorted(present, lo))
        got = np.array([r.count for r in res])
        if not np.array_equal(got, want):
            raise AssertionError(f"Scan mismatch in {what}")

    def frozen(self, seed: int) -> "_Oracle":
        """A copy of the oracle as it stands, with zipfian samplers of its
        own drawn from ``seed`` (the run's samplers and values go on)."""
        rng = np.random.default_rng(seed)
        return _Oracle(self.ids, {t: v.copy() for t, v in self.val.items()},
                       {t: v.copy() for t, v in self.live.items()},
                       {t: Zipf(len(i), rng) for t, i in self.ids.items()})


def _drive(svc, prim, rng, *, n_keys, batch, n_mixed, gets, puts, deletes,
           scans, n_tail, profile_submits, on_part=None, mark_at=None):
    trees = TREES
    for t in trees:
        svc.create_tree(t)
    ids = {t: [] for t in trees}
    val = {t: np.zeros(n_keys, np.int64) for t in trees}
    live = {t: np.zeros(n_keys, bool) for t in trees}
    perm = rng.permutation(n_keys)
    t0 = time.perf_counter()
    for bi, s in enumerate(range(0, n_keys, batch)):
        tree = trees[0] if bi % 10 else trees[1]       # 90/10 write skew
        b = perm[s:s + batch]
        v = rng.integers(0, 2**40, len(b))
        svc.submit_strict([Put(tree, _key_of(b), v)])
        ids[tree].append(b)
        val[tree][b] = v
        live[tree][b] = True
    load_s = time.perf_counter() - t0
    ids = {t: np.concatenate(ids[t]) for t in trees}
    zipf = {t: Zipf(len(ids[t]), rng) for t in trees}
    checked = 0
    mark = None
    digest = hashlib.sha256()
    at_load = _state(svc, prim)
    oracle = _Oracle(ids, val, live, zipf)
    if on_part is not None:
        on_part("load", svc, oracle)
    win = _Window(svc, profile_submits)
    t0 = time.perf_counter()
    for si in range(n_mixed):
        tree = trees[0] if si % 10 else trees[1]
        pool = ids[tree]
        g_ids = pool[zipf[tree](gets)]
        p_ids = pool[zipf[tree](puts)]
        p_vals = rng.integers(0, 2**40, puts)
        cand = np.setdiff1d(pool[rng.integers(0, len(pool), 4 * deletes)],
                            p_ids)
        d_ids = rng.permutation(cand)[:deletes]
        s_ids = pool[rng.integers(0, len(pool), scans)]
        s_lo = _key_of(s_ids)
        # Gets and Scans are listed first, so their steps run before this
        # submit's writes (the planner runs steps in first-seen order).
        res = win.submit([Get(tree, _key_of(g_ids))]
                         + [Scan(tree, int(lo), 100) for lo in s_lo]
                         + [Put(tree, _key_of(p_ids), p_vals),
                            Delete(tree, _key_of(d_ids))])
        g = res[0]
        _check_get(g, live[tree], val[tree], g_ids, f"submit {si} ({tree})")
        present = np.sort(_key_of(np.flatnonzero(live[tree])))
        want_scan = (np.searchsorted(present, s_lo + 100)
                     - np.searchsorted(present, s_lo))
        got_scan = np.array([r.count for r in res[1:1 + scans]])
        if not np.array_equal(got_scan, want_scan):
            raise AssertionError(f"Scan mismatch in submit {si}")
        for a in (g.found, g.vals, got_scan):
            digest.update(a.tobytes())
        u, uv = _last_wins(p_ids, p_vals)
        val[tree][u] = uv
        live[tree][u] = True
        live[tree][d_ids] = False
        checked += gets + scans
        if si + 1 == mark_at:
            t_mark = time.perf_counter()
            st = svc.store.disk
            mark = {"submits": mark_at, "digest": digest.copy().hexdigest(),
                    "iostats": vars(st.stats).copy(),
                    "cache": [st.cache.hits, st.cache.misses]}
            if on_part is not None:
                on_part("mark", svc, oracle)
            t0 += time.perf_counter() - t_mark   # outside the timed window
    mixed_s = time.perf_counter() - t0
    at_mixed = _state(svc, prim)
    if on_part is not None:
        on_part("mixed", svc, oracle)
    tail = _Window(svc, profile_submits if n_tail else 0)
    t0 = time.perf_counter()
    for si in range(n_tail):
        tree = trees[0] if si % 10 else trees[1]
        g_ids = ids[tree][zipf[tree](2 * gets)]
        g = tail.submit([Get(tree, _key_of(g_ids))])[0]
        _check_get(g, live[tree], val[tree], g_ids, f"tail submit {si}")
        checked += 2 * gets
    tail_s = time.perf_counter() - t0
    at_tail = _state(svc, prim)
    if on_part is not None:
        on_part("tail", svc, oracle)
    st = svc.stats
    stores = _stores(svc.store)
    out = {"load_s": load_s, "mixed_wall_s": mixed_s,
           "mixed": {**win.report(), **_part(at_load, at_mixed),
                     "digest": digest.hexdigest(),
                     "iostats": at_mixed["iostats"],
                     "cache": at_mixed["cache"]},
           "reads_checked": checked,
           "flushes_mem": st.flushes_mem, "flushes_log": st.flushes_log,
           "pages_flushed": st.pages_flushed,
           "pages_merge_written": st.pages_merge_written,
           "disk_levels": {t: max(s.trees[t].levels.num_levels
                                  for s in stores) for t in trees},
           "disk_tables": {t: sum(len(x) for s in stores
                                  for x in s.trees[t].l0.lookup_tiers()
                                  + s.trees[t].levels.lookup_tiers())
                           for t in trees},
           "write_stalls": st.write_stalls}
    router = getattr(svc.store, "router", None)
    if router is not None:
        out["shard_keys"] = np.bincount(
            router.shard_of_batch(np.concatenate(
                [_key_of(np.flatnonzero(live[t])) for t in trees])),
            minlength=router.n_shards).tolist()
    out["primitives_total"] = at_tail["primitives"]
    if mark_at is not None:
        out["mark"] = mark
    if n_tail:
        out["tail_wall_s"] = tail_s
        out["tail"] = {**tail.report(), **_part(at_mixed, at_tail)}
    return out


def k1_per_call(phase: dict) -> dict:
    """K1's launches over a service phase beside the calls of its two
    engine primitives (load and every part), and the calls by route."""
    calls = {p: phase["primitives_total"][p][0]
             for p in ("merge_runs", "ingest_run")}
    launches = phase["launches"]["merge_pair"]
    total = sum(calls.values())
    return {"calls": total, **{f"{p}_calls": c for p, c in calls.items()},
            "launches": launches,
            "k1_launches_per_call": launches / total if total else None,
            "routes": dict(merge_k.ROUTES)}


def same_as_staged(staged: dict, pooled: dict) -> None:
    """The fused path against the staged path over the mixed part: every
    Get and Scan result, IOStats without the ``fused_*`` counters, and
    the buffer cache's hits and misses."""
    a, b = staged["mixed"], pooled["mixed"]
    io = lambda d: {k: v for k, v in d["iostats"].items()  # noqa: E731
                    if not k.startswith("fused_")}
    for what, x, y in (("results", a["digest"], b["digest"]),
                       ("IOStats", io(a), io(b)),
                       ("cache hits and misses", a["cache"], b["cache"])):
        if x != y:
            raise AssertionError(f"pool phase differs from the staged phase "
                                 f"in {what}: {x} vs {y}")


# --------------------------- card-vs-CPU replay ------------------------------
def small_config(dev, **kw) -> StoreConfig:
    """The differential suite's small store, with a log cap small enough
    that log-triggered flushes run; ``kw`` overrides any field."""
    return StoreConfig(**{
        "total_memory_bytes": 32 * MB, "write_memory_bytes": 256 * KB,
        "sim_cache_bytes": 1 * MB, "page_bytes": 4 * KB, "entry_bytes": 256,
        "active_sstable_bytes": 32 * KB, "sstable_bytes": 64 * KB,
        "max_log_bytes": REPLAY_MAX_LOG_BYTES, "scheme": "partitioned",
        "flush_policy": "lsn", "device": dev, **kw})


def _sst_bits(s):
    return (s.keys.tobytes(), s.vals.tobytes(), s.lsn_min, s.lsn_max)


def fingerprint(store) -> dict:
    """Bit-exact structural state of a store (partitioned scheme)."""
    out = {"log_pos": store.log_pos, "write_mem": store.write_memory_bytes}
    for name in sorted(store.trees):
        t = store.trees[name]
        out[name] = {
            "active": sorted(t.mem.active.items()),
            "mem_levels": [[_sst_bits(s) for s in lvl]
                           for lvl in t.mem.levels],
            "l0": [[_sst_bits(s) for s in g] for g in t.l0.groups],
            "levels": [[_sst_bits(s) for s in lvl]
                       for lvl in t.levels.levels]}
    return out


def replay_requests(n_submits: int, seed: int, keys: int):
    """The replay's seeded op stream: one list of requests a submit."""
    rng = np.random.default_rng(seed)
    for _ in range(n_submits):
        tree = "a" if rng.random() < 0.7 else "b"
        pk = rng.integers(0, keys, 200)
        yield [Get(tree, rng.integers(0, keys, 100)),
               Scan(tree, int(rng.integers(0, keys)), 200),
               Put(tree, pk, rng.integers(0, 2**40, 200)),
               Delete(tree, rng.integers(0, keys, 20))]


def replay(dev, *, n_submits: int, seed: int = 1, shards=None, tuner=None,
           keys: int = 4000, **cfg_kw):
    """One seeded op stream over ``keys`` keys through a small store on
    ``dev``: an ``LSMStore``, or a ``ShardedStore`` of ``shards``
    hash-routed shards; with ``tuner`` (``TunerConfig`` fields) under an
    ``AdaptiveGovernor``. The result holds the store itself under
    ``"store"``."""
    reset_sst_ids()
    cfg = small_config(dev, **cfg_kw)
    gov = AdaptiveGovernor(TunerConfig(**tuner)) if tuner else None
    svc = StorageService(ShardedStore(cfg, shards=shards) if shards
                         else LSMStore(cfg), governor=gov)
    for t in ("a", "b"):
        svc.create_tree(t)
    outs, n_ops = [], 0
    for reqs in replay_requests(n_submits, seed, keys):
        for r in svc.submit_strict(reqs):
            if hasattr(r, "found"):
                outs.append(("get", r.found.tobytes(), r.vals.tobytes()))
            elif hasattr(r, "count"):
                outs.append(("scan", r.count))
            else:
                outs.append((type(r).__name__, r.n))
        n_ops += 100 + 1 + 200 + 20
    st = svc.store
    st.arena.workers.close()
    return {"store": st, "fingerprint": [fingerprint(x) for x in _stores(st)],
            "outputs": outs,
            "records": [vars(r) for r in gov.records] if gov else None,
            "iostats": vars(st.disk.stats).copy(),
            "wal": [encode_record(r) for r in st.wal.records()],
            "manifest": [vars(e) for e in st.manifest.edits],
            "pool": st.device_pool.stats(),
            "truncated_to": st.wal.truncated_to,
            "flushes_log": svc.stats.flushes_log, "n_ops": n_ops}


def compare_replays(a: dict, b: dict) -> None:
    for k in ("outputs", "fingerprint", "iostats", "wal", "manifest",
              "pool", "records"):
        if a[k] != b[k]:
            raise AssertionError(f"card and CPU replays differ in {k}")


# --------------------------- the §5 tuner and the HBM arbiter ----------------
def adaptive_phase(card: str, staged: dict, service_kw: dict,
                   on_part=None) -> dict:
    """The staged phase's store and stream over ``ADAPTIVE_SHARDS``
    hash-routed shards under ``AdaptiveGovernor(TunerConfig())``: the
    oracle holds every read, K1, K2 and K5 must launch (K1 at most once
    per engine merge call), and the tuner must run. ``on_part`` as
    ``run_service``'s."""
    t0 = time.perf_counter()
    reset_sst_ids()
    zero_counts()
    out = run_service("cuda", cfg_kw={"max_log_bytes": SERVICE_MAX_LOG_BYTES},
                      shards=ADAPTIVE_SHARDS,
                      governor=AdaptiveGovernor(TunerConfig()),
                      on_part=on_part, **service_kw)
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    out["wall_s"] = time.perf_counter() - t0
    out["k1"] = k1_per_call(out)
    out["submits_per_s"] = {"adaptive": out["mixed"]["submits_per_s"],
                            "staged": staged["mixed"]["submits_per_s"]}
    emit({"phase": "adaptive", "card": card, "shards": ADAPTIVE_SHARDS,
          **out})
    missing = [k for k in ("merge_pair", "bloom_build", "bloom_probe")
               if out["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the adaptive "
                             f"phase: {missing}")
    if out["k1"]["launches"] > out["k1"]["calls"]:
        raise AssertionError(f"K1 launched more than once per merge_runs or "
                             f"ingest_run call in the adaptive phase: "
                             f"{out['k1']}")
    if out["tuner"]["cycles"] < 1:
        raise AssertionError("the tuner ran no cycle in the adaptive phase")
    return out


def adaptive_replays(n_submits: int) -> list:
    """One seeded stream through the replay's small store under the tuner
    (``REPLAY_TUNER``), unsharded and sharded, on the card and on the CPU:
    every TuneRecord, the stores, results, IOStats and WAL bytes must be
    identical, the tuner must actuate at least twice, and the card's
    replay must launch K1, K2 and K5."""
    out = []
    for shards in REPLAY_SHARDS:
        t0 = time.perf_counter()
        zero_counts()
        on_card = replay("cuda", n_submits=n_submits, shards=shards,
                         tuner=REPLAY_TUNER, keys=REPLAY_TUNED_KEYS,
                         **REPLAY_TUNED_STORE)
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        t1 = time.perf_counter()
        on_cpu = replay("cpu", n_submits=n_submits, shards=shards,
                        tuner=REPLAY_TUNER, keys=REPLAY_TUNED_KEYS,
                        **REPLAY_TUNED_STORE)
        missing = [k for k in ("merge_pair", "bloom_build", "bloom_probe")
                   if launched[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched in the tuned "
                                 f"replay over {shards} shard(s): {missing}")
        compare_replays(on_card, on_cpu)
        recs = on_card["records"]
        moves = sum(r["x_next"] != r["x"] for r in recs)
        if moves < 2:
            raise AssertionError(f"the tuned replay over {shards} shard(s) "
                                 f"actuated {moves} times, not 2 or more")
        row = {"phase": "adaptive_replay", "shards": shards,
               "n_ops": on_card["n_ops"], "cycles": len(recs),
               "moves": moves,
               "trajectory": [[r["x"] / MB, r["x_next"] / MB,
                               r["stopped"] or "step"] for r in recs],
               "flushes_log": [on_card["flushes_log"], on_cpu["flushes_log"]],
               "wal_records": len(on_card["wal"]), "launches": launched,
               "card_s": t1 - t0, "cpu_s": time.perf_counter() - t1,
               "identical": True}
        emit(row)
        out.append(row)
    return out


def arbiter_phase(card: str, service_kw: dict) -> dict:
    """``HBMArbiter`` over the pool phase's store (2**20 keys, store-scope
    fused reads) and a Yi-6B KV pool, one 2 GiB budget: load, phase A
    (read-only submits), phase B (KV append churn: one-page appends over
    ``ARBITER_STREAMS`` streams with a 32-Get submit every 64). Every Get
    against the oracle; the leases sum to the budget after every decision
    and the pool's budget follows the device lease; some bytes must move;
    K3 and K4 must launch exactly once per backend call with queries."""
    yi = get_config("yi-6b")
    page = 16 * yi.num_layers * 2 * yi.num_kv_heads * yi.head_dim * 2
    rest = POOL_BYTES - ARBITER_DEVICE_LEASE
    leases = {"device": ARBITER_DEVICE_LEASE, "kv": rest // 2,
              "prefix": rest - rest // 2}
    kvp = PagedKVPool(KVPoolConfig(
        page_tokens=16, total_pages=(leases["kv"] + leases["prefix"]) // page,
        pool_pages=leases["kv"] // page, sim_pages=256))
    arb = HBMArbiter(kvp, HBMArbiterConfig(
        total_bytes=POOL_BYTES, kv_page_bytes=page,
        ops_cycle=ARBITER_OPS_CYCLE), leases=leases)
    at_end: dict = {}      # part -> (leases, decisions so far)
    churn: dict = {}

    def on_part(part, svc, oracle):
        at_end[part] = (dict(arb.leases), len(arb.records))
        if part != "tail":
            return
        t0 = time.perf_counter()
        for i in range(ARBITER_APPENDS):
            kvp.append_tokens(f"s{i % ARBITER_STREAMS}", 16)
            if i % 64 == 0:
                oracle.get(svc, TREES[0] if (i // 64) % 10 else TREES[1], 32,
                           f"churn append {i}")
        churn.update(seconds=time.perf_counter() - t0,
                     gets=32 * -(-ARBITER_APPENDS // 64),
                     pool=svc.store.device_pool.stats())
        at_end["churn"] = (dict(arb.leases), len(arb.records))

    kw = dict(service_kw, n_mixed=0)
    t0 = time.perf_counter()
    reset_sst_ids()
    zero_counts()
    out = run_service("cuda", cfg_kw={
        "max_log_bytes": SERVICE_MAX_LOG_BYTES,
        "device_pool_bytes": ARBITER_DEVICE_LEASE, "fused_scope": "store"},
        n_tail=32, governor=arb, on_part=on_part, **kw)
    torch.cuda.synchronize()
    out["launches"] = dict(LAUNCHES)
    out["wall_s"] = time.perf_counter() - t0
    out["churn"] = churn
    out["leases"] = {part: ls for part, (ls, _) in at_end.items()}
    out["decisions"] = {part: n for part, (_, n) in at_end.items()}
    recs = arb.records
    out["arbiter"] = {
        "total_bytes": POOL_BYTES, "kv_page_bytes": page,
        "initial_leases": leases, "final_leases": dict(arb.leases),
        "decisions": len(recs),
        "shifts": sum(1 for r in recs if r["shift_bytes"]),
        "shift_bytes": arb.shift_bytes_total,
        "trajectory": [[r["leases"]["device"] // MB, r["leases"]["kv"] // MB,
                        r["leases"]["prefix"] // MB, r["donor"],
                        r["recipient"], r["shift_bytes"] // MB]
                       for r in recs if r["shift_bytes"]],
        "device_direction": {
            part: out["leases"][part]["device"] - before["device"]
            for before, part in ((leases, "load"),
                                 (out["leases"]["load"], "tail"),
                                 (out["leases"]["tail"], "churn"))},
        "kv_pool": {"total_pages": kvp.total_pages,
                    "pool_pages": kvp.cfg.pool_pages, **kvp.stats}}
    emit({"phase": "arbiter", "card": card, **out})
    bad = [r for r in recs if sum(r["leases"].values()) != POOL_BYTES]
    if bad or arb.total_leased() != POOL_BYTES:
        raise AssertionError(f"leases drifted from {POOL_BYTES} bytes: "
                             f"{bad[:3]}")
    if arb.shift_bytes_total <= 0:
        raise AssertionError("the arbiter never moved a byte")
    pool = out["tail"]["pool"]
    if churn["pool"]["budget_bytes"] != arb.leases["device"]:
        raise AssertionError(f"the device pool's budget "
                             f"{churn['pool']['budget_bytes']} is not "
                             f"the device lease {arb.leases['device']}")
    for k in ("probe_store", "probe_tier"):
        if out["launches"][k] <= 0 or out["launches"][k] != \
                out["lookup_shapes"][k]["launching_calls"]:
            raise AssertionError(f"{k} launched {out['launches'][k]} times "
                                 f"in the arbiter phase, not once per call: "
                                 f"{out['lookup_shapes'][k]}, pool {pool}")
    return out


# --------------------------- crash recovery and the worker pool --------------
# The replay stream's crash points: after these submits (spread over the
# stream's 190), and once in the middle of a tick run by hand after
# RECOVERY_MID_TICK (its flushes ran, its truncation not yet).
RECOVERY_CRASH_SUBMITS = (10, 31, 52, 73, 94, 115, 136, 157, 178, 189)
RECOVERY_MID_TICK = 100
# Held submits against the oracle after a full-width recovery: Gets of
# ``service_kw["gets"]`` keys, then Scans (16 of 100 keys) on each tree.
RECOVERY_HELD_GETS = 4
# The workers phase's pool, and the card-vs-CPU worker replay's.
WORKERS = 2
REPLAY_WORKERS = 4
# Depth of the workers phase, cut when the train phase came so that the
# whole script stays within 700 s: the staged stream runs its first
# FILES_SUBMITS mixed submits (of SERVICE_MIXED; held to the staged
# phase's state at that submit, its "mark"), and the replay stream
# WORKERS_REPLAY_SUBMITS submits (of 190). 128 mixed submits took 33.8 s,
# the three 190-submit replays 9.1 s (on an NVIDIA H100 80GB HBM3 at 700 W).
WORKERS_REPLAY_SUBMITS = 95
# IOStats that say where wall time went and differ with workers on.
BG_FIELDS = ("bg_segments", "bg_overlap_us")


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def wal_digest(wal) -> str:
    """sha256 of the WAL's retained encoded records, oldest first."""
    h = hashlib.sha256()
    for r in wal._records:
        h.update(r.buf)
    return h.hexdigest()


def durable(store) -> dict:
    """What a recovery of ``store``'s WAL and manifest must reproduce: the
    fingerprint of every shard, ``RECOVERY_EXACT_COUNTERS``, the log
    position, the write-memory size and the WAL's encoded records."""
    return {"fingerprint": [fingerprint(s) for s in _stores(store)],
            "counters": {k: getattr(store.disk.stats, k)
                         for k in RECOVERY_EXACT_COUNTERS},
            "log_pos": store.log_pos,
            "write_memory_bytes": store.write_memory_bytes,
            "wal": wal_digest(store.wal)}


def crash_point(store, oracle=None, seed: int = 7) -> dict:
    """What stable storage holds at this point of a run (clones of the WAL
    and the manifest), the store's config, the live store's ``durable``
    state, and a frozen copy of the run's oracle."""
    return {"wal": store.wal.clone(), "manifest": store.manifest.clone(),
            "cfg": store.cfg, "live": durable(store),
            "oracle": None if oracle is None else oracle.frozen(seed)}


def same_durable(got: dict, want: dict, what: str) -> None:
    for k in want:
        if got[k] != want[k]:
            raise AssertionError(f"{what}: the recovered store differs from "
                                 f"the live one in {k}")


def recover_full_width(name: str, point: dict, gets: int,
                       dev="cuda") -> dict:
    """Recover ``point`` on the card through ``StorageService.recover``,
    hold the store to the live one's ``durable`` state, then run held Get
    and Scan submits against the point's oracle. K1 (the replay's ingest
    and ticks), K2 (the first reads' filters: restore gives every table a
    fresh sst_id) and K5 must launch."""
    zero_counts()
    t0 = time.perf_counter()
    svc = StorageService.recover(point["cfg"], point["wal"],
                                 point["manifest"])
    _sync(dev)
    secs = time.perf_counter() - t0
    replay_launches = dict(LAUNCHES)
    same_durable(durable(svc.store), point["live"], name)
    oracle, rng = point["oracle"], np.random.default_rng(11)
    t0 = time.perf_counter()
    oracle.get(svc, TREES[0], gets, f"{name}: first held submit")
    first_s = time.perf_counter() - t0
    for i in range(RECOVERY_HELD_GETS):
        oracle.get(svc, TREES[i % 2], gets, f"{name}: held Get {i}")
    for t in TREES:
        oracle.scan(svc, t, 16, rng, f"{name}: held Scan on {t}")
    _sync(dev)
    launches = dict(LAUNCHES)
    info = svc.store.recovery_info
    svc.store.arena.workers.close()
    missing = [k for k in ("merge_pair", "bloom_build", "bloom_probe")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched by the recovered "
                             f"store of {name}: {missing}")
    return {"point": name, "recovery_s": secs, "info": info,
            "replayed_keys_per_s": info["replayed_keys"] / secs,
            "k1_launches_replay": replay_launches["merge_pair"],
            "launches_replay": replay_launches,
            "first_held_submit_s": first_s, "launches": launches,
            "shards": len(_stores(svc.store)), "identical": True}


def recovery_phase(card: str, points: dict, gets: int, dev="cuda") -> list:
    """Each full-width crash point recovered on the card (see
    ``recover_full_width``)."""
    rows = []
    for name in list(points):
        row = recover_full_width(name, points.pop(name), gets, dev)
        emit({"phase": "recovery", "card": card, **row})
        rows.append(row)
    return rows


def replay_crashes(shards: int, n_submits: int = 190, seed: int = 1,
                   keys: int = 4000, dev="cuda") -> list:
    """The replay stream on the card over ``shards`` hash-routed shards,
    with a crash point after each submit of ``RECOVERY_CRASH_SUBMITS`` and
    one in the middle of a tick run by hand after ``RECOVERY_MID_TICK``
    (logged write-ahead, its flushes run, the crash before its merges and
    its WAL truncation; the live store then completes it)."""
    reset_sst_ids()
    cfg = small_config(dev)
    store = ShardedStore(cfg, shards=shards)
    svc = StorageService(store)
    for t in ("a", "b"):
        svc.create_tree(t)
    points = []
    for i, reqs in enumerate(replay_requests(n_submits, seed, keys)):
        svc.submit_strict(reqs)
        if i in RECOVERY_CRASH_SUBMITS:
            points.append((f"submit {i}", crash_point(store)))
        if i == RECOVERY_MID_TICK:
            sch = store.scheduler
            store.wal.append_tick("default")
            sch.ticks += 1
            for s in sch.stores:
                s.scheduler._mem_upkeep()
            sch._enforce_memory()
            sch._enforce_log()
            wal_c, man_c = store.wal.clone(), store.manifest.clone()
            sch._run_merges(sch.merge_budget)
            enforce_wal(store.arena, sch)
            points.append((f"mid-tick after submit {i}",
                           {"wal": wal_c, "manifest": man_c, "cfg": cfg,
                            "live": durable(store)}))
    return points


def recovery_replay_phase(card: str, dev="cuda", **kw) -> list:
    """Each crash point of ``replay_crashes`` over 1 and 4 shards recovered
    on the card and on the CPU: both equal each other and the live store
    at that point; some point recovers from a checkpoint."""
    rows = []
    for shards in REPLAY_SHARDS:
        t0 = time.perf_counter()
        zero_counts()
        points = replay_crashes(shards, dev=dev, **kw)
        rec = []
        for name, pt in points:
            t1 = time.perf_counter()
            on_card = recover(pt["cfg"], pt["wal"].clone(),
                              pt["manifest"].clone())
            _sync(dev)
            t2 = time.perf_counter()
            cpu_cfg = StoreConfig(**{**vars(pt["cfg"]), "device": "cpu"})
            on_cpu = recover(cpu_cfg, pt["wal"].clone(),
                             pt["manifest"].clone())
            t3 = time.perf_counter()
            same_durable(durable(on_card), pt["live"], f"card, {name}")
            same_durable(durable(on_cpu), pt["live"], f"CPU, {name}")
            if on_card.recovery_info != on_cpu.recovery_info:
                raise AssertionError(f"card and CPU recoveries of {name} "
                                     f"differ in recovery_info")
            rec.append({"point": name, "info": on_card.recovery_info,
                        "card_s": t2 - t1, "cpu_s": t3 - t2})
        _sync(dev)
        if not any(r["info"]["from_checkpoint"] for r in rec):
            raise AssertionError(f"no crash point over {shards} shard(s) "
                                 f"recovered from a checkpoint")
        row = {"phase": "recovery_replay", "shards": shards,
               "points": rec, "launches": dict(LAUNCHES),
               "seconds": time.perf_counter() - t0, "identical": True}
        emit(row)
        rows.append(row)
    return rows


@contextlib.contextmanager
def watch_prepares(errors: list):
    """Every prepare any ``MaintenanceWorkerPool`` accepts meanwhile runs
    inside a wrapper that notes the exception it raises (the pool turns it
    into a ``take`` miss) in ``errors``."""
    submit = MaintenanceWorkerPool.submit

    def watched(pool, key, fn):
        def run():
            try:
                return fn()
            except BaseException as e:
                errors.append(f"{key!r}: {e!r}")
                raise
        return submit(pool, key, run)

    MaintenanceWorkerPool.submit = watched
    try:
        yield errors
    finally:
        MaintenanceWorkerPool.submit = submit


def _masked(iostats: dict) -> dict:
    return {k: v for k, v in iostats.items() if k not in BG_FIELDS}


def threaded_k1_k2(n_threads: int = 4, dev="cuda") -> dict:
    """K1 (``merge_runs``, ``ingest_run``) and K2 (``bloom_build``) from
    ``n_threads`` threads at once through one backend, at the engine's
    shapes (2,048-key tables, 4,096-key ingests): every result equals the
    same call made alone, and every launch is counted."""
    rng = np.random.default_rng(5)
    tb = TorchBackend(device=dev)
    calls = []
    for _ in range(n_threads):
        mine = []
        for j in range(12):
            if j % 3 == 0:
                mine.append(("merge", [(np.unique(rng.integers(0, 2**40, 2048)),
                                        rng.integers(0, 2**40, 2048))
                                       for _ in range(4)]))
            elif j % 3 == 1:
                mine.append(("ingest", (rng.integers(0, 3000, 4096),
                                        rng.integers(0, 2**40, 4096))))
            else:
                mine.append(("bloom", np.unique(rng.integers(0, 2**40, 2048))))
        calls.append(mine)

    def call(kind, a):
        if kind == "merge":
            return [x.tolist() for x in tb.merge_runs(a)]
        if kind == "ingest":
            return [x.tolist() for x in tb.ingest_run(*a)]
        return tb.bloom_build(a)[1].cpu().tolist()

    alone = [[call(k, a) for k, a in c] for c in calls]
    _sync(dev)
    zero_counts()
    got = [None] * n_threads
    errors = []
    start = threading.Barrier(n_threads)

    def work(i):
        try:
            start.wait()
            got[i] = [call(k, a) for k, a in calls[i]]
        except BaseException as e:
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _sync(dev)
    launches = dict(LAUNCHES)
    if errors:
        raise AssertionError(f"threaded K1/K2 calls raised: {errors}")
    if got != alone:
        raise AssertionError("threaded K1/K2 calls differ from the same "
                             "calls made alone")
    want = {"merge_pair": 8 * n_threads, "bloom_build": 4 * n_threads}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"threaded launches counted {launches}, not "
                             f"{want}")
    return {"threads": n_threads, "calls": 12 * n_threads,
            "launches": {k: launches[k] for k in want}, "identical": True}


def workers_phase(card: str, staged: dict, staged_mark: dict,
                  service_kw: dict, dev="cuda", cfg_kw=None,
                  n_replay: int = WORKERS_REPLAY_SUBMITS) -> dict:
    """The staged phase's stream again (same seed, same submits, its first
    ``FILES_SUBMITS`` mixed submits) with ``WORKERS`` maintenance workers:
    every Get and Scan result, the fingerprint, every IOStats field but
    ``bg_*``, the buffer cache's counts and the WAL's encoded records equal
    the staged phase's at that submit (``staged["mark"]``,
    ``staged_mark``); the pool must consume prepares and no prepare may
    raise. Then the replay
    stream on the card with 0 and ``REPLAY_WORKERS`` workers and on the
    CPU with ``REPLAY_WORKERS``: all three identical (``bg_*`` aside).
    ``dev``, ``cfg_kw`` (the staged phase's store fields) and ``n_replay``
    let a CPU rehearsal run it small."""
    t0 = time.perf_counter()
    threads = threaded_k1_k2(dev=dev)
    errors: list = []
    end: dict = {}

    def on_part(part, svc, oracle):
        if part == "mixed":
            pool = svc.store.arena.workers
            end.update(durable(svc.store), pool={
                k: getattr(pool, k) for k in ("workers", "submitted",
                                              "prepared", "hits", "misses",
                                              "wasted")})

    reset_sst_ids()
    zero_counts()
    with watch_prepares(errors):
        out = run_service(dev, cfg_kw={
            **(cfg_kw or {}), "max_log_bytes": SERVICE_MAX_LOG_BYTES,
            "maintenance_workers": WORKERS}, on_part=on_part,
            **{**service_kw, "n_mixed": FILES_SUBMITS})
    _sync(dev)
    out["launches"] = dict(LAUNCHES)
    out["wall_s"] = time.perf_counter() - t0
    out["k1"] = k1_per_call(out)
    io = out["mixed"]["iostats"]
    row = {"phase": "workers", "card": card, "workers": WORKERS,
           "pool": end["pool"], "prepare_errors": errors,
           "bg": {k: io[k] for k in BG_FIELDS},
           "launches": out["launches"], "k1": out["k1"],
           "submits_per_s": {"workers": out["mixed"]["submits_per_s"],
                             "staged": staged["mixed"]["submits_per_s"]},
           "load_s": out["load_s"], "mixed_wall_s": out["mixed_wall_s"],
           "reduced": {"mixed_submits": [FILES_SUBMITS,
                                         service_kw["n_mixed"]],
                       "replay_submits": [n_replay, 190]},
           "primitives_total": out["primitives_total"], "threads": threads}
    want = staged["mark"]
    for what, x, y in (("results", out["mixed"]["digest"], want["digest"]),
                       ("IOStats but bg_*", _masked(io),
                        _masked(want["iostats"])),
                       ("cache hits and misses", out["mixed"]["cache"],
                        want["cache"])):
        if x != y:
            emit(row)
            raise AssertionError(f"workers phase differs from the staged "
                                 f"phase in {what}")
    same_durable({k: end[k] for k in staged_mark}, staged_mark,
                 f"workers phase against the staged phase at submit "
                 f"{FILES_SUBMITS}")
    t1 = time.perf_counter()
    zero_counts()
    rep = {"card_0": replay(dev, n_submits=n_replay)}
    rep["card_w"] = replay(dev, n_submits=n_replay,
                           maintenance_workers=REPLAY_WORKERS)
    _sync(dev)
    replay_launches = dict(LAUNCHES)
    rep["cpu_w"] = replay("cpu", n_submits=n_replay,
                          maintenance_workers=REPLAY_WORKERS)
    for r in rep.values():
        r["iostats"] = _masked(r["iostats"])
    compare_replays(rep["card_0"], rep["card_w"])
    compare_replays(rep["card_w"], rep["cpu_w"])
    row["replay"] = {"workers": REPLAY_WORKERS,
                     "wal_records": len(rep["card_w"]["wal"]),
                     "launches": replay_launches,
                     "seconds": time.perf_counter() - t1, "identical": True}
    row["wall_s"] = time.perf_counter() - t0
    emit(row)
    if errors:
        raise AssertionError(f"worker prepares raised on the card: "
                             f"{errors[:3]}")
    if not end["pool"]["hits"] > 0:
        raise AssertionError(f"no worker prepare was consumed: "
                             f"{end['pool']}")
    missing = [k for k in ("merge_pair", "bloom_build", "bloom_probe")
               if out["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched in the workers "
                             f"phase: {missing}")
    if out["k1"]["launches"] > out["k1"]["calls"]:
        raise AssertionError(f"K1 launched more than once per merge_runs or "
                             f"ingest_run call in the workers phase: "
                             f"{out['k1']}")
    return row


# --------------------------- the files medium --------------------------------
# The files phase drives the staged stream's load and its first
# FILES_SUBMITS mixed submits (of SERVICE_MIXED) on the files medium: cut
# from 64 to 32 when the train phase came, so that the whole script stays
# within 700 s (the 64 submits took 34.5 s on 9p, and the files phase
# 126.3 s of its 120 s box, with an NVIDIA H100 80GB HBM3 at 700 W).
FILES_SUBMITS = 32
# (shards, boundary) of the kill workload at which a child kills itself.
FILES_KILLS = ((1, 5), (1, 17), (4, 11), (4, 23))
# The four parts' time box, in seconds of command time.
FILES_BOX_S = 120.0
# IOStats fields the memory medium never moves.
FSYNC_FIELDS = ("fsyncs", "fsync_wait_us")


def filesystem_of(path: str) -> dict:
    """Type, mount point and device of the filesystem holding ``path``
    (the longest mount point of ``/proc/mounts`` above it)."""
    real = os.path.realpath(path)
    best = {"type": None, "mount": "", "device": None}
    with open("/proc/mounts") as f:
        for line in f:
            dev, mnt, fstype = line.split()[:3]
            mnt = mnt.replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best["mount"]):
                best = {"type": fstype, "mount": mnt, "device": dev}
    return best


def files_report(store, n_ops: int) -> dict:
    """The files medium's counters of ``store``: fsyncs (all and the
    WAL's), per 1k operations, the foreground fsync wait, commit latency
    (p50/p99 us), WAL segments, page bytes written and read, SST files."""
    st, wal, ps = store.disk.stats, store.wal, store.disk.page_store
    h = wal.commit_hist
    return {"fsyncs": st.fsyncs, "wal_fsyncs": wal.fsyncs,
            "fsyncs_per_kop": 1e3 * st.fsyncs / n_ops,
            "fsync_wait_us": st.fsync_wait_us, "commits": h.count,
            "commit_p50_us": h.quantile(0.5) if h.count else None,
            "commit_p99_us": h.quantile(0.99) if h.count else None,
            "wal_segments": wal.segment_count,
            "page_bytes_written": ps.bytes_written,
            "page_bytes_read": ps.bytes_read, "sst_files": len(ps.ids())}


def plane_digest(root: str) -> dict:
    """sha256 of every file of the plane under ``root``; the MANIFEST's
    CHECKPOINT frames with their one clock reading,
    ``iostats["fsync_wait_us"]``, set to 0 (the frames re-pickled)."""
    out = {}
    for d, _, names in os.walk(root):
        for n in sorted(names):
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    h = hashlib.sha256()
    for tag, payload in read_frames(os.path.join(root, "MANIFEST"),
                                    allow_torn_tail=False):
        if tag == TAG_CHECKPOINT:
            ck = pickle.loads(payload)
            ck["iostats"] = {**ck["iostats"], "fsync_wait_us": 0.0}
            payload = pickle.dumps(ck)
        h.update(tag.to_bytes(8, "little", signed=True))
        h.update(hashlib.sha256(payload).digest())
    out["MANIFEST"] = h.hexdigest()
    return out


def _unfsynced(iostats: dict) -> dict:
    return {k: v for k, v in iostats.items() if k not in FSYNC_FIELDS}


def files_stream(card: str, fs: dict, root: str, staged: dict,
                 staged_mark: dict, service_kw: dict, dev="cuda") -> tuple:
    """The staged phase's configuration on the files medium under
    ``per_batch``: the 2**20-key load and the first ``FILES_SUBMITS``
    mixed submits, every Get and Scan against the oracle; the results,
    IOStats (but fsyncs) and cache counts equal the staged phase's at that
    submit (``staged["mark"]``), and so does the store's ``durable``
    state (``staged_mark``). K1, K2 and K5 launch; K3, K4 and K6 do not.
    Returns what the reopen needs: the store, its state and the oracle."""
    keep: dict = {}

    def on_part(part, svc, oracle):
        if part == "mixed":
            keep.update(store=svc.store, live=durable(svc.store),
                        oracle=oracle.frozen(7))

    t0 = time.perf_counter()
    reset_sst_ids()
    zero_counts()
    out = run_service(dev, cfg_kw={
        "max_log_bytes": SERVICE_MAX_LOG_BYTES, "storage_medium": "files",
        "storage_dir": root, "fsync_policy": "per_batch"},
        on_part=on_part, **{**service_kw, "n_mixed": FILES_SUBMITS})
    _sync(dev)
    launches = out["launches"] = dict(LAUNCHES)
    per_submit = sum(service_kw[k] for k in ("gets", "puts", "deletes",
                                             "scans"))
    n_ops = service_kw["n_keys"] + FILES_SUBMITS * per_submit
    row = {"phase": "files", "part": "stream", "card": card,
           "filesystem": fs, "fsync_policy": "per_batch",
           "reduced": {"mixed_submits": [FILES_SUBMITS,
                                         service_kw["n_mixed"]]},
           "n_ops": n_ops, "files": files_report(keep["store"], n_ops),
           "submits_per_s": {"files": out["mixed"]["submits_per_s"],
                             "staged": staged["mixed"]["submits_per_s"]},
           "load_s": {"files": out["load_s"], "staged": staged["load_s"]},
           "mixed_wall_s": out["mixed_wall_s"],
           "device_busy_share": out["mixed"]["device_busy_share"],
           "launches": launches, "k1": k1_per_call(out),
           "primitives_total": out["primitives_total"],
           "seconds": time.perf_counter() - t0}
    emit(row)
    want = staged["mark"]
    for what, x, y in (
            ("results", out["mixed"]["digest"], want["digest"]),
            ("IOStats but fsyncs", _unfsynced(out["mixed"]["iostats"]),
             _unfsynced(want["iostats"])),
            ("cache hits and misses", out["mixed"]["cache"], want["cache"])):
        if x != y:
            raise AssertionError(f"files stream differs from the memory "
                                 f"medium at submit {FILES_SUBMITS} in {what}")
    same_durable(keep["live"], staged_mark,
                 f"files stream against the memory medium at submit "
                 f"{FILES_SUBMITS}")
    if not row["files"]["fsyncs"] > 0:
        raise AssertionError("the files stream made no fsync")
    if dev != "cpu":
        missing = [k for k in ("merge_pair", "bloom_build", "bloom_probe")
                   if launches[k] <= 0]
        stray = [k for k in ("probe_tier", "probe_store", "flash_attention")
                 if launches[k] != 0]
        if missing or stray:
            raise AssertionError(f"files stream launches: never {missing}, "
                                 f"unexpected {stray}")
    return keep


def files_reopen(card: str, fs: dict, keep: dict, gets: int,
                 dev="cuda") -> dict:
    """Close the stream's store, reopen its plane (``open_plane``, as a
    restarted process would: sst ids from 0) and recover it through
    ``StorageService.recover`` (``recover_full_width``: equal to the live
    store, then held Gets and Scans against the oracle)."""
    t0 = time.perf_counter()
    store = keep.pop("store")
    cfg = store.cfg
    store.wal.close()
    store.manifest.close()
    del store
    reset_sst_ids()
    t1 = time.perf_counter()
    wal, manifest = open_plane(cfg)
    open_s = time.perf_counter() - t1
    rec = recover_full_width("files reopen", {
        "wal": wal, "manifest": manifest, "cfg": cfg, "live": keep["live"],
        "oracle": keep["oracle"]}, gets, dev)
    row = {"phase": "files", "part": "reopen", "card": card,
           "filesystem": fs, "open_plane_s": open_s, **rec,
           "gc_ssts": rec["info"]["gc_ssts"],
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def kill_snapshot(store) -> dict:
    """What a recovery after a kill must reproduce: every shard's
    fingerprint, ``RECOVERY_EXACT_COUNTERS`` and the log position."""
    return {"fp": [fingerprint(s) for s in _stores(store)],
            "counters": [{k: getattr(s.disk.stats, k)
                          for k in RECOVERY_EXACT_COUNTERS}
                         for s in _stores(store)],
            "log_pos": store.log_pos}


def files_sigkill(card: str, fs: dict, base: str, dev="cuda") -> dict:
    """The port's kill workload (``tests/torch_kill_workload.py``) in one
    child per ``FILES_KILLS`` point, all started together, each on
    ``dev`` on the files medium, killing itself with SIGKILL at its
    boundary; meanwhile the memory-medium oracle runs here over 1 and 4
    shards. Each plane is recovered here on ``dev`` and must equal the
    oracle at its boundary."""
    t0 = time.perf_counter()
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    from torch_kill_workload import drive, kill_config

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [os.path.join(ROOT, "src"), tests])}
    kids = []
    for shards, at in FILES_KILLS:
        root = os.path.join(base, f"kill-{shards}-{at}")
        argv = [sys.executable, os.path.join(tests, "torch_crash_child.py"),
                "--root", root, "--shards", str(shards), "--kill-at",
                str(at), "--device", dev]
        kids.append((shards, at, root, subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    try:
        oracles = {}
        for shards in sorted({s for s, _ in FILES_KILLS}):
            reset_sst_ids()
            store = ShardedStore(kill_config(shards, medium="memory",
                                             device=dev), shards=shards)
            snaps = []
            drive(store, lambda i: snaps.append(kill_snapshot(store)))
            oracles[shards] = snaps
        ended = [(shards, at, root, *p.communicate(timeout=300),
                  p.returncode) for shards, at, root, p in kids]
    finally:
        for *_, p in kids:
            if p.poll() is None:
                p.kill()
                p.wait()
    children_s = time.perf_counter() - t0
    zero_counts()
    points = []
    for shards, at, root, _, err, rc in ended:
        if rc != -signal.SIGKILL:
            raise AssertionError(f"kill child ({shards} shards, boundary "
                                 f"{at}) ended with {rc}, not SIGKILL:\n"
                                 f"{err[-2000:]}")
        t1 = time.perf_counter()
        reset_sst_ids()
        cfg = kill_config(shards, medium="files", root=root, device=dev)
        rec = recover(cfg, *open_plane(cfg))
        _sync(dev)
        secs = time.perf_counter() - t1
        if kill_snapshot(rec) != oracles[shards][at]:
            raise AssertionError(f"recovery after the kill at boundary {at} "
                                 f"over {shards} shard(s) differs from the "
                                 f"memory-medium oracle")
        points.append({"shards": shards, "boundary": at,
                       "recovery_s": secs, "info": rec.recovery_info,
                       "identical": True})
    row = {"phase": "files", "part": "sigkill", "card": card,
           "filesystem": fs, "points": points, "children_s": children_s,
           "launches": dict(LAUNCHES), "seconds": time.perf_counter() - t0}
    emit(row)
    return row


# The replay store's submits under each fsync policy (of the replay's 190),
# cut when the train phase came (six 190-submit replays took 28.6 s on 9p,
# with an NVIDIA H100 80GB HBM3 at 700 W).
FILES_POLICY_SUBMITS = 95


def files_policies(card: str, fs: dict, base: str,
                   n_submits: int = FILES_POLICY_SUBMITS,
                   devs=("cuda", "cpu")) -> dict:
    """The card-vs-CPU replay's small store (192 KB log cap: log-triggered
    flushes, checkpoints, truncation) on the files medium under each
    fsync policy, on the card and on the CPU (``group`` with a 3600 s
    wait, so its groups close on bytes alone). Every result, the
    fingerprint, IOStats but ``fsync_wait_us``, the WAL's records, the
    manifest's edits and every byte of the plane after ``sync()`` (the
    checkpoints' clock reading aside, see ``plane_digest``) are equal;
    fsync counts too under ``per_record`` and ``per_batch``."""
    t0 = time.perf_counter()
    out = {}
    for policy in FSYNC_POLICIES:
        runs = {}
        for i, dev in enumerate(devs):
            root = os.path.join(base, f"{policy}-{i}-{dev}")
            r = replay(dev, n_submits=n_submits, storage_medium="files",
                       storage_dir=root, fsync_policy=policy,
                       group_commit_max_wait_s=3600.0)
            store = r.pop("store")
            store.wal.sync()
            r["files"] = files_report(store, r["n_ops"])
            r["plane"] = plane_digest(root)
            r["checkpoints"] = sum(
                tag == TAG_CHECKPOINT for tag, _ in read_frames(
                    os.path.join(root, "MANIFEST"), allow_torn_tail=False))
            r["iostats"] = {k: v for k, v in r["iostats"].items()
                            if k not in (FSYNC_FIELDS if policy == "group"
                                         else FSYNC_FIELDS[1:])}
            runs[i] = r
        a, b = runs[0], runs[1]
        compare_replays(a, b)
        if a["plane"] != b["plane"]:
            bad = sorted(k for k in a["plane"]
                         if a["plane"][k] != b["plane"].get(k))
            raise AssertionError(f"{policy}: card and CPU planes differ in "
                                 f"{bad or 'their file lists'}")
        if policy != "group" and \
                [a["files"][k] for k in ("fsyncs", "wal_fsyncs")] != \
                [b["files"][k] for k in ("fsyncs", "wal_fsyncs")]:
            raise AssertionError(f"{policy}: card and CPU fsync counts "
                                 f"differ")
        if not (a["flushes_log"] > 0 and a["checkpoints"] > 0
                and a["truncated_to"] > 0):
            raise AssertionError(f"{policy}: the replay ran no log-triggered "
                                 f"flush, checkpoint or truncation")
        out[policy] = {d: runs[i]["files"] for i, d in enumerate(devs)}
        out[policy].update(plane_files=len(a["plane"]),
                           checkpoint_frames=a["checkpoints"],
                           flushes_log=a["flushes_log"],
                           truncated_to=a["truncated_to"],
                           n_ops=a["n_ops"], identical=True)
    row = {"phase": "files", "part": "policies", "card": card,
           "filesystem": fs, "n_submits": n_submits,
           "group_commit_max_wait_s": 3600.0, "policies": out,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def files_phase(card: str, staged: dict, staged_mark: dict,
                service_kw: dict, dev="cuda", policies_kw=None) -> dict:
    """The files medium on the card in four parts (stream, reopen,
    sigkill, policies), in a fresh temporary directory removed at the
    end; then the parts' seconds against ``FILES_BOX_S``."""
    base = tempfile.mkdtemp(prefix="repro_torch_files_")
    fs = filesystem_of(base)
    seconds = {}
    try:
        t0 = time.perf_counter()
        keep = files_stream(card, fs, os.path.join(base, "stream"),
                            staged, staged_mark, service_kw, dev)
        seconds["stream"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        files_reopen(card, fs, keep, service_kw["gets"], dev)
        del keep
        seconds["reopen"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        files_sigkill(card, fs, base, dev)
        seconds["sigkill"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        files_policies(card, fs, base, **(policies_kw or {}))
        seconds["policies"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(base, ignore_errors=True)
    total = sum(seconds.values())
    row = {"phase": "files_seconds", "card": card, "filesystem": fs,
           **seconds, "total": total, "box_s": FILES_BOX_S,
           "within_box": total <= FILES_BOX_S}
    emit(row)
    return row


# --------------------------- K6: attention kernel phase ----------------------
# K6 against its plain version: bf16 by 2e-2 (the kernel rounds p to bf16
# per key tile, the plain version once over all keys), f32 by 1e-5
# (summation order only).
ATTN_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# bf16 also: RMS(kernel - plain) / RMS(plain) at most ATTN_REL_RMS. At
# long rows a typical |output| is 0.03-0.05, so 2e-2 alone would pass a
# kernel that drops a key tile or skips a rescale. The limit lies between
# the largest reading of the sound kernel (2.35e-3, decode_long_cache) and
# the smallest of a fault in its place where the fault changes anything
# (1.12e-2, no rescale at hd80_gqa3_sq_lt_sk; 0.15 or more at the long
# cases): tools/k6_faults.py on an H100, PERF.md section 6.
ATTN_REL_RMS = 5e-3
YI_HEADS = {"h": 32, "kv": 4, "hd": 128}
GRANITE_HEADS = {"h": 16, "kv": 8, "hd": 64}
ZAMBA_HEADS = {"h": 32, "kv": 32, "hd": 80}
# The serving path's prefill (48 prompt tokens over its cache of 64 rows)
# and decode (one query over rows 0..pos of that cache) at Yi-6B's heads
# and at Granite-3.0-1B-A400M's and Zamba2-2.7B's shared attention's
# (prefill, and decode at the last position), a 4096-token Yi-6B prefill,
# and a Gemma-2-27B local layer at 8192 tokens.
ATTN_CASES = [
    ("serve_prefill", dict(b=4, sq=48, sk=64, causal=True, **YI_HEADS)),
    *[(f"serve_decode_pos{p}", dict(b=4, sq=1, sk=p + 1, causal=False,
                                    **YI_HEADS)) for p in (0, 47, 63)],
    ("granite_serve_prefill", dict(b=4, sq=48, sk=64, causal=True,
                                   **GRANITE_HEADS)),
    ("granite_serve_decode_pos63", dict(b=4, sq=1, sk=64, causal=False,
                                        **GRANITE_HEADS)),
    ("zamba2_serve_prefill", dict(b=4, sq=48, sk=64, causal=True,
                                  **ZAMBA_HEADS)),
    ("zamba2_serve_decode_pos63", dict(b=4, sq=1, sk=64, causal=False,
                                       **ZAMBA_HEADS)),
    ("yi_prefill_4096", dict(b=1, sq=4096, sk=4096, causal=True, **YI_HEADS)),
    ("gemma2_local_8192", dict(b=1, sq=8192, sk=8192, causal=True, h=32,
                               kv=16, hd=128, window=4096, softcap=50.0)),
]
# Edges of K6's paths, checked against the plain version in both dtypes
# and not timed: head dims 16/64/80, H == KV and H/KV = 2, 3 or 8, query
# counts that are no multiple of a block's rows, Sq > Sk with a window
# (rows that keep no key), window with softcap, decode with H == KV and
# over a cache longer than one key tile, k/v as row views at an offset
# into a wider cache ("lo"), and k/v whose head stride is no multiple of
# 8 elements ("pad": bf16 then takes the CUDA-core kernel).
ATTN_EDGES = [
    ("hd16_h_eq_kv", dict(b=2, sq=37, sk=53, h=4, kv=4, hd=16,
                          causal=True)),
    ("hd64_gqa2_window_softcap", dict(b=2, sq=100, sk=100, h=8, kv=4,
                                      hd=64, causal=True, window=16,
                                      softcap=30.0)),
    ("hd80_gqa3_sq_lt_sk", dict(b=2, sq=70, sk=90, h=6, kv=2, hd=80,
                                causal=True)),
    ("sq_gt_sk_window", dict(b=2, sq=64, sk=32, h=4, kv=2, hd=64,
                             causal=True, window=8)),
    ("gqa8_sq_gt_sk_window_softcap", dict(b=1, sq=200, sk=72, h=32, kv=4,
                                          hd=128, causal=True, window=40,
                                          softcap=50.0)),
    ("decode_h_eq_kv_softcap", dict(b=3, sq=1, sk=37, h=8, kv=8, hd=128,
                                    causal=False, softcap=50.0)),
    ("decode_long_cache", dict(b=2, sq=1, sk=1000, h=32, kv=4, hd=128,
                               causal=False)),
    ("prefill_cache_view", dict(b=2, sq=48, sk=80, h=32, kv=4, hd=128,
                                causal=True, lo=16)),
    ("decode_cache_view", dict(b=4, sq=1, sk=40, h=32, kv=4, hd=128,
                               causal=False, lo=9)),
    ("head_stride_pad", dict(b=2, sq=33, sk=33, h=4, kv=2, hd=16,
                             causal=True, pad=4)),
    # Enough row blocks for the long-prefill tiling at hd 16, 64 and 80.
    ("hd16_long", dict(b=8, sq=300, sk=300, h=8, kv=8, hd=16, causal=True)),
    ("hd64_long_h_eq_kv_window", dict(b=4, sq=1000, sk=1000, h=16, kv=16,
                                      hd=64, causal=True, window=300)),
    ("hd80_long_gqa3_softcap", dict(b=4, sq=600, sk=600, h=12, kv=4, hd=80,
                                    causal=True, softcap=30.0)),
]
# The p-rounding check: at these bf16 cases one key tile of the kernel
# holds every key, so the kernel rounds the same p as the plain version,
# and the RMS of (kernel - plain) must stay below P_ROUNDING_SHARE of the
# RMS of (plain - the unrounded control _p_unrounded). A kernel that keeps
# p in f32 reads about that whole gap (tools/k6_faults.py). The gap must
# be at least P_ROUNDING_MIN_GAP, the floor tests/test_torch_attention.py
# holds it to on the CPU, or the check could not tell the two apart.
P_ROUNDING_CASES = ("serve_prefill", "serve_decode_pos47",
                    "serve_decode_pos63")
P_ROUNDING_SHARE = 0.5
P_ROUNDING_MIN_GAP = 2e-4
# The kernels line reports the serving path's most frequent call: decode
# at the last position of its 64-row cache, in the compute dtype.
ATTN_REPORTED = "serve_decode_pos63/bfloat16"
SERVE_CACHE_ROWS = 64


def _kept_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs that K6 keeps for one batch row and head."""
    if not causal:
        return sq * sk
    qp = np.arange(sq)
    hi = np.minimum(qp, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else np.zeros_like(qp)
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attn_inputs(shape: dict, dtype, gen):
    """q, and k, v as row views of a cache of 64 rows where the serving
    path reads one (the model's own strided layout), else whole tensors;
    with ``lo``, rows lo..lo+sk-1 of a wider cache; with ``pad``, heads
    padded by that many elements, so the head stride is hd + pad."""
    b, sq, sk, h, kv, hd = (shape[k] for k in ("b", "sq", "sk", "h", "kv",
                                               "hd"))
    lo, pad = shape.get("lo", 0), shape.get("pad", 0)
    rows = max(lo + sk, SERVE_CACHE_ROWS)

    def mk(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dtype)

    def cache():
        return mk(b, rows, kv, hd + pad)[:, lo:lo + sk, :, :hd]

    return mk(b, sq, h, hd), cache(), cache()


def _attn_kw(shape: dict) -> dict:
    return {"causal": shape["causal"], "window": shape.get("window", 0),
            "softcap": shape.get("softcap", 0.0)}


def _rms(x) -> float:
    return float(x.float().pow(2).mean().sqrt())


def p_rounding(got, plain, control) -> dict:
    """RMS of (got - plain) against P_ROUNDING_SHARE of the RMS of
    (plain - control); ``ok`` when it stays below and that gap is at
    least P_ROUNDING_MIN_GAP."""
    near, gap = _rms(got.float() - plain.float()), _rms(
        plain.float() - control.float())
    return {"rms_vs_plain": near, "rms_plain_vs_unrounded": gap,
            "limit": P_ROUNDING_SHARE * gap,
            "ok": gap >= P_ROUNDING_MIN_GAP and near < P_ROUNDING_SHARE * gap}


def attention_error(got, want) -> dict:
    """The largest difference of K6's output from its plain version's, and
    in bf16 the relative RMS difference."""
    diff = got.float() - want.float()
    out = {"max_abs_err": float(diff.abs().max())}
    if got.dtype == torch.bfloat16:
        out["rel_rms"] = _rms(diff) / _rms(want)
    return out


def _held(name: str, shape: dict, dname: str, gen):
    """K6 and its plain version on fresh inputs of ``shape``: (q, k, v),
    both outputs and attention_error; raises beyond ATTN_TOL or, in bf16,
    ATTN_REL_RMS."""
    q, k, v = _attn_inputs(shape, getattr(torch, dname), gen)
    kw = _attn_kw(shape)
    got = attn_k.flash_attention(q, k, v, **kw)
    want = attn_k.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = attention_error(got, want)
    if not err["max_abs_err"] <= ATTN_TOL[dname]:
        raise AssertionError(f"flash_attention {name} {dname}: max abs err "
                             f"{err['max_abs_err']} > {ATTN_TOL[dname]}")
    if not err.get("rel_rms", 0.0) <= ATTN_REL_RMS:
        raise AssertionError(f"flash_attention {name} {dname}: relative RMS "
                             f"err {err['rel_rms']} > {ATTN_REL_RMS}")
    return (q, k, v), got, want, err


def check_attention_edges(gen) -> dict:
    """Hold K6 against its plain version at every ATTN_EDGES case in bf16
    and f32 (not timed)."""
    out = {}
    for name, shape in ATTN_EDGES:
        for dname in ("bfloat16", "float32"):
            err = _held(name, shape, dname, gen)[3]
            out[f"{name}/{dname}"] = {"shape": shape, **err}
    return out


def check_attention(gen) -> dict:
    """Hold K6 against its plain version at every case in bf16 and f32;
    time the kernel, its plain version and the SDPA yardstick with the
    same mask (none with a softcap, which SDPA does not take). Raises
    beyond tolerance."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    out = {}
    for name, shape in ATTN_CASES:
        kw = _attn_kw(shape)
        for dname in ("bfloat16", "float32"):
            (q, k, v), got, want, err = _held(name, shape, dname, gen)
            rounding = None
            if dname == "bfloat16" and name in P_ROUNDING_CASES:
                rounding = p_rounding(got, want, _p_unrounded(q, k, v, **kw))
            del got, want
            if rounding and not rounding["ok"]:
                raise AssertionError(f"flash_attention {name}: p not rounded "
                                     f"as the plain version rounds it, or "
                                     f"the check cannot tell: {rounding}")
            reps = 5 if shape["sq"] >= 4096 else 25
            # Bytes: q read and o written once, and the k and v rows that
            # some query keeps (rows 0..min(sq, sk)-1 when causal).
            kv_rows = (min(shape["sq"], shape["sk"]) if kw["causal"]
                       else shape["sk"])
            nbytes = (2 * q.numel() + 2 * shape["b"] * kv_rows * shape["kv"]
                      * shape["hd"]) * q.element_size()
            pairs = _kept_pairs(shape["sq"], shape["sk"], kw["causal"],
                                kw["window"]) * shape["b"] * shape["h"]
            rate = BF16_OPS_PER_S if dname == "bfloat16" else OPS_PER_S
            lib = None
            if not kw["softcap"]:
                mask = (attn_k.keep_mask(shape["sq"], shape["sk"],
                                         kw["window"], q.device)
                        if kw["window"] else None)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                lib = cuda_ms(lambda: sdpa(
                    qt, kt, vt, attn_mask=mask,
                    is_causal=kw["causal"] and mask is None,
                    scale=shape["hd"] ** -0.5, enable_gqa=True), reps)
            out[f"{name}/{dname}"] = {
                "shape": shape, **err, "tol": ATTN_TOL[dname],
                "ms": cuda_ms(lambda: attn_k.flash_attention(q, k, v, **kw),
                              reps),
                "device_ms": kernel_device_ms(
                    lambda: attn_k.flash_attention(q, k, v, **kw),
                    "flash_attention_kernel", reps),
                "plain_ms": cuda_ms(
                    lambda: attn_k.flash_attention_plain(q, k, v, **kw), reps),
                **bound(nbytes, 4 * shape["hd"] * pairs, rate),
                "kept_pairs": pairs, "library_ms": lib}
            if rounding:
                out[f"{name}/{dname}"]["p_rounding"] = rounding
            del q, k, v
            torch.cuda.empty_cache()
    return out


# --------------------------- serve phase --------------------------------------
@contextlib.contextmanager
def patched(cls, name, make):
    """Replace ``cls.name`` by ``make(original)`` for the block."""
    orig = getattr(cls, name)
    setattr(cls, name, make(orig))
    try:
        yield
    finally:
        setattr(cls, name, orig)


class _ServeProbe:
    """What the serve phase reads around ``serve.main``: CUDA events around
    every prefill and decode step (no synchronisation), whether every
    logits tensor is finite (flags on the device, read once at the end),
    the governor, and, when ``n_profile`` > 0, the profiler over
    ``n_profile`` decode steps from step ``profile_from``."""

    def __init__(self, profile_from: int = 0, n_profile: int = 0):
        self.prefill, self.decode, self.finite = [], [], []
        self.governor = None
        self.profile_from, self.n_profile = profile_from, n_profile
        self.prof = None
        self.prof_wall = 0.0

    @staticmethod
    def _timed(events, orig):
        def fn(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = orig(*a, **kw)
            e1.record()
            events.append((e0, e1))
            return out
        return fn

    def _decode(self, orig):
        timed = self._timed(self.decode, orig)
        if not self.n_profile:
            return timed

        def fn(*a, **kw):
            i = len(self.decode)
            if i == self.profile_from:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                # Device activity only: with CPU ops traced too, each op's
                # self device time would count its kernels a second time.
                self.prof = profile(activities=[ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.prof_wall = time.perf_counter()
            out = timed(*a, **kw)
            if i == self.profile_from + self.n_profile - 1:
                torch.cuda.synchronize()
                self.prof_wall = time.perf_counter() - self.prof_wall
                self.prof.__exit__(None, None, None)
            return out
        return fn

    def _logits(self, orig):
        def fn(model, params, x):
            out = orig(model, params, x)
            self.finite.append(torch.isfinite(out).all())
            return out
        return fn

    def _observe(self, orig):
        def fn(gov, *a, **kw):
            self.governor = gov
            return orig(gov, *a, **kw)
        return fn

    @contextlib.contextmanager
    def attached(self):
        with patched(CausalLM, "prefill",
                     lambda f: self._timed(self.prefill, f)), \
                patched(CausalLM, "decode_step", self._decode), \
                patched(CausalLM, "_logits", self._logits), \
                patched(HBMGovernor, "observe", self._observe):
            yield self

    def profile_report(self) -> dict:
        dev: dict = {}
        for e in self.prof.key_averages():
            us = getattr(e, "self_device_time_total", 0.0)
            if us > 0:
                dev[e.key] = dev.get(e.key, 0.0) + us
        total = sum(dev.values())
        k6 = sum(v for k, v in dev.items() if "flash_attention_kernel" in k)
        top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
        return {"decode_steps": self.n_profile,
                "wall_ms": self.prof_wall * 1e3, "device_ms": total / 1e3,
                "device_busy_share": total / 1e3 / (self.prof_wall * 1e3),
                "flash_attention_share": k6 / total if total else None,
                "device_ms_top": [[k[:100], v / 1e3] for k, v in top]}


def run_serve(argv, *, profile_from: int = 0, n_profile: int = 0) -> dict:
    """``repro_torch.launch.serve.main(argv)`` on the card under a
    ``_ServeProbe``; returns its stats and lines, times, counts and the
    device's memory, and with ``n_profile`` > 0 the profile (then the
    times hold the profiled steps: use them for the profile alone)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probe = _ServeProbe(profile_from, n_profile)
    buf = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with probe.attached(), contextlib.redirect_stdout(buf):
        stats = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    pre = [a.elapsed_time(b) for a, b in probe.prefill]
    dec = [a.elapsed_time(b) for a, b in probe.decode]
    loop_s = probe.prefill[0][0].elapsed_time(probe.decode[-1][1]) / 1e3
    lines = buf.getvalue().splitlines()
    serve_line = [ln for ln in lines if ln.startswith("[serve]")][-1]
    tokens = int(serve_line.split("tokens=")[1].split()[0])
    out = {"argv": argv, "wall_s": wall, "loop_s": loop_s,
           "launches": launches,
           "logits_finite": bool(torch.stack(probe.finite).all()),
           "logits_calls": len(probe.finite),
           "prefill_calls": len(pre), "decode_calls": len(dec),
           "prefill_ms_median": float(np.median(pre)),
           "prefill_ms_mean": float(np.mean(pre)),
           "decode_ms_median": float(np.median(dec)),
           "decode_ms_mean": float(np.mean(dec)),
           "tokens": tokens, "tokens_per_s": tokens / loop_s,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "stats": stats, "lines": lines,
           "governor_records": probe.governor.records}
    if n_profile:
        out["profile"] = probe.profile_report()
    return out


def param_bytes(cfg) -> dict:
    """Bytes of the params in ``param_dtype`` and of the compute copy (every
    weight but those ``F32_LEAVES`` names, in the compute dtype)."""
    n = {"all": 0, "f32": 0}

    def walk(tree, key=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, key)
        else:
            size = int(np.prod(tree.shape))
            n["all"] += size
            n["f32"] += size if key in F32_LEAVES else 0

    walk(build_model(cfg).param_specs())
    size = lambda d: torch.empty((), dtype=getattr(torch, d)).element_size()  # noqa: E731
    return {"param_bytes": n["all"] * size(cfg.param_dtype),
            "compute_copy_bytes": (n["all"] - n["f32"])
            * size(cfg.compute_dtype)}


# --------------------------- card-vs-CPU model phase -------------------------
# Logits limits of the card-vs-CPU model phase, absolute, on the largest and
# on the RMS difference over one step's logits (f32 compute: summation order
# only; bf16: the two devices round activations at other places). Each is
# about 3x the largest reading of a sound run on an H100 (f32: 1.53e-5 and
# 9.5e-7; bf16: 0.25, one bf16 ulp of the fed token's logit near 48, and
# 6.0e-3, against logits of RMS 1.0); PERF.md (section 6) has the readings
# and the faults that break them.
MODEL_TOL = {"float32": {"max": 5e-5, "rms": 3e-6},
             "bfloat16": {"max": 0.75, "rms": 0.018}}
# Depth of the card-vs-CPU model phase (Yi-6B has 32 layers): the CPU side
# must finish inside the run's time limit.
MODEL_LAYERS = 2


def _p_unrounded(q, k, v, *, causal=True, window=0, softcap=0.0):
    """K6's function with ``p`` kept in f32 before ``p @ v``."""
    return attn_k.flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        softcap=softcap).to(q.dtype)


def _skip_oldest_key(f):
    def fn(q, k, v, **kw):
        if q.shape[1] == 1 and k.shape[1] > 1:      # decode: off by one row
            k, v = k[:, 1:], v[:, 1:]
        return f(q, k, v, **kw)
    return fn


# Faults run on the card in place of K6 and held to the same limits: each
# must break one of them in the compute dtypes listed. "p_unrounded" is
# K6's function in f32, and in bf16 its logits stay inside the card-vs-CPU
# rounding noise, so it is recorded and not asserted.
BOTH = ("float32", "bfloat16")
MODEL_FAULTS = {
    "attention_dropped": (
        lambda f: lambda q, k, v, **kw: torch.zeros_like(q), BOTH),
    "decode_skips_oldest_key": (_skip_oldest_key, BOTH),
    "p_unrounded": (lambda f: _p_unrounded, ()),
}


def _greedy_logits(m, params, cache, tokens, steps: int, d,
                   feed=None) -> tuple:
    """Prefill ``tokens`` and decode ``steps`` tokens on device ``d``: the
    last row's logits of each step (f32, on the CPU) and the tokens fed
    after each step (the greedy ones, or ``feed``'s)."""
    out, fed = [], []
    lg, _ = m.prefill(params, tokens.to(d), cache)
    for step in range(steps + 1):
        if step:
            lg, _ = m.decode_step(params, tok.to(d), cache,
                                  tokens.shape[1] + step - 1)
        out.append(lg[:, -1].float().cpu())
        tok = (out[-1].argmax(-1) if feed is None else feed[step])[:, None]
        tok = tok.to(torch.int32)
        fed.append(tok[:, 0])
    return out, fed


def _diff(ref: torch.Tensor, got: torch.Tensor) -> dict:
    d = (got - ref).abs()
    return {"max_abs_err": float(d.max()),
            "rms_err": float(d.square().mean().sqrt()),
            "finite": bool(torch.isfinite(got).all())}


def _step(ref: torch.Tensor, got: torch.Tensor, tol: dict) -> dict:
    """One step's logits on the card against the CPU's: ``_diff``, and
    whether the greedy tokens agree where the CPU's top-2 gap is clear."""
    top2 = ref.topk(2, dim=-1).values
    # Two logits each within "max" of the CPU's keep their order when
    # their gap is wider than twice that.
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol["max"]
    same = ref.argmax(-1) == got.argmax(-1)
    return {**_diff(ref, got),
            "logits_rms": float(ref.square().mean().sqrt()),
            "clear_rows": int(clear.sum()), "tokens_equal": int(same.sum()),
            "clear_tokens_equal": bool(same[clear].all())}


def compare_model(cfg, *, batch: int, prompt: int, steps: int,
                  seed: int = 0, dev: str = "cuda") -> list:
    """``cfg`` (a model at full width, fewer layers): the same weights from
    one seeded generator through the port on the CPU and on ``dev``, in f32
    and bf16 compute, the card fed the CPU's greedy tokens. Then each of
    ``MODEL_FAULTS`` in place of K6 on the card, fed the same tokens.
    Returns each step's differences; ``check_model`` holds them."""
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(seed)
    p_cpu = init_params(model.param_specs(), gen, cfg.param_dtype, "cpu")
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    tokens = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32))
    out = []
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.with_(compute_dtype=dname))

        def run(d, params, feed=None):
            cache = init_params(m.cache_specs(batch, prompt + steps), None,
                                cfg.param_dtype, d)
            return _greedy_logits(m, params, cache, tokens, steps, d, feed)

        t0 = time.perf_counter()
        ref, fed = run("cpu", m.compute_params(p_cpu))
        cp = m.compute_params(p_dev)
        got, _ = run(dev, cp, fed)
        rec = {"compute_dtype": dname, "layers": cfg.num_layers,
               "tol": MODEL_TOL[dname],
               "steps": [_step(r, g, MODEL_TOL[dname])
                         for r, g in zip(ref, got)], "faults": {}}
        for name, (make, _) in MODEL_FAULTS.items():
            with patched(port_attention, "flash_attention", make):
                bad, _ = run(dev, cp, fed)
            rec["faults"][name] = [_diff(r, b) for r, b in zip(ref, bad)]
        rec["seconds"] = time.perf_counter() - t0
        out.append(rec)
        del cp
    return out


def _breaks(steps, tol) -> bool:
    return any(not s["finite"] or s["max_abs_err"] > tol["max"]
               or s["rms_err"] > tol["rms"] for s in steps)


def check_model(runs) -> None:
    """Raises unless every sound step is finite and within both limits with
    the clear greedy tokens equal, and every fault breaks a limit in the
    compute dtypes ``MODEL_FAULTS`` lists for it."""
    for rec in runs:
        dname, tol = rec["compute_dtype"], rec["tol"]
        for i, s in enumerate(rec["steps"]):
            if _breaks([s], tol):
                raise AssertionError(f"model {dname} step {i}: card vs CPU "
                                     f"logits {s} outside {tol}")
            if not s["clear_tokens_equal"]:
                raise AssertionError(f"model {dname} step {i}: greedy "
                                     f"tokens differ where the gap is clear")
        for name, steps in rec["faults"].items():
            if dname in MODEL_FAULTS[name][1] and not _breaks(steps, tol):
                raise AssertionError(f"model {dname}: the fault {name} stays "
                                     f"inside the limits {tol}")


# --------------------------- MoE: Granite serve and model phases -------------
MOE_ARCH = "granite-moe-1b-a400m"
# Depth of the Granite card-vs-CPU model phase: all of Granite's 24 layers
# (the CPU side takes under half a minute on an H100 host).
MOE_MODEL_LAYERS = 24
# The routing rule of that phase. On the card's sound run, every MoE call
# is held to the CPU's same call. Its router logits [T, E] are held to
# MODEL_TOL, the limits of the model's output logits (both have an RMS
# near 1.0). A token whose set of top-k experts differs is a flip, and
# each flip must be excused:
#  * f32, by its gate gap: every expert that one side alone chose lies, on
#    the CPU's gates, within ROUTE_MARGIN of the other side of the CPU's
#    k-th/(k+1)-th boundary, relative to the CPU's k-th gate:
#    (g - g_(k+1)) / g_(k) for an expert the CPU alone chose,
#    (g_(k) - g) / g_(k) for one the card alone chose; 1e-4 is about 6x
#    the largest f32 logits difference of the Yi-6B model phase (1.53e-5).
#  * bf16 (margin None), by the router logits: for each expert a that the
#    CPU alone chose and b that the card alone chose, the CPU's logit gap
#    l_a - l_b is at most the card-vs-CPU difference of l_a plus that of
#    l_b. Such a flip is the exact top-k of the card's own logits, which
#    are held to MODEL_TOL. In bf16 the two sides' residual streams drift
#    apart layer by layer (on an H100 the router logits' RMS difference
#    grows from 1.4e-3 at the first layer to 1.4e-2 at the 24th), so the
#    gaps that flip grow with depth and no fixed gap or count of ulps of
#    the router's own rounding bounds them (PERF.md section 6).
# At each flip the card takes the CPU's experts (with its own gates), as
# compare_model feeds it the CPU's greedy tokens, so that the logits are
# held to MODEL_TOL for their rounding and not for a discontinuity; the
# fault runs keep the card's own routing.
ROUTE_MARGIN = {"float32": 1e-4, "bfloat16": None}
# Time box of the two MoE phases (serve_moe and model_moe) together.
MOE_BOX_S = 240.0


def route_agreement(g_cpu, l_cpu, id_cpu, l_card, id_card, margin,
                    cap: int) -> dict:
    """One MoE call's routing on the card against the CPU's: the CPU's
    gates and router logits [T, E] and top-k ids [T, k], the card's router
    logits and ids. Returns the choices, those both sides made, the
    router logits' difference, each flip and the pairs past ``cap`` on
    each side. A flip has its token, its relative gate gap, its widest
    CPU logit gap ``logit_gap`` over the crossed pairs (and that pair's
    two CPU logits, ``logits``), the most by
    which a pair's gap exceeds its two logits' differences (``beyond``),
    and whether it is excused: by ``gap < margin``, or with ``margin``
    None by ``beyond <= 0`` (ROUTE_MARGIN)."""
    t, k = id_cpu.shape
    on_cpu = torch.zeros_like(g_cpu, dtype=torch.bool).scatter_(1, id_cpu,
                                                                True)
    on_card = torch.zeros_like(on_cpu).scatter_(1, id_card, True)
    top = g_cpu.sort(dim=1, descending=True).values
    l_cpu = l_cpu.float()
    moved = (l_card.float() - l_cpu).abs()
    flips = []
    for r in (on_cpu != on_card).any(1).nonzero()[:, 0].tolist():
        a, b = on_cpu[r] & ~on_card[r], on_card[r] & ~on_cpu[r]
        gk, gk1 = top[r, k - 1], top[r, k]
        gap = float(torch.cat([g_cpu[r][a] - gk1, gk - g_cpu[r][b]]).max()
                    / gk)
        pair_gap = l_cpu[r][a][:, None] - l_cpu[r][b][None, :]
        beyond = float((pair_gap - moved[r][a][:, None]
                        - moved[r][b][None, :]).max())
        i, j = divmod(int(pair_gap.argmax()), pair_gap.shape[1])
        flips.append({"token": r, "gap": gap,
                      "logit_gap": float(pair_gap.max()),
                      "logits": [float(l_cpu[r][a][i]), float(l_cpu[r][b][j])],
                      "beyond": beyond,
                      "excused": (beyond <= 0 if margin is None
                                  else gap < margin)})

    def dropped(on):
        return int((on.sum(0) - cap).clamp_min(0).sum())
    return {"choices": t * k, "agree": int((on_cpu & on_card).sum()),
            "router_logits": {"max_abs_err": float(moved.max()),
                              "rms_err": float(moved.square().mean().sqrt())},
            "flips": flips,
            "dropped_pairs": [dropped(on_cpu), dropped(on_card)]}


class _RouteProbe:
    """Wraps ``moe.router_logits``, ``moe.top_k`` and ``_greedy_logits``
    around ``compare_model``: keeps the CPU run's router logits, gates and
    ids of every MoE call, holds the card's sound run (the first on the
    card in each compute dtype) to them call by call with
    ``route_agreement`` and feeds the card the CPU's experts at each flip;
    fault runs pass through."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.run = None                 # (dtype, index of the run)
        self.runs: dict = {}            # dtype -> runs started
        self.logits = None              # the last MoE call's router logits
        self.cpu: dict = {}             # dtype -> [(gates, logits, ids)]
        self.calls: dict = {}           # dtype -> [route_agreement] per call

    def _greedy(self, orig):
        def fn(m, *a, **kw):
            d = m.cfg.compute_dtype
            self.run = (d, self.runs.get(d, 0))
            self.runs[d] = self.run[1] + 1
            try:
                return orig(m, *a, **kw)
            finally:
                self.run = None
        return fn

    def _router_logits(self, orig):
        def fn(p, x):
            self.logits = orig(p, x)
            return self.logits
        return fn

    def _top_k(self, orig):
        def fn(gates, k):
            vals, ids = orig(gates, k)
            d, i = self.run
            if i == 0:                                  # the CPU
                self.cpu.setdefault(d, []).append(
                    (gates.cpu(), self.logits.cpu(), ids.cpu()))
                return vals, ids
            calls = self.calls.setdefault(d, [])
            if i > 1 or len(calls) >= len(self.cpu[d]):
                return vals, ids                        # a fault run
            g_cpu, l_cpu, id_cpu = self.cpu[d][len(calls)]
            rec = route_agreement(g_cpu, l_cpu, id_cpu, self.logits.cpu(),
                                  ids.cpu(), ROUTE_MARGIN[d],
                                  moe._capacity(self.cfg, g_cpu.shape[0]))
            calls.append(rec)
            if not rec["flips"]:
                return vals, ids
            rows = torch.tensor([f["token"] for f in rec["flips"]])
            ids = ids.clone()
            ids[rows.to(ids.device)] = id_cpu[rows].to(ids.device)
            return gates.gather(-1, ids), ids
        return fn

    @contextlib.contextmanager
    def attached(self):
        with patched(moe, "router_logits", self._router_logits), \
                patched(moe, "top_k", self._top_k), \
                patched(sys.modules[__name__], "_greedy_logits",
                        self._greedy):
            yield self

    def report(self, dname: str, layers: int) -> list:
        """Per step (0: prefill; then each decode step): choices, agreed
        share, the router logits' largest max-abs and RMS difference over
        the step's calls, flips and excused flips with the excused flip of
        the widest logit gap, the unexcused flips, and the CPU's and
        card's pairs past capacity."""
        out = []
        calls = self.calls.get(dname, [])
        for step in range(0, len(calls), layers):
            part = calls[step:step + layers]
            flips = [{"layer": li, **f} for li, c in enumerate(part)
                     for f in c["flips"]]
            excused = [f for f in flips if f["excused"]]
            n = sum(c["choices"] for c in part)
            agree = sum(c["agree"] for c in part)
            out.append({
                "calls": len(part), "choices": n, "agree_share": agree / n,
                "router_logits": {
                    key: max(c["router_logits"][key] for c in part)
                    for key in ("max_abs_err", "rms_err")},
                "flips": len(flips),
                "excused": len(excused),
                "widest_excused": max(excused, default=None,
                                      key=lambda f: f["logit_gap"]),
                "unexcused": [f for f in flips if not f["excused"]],
                "dropped_pairs": [sum(c["dropped_pairs"][j] for c in part)
                                  for j in (0, 1)]})
        return out

    def by_layer(self, dname: str, layers: int) -> list:
        """Per layer, the router logits' largest RMS difference over the
        steps: how the two sides drift apart with depth."""
        calls = self.calls.get(dname, [])
        return [max(c["router_logits"]["rms_err"]
                    for c in calls[li::layers]) for li in range(layers)]


def check_routing(routing: dict, steps: int, layers: int) -> None:
    """Raises unless each compute dtype held every MoE call of its ``steps``
    steps (prefill and decode) to the CPU's, with its router logits within
    MODEL_TOL and no flip unexcused."""
    for dname, held in routing.items():
        if [s["calls"] for s in held] != [layers] * steps:
            raise AssertionError(f"model_moe {dname}: held MoE calls per "
                                 f"step {[s['calls'] for s in held]}, not "
                                 f"{layers} in each of {steps} steps")
        tol = MODEL_TOL[dname]
        over = [(i, s["router_logits"]) for i, s in enumerate(held)
                if s["router_logits"]["max_abs_err"] > tol["max"]
                or s["router_logits"]["rms_err"] > tol["rms"]]
        if over:
            raise AssertionError(f"model_moe {dname}: router logits outside "
                                 f"{tol} (step, difference): {over[:5]}")
        bad = [(i, f) for i, s in enumerate(held) for f in s["unexcused"]]
        if bad:
            raise AssertionError(f"model_moe {dname}: flips the routing "
                                 f"rule does not excuse (margin "
                                 f"{ROUTE_MARGIN[dname]}; step, flip): "
                                 f"{bad[:5]}")


def serve_moe_phase(card: str) -> dict:
    """The serving entry point at Granite-3.0-1B-A400M's full width with
    the reference's defaults; K6 must launch once per attention call
    (24 x 17 x 16 = 6,528) and every logits tensor must be finite. Then a
    short run (8 requests, counts not read) profiled over 5 decode steps,
    as the Yi-6B serve phase does."""
    cfg = get_config(MOE_ARCH)
    argv = ["--arch", MOE_ARCH, "--device", "cuda", "--seed", "0"]
    served = run_serve(argv)
    served.update(param_bytes(cfg))
    for ln in served["lines"]:
        print(ln, flush=True)
    emit({"phase": "serve_moe", "card": card, **served})
    want = cfg.num_layers * (1 + 16) * (64 // 4)
    if served["launches"]["flash_attention"] != want:
        raise AssertionError(f"serve_moe launched flash_attention "
                             f"{served['launches']['flash_attention']} "
                             f"times, not {want}")
    if not served["logits_finite"]:
        raise AssertionError("serve_moe produced non-finite logits")
    torch.cuda.empty_cache()
    profiled = run_serve(argv + ["--requests", "8"], profile_from=20,
                         n_profile=5)
    emit({"phase": "serve_moe_profile", "card": card,
          "argv": profiled["argv"], "profile": profiled["profile"],
          "logits_finite": profiled["logits_finite"]})
    if not profiled["logits_finite"]:
        raise AssertionError("profiled serve_moe run produced non-finite "
                             "logits")
    return served


def moe_model_phase(cfg, *, layers: int, batch: int = 4, prompt: int = 48,
                    steps: int = 8, dev: str = "cuda") -> dict:
    """``compare_model`` on ``cfg`` cut to ``layers`` under a
    ``_RouteProbe``: the runs and the routing per step in both compute
    dtypes, emitted, then the logits held to MODEL_TOL and the routing by
    ``check_routing``."""
    cfg = cfg.with_(num_layers=layers)
    probe = _RouteProbe(cfg)
    t0 = time.perf_counter()
    with probe.attached():
        runs = compare_model(cfg, batch=batch, prompt=prompt, steps=steps,
                             dev=dev)
    row = {"phase": "model_moe", "arch": cfg.name, "layers": layers,
           "steps": steps, "seconds": time.perf_counter() - t0,
           "route_margin": ROUTE_MARGIN, "runs": runs,
           "routing": {d: probe.report(d, layers) for d in BOTH},
           "router_rms_by_layer": {d: probe.by_layer(d, layers)
                                   for d in BOTH}}
    emit(row)
    check_model(runs)
    check_routing(row["routing"], steps + 1, layers)
    return row


# --------------------------- hybrid: Zamba2 serve and model phases ----------
HYBRID_ARCH = "zamba2-2.7b"
# Depth of the Zamba2 card-vs-CPU model phase, fixed before its first run
# on the card: all 54 Mamba2 layers in their 9 groups, each group followed
# by the shared attention block (the CPU side was estimated at 8-10 s a
# compute dtype from one full-width layer and block timed on an 8-core
# host, as tools/hybrid_drift.py times them). A failing limit is a
# finding, not a reason to cut it. The phase runs at the serve's prompt
# of 48 tokens.
HYBRID_MODEL_LAYERS = 54
# Prompt of one more fault run, in bf16 only: the decode fault that drops
# the oldest key, at 16 tokens (one key of 17 to 24). At the serve's 48
# (one key of 49 to 56) it moved the first attention slot's bf16 logits
# by an RMS of 0.0166, inside MODEL_TOL's 0.018 (run H2 on an H100,
# PERF.md section 6): there the bf16 limit cannot see it, while the f32
# one can (0.0159 against 3e-6).
HYBRID_FAULT_PROMPT = 16
HYBRID_SHORT_FAULT = ("bfloat16", "decode_skips_oldest_key")
# Limit of the free card run, which no slot is fed: at every step, after
# every group and at the logits, the RMS of its difference from the CPU
# at most HYBRID_DRIFT_MULT times the RMS of the CPU's own difference
# from an f64 run of the same weights and tokens (the rounding of the
# compute dtype alone, amplified by the model as the card's is). Two
# implementations that each drift D from the exact stream differ by up
# to 2D; 4 leaves the card twice the CPU's drift. Before this limit was
# set, the card-vs-CPU drift read 8.37e-6 to 1.64e-4 in f32 (run H3) and
# the CPU's f32-vs-f64 drift 5.17e-6 to 9.03e-5 (tools/hybrid_drift.py,
# other weights of the same shapes): a ratio of 1.6-1.8.
HYBRID_DRIFT_MULT = 4.0
# Time box of the two hybrid phases (serve_hybrid and model_hybrid)
# together, stated before their first run.
HYBRID_BOX_S = 240.0


@contextlib.contextmanager
def float64_mode():
    """The port's model in f64, as an exact reference: ``Tensor.float``
    keeps float64 (the port casts to f32 where the reference reads f32)
    and attention takes K6's plain version (K6 takes f32 and bf16 only)."""
    to_f32 = torch.Tensor.float
    torch.Tensor.float = lambda t: (t if t.dtype == torch.float64
                                    else to_f32(t))
    try:
        with patched(port_attention, "flash_attention",
                     lambda f: attn_k.flash_attention_plain):
            yield
    finally:
        torch.Tensor.float = to_f32


def _recording(store: list, only=None):
    """A wrapper of ``transformer._apply_slot`` that appends each slot's
    (name, input, output) on the CPU to ``store`` (``only``: that slot)."""
    def make(orig):
        def fn(cfg, slot, p, x, *a):
            out = orig(cfg, slot, p, x, *a)
            if only is None or slot == only:
                store.append((slot, x.cpu(), out[0].cpu()))
            return out
        return fn
    return make


def _anchored(rec: list, m, params, diffs: list):
    """A wrapper of ``transformer._apply_slot`` that feeds each slot the
    input that ``rec`` (a ``_recording`` of the CPU's run) holds for it,
    and appends to ``diffs`` the ``_diff`` of its output from the
    recorded one in logits, both mapped by the model's own head."""
    def make(orig):
        calls = iter(rec)

        def fn(cfg, slot, p, x, *a):
            name, x_in, x_out = next(calls)
            if name != slot:
                raise AssertionError(f"anchored run: slot {slot}, the "
                                     f"record has {name}")
            out = orig(cfg, slot, p, x_in.to(x.device), *a)
            diffs.append(_diff(m._logits(params, x_out.to(x.device)),
                               m._logits(params, out[0])))
            return out
        return fn
    return make


def _per_slot(diffs: list, n: int, tol: dict) -> dict:
    """An anchored run's ``diffs``: per slot of a step (``n`` of them), the
    largest max-abs and RMS logits difference over the steps; the calls
    held and whether any breaks ``tol``."""
    return {"calls": len(diffs),
            "max_abs_err": [max(c["max_abs_err"] for c in diffs[j::n])
                            for j in range(min(n, len(diffs)))],
            "rms_err": [max(c["rms_err"] for c in diffs[j::n])
                        for j in range(min(n, len(diffs)))],
            "breaks": _breaks(diffs, tol)}


def _drift(cpu, card, exact) -> dict:
    """One point of the free run: the card's RMS difference from the CPU,
    the CPU's from the f64 run, their ratio and whether the card's is
    finite."""
    err = _rms(card.double() - cpu.double())
    ref = _rms(cpu.double() - exact.double())
    return {"rms_err": err, "f64_rms_err": ref,
            "ratio": err / ref if ref else (0.0 if err == 0 else
                                            float("inf")),
            "finite": bool(torch.isfinite(card).all())}


def serve_hybrid_phase(card: str) -> dict:
    """The serving entry point at Zamba2-2.7B's full width with the
    reference's defaults; K6 must launch once per shared-attention call
    (9 groups x 17 x 16 = 2,448) and every logits tensor must be finite.
    Then a short run (8 requests, counts not read) profiled over 5 decode
    steps, as the other serve phases do."""
    cfg = get_config(HYBRID_ARCH)
    argv = ["--arch", HYBRID_ARCH, "--device", "cuda", "--seed", "0"]
    served = run_serve(argv)
    served.update(param_bytes(cfg))
    for ln in served["lines"]:
        print(ln, flush=True)
    emit({"phase": "serve_hybrid", "card": card, **served})
    want = build_model(cfg).n_super * (1 + 16) * (64 // 4)
    if served["launches"]["flash_attention"] != want:
        raise AssertionError(f"serve_hybrid launched flash_attention "
                             f"{served['launches']['flash_attention']} "
                             f"times, not {want}")
    if not served["logits_finite"]:
        raise AssertionError("serve_hybrid produced non-finite logits")
    torch.cuda.empty_cache()
    profiled = run_serve(argv + ["--requests", "8"], profile_from=20,
                         n_profile=5)
    emit({"phase": "serve_hybrid_profile", "card": card,
          "argv": profiled["argv"], "profile": profiled["profile"],
          "logits_finite": profiled["logits_finite"]})
    if not profiled["logits_finite"]:
        raise AssertionError("profiled serve_hybrid run produced non-finite "
                             "logits")
    return served


def hybrid_model_phase(cfg, *, layers: int, batch: int = 4,
                       prompt: int = 48,
                       fault_prompt: int = HYBRID_FAULT_PROMPT,
                       steps: int = 8, dev: str = "cuda") -> dict:
    """``cfg`` cut to ``layers``, card against CPU, with the same weights
    (drawn on ``dev`` from seed 0) and tokens. First an f64 run on
    ``dev`` (``float64_mode``), whose greedy tokens every run at
    ``prompt`` is fed. Then in each compute dtype:

      * the CPU's run, every slot's input and output recorded;
      * the card's free run: after each group (the shared block's output)
        and at the logits, at every step, its RMS difference from the
        CPU's held to ``HYBRID_DRIFT_MULT`` times the CPU's difference
        from the f64 run, and finite (``residual_rms_by_group``,
        ``free_logits``);
      * the card's anchored sound run: each slot (a Mamba2 layer or the
        shared block) fed the CPU's input of that slot, its output held
        in logits, through the model's head, to ``MODEL_TOL``
        (``slot_logits``), as are the final logits and the clear greedy
        tokens (``runs``, as ``check_model`` holds them);
      * each of ``MODEL_FAULTS`` in place of K6, anchored, which must
        break a limit at a slot or at the logits in the dtypes it lists
        (``fault_slots``), but for ``HYBRID_SHORT_FAULT``, which must
        break in the short run:
    then in bf16 the CPU, the anchored sound run and that fault at
    ``fault_prompt`` tokens (``short_fault``), the CPU's greedy tokens
    fed.

    Why anchored: in this model a perturbation grows with depth in exact
    arithmetic (a relative 1e-7 at the input is 1.8e-6 of the stream
    after 54 layers in f64), so end to end the card and the CPU drift
    apart by the amplified rounding of their dtype: after 54 layers the
    CPU's f32 stream is 1.0e-5 of the stream away from its f64 one, past
    MODEL_TOL's 3e-6 RMS, while a slot fed the f64 input reads at most
    6.6e-7 RMS in logits (``tools/hybrid_drift.py``). Each slot fed the
    CPU's input is held for its own rounding, as the MoE phase feeds the
    card the CPU's experts at a flip; the free run is held against the
    drift that rounding alone makes."""
    cfg = cfg.with_(num_layers=layers)
    model = build_model(cfg)
    per_step = model.n_super * (len(model.slots) + 1)
    t0 = time.perf_counter()
    p_dev = init_params(model.param_specs(),
                        torch.Generator(device=dev).manual_seed(0),
                        cfg.param_dtype, dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt)).astype(np.int32))

    def run(m, params, toks, d, feed, hook, fault=None, cache_dtype=None):
        cache = init_params(m.cache_specs(batch, toks.shape[1] + steps),
                            None, cache_dtype or cfg.param_dtype, d)
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(transformer, "_apply_slot", hook))
            if fault is not None:
                stack.enter_context(patched(port_attention,
                                            "flash_attention", fault))
            return _greedy_logits(m, params, cache, toks, steps, d, feed)

    exact: list = []
    with float64_mode():
        p64 = tree_map(lambda t: t.double(), p_dev)
        exact_logits, fed = run(
            build_model(cfg.with_(compute_dtype="float64")), p64, tokens,
            dev, None, _recording(exact, "attn:global"), None, "float64")
        del p64
    row = {"phase": "model_hybrid", "arch": cfg.name, "layers": layers,
           "groups": model.n_super, "prompt": prompt, "steps": steps,
           "drift_mult": HYBRID_DRIFT_MULT, "runs": [],
           "residual_rms_by_group": {}, "free_logits": {},
           "slot_logits": {}, "fault_slots": {}}
    for dname in BOTH:
        m = build_model(cfg.with_(compute_dtype=dname))
        cp_cpu, cp_dev = m.compute_params(p_cpu), m.compute_params(p_dev)
        rec: list = []
        ref, _ = run(m, cp_cpu, tokens, "cpu", fed, _recording(rec))
        free: list = []
        free_logits, _ = run(m, cp_dev, tokens, dev, fed,
                             _recording(free, "attn:global"))
        cpu_groups = [r for r in rec if r[0] == "attn:global"]
        if not len(free) == len(cpu_groups) == len(exact):
            raise AssertionError(f"model_hybrid {dname}: group outputs "
                                 f"{len(free)}, {len(cpu_groups)}, "
                                 f"{len(exact)}")
        points = [_drift(c[2], f[2], e[2])
                  for c, f, e in zip(cpu_groups, free, exact)]
        row["residual_rms_by_group"][dname] = {
            k: [max(p[k] for p in points[g::model.n_super])
                for g in range(model.n_super)]
            for k in ("rms_err", "f64_rms_err", "ratio")}
        row["residual_rms_by_group"][dname]["stream_rms"] = [
            max(_rms(c[2]) for c in cpu_groups[g::model.n_super])
            for g in range(model.n_super)]
        logit_points = [_drift(r, f, e) for r, f, e in
                        zip(ref, free_logits, exact_logits)]
        row["free_logits"][dname] = logit_points
        for where, pts in (("group", points), ("logits", logit_points)):
            bad = [p for p in pts if not p["finite"]
                   or p["rms_err"] > HYBRID_DRIFT_MULT * p["f64_rms_err"]]
            if bad:
                raise AssertionError(
                    f"model_hybrid {dname}: the free run's {where} drift "
                    f"from the CPU exceeds {HYBRID_DRIFT_MULT}x the CPU's "
                    f"from f64: {bad[0]}")

        def anchored(toks, feed, rec, fault=None):
            diffs: list = []
            got, _ = run(m, cp_dev, toks, dev, feed,
                         _anchored(rec, m, cp_dev, diffs), fault)
            if len(diffs) != len(rec):
                raise AssertionError(f"model_hybrid {dname}: held "
                                     f"{len(diffs)} slots of {len(rec)}")
            return got, _per_slot(diffs, per_step, MODEL_TOL[dname])

        got, row["slot_logits"][dname] = anchored(tokens, fed, rec)
        steps_rec = {"compute_dtype": dname, "layers": layers,
                     "tol": MODEL_TOL[dname], "faults": {},
                     "steps": [_step(r, g, MODEL_TOL[dname])
                               for r, g in zip(ref, got)]}
        row["fault_slots"][dname] = {}
        for name, (make, _) in MODEL_FAULTS.items():
            bad, slots = anchored(tokens, fed, rec, make)
            steps_rec["faults"][name] = [_diff(r, b) for r, b in
                                         zip(ref, bad)]
            row["fault_slots"][dname][name] = slots
        row["runs"].append(steps_rec)
        del rec, cp_cpu, cp_dev
    # The short fault run, in its dtype only.
    dname, fault = HYBRID_SHORT_FAULT
    m = build_model(cfg.with_(compute_dtype=dname))
    cp_cpu, cp_dev = m.compute_params(p_cpu), m.compute_params(p_dev)
    short = tokens[:, :fault_prompt]
    rec = []
    ref, fed_short = run(m, cp_cpu, short, "cpu", None, _recording(rec))
    row["short_fault"] = {"compute_dtype": dname, "fault": fault,
                          "prompt": fault_prompt}
    for name, make in (("sound", None), (fault, MODEL_FAULTS[fault][0])):
        diffs: list = []
        got, _ = run(m, cp_dev, short, dev, fed_short,
                     _anchored(rec, m, cp_dev, diffs), make)
        row["short_fault"][name] = {
            **_per_slot(diffs, per_step, MODEL_TOL[dname]),
            "logits": [_diff(r, g) for r, g in zip(ref, got)]}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    for d in BOTH:
        held = row["slot_logits"][d]
        if held["breaks"]:
            raise AssertionError(
                f"model_hybrid {d}: an anchored slot's logits outside "
                f"{MODEL_TOL[d]}: max {max(held['max_abs_err'])}, rms "
                f"{max(held['rms_err'])}")
    for res in row["runs"]:
        d, tol = res["compute_dtype"], res["tol"]
        for i, s in enumerate(res["steps"]):
            if _breaks([s], tol) or not s["clear_tokens_equal"]:
                raise AssertionError(f"model_hybrid {d} step {i}: the "
                                     f"anchored logits {s} outside {tol} "
                                     f"or clear greedy tokens differ")
        for name, steps_ in res["faults"].items():
            if (d, name) == HYBRID_SHORT_FAULT or \
                    d not in MODEL_FAULTS[name][1]:
                continue
            if not (_breaks(steps_, tol)
                    or row["fault_slots"][d][name]["breaks"]):
                raise AssertionError(f"model_hybrid {d}: the fault {name} "
                                     f"stays inside the limits {tol}")
    sf, tol = row["short_fault"], MODEL_TOL[dname]
    if sf["sound"]["breaks"] or _breaks(sf["sound"]["logits"], tol):
        raise AssertionError(f"model_hybrid {dname} at prompt "
                             f"{fault_prompt}: the sound anchored run "
                             f"breaks {tol}")
    if not (sf[fault]["breaks"] or _breaks(sf[fault]["logits"], tol)):
        raise AssertionError(f"model_hybrid {dname} at prompt "
                             f"{fault_prompt}: the fault {fault} stays "
                             f"inside the limits {tol}")
    return row


# --------------------------- train phase: K6's backward, MiniCPM-2B ----------
TRAIN_ARCH = "minicpm-2b"
# Time box of the train phase's five parts together, stated before its
# first run; reported, as FILES_BOX_S is.
TRAIN_BOX_S = 150.0
# K6's backward against its plain version on the same inputs (the kernel
# forward's o and lse): per gradient, the largest difference over the
# largest value of the plain version's gradient and the relative RMS
# difference. Both compute in f32 from the same inputs, in other orders;
# bf16 also rounds each gradient to bf16 once. About 6x the sound
# kernels' largest readings on an NVIDIA H100 80GB HBM3 at 700 W (f32
# 7.7e-6 and 3.5e-6; bf16 2.3e-3 and 1.3e-4, Yi-6B's 4096-token dK;
# PERF.md section 6).
BWD_TOL = {"float32": {"max_rel": 5e-5, "rel_rms": 2e-5},
           "bfloat16": {"max_rel": 2e-2, "rel_rms": 2e-3}}
# The forward's log-sum-exp against the plain version's, absolute, on the
# rows that keep a key (1.9e-6 read).
LSE_TOL = 1e-5
MINICPM_HEADS = {"h": 36, "kv": 36, "hd": 64}
# The timed shapes: every causal (prefill) case of ATTN_CASES and
# MiniCPM-2B's training shapes, the entry point's defaults (batch 8 x 64) and
# one 4096-token sequence; and, untimed, every causal ATTN_EDGES case.
BWD_CASES = [*[(n, s) for n, s in ATTN_CASES if s["causal"]],
             ("minicpm_train_b8_s64", dict(b=8, sq=64, sk=64, causal=True,
                                           **MINICPM_HEADS)),
             ("minicpm_train_b1_s4096", dict(b=1, sq=4096, sk=4096,
                                             causal=True, **MINICPM_HEADS))]
BWD_EDGES = [(n, s) for n, s in ATTN_EDGES if s["causal"]]
BWD_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_dkv",
               "flash_attention_bwd_dq")
# The kernels line reports the main path's call: MiniCPM-2B at the
# entry point's defaults, in the compute dtype.
BWD_REPORTED = "minicpm_train_b8_s64/bfloat16"
# The full-width runs of launch.train.main: the entry point's defaults for 8
# steps, then one 4096-token sequence for 4.
TRAIN_RUNS = (("defaults", ["--batch", "8", "--seq", "64", "--steps", "8"]),
              ("seq4096", ["--batch", "1", "--seq", "4096", "--steps", "4"]))
# The run's step that runs under the profiler (the last: the median of
# the steps after the first moves by at most one place).
TRAIN_PROFILE_AT = {"defaults": 7, "seq4096": 3}
# The card-vs-CPU step: MiniCPM-2B at full width cut to 2 layers
# (405,220,608 params), batch 4 x 64, launch/train.py's TrainConfig at 100
# steps. f32: the loss to 1e-5 relative, the grad norm to 1e-4 relative
# and each leaf's gradient to 1e-4 relative RMS; bf16: the loss and each
# leaf's gradient within TRAIN_BF16_MULT times the CPU's own bf16 reading
# against an f64 run on the CPU (as HYBRID_DRIFT_MULT), the grad norm as
# below. In both, the
# params after the update within TRAIN_UPDATE_TOL (max abs) of AdamW run
# on the CPU on the card's own gradients (the update from the card's
# params and the CPU's differ on elements whose gradient is within a few
# eps of 0, so those are reported, not held). Fixed before the first
# chip run; each of TRAIN_FAULTS, run on the card in place of the
# backward in f32, must break the f32 limits. One change after a failing
# run: in bf16 the grad norm is no longer held to 4x the CPU's own
# |norm(bf16) - norm(f64)|, a single draw of rounding noise that can
# cancel toward 0 (1.37e-6 relative on an NVIDIA H100 80GB HBM3 at 700
# W, a limit of 5.5e-6 against the card's 3.88e-5, while every leaf's
# gradient read 0.65-0.84 of its limit); it is held to the f32 limit
# against global_norm of the card's own gradients on the CPU, and its
# difference from the CPU's bf16 norm is reported with that ratio. The
# gradients it is the norm of stay held per leaf.
TRAIN_CMP = {"layers": 2, "batch": 4, "seq": 64}
TRAIN_F32_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "grad_rel_rms": 1e-4}
TRAIN_BF16_MULT = 4.0
TRAIN_UPDATE_TOL = 1e-6
# The checkpoint restart at reduced width, as tests/test_runtime.py:58-60.
CKPT_TOL = {"rtol": 1e-5, "atol": 1e-6}


def _bwd_inputs(shape: dict, dname: str, gen):
    q, k, v = _attn_inputs(shape, getattr(torch, dname), gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    return q, k, v, do


def _grad_errors(got, want) -> dict:
    out = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        d = (g.float() - w.float()).abs()
        top, worst = float(w.float().abs().max()), float(d.max())
        out[name] = {"max_abs_err": worst,
                     "max_rel": worst / top if top else float(worst > 0),
                     "rel_rms": _rms(d) / max(_rms(w), 1e-30)}
    return out


def _held_bwd(name: str, shape: dict, dname: str, gen):
    """K6's forward with its lse, then the backward kernels and their plain
    version on its output; raises beyond BWD_TOL or LSE_TOL, or if the
    forward's output with the lse differs from the serving call's."""
    q, k, v, do = _bwd_inputs(shape, dname, gen)
    kw = _attn_kw(shape)
    o, lse = attn_k.flash_attention_fwd(q, k, v, **kw)
    if not torch.equal(o, attn_k.flash_attention(q, k, v, **kw)):
        raise AssertionError(f"flash_attention {name} {dname}: the output "
                             f"with the lse differs from the serving call's")
    lse_plain = attn_k.flash_attention_fwd_plain(q, k, v, **kw)[1]
    kept = lse_plain > -1e30
    lse_err = float((lse - lse_plain)[kept].abs().max())
    got = attn_k.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = attn_k.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    delta = attn_k.bwd_prep(o, do)
    delta_plain = (do.float() * o.float()).sum(-1).transpose(1, 2)
    torch.cuda.synchronize()
    err = _grad_errors(got, want)
    d = float((delta - delta_plain).abs().max())
    err["delta"] = {"max_abs_err": d, "max_rel": d / float(
        delta_plain.abs().max()), "rel_rms": _rms(delta - delta_plain)
        / _rms(delta_plain)}
    tol = BWD_TOL[dname]
    for g, e in err.items():
        if not (e["max_rel"] <= tol["max_rel"]
                and e["rel_rms"] <= tol["rel_rms"]):
            raise AssertionError(f"flash_attention backward {name} {dname} "
                                 f"{g}: {e} outside {tol}")
    if not lse_err <= LSE_TOL:
        raise AssertionError(f"flash_attention {name} {dname}: lse err "
                             f"{lse_err} > {LSE_TOL}")
    return (q, k, v, do, o, lse), {"lse_max_err": lse_err, "errors": err}


def _bwd_bounds(shape: dict, esize: int, dname: str) -> dict:
    """Each backward kernel's bound and the whole backward's: the bytes it
    must move (its inputs read once, its outputs written once; of k and v
    the rows some query keeps) at the memory rate, or its operations on
    the kept pairs at the peak rate of the dtype (bf16: the tensor cores):
    dK/dV 8 hd (S, dP, dK, dV), dQ 6 hd (S, dP, dQ), the backward 10 hd
    (S, dP, dQ, dK, dV once each); D 2 hd a row outside the tensor cores."""
    b, sq, sk, h, kvh, hd = (shape[x] for x in ("b", "sq", "sk", "h", "kv",
                                                "hd"))
    kw = _attn_kw(shape)
    rows_kv = min(sq, sk) if kw["causal"] else sk
    qo = b * sq * h * hd * esize                 # one [B, Sq, H, hd]
    kv_in = b * rows_kv * kvh * hd * esize       # one of k, v as read
    kv_out = b * sk * kvh * hd * esize           # one of dk, dv
    rows = b * h * sq * 4                        # lse or D
    pairs = _kept_pairs(sq, sk, kw["causal"], kw["window"]) * b * h
    rate = BF16_OPS_PER_S if dname == "bfloat16" else OPS_PER_S
    return {
        "flash_attention_bwd_prep": bound(2 * qo + rows, 2 * hd * b * sq * h),
        "flash_attention_bwd_dkv": bound(2 * qo + 2 * kv_in + 2 * rows
                                         + 2 * kv_out, 8 * hd * pairs, rate),
        "flash_attention_bwd_dq": bound(2 * qo + 2 * kv_in + 2 * rows + qo,
                                        6 * hd * pairs, rate),
        "backward": bound(3 * qo + 2 * kv_in + rows + qo + 2 * kv_out,
                          10 * hd * pairs, rate),
        "kept_pairs": pairs}


def check_attention_bwd(gen) -> dict:
    """K6's backward against its plain version at every BWD_CASES shape
    (timed) and BWD_EDGES shape (not timed), in bf16 and f32. Times the
    whole backward's call, each kernel's call and device time, the plain
    version and SDPA's backward (same mask; none with a softcap)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    out, edges = {}, {}
    for name, shape in BWD_EDGES:
        for dname in ("bfloat16", "float32"):
            edges[f"{name}/{dname}"] = {"shape": shape,
                                       **_held_bwd(name, shape, dname, gen)[1]}
    for name, shape in BWD_CASES:
        kw = _attn_kw(shape)
        for dname in ("bfloat16", "float32"):
            (q, k, v, do, o, lse), err = _held_bwd(name, shape, dname, gen)
            reps = 5 if shape["sq"] >= 4096 else 25
            delta = attn_k.bwd_prep(o, do)
            calls = {
                "flash_attention_bwd_prep": lambda: attn_k.bwd_prep(o, do),
                "flash_attention_bwd_dkv": lambda: attn_k.bwd_dkv(
                    q, k, v, do, lse, delta, **kw),
                "flash_attention_bwd_dq": lambda: attn_k.bwd_dq(
                    q, k, v, do, lse, delta, **kw)}
            whole = lambda: attn_k.flash_attention_bwd(  # noqa: E731
                q, k, v, o, lse, do, **kw)
            row = {"shape": shape, **err, "tol": BWD_TOL[dname],
                   "ms": cuda_ms(whole, reps),
                   "call_ms": {kn: cuda_ms(fn, reps)
                               for kn, fn in calls.items()},
                   "device_ms": {kn: kernel_device_ms(whole, kn + "_kernel",
                                                      reps)
                                 for kn in BWD_KERNELS},
                   "plain_ms": cuda_ms(lambda: attn_k.flash_attention_bwd_plain(
                       q, k, v, o, lse, do, **kw), reps),
                   "plain_prep_ms": cuda_ms(lambda: (
                       do.float() * o.float()).sum(-1), reps),
                   **_bwd_bounds(shape, q.element_size(), dname),
                   "library_ms": None}
            if not kw["softcap"]:
                mask = (attn_k.keep_mask(shape["sq"], shape["sk"],
                                         kw["window"], q.device)
                        if kw["window"] else None)
                qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                lib_out = sdpa(qt, kt, vt, attn_mask=mask,
                               is_causal=kw["causal"] and mask is None,
                               scale=shape["hd"] ** -0.5, enable_gqa=True)
                dot = do.transpose(1, 2)
                row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (qt, kt, vt), dot, retain_graph=True), reps)
                del qt, kt, vt, lib_out
            out[f"{name}/{dname}"] = row
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    return {"cases": out, "edges": edges}


def _profiled(at: int, out: dict):
    """A wrapper of ``make_train_step`` whose step number ``at`` runs under
    the CUDA profiler (device activity only); ``out`` gets the step's wall
    ms, device ms, busy share, K6's forward and backward shares and the
    ten largest device times."""
    from torch.profiler import ProfilerActivity, profile

    def make(orig):
        def mk(*a, **kw):
            step, calls = orig(*a, **kw), [0]

            def fn(*sa):
                calls[0] += 1
                if calls[0] - 1 != at:
                    return step(*sa)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t = time.perf_counter()
                    res = step(*sa)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t) * 1e3
                dev: dict = {}
                for e in prof.key_averages():
                    us = getattr(e, "self_device_time_total", 0.0)
                    if us > 0:
                        dev[e.key] = dev.get(e.key, 0.0) + us
                total = sum(dev.values()) / 1e3
                share = lambda pat: (sum(  # noqa: E731
                    v for k, v in dev.items() if pat in k) / 1e3 / total
                    if total else None)
                top = sorted(dev.items(), key=lambda kv: -kv[1])[:10]
                out.update({
                    "step": at, "wall_ms": wall, "device_ms": total,
                    "device_busy_share": total / wall,
                    "flash_attention_share": share("flash_attention_kernel"),
                    "flash_attention_bwd_share": share("flash_attention_bwd"),
                    "device_ms_top": [[k[:100], v / 1e3] for k, v in top]})
                return res
            return fn
        return mk
    return make


def train_run(card: str, name: str, argv: list, profile_at=None) -> dict:
    """``launch.train.main`` at MiniCPM-2B's full width on the card: every
    loss finite; K6's forward launched once a layer and step, twice with
    remat "full" (the recompute), and each backward kernel once a layer
    and step. With ``profile_at``, that step runs under the profiler."""
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    steps = int(argv[argv.index("--steps") + 1])
    full = ["--arch", TRAIN_ARCH, "--device", "cuda", "--seed", "0",
            "--log-every", "1", *argv]
    buf = io.StringIO()
    prof: dict = {}
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(contextlib.redirect_stdout(buf))
        if profile_at is not None:
            stack.enter_context(patched(train_entry, "make_train_step",
                                        _profiled(profile_at, prof)))
        losses = train_entry.main(full)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    lines = buf.getvalue().splitlines()
    tag = "[train] card "
    stats = json.loads([ln for ln in lines if ln.startswith(tag)][-1][
        len(tag):])
    layers = sum(n for n, _ in attention_layer_count(cfg))
    fwd_per_step = layers * (2 if cfg.remat == "full" else 1)
    row = {"phase": "train", "run": name, "card": card, "argv": full,
           "wall_s": wall, "losses": losses, "remat": cfg.remat,
           "attention_layers": layers, "launches": launches,
           "want_launches": {"flash_attention": fwd_per_step * steps,
                             **{k: layers * steps for k in BWD_KERNELS}},
           **stats, "profile": prof or None, "lines": lines}
    emit(row)
    if not all(np.isfinite(losses)) or len(losses) != steps:
        raise AssertionError(f"train {name}: losses {losses}")
    for k, want in row["want_launches"].items():
        if launches[k] != want:
            raise AssertionError(f"train {name}: {k} launched {launches[k]} "
                                 f"times, not {want}")
    return row


def _fault_dq_without_diagonal(f):
    """The backward with the diagonal key's term left out of dQ."""
    def fn(q, k, v, o, lse, do, *, causal, window, softcap):
        dq, dk, dv = attn_k.flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, window=window,
            softcap=softcap)
        g = q.shape[2] // k.shape[2]
        n = min(q.shape[1], k.shape[1])
        qf, of, df = (t[:, :n].float() for t in (q, o, do))
        kf, vf = (t[:, :n].float().repeat_interleave(g, 2) for t in (k, v))
        scale = q.shape[-1] ** -0.5
        s = (qf * kf).sum(-1) * scale                     # [B, n, H]
        t = torch.tanh(s / softcap) if softcap else None
        if softcap:
            s = softcap * t
        p = torch.exp(s - lse[..., :n].transpose(1, 2))
        ds = p * ((df * vf).sum(-1) - (df * of).sum(-1))
        if softcap:
            ds = ds * (1 - t * t)
        dq = dq.float()
        dq[:, :n] -= scale * ds[..., None] * kf
        return dq.to(q.dtype), dk, dv
    return fn


def _fault_dkv_without_last_tile(f):
    """The backward with the last tile of 32 keys (the kernels' kBK) left
    without dK and dV."""
    def fn(q, k, v, o, lse, do, **kw):
        dq, dk, dv = attn_k.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                      **kw)
        last = (k.shape[1] - 1) // 32 * 32
        dk[:, last:] = 0
        dv[:, last:] = 0
        return dq, dk, dv
    return fn


def _fault_lse_without_log_l(f):
    """The forward's lse without log l (the row max alone)."""
    def fn(q, k, v, *, causal, window, softcap):
        o, _ = f(q, k, v, causal=causal, window=window, softcap=softcap)
        m = attn_k._plain(q, k, v, causal, window, softcap)[1]
        return o, m.squeeze(-1).contiguous()
    return fn


TRAIN_FAULTS = {
    "dq_without_diagonal_key": ("flash_attention_bwd",
                                _fault_dq_without_diagonal),
    "dkv_without_last_key_tile": ("flash_attention_bwd",
                                  _fault_dkv_without_last_tile),
    "lse_without_log_l": ("flash_attention_fwd", _fault_lse_without_log_l),
}


def _leaf_rel(a, b, dev: str = "cuda") -> list:
    """Per leaf (JAX's order): RMS(a - b) / RMS(b), in f64 on ``dev``."""
    out = []
    for x, y in zip(flatten(a), flatten(b)):
        x, y = (t.detach().to(dev, torch.float64) for t in (x, y))
        out.append(_rms(x - y) / max(_rms(y), 1e-300))
    return out


def _step_readings(model, params, opt, batch, tcfg):
    """(loss, grads, grad norm, params after the update) of one step."""
    loss, grads = training.loss_and_grads(model, params, batch)
    with torch.no_grad():
        after, _, met = training.adamw_update(params, grads, opt, tcfg)
    return float(loss), grads, float(met["grad_norm"]), after


def _train_breaks(r: dict) -> list:
    tol = TRAIN_F32_TOL
    bad = []
    if not r["loss_rel"] <= tol["loss"]:
        bad.append("loss")
    if not r["grad_norm_rel"] <= tol["grad_norm"]:
        bad.append("grad_norm")
    if not max(r["grad_rel_rms"]) <= tol["grad_rel_rms"]:
        bad.append("grads")
    return bad


def train_compare(dev: str = "cuda") -> dict:
    """One train step of MiniCPM-2B at full width cut to
    TRAIN_CMP["layers"], on the card and on the CPU from the same params,
    in f32 and bf16 compute, with an f64 run on the CPU for the bf16
    limits; then each of TRAIN_FAULTS on the card in f32."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).with_(num_layers=TRAIN_CMP["layers"])
    tcfg = training.TrainConfig(learning_rate=1e-3, total_steps=100,
                                warmup_steps=5)
    spec = build_model(cfg).param_specs()
    p_dev = init_params(spec, torch.Generator(dev).manual_seed(0),
                        cfg.param_dtype, dev)
    o_dev = init_params(training.opt_state_specs(spec, cfg), None,
                        cfg.optstate_dtype, dev)
    p_cpu, o_cpu = (tree_map(lambda t: t.cpu(), x) for x in (p_dev, o_dev))
    host = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_CMP["seq"],
                                  global_batch=TRAIN_CMP["batch"])).batch(0)
    b_cpu = {k: torch.from_numpy(v) for k, v in host.items()}
    b_dev = {k: t.to(dev) for k, t in b_cpu.items()}
    seconds = {"init": time.perf_counter() - t0}
    t0 = time.perf_counter()
    with float64_mode():
        p64 = tree_map(lambda t: t.double(), p_cpu)
        l64, g64 = training.loss_and_grads(
            build_model(cfg.with_(compute_dtype="float64")), p64, b_cpu)
        l64 = float(l64)
        n64 = float(training.global_norm(g64))
    seconds["cpu_f64"] = time.perf_counter() - t0
    runs = []
    for dname in ("float32", "bfloat16"):
        m = build_model(cfg.with_(compute_dtype=dname))
        t0 = time.perf_counter()
        lc, gc, nc, ac = _step_readings(m, p_cpu, o_cpu, b_cpu, tcfg)
        seconds[f"cpu_{dname}"] = time.perf_counter() - t0
        gc = tree_map(lambda t: t.to(dev), gc)      # compared on the card
        t0 = time.perf_counter()
        ld, gd, nd, ad = _step_readings(m, p_dev, o_dev, b_dev, tcfg)
        torch.cuda.synchronize()
        seconds[f"card_{dname}"] = time.perf_counter() - t0
        # AdamW on the CPU from the card's gradients: the card's update.
        t0 = time.perf_counter()
        with torch.no_grad():
            ax = training.adamw_update(
                p_cpu, tree_map(lambda t: t.cpu(), gd), o_cpu, tcfg)[0]
        update_err = max(float((a - b.to(a.device)).abs().max())
                         for a, b in zip(flatten(ad), flatten(ax)))
        del ax
        r = {"compute_dtype": dname, "loss": [ld, lc, l64],
             "grad_norm": [nd, nc, n64],
             "loss_rel": abs(ld - lc) / abs(lc),
             "grad_norm_rel": abs(nd - nc) / abs(nc),
             "grad_rel_rms": _leaf_rel(gd, gc, dev),
             "update_max_abs_err": update_err,
             "params_after_rel_rms": _leaf_rel(ad, ac, dev)}
        if dname == "bfloat16":
            ref = {"loss_rel": abs(lc - l64) / abs(l64),
                   "grad_norm_rel": abs(nc - n64) / abs(n64),
                   "grad_rel_rms": _leaf_rel(gc, g64, dev)}
            r["cpu_vs_f64"] = ref
            r["grad_norm_ratio"] = r["grad_norm_rel"] / max(
                ref["grad_norm_rel"], 1e-300)
            own = float(training.global_norm(tree_map(lambda t: t.cpu(), gd)))
            r["grad_norm_own_rel"] = abs(nd - own) / abs(own)
            r["limits"] = {
                "loss_rel": TRAIN_BF16_MULT * ref["loss_rel"],
                "grad_norm_own_rel": TRAIN_F32_TOL["grad_norm"],
                "grad_rel_rms": [TRAIN_BF16_MULT * x
                                 for x in ref["grad_rel_rms"]]}
            held = (r["loss_rel"] <= r["limits"]["loss_rel"]
                    and r["grad_norm_own_rel"]
                    <= r["limits"]["grad_norm_own_rel"]
                    and all(x <= y for x, y in zip(
                        r["grad_rel_rms"], r["limits"]["grad_rel_rms"])))
        else:
            r["limits"] = TRAIN_F32_TOL
            held = not _train_breaks(r)
            r["faults"] = {}
            for fname, (target, make) in TRAIN_FAULTS.items():
                with patched(attn_k, target, make):
                    lf, gf = training.loss_and_grads(m, p_dev, b_dev)
                fr = {"loss_rel": abs(float(lf) - lc) / abs(lc),
                      "grad_norm_rel": abs(float(training.global_norm(gf))
                                           - nc) / abs(nc),
                      "grad_rel_rms": _leaf_rel(gf, gc, dev)}
                fr["breaks"] = _train_breaks(fr)
                r["faults"][fname] = fr
                del gf
        r["held"] = held and update_err <= TRAIN_UPDATE_TOL
        seconds[f"held_{dname}"] = time.perf_counter() - t0
        runs.append(r)
        del gc, gd, ac, ad
    row = {"phase": "train_compare", "layers": cfg.num_layers,
           "params": sum(t.numel() for t in flatten(p_cpu)),
           "update_tol": TRAIN_UPDATE_TOL, "runs": runs, "seconds": seconds}
    emit(row)
    for r in runs:
        if not r["held"]:
            raise AssertionError(f"train_compare {r['compute_dtype']}: "
                                 f"outside the limits: {r}")
        for fname, fr in r.get("faults", {}).items():
            if not fr["breaks"]:
                raise AssertionError(f"train_compare: the fault {fname} "
                                     f"stays inside the f32 limits: {fr}")
    return row


def train_checkpoint(dev: str = "cuda") -> dict:
    """At reduced width on the card, in a temporary directory: 4 straight
    steps equal 2 steps, an async save, a restore and 2 more (CKPT_TOL);
    the checkpoint restores in the CPU port to the card's state, exactly."""
    cfg = reduced(get_config(TRAIN_ARCH))
    model = build_model(cfg)
    spec = model.param_specs()
    params = init_params(spec, torch.Generator(dev).manual_seed(0),
                         cfg.param_dtype, dev)
    opt = init_params(training.opt_state_specs(spec, cfg),
                      torch.Generator(dev).manual_seed(1),
                      cfg.optstate_dtype, dev)
    step = training.make_train_step(model, training.TrainConfig(
        learning_rate=1e-3, warmup_steps=2, total_steps=50))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4))

    def run(p, o, n, start=0):
        for i in range(start, start + n):
            p, o, _ = step(p, o, data.device_batch(i, dev))
        return p, o

    p4, _ = run(params, opt, 4)
    p2, o2 = run(params, opt, 2)
    base = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        ck = Checkpointer(os.path.join(base, "ckpt"), keep=2, async_save=True)
        ck.save(2, {"params": p2, "opt": o2})
        ck.wait()
        restored, at = ck.restore({"params": p2, "opt": o2})
        pr, _ = run(restored["params"], restored["opt"], 2, start=2)
        worst = 0.0
        for a, b in zip(flatten(p4), flatten(pr)):
            np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                       **CKPT_TOL)
            worst = max(worst, float((a - b).abs().max()))
        like = tree_map(lambda t: torch.empty_like(t, device="cpu"),
                        {"params": p2, "opt": o2})
        on_cpu, at_cpu = Checkpointer(os.path.join(base, "ckpt")).restore(like)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(
            flatten({"params": p2, "opt": o2}), flatten(on_cpu)))
        files = sorted(os.listdir(os.path.join(base, "ckpt", "step_2")))
    finally:
        shutil.rmtree(base, ignore_errors=True)
    row = {"phase": "train_checkpoint", "restored_at": at,
           "restart_max_abs_err": worst, "tol": CKPT_TOL,
           "cpu_restore_at": at_cpu, "cpu_restore_equal": same,
           "files": len(files)}
    emit(row)
    if at != 2 or at_cpu != 2 or not same:
        raise AssertionError(f"train_checkpoint: {row}")
    return row


def train_phase(card: str) -> dict:
    """The five parts of the train phase, timed against TRAIN_BOX_S."""
    seconds = {}
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bwd = check_attention_bwd(gen)
    seconds["kernels"] = time.perf_counter() - t0
    emit({"phase": "kernels_attention_bwd", "card": card,
          "tol": BWD_TOL, "lse_tol": LSE_TOL, **bwd})
    torch.cuda.empty_cache()
    runs = {}
    for name, argv in TRAIN_RUNS:
        t0 = time.perf_counter()
        runs[name] = train_run(card, name, argv, TRAIN_PROFILE_AT[name])
        seconds[f"run_{name}"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_compare()
    seconds["compare"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_checkpoint()
    seconds["checkpoint"] = time.perf_counter() - t0
    total = sum(seconds.values())
    emit({"phase": "train_seconds", "card": card, **seconds, "total": total,
          "box_s": TRAIN_BOX_S, "within_box": total <= TRAIN_BOX_S,
          "reduced": ["the card-vs-CPU step cut to 2 of 40 layers",
                      "no full-width checkpoint (32.7 GB on the card "
                      "host's 9p)"]})
    return {"bwd": bwd, "runs": runs}


# --------------------------- main --------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA GPU", file=sys.stderr)
        return 2
    # f32 products in full f32 on the card (no TF32), as on the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    lib = build.build(verbose=True)
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, ROOT)})

    # Kernel phase: its launches are comparisons; the counts are zeroed
    # before each main path below.
    checked = check_kernels(
        "cuda", merge_shapes=[(2048, 2048), (2048, 20480), (16384, 131072),
                              (131072, 1 << 20), (1 << 20, 1 << 20)],
        ingest_n=4096, sst_keys=2048, n_queries=4096,
        lookup_kw={"tier_tables": 512, "table_keys": 2048,
                   "store_sizes": [4, 4, 8, 32, 96, 368],
                   "pool_shapes": POOL_LOOKUPS})
    torch.cuda.synchronize()
    timing = time_kernels(checked["timed"])
    emit({"phase": "kernels", "card": card, "max_abs_err": checked["err"],
          "view_bytes": checked["view_bytes"], "k1_cases": checked["k1_cases"],
          "lookup_cases": checked["lookup_cases"],
          "timing": timing})
    emit({"phase": "host_split", "card": card, "ns": host_split(
        checked["timed"])})
    # K6 at the serving path's shapes and two long prefills, bf16 and f32.
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    attn = check_attention(gen)
    edges = check_attention_edges(gen)
    emit({"phase": "kernels_attention", "card": card, "tol": ATTN_TOL,
          "seconds": time.perf_counter() - t0, "cases": attn,
          "edges": edges})
    checked["err"]["flash_attention"] = max(
        c["max_abs_err"] for c in [*attn.values(), *edges.values()])
    timing["flash_attention"] = attn[ATTN_REPORTED]

    # Staged service phase (device pool off): the default path.
    service_kw = dict(n_keys=1 << 20, batch=4096, n_mixed=SERVICE_MIXED,
                      gets=2048, puts=2048, deletes=64, scans=16,
                      profile_submits=8)
    # Crash points for the recovery phase: the durable pair and the live
    # state after the staged load, the staged mixed part and the adaptive
    # mixed part (taken between parts, outside the timed windows).
    points: dict = {}

    def keep_points(tag, parts):
        def on_part(part, svc, oracle):
            if part in parts:
                points[f"{tag} {part}"] = crash_point(svc.store, oracle)
        return on_part

    # The staged store's durable state after submit FILES_SUBMITS, which
    # the files phase's stream must reach (taken outside the timed window).
    staged_mark: dict = {}
    keep_staged = keep_points("staged", ("load", "mixed"))

    def staged_on_part(part, svc, oracle):
        if part == "mark":
            staged_mark.update(durable(svc.store))
        keep_staged(part, svc, oracle)

    t0 = time.perf_counter()
    reset_sst_ids()
    zero_counts()
    staged = run_service("cuda", cfg_kw={
        "max_log_bytes": SERVICE_MAX_LOG_BYTES},
        on_part=staged_on_part, mark_at=FILES_SUBMITS, **service_kw)
    torch.cuda.synchronize()
    staged["launches"] = dict(LAUNCHES)
    staged["wall_s"] = time.perf_counter() - t0
    staged["k5_launches_per_submit"] = (staged["launches"]["bloom_probe"]
                                        / service_kw["n_mixed"])
    staged["k1"] = k1_per_call(staged)
    emit({"phase": "service", "card": card, **staged})
    missing = [k for k in ("merge_pair", "bloom_build", "bloom_probe")
               if staged["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the staged path: "
                             f"{missing}")
    if staged["k1"]["launches"] > staged["k1"]["calls"]:
        raise AssertionError(f"K1 launched more than once per merge_runs or "
                             f"ingest_run call: {staged['k1']}")

    # Pool service phase: the same stream with the device page pool on and
    # the store-scope fused reads, then a read-only tail (YCSB C).
    t0 = time.perf_counter()
    reset_sst_ids()
    zero_counts()
    pooled = run_service("cuda", cfg_kw={
        "max_log_bytes": SERVICE_MAX_LOG_BYTES,
        "device_pool_bytes": POOL_BYTES, "fused_scope": "store"},
        n_tail=32, **service_kw)
    torch.cuda.synchronize()
    pooled["launches"] = dict(LAUNCHES)
    pooled["wall_s"] = time.perf_counter() - t0
    pooled["k1"] = k1_per_call(pooled)
    emit({"phase": "pool_service", "card": card, **pooled})
    same_as_staged(staged, pooled)
    # K5 does not run here: a store-view miss admits every page of the
    # tree, so the per-tier loop that follows finds each tier resident.
    # The tier-scope replay below holds K5 on the pool path.
    missing = [k for k in ("probe_store", "probe_tier")
               if pooled["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the pool path: "
                             f"{missing}")
    for k in ("probe_store", "probe_tier"):
        if pooled["launches"][k] != \
                pooled["lookup_shapes"][k]["launching_calls"]:
            raise AssertionError(f"{k} launched {pooled['launches'][k]} "
                                 f"times, not once per call: "
                                 f"{pooled['lookup_shapes'][k]}")
    if not pooled["tail"]["pool"]["store_hits"] > \
            pooled["mixed"]["pool"]["store_hits"]:
        raise AssertionError("the read-only tail was never served by the "
                             "one-launch store path")

    # Adaptive phase: the staged stream over 4 shards under the §5 tuner;
    # then the HBM arbiter over the pool phase's store and a KV pool.
    seconds = {}
    t0 = time.perf_counter()
    adaptive_phase(card, staged, service_kw,
                   on_part=keep_points("adaptive", ("mixed",)))
    seconds["adaptive"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arbiter_phase(card, service_kw)
    seconds["arbiter"] = time.perf_counter() - t0

    # Card-vs-CPU replays of one seeded stream: pool off, then the pool on
    # in each fused scope, with the kernels each must launch on the card.
    for scope, pool_bytes, kernels in (
            (None, 0, ("merge_pair", "bloom_build", "bloom_probe")),
            ("store", 32 * MB, ("probe_store", "probe_tier")),
            ("tier", 32 * MB, ("probe_tier", "bloom_probe"))):
        t0 = time.perf_counter()
        kw = ({"device_pool_bytes": pool_bytes, "fused_scope": scope}
              if pool_bytes else {})
        zero_counts()
        on_card = replay("cuda", n_submits=190, **kw)
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        on_cpu = replay("cpu", n_submits=190, **kw)
        missing = [k for k in kernels if launched[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched in the {scope} "
                                 f"replay: {missing}")
        compare_replays(on_card, on_cpu)
        if not on_card["flushes_log"] > 0 < on_cpu["flushes_log"]:
            raise AssertionError("the replay ran no log-triggered flush")
        pool = on_card["pool"]
        if pool_bytes and not (pool["tier_hits"] > 0 and (
                scope == "tier" or pool["store_hits"] > 0)):
            raise AssertionError(f"the {scope} replay never took the fused "
                                 f"path: {pool}")
        emit({"phase": "replay", "fused_scope": scope,
              "device_pool_bytes": pool_bytes, "n_ops": on_card["n_ops"],
              "flushes_log": [on_card["flushes_log"], on_cpu["flushes_log"]],
              "wal_records": len(on_card["wal"]),
              "manifest_edits": len(on_card["manifest"]), "pool": pool,
              "fused_launches": on_card["iostats"]["fused_launches"],
              "launches": launched,
              "seconds": time.perf_counter() - t0, "identical": True})

    # Card-vs-CPU replays of one seeded stream under the tuner, unsharded
    # and over 4 shards.
    t0 = time.perf_counter()
    adaptive_replays(190)
    seconds["adaptive_replay"] = time.perf_counter() - t0
    emit({"phase": "new_phase_seconds", **seconds})

    # Crash recovery at full width (the staged load and mixed part, the
    # adaptive mixed part), the replay stream crashed and recovered on the
    # card and on the CPU, then the staged stream under maintenance
    # workers.
    seconds = {}
    t0 = time.perf_counter()
    recovery_phase(card, points, service_kw["gets"])
    seconds["recovery"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recovery_replay_phase(card)
    seconds["recovery_replay"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    workers_phase(card, staged, staged_mark, service_kw)
    seconds["workers"] = time.perf_counter() - t0
    emit({"phase": "recovery_workers_seconds", **seconds})

    # The files medium: the staged stream's load and first FILES_SUBMITS
    # submits on files, its reopen, SIGKILLed children of the kill
    # workload, and the replay store under each fsync policy.
    files_phase(card, staged, staged_mark, service_kw)

    # Serve phase: the serving entry point at Yi-6B's full width with the
    # reference's defaults (64 requests, batch 4, prompt 48, 16 tokens);
    # every attention call of prefill and decode launches K6. The timed run
    # has no profiler attached; a second, short run (8 requests, counts
    # not read) is profiled over 5 decode steps.
    torch.cuda.empty_cache()
    yi = get_config("yi-6b")
    argv = ["--arch", "yi-6b", "--device", "cuda", "--seed", "0"]
    served = run_serve(argv)
    served.update(param_bytes(yi))
    for ln in served["lines"]:
        print(ln, flush=True)
    emit({"phase": "serve", "card": card, **served})
    want = yi.num_layers * (1 + 16) * (64 // 4)
    if served["launches"]["flash_attention"] != want:
        raise AssertionError(f"serve phase launched flash_attention "
                             f"{served['launches']['flash_attention']} times, "
                             f"not {want}")
    if not served["logits_finite"]:
        raise AssertionError("serve phase produced non-finite logits")
    torch.cuda.empty_cache()
    profiled = run_serve(argv + ["--requests", "8"], profile_from=20,
                         n_profile=5)
    emit({"phase": "serve_profile", "card": card,
          "argv": profiled["argv"], "profile": profiled["profile"],
          "logits_finite": profiled["logits_finite"]})
    if not profiled["logits_finite"]:
        raise AssertionError("profiled serve run produced non-finite logits")
    del profiled
    torch.cuda.empty_cache()

    # The MoE family: Granite-3.0-1B-A400M served at full width with the
    # same defaults (K6 at head dim 64, GQA 2), then held card vs CPU with
    # its routing; the two phases share MOE_BOX_S.
    seconds = {}
    t0 = time.perf_counter()
    served_moe = serve_moe_phase(card)
    seconds["serve_moe"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    moe_model_phase(get_config(MOE_ARCH), layers=MOE_MODEL_LAYERS)
    seconds["model_moe"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    total = sum(seconds.values())
    emit({"phase": "moe_seconds", "card": card, **seconds, "total": total,
          "box_s": MOE_BOX_S, "within_box": total <= MOE_BOX_S})

    # The hybrid family: Zamba2-2.7B served at full width with the same
    # defaults (K6 at head dim 80, H == KV, in the shared attention block
    # after each group of 6 Mamba2 layers), then held card vs CPU at all
    # HYBRID_MODEL_LAYERS; the two phases share HYBRID_BOX_S.
    seconds = {}
    t0 = time.perf_counter()
    served_hybrid = serve_hybrid_phase(card)
    seconds["serve_hybrid"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    hybrid_model_phase(get_config(HYBRID_ARCH), layers=HYBRID_MODEL_LAYERS)
    seconds["model_hybrid"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    total = sum(seconds.values())
    emit({"phase": "hybrid_seconds", "card": card, **seconds,
          "total": total, "box_s": HYBRID_BOX_S,
          "within_box": total <= HYBRID_BOX_S})

    # Card-vs-CPU model phase: Yi-6B at full width, 2 layers (depth cut),
    # in f32 and bf16 compute, with the faults it must see.
    t0 = time.perf_counter()
    model_cmp = compare_model(yi.with_(num_layers=MODEL_LAYERS), batch=4,
                              prompt=48, steps=8)
    emit({"phase": "model", "seconds": time.perf_counter() - t0,
          "runs": model_cmp})
    check_model(model_cmp)

    # Train phase: K6's backward against its plain version, MiniCPM-2B
    # trained at full width through launch.train.main, one step card vs
    # CPU with the backward's faults, and a checkpoint restart.
    trained = train_phase(card)
    bwd_rep = trained["bwd"]["cases"][BWD_REPORTED]
    bwd_err = {k: 0.0 for k in BWD_KERNELS}
    of_kernel = {"flash_attention_bwd_prep": ("delta",),
                 "flash_attention_bwd_dkv": ("dk", "dv"),
                 "flash_attention_bwd_dq": ("dq",)}
    for c in [*trained["bwd"]["cases"].values(),
              *trained["bwd"]["edges"].values()]:
        for k, names in of_kernel.items():
            bwd_err[k] = max(bwd_err[k], *(c["errors"][n]["max_abs_err"]
                                           for n in names))
    train_launches = trained["runs"]["defaults"]["launches"]

    launches = {**staged["launches"],
                **{k: pooled["launches"][k]
                   for k in ("probe_tier", "probe_store")},
                "flash_attention": served["launches"]["flash_attention"]}
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": launches[k],
         "max_abs_err": checked["err"][k], "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k]["bound_by"],
         "library_ms": timing[k]["library_ms"],
         **({"launches_serve_moe": served_moe["launches"][k],
             "launches_serve_hybrid": served_hybrid["launches"][k],
             "launches_train": train_launches[k]}
            if k == "flash_attention" else {})}
        for k in LAUNCHES if k not in BWD_KERNELS] + [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": train_launches[k],
         "launches_train_seq4096": trained["runs"]["seq4096"]["launches"][k],
         "max_abs_err": bwd_err[k], "ms": bwd_rep["call_ms"][k],
         "device_ms": bwd_rep["device_ms"][k],
         "plain_ms": (bwd_rep["plain_prep_ms"]
                      if k == "flash_attention_bwd_prep"
                      else bwd_rep["plain_ms"]),
         "bound_ms": bwd_rep[k]["bound_ms"],
         "bound_by": bwd_rep[k]["bound_by"],
         "library_ms": (None if k == "flash_attention_bwd_prep"
                        else bwd_rep["library_ms"]),
         "shape": BWD_REPORTED} for k in BWD_KERNELS]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
