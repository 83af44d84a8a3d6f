"""Request planner: groups a mixed-op submit batch into vectorized steps.

``build_plan`` partitions the submitted requests into ``PlanStep``s keyed by
(tree, op-kind) -- and, over a sharded store, write steps further split per
(tree, shard, op-kind) through the router. Steps execute in order of each
group's *first appearance* in the request list; within a step, requests
keep submission order. One put/delete/get step dispatches as ONE batched
backend call (the per-request keys concatenated), so a plan step is
bit-identical to the equivalent direct ``LSMStore.write_batch`` /
``delete_batch`` / ``read_batch`` call on the concatenated keys; a scan
step dispatches as ONE ``scan_batch`` call (one logical op per range).

Sharded write splitting is what keeps backpressure *per shard*: admission
gates inspect the one (tree, shard) a step targets, so an L0 pile-up on the
hot shard defers only the keys routed there while the rest of the submit
proceeds. Read steps stay whole -- the sharded store scatters/gathers
internally -- because reads are never admission-gated.

The grouping defines the submit batch's intra-batch semantics: a Get
observes a Put from the same batch iff the Put's (tree, "put") group first
appears before the Get's (tree, "get") group. Callers needing strict
read-your-writes across kinds issue separate submits.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .requests import Request, Scan, request_kind


@dataclass
class PlanStep:
    """One vectorized execution unit: all same-kind requests for one tree
    (and, for write steps over a sharded store, one shard)."""

    tree: str
    kind: str                                  # put | delete | get | scan
    indices: list[int] = field(default_factory=list)   # submission positions
    requests: list[Request] = field(default_factory=list)
    shard: int | None = None                   # write steps on sharded stores
    # Per-request positions (into request.keys) routed to this step's
    # shard; None = the whole request belongs to this step (unsharded).
    key_sel: list[np.ndarray] | None = None

    def _sels(self):
        return self.key_sel if self.key_sel is not None \
            else [None] * len(self.requests)

    def _req_len(self, r, sel) -> int:
        if isinstance(r, Scan):
            return 1
        return len(r.keys) if sel is None else len(sel)

    @property
    def n_keys(self) -> int:
        return sum(self._req_len(r, sel)
                   for r, sel in zip(self.requests, self._sels()))

    def concat_keys(self) -> np.ndarray:
        return np.concatenate([r.keys if sel is None else r.keys[sel]
                               for r, sel in zip(self.requests, self._sels())])

    def concat_vals(self) -> np.ndarray:
        """Put payloads with the vals=None -> keys default applied."""
        out = []
        for r, sel in zip(self.requests, self._sels()):
            v = r.keys if r.vals is None else r.vals
            out.append(v if sel is None else v[sel])
        return np.concatenate(out)

    def slices(self):
        """(index, request, start, stop) views back into the concat arrays."""
        off = 0
        for i, r, sel in zip(self.indices, self.requests, self._sels()):
            n = self._req_len(r, sel)
            yield i, r, off, off + n
            off += n


@dataclass
class ExecutionPlan:
    steps: list[PlanStep]
    n_requests: int

    def describe(self) -> str:
        parts = [f"{s.kind}:{s.tree}"
                 + (f"#{s.shard}" if s.shard is not None else "")
                 + f"[{len(s.requests)}r/{s.n_keys}k]"
                 for s in self.steps]
        return " -> ".join(parts) if parts else "(empty)"


def build_plan(requests, *, router=None) -> ExecutionPlan:
    """Plan a submit batch. ``router`` (a ``ShardRouter``, from a sharded
    store) splits write steps per shard; reads and scans stay whole."""
    groups: dict[tuple, PlanStep] = {}
    n = 0
    for i, req in enumerate(requests):
        kind = request_kind(req)      # raises TypeError on foreign objects
        if router is not None and kind in ("put", "delete"):
            for si, sel in router.split(req.keys):
                key = (req.tree, kind, si)
                step = groups.get(key)
                if step is None:
                    step = groups[key] = PlanStep(
                        tree=req.tree, kind=kind, shard=si, key_sel=[])
                step.indices.append(i)
                step.requests.append(req)
                step.key_sel.append(sel)
        else:
            key = (req.tree, kind, None)
            step = groups.get(key)
            if step is None:
                step = groups[key] = PlanStep(tree=req.tree, kind=kind)
            step.indices.append(i)
            step.requests.append(req)
        n += 1
    return ExecutionPlan(steps=list(groups.values()), n_requests=n)
