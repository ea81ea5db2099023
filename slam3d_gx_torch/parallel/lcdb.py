"""Keyframe retrieval database: scored loop-closure candidates and the
finalize pre-filter (counterpart of slam3d_gx_tpu/parallel/lcdb.py).

The reference draws 30 loop-closure candidates at random from the
keyframe history (src/GraphicEnd.cpp:729-731) and scans the whole
history in findMoreLoops (864-947). Here every keyframe's descriptors
live in one fixed-capacity device stack (C, P*K, D) with masks, grown by
doubling on the device, and a query is scored against all of them at
once with the frontend's own gate: nearest neighbour plus the
3*min_dist gate with the descriptor's match floor, and a mean-distance
tiebreak. Acceptance still runs the full multiPnP on the chosen
candidates (parallel/registration.py).

Scores are computed in blocks of keyframes, so the (block, Nq, Ndb)
distance tensor stays under _BLOCK_ELEMS elements whatever the history's
length; a keyframe's score does not depend on its block.

With a mesh (parallel/mesh.py) the rows are split over its "sp" axis,
cyclically: keyframe i lives on sp rank i % sp, at local row i // sp.
An add writes on the owner only and a doubling moves no row. Each rank
scores its own rows, and the scores are all-gathered over the sp group
and put back in keyframe order, so every rank holds all of them and
chooses the same candidates; they equal the unsharded scores exactly.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..frontend.state import FrameFeatures
from ..ops import match
from ..ops.features.common import top_k
from . import mesh as mesh_mod

# elements of one block's (keyframes, Nq, Ndb) fp32 distance tensor: 64 MiB
_BLOCK_ELEMS = 1 << 24
# the newest keyframes no round may draw: the reference's sampler skips
# the 3 newest (src/GraphicEnd.cpp:731)
_EXCLUDE_NEWEST = 3


def _flatten(f: FrameFeatures):
    """(P,K,D) descriptors -> (P*K, D); validity folds plane_valid in."""
    p, k, d = f.desc.shape
    return f.desc.reshape(p * k, d), (f.kp_valid & f.plane_valid[:, None]).reshape(p * k)


def score_block(db_desc, db_valid, q_desc, q_valid, floor: float) -> torch.Tensor:
    """(Cb, N, D) x (Nq, D) -> (Cb,) fp32 retrieval scores.

    The count of the query's keypoints whose nearest neighbour in the
    keyframe passes the frontend's good-match gate (match.py with the
    descriptor's `floor`, reference src/GraphicEnd.cpp:486-520; without
    the floor one exact binary match collapses the bound), plus
    1/(1 + mean NN distance), in (0, 1], which ranks equal counts by how
    well the descriptors agree.

    Distances come from the differences themselves (torch.cdist without
    the |a|^2 + |b|^2 - 2ab expansion that match.py uses): at descriptor
    norms ~60 the expansion leaves distances below ~0.05 to fp32
    rounding, so a keyframe equal to the query would score its rounding
    noise through the 3*min_dist gate, where the reference's matcher
    gives 0 and passes every keypoint."""
    cb, nq, d = db_desc.shape[0], q_desc.shape[0], q_desc.shape[1]
    dist = torch.cdist(q_desc.to(torch.float32).expand(cb, nq, d), db_desc,
                       compute_mode="donot_use_mm_for_euclid_dist")
    dist = torch.amin(torch.where(db_valid[:, None, :], dist, torch.inf), dim=-1)
    ok = q_valid & torch.isfinite(dist)
    good = match.good_match_filter(torch.where(ok, dist, torch.inf), ok, floor=floor)
    n_ok = torch.clamp(ok.sum(-1), min=1)
    mean_dist = torch.where(ok, dist, 0.0).sum(-1) / n_ok
    return good.sum(-1).to(torch.float32) + 1.0 / (1.0 + mean_dist)


class KeyframeDatabase:
    """Fixed-capacity, device-resident keyframe descriptor store on
    `device` (the card unless "cpu" is asked for). Adds write in place;
    the capacity doubles on the device when full. With `mesh`, the rows
    are split over its sp axis (see the module docstring) and `desc` and
    `valid` hold this rank's rows only."""

    def __init__(self, n_desc: int, dim: int, capacity: int = 64, match_floor: float = 0.0,
                 device=None, mesh=None):
        self.mesh = mesh
        self.sp = mesh_mod.axis_size(mesh, mesh_mod.SP_AXIS)
        self._sp_rank = mesh_mod.axis_rank(mesh, mesh_mod.SP_AXIS)
        self.n_desc = n_desc
        self.dim = dim
        self.match_floor = float(match_floor)
        self.count = 0
        self.capacity = mesh_mod.pad_to_multiple(capacity, self.sp)
        dev = resolve_device(device)
        local = self.capacity // self.sp
        self.desc = torch.zeros((local, n_desc, dim), dtype=torch.float32, device=dev)
        self.valid = torch.zeros((local, n_desc), dtype=torch.bool, device=dev)
        self.block = max(1, _BLOCK_ELEMS // (n_desc * n_desc))

    def _grow(self):
        self.capacity *= 2
        self.desc = torch.cat([self.desc, torch.zeros_like(self.desc)])
        self.valid = torch.cat([self.valid, torch.zeros_like(self.valid)])

    def add(self, features: FrameFeatures) -> int:
        if self.count == self.capacity:
            self._grow()
        i = self.count
        if i % self.sp == self._sp_rank:
            d, v = _flatten(features)
            self.desc[i // self.sp] = d
            self.valid[i // self.sp] = v
        self.count += 1
        return i

    def _scores(self, query: FrameFeatures) -> torch.Tensor:
        """(count,) scores of the query against every stored keyframe,
        on the device (on every rank, with a mesh)."""
        qd, qv = _flatten(query)
        # with a mesh: this rank's first rows, as many on every rank
        rows = -(-self.count // self.sp)
        blocks = [slice(c0, min(c0 + self.block, rows)) for c0 in range(0, rows, self.block)]
        s = torch.cat([score_block(self.desc[b], self.valid[b], qd, qv, self.match_floor)
                       for b in blocks])
        if self.mesh is None:
            return s
        # rank r's local row j is keyframe j * sp + r
        s = mesh_mod.gather_rows(s, self.mesh, mesh_mod.SP_AXIS)
        return s.reshape(self.sp, rows).T.reshape(-1)[: self.count]

    def scores(self, query: FrameFeatures) -> np.ndarray:
        """(count,) host scores of the query against every stored keyframe."""
        if self.count == 0:
            return np.zeros((0,), np.float32)
        return self._scores(query).cpu().numpy()

    def top_candidates(self, query: FrameFeatures, n: int) -> List[int]:
        """The n best-scoring keyframe indices but the newest few, best
        first, ties in index order."""
        s = self.scores(query)[: max(0, self.count - _EXCLUDE_NEWEST)]
        return [int(i) for i in np.argsort(-s, kind="stable")[:n]]

    def select_candidates_device(self, query: FrameFeatures, n: int,
                                 n_det: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
        """The scored loop-closure round's candidates, chosen on the device
        with no host wait: the deterministic keyframes count-3, count-4, ...
        (n_det of them, record=False in the reference, src/GraphicEnd.cpp:
        694-725), then the n best-scoring keyframes among all but the 3
        newest (ties in index order, as lax.top_k takes them; torch.topk
        leaves their order to the device). Returns
        ((n_det + n,) int64 indices, (n_det + n,) bool valid); invalid
        rows (a negative deterministic index, fewer eligible keyframes
        than n) carry indices the caller must clamp and mask."""
        dev = self.desc.device
        s = self._scores(query) if self.count else torch.zeros(0, device=dev)
        width = max(self.count, n)
        s = torch.cat([s, torch.full((width - self.count,), -torch.inf, device=dev)])
        idx = torch.arange(width, device=dev)
        s = torch.where(idx < self.count - _EXCLUDE_NEWEST, s, -torch.inf)
        top_s, top_i = top_k(s, n)
        det = self.count - 3 - torch.arange(n_det, device=dev)
        return torch.cat([det, top_i]), torch.cat([det >= 0, torch.isfinite(top_s)])
