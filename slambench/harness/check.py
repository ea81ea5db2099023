"""Decide `correct`: hold what the timed path produced against the plain
reference (slambench/reference), once the window has closed.

Numbers, each against the limit that slambench/checks/<config>.json
gives it (a configuration is held to the numbers its file lists):

- kp_miss: per extraction, the share of the detector's keypoint list
  (its K strongest local maxima) that the reference's GFTT list lacks;
  the largest over the extractions (GFTT configurations).
- kp3d_gap_m: the largest distance between a valid keypoint's 3-D point
  and the reference's back-projection of the raw depth frame.
- desc_diff_share: the share of descriptor components of valid keypoints
  that differ from the reference SIFT descriptor at the same keypoint.
- inlier_gap: per accepted registration, |claimed inliers - the
  reference's count of correspondences the reported pose explains| over
  the claim; the largest.
- missed_share: the inlier decisions, accepted and rejected alike. A
  registration is plainly registrable when the true relative pose of its
  two frames (the traffic's trajectory) explains at least twice the
  inliers it was asked for and half of its correspondences, with a pose
  norm under half the configuration's error_threshold: RANSAC's draws
  cannot all miss such a pair, nor its gate turn it away. The share of
  those that the program rejected, the larger of the single
  registrations' and the batched verifier's.
- pose_gap_m: per session, the largest distance between a vertex
  of final_after.g2o and the reference's optimum of the session's graph
  (its edges as the program built them, robust flags included, which the
  file does not carry) from final.g2o's start.

Extractions and sessions are all checked; accepted registrations, when
more than MAX_REGISTRATIONS, by a sample drawn from the seed, and the
decisions of every registration, accepted or rejected, by a sample of
MAX_DECISIONS drawn from the seed.
"""

from __future__ import annotations

import math
import os
import random

import numpy as np
import torch

from ..reference import features as ref_features
from ..reference import posegraph as ref_posegraph
from ..reference import registration as ref_registration

MAX_REGISTRATIONS = 600
MAX_DECISIONS = 1200


def _parse_g2o(path: str):
    """{id: 4x4} vertices and the set of fixed ids of a .g2o file."""
    verts, fixed = {}, set()
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                x, y, z, qx, qy, qz, qw = map(float, tok[2:9])
                n = math.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
                qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
                T = np.eye(4)
                T[:3, :3] = [
                    [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                    [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                    [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)]]
                T[:3, 3] = [x, y, z]
                verts[int(tok[1])] = T
            elif tok[0] == "FIX":
                fixed.add(int(tok[1]))
    return verts, fixed


def _registration_rows(rec):
    """(fa, fb, T 4x4, claimed inliers, ok, (frame a, frame b), inlier
    minimum, batched) of each recorded registration."""
    for r in rec.registrations:
        if "result" in r:
            res = r["result"]
            T, inl, ok = res.T.double().cpu().numpy(), int(res.inliers), bool(res.ok)
        else:
            packed, i = r["packed"]
            row = packed[i].double().cpu().numpy()
            T, inl, ok = row[:16].reshape(4, 4), int(round(row[17])), row[18] != 0
        yield r["fa"], r["fb"], T, inl, bool(ok), r["frames"], r["min"], "packed" in r


def _pose_norm(T) -> float:
    """The reference system's normofTransform: the rotation angle folded
    into [0, pi] plus the translation's length."""
    c = float(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1.0, 1.0))
    a = math.acos(c)
    return abs(min(a, 2 * math.pi - a)) + float(np.linalg.norm(T[:3, 3]))


class Checker:
    def __init__(self, cam: dict, gftt: bool, optimize_step: int, error_threshold: float,
                 poses, limits: dict):
        self.cam = cam
        self.gftt = gftt
        self.optimize_step = optimize_step
        self.error_threshold = error_threshold
        self.poses = [np.asarray(p, np.float64) for p in poses]  # camera to world, frame n at n-1
        self.limits = limits

    # -- extraction -------------------------------------------------------
    def extraction(self, recs, control_dtype=None) -> dict:
        """kp_miss, kp3d_gap_m, desc_diff_share over every recorded
        extraction; recs holds (recorder, gray frames, depth frames) of
        each session. With control_dtype the program's outputs are
        replaced by the reference's in that precision (the control)."""
        miss, gap, diff, comps = 0.0, 0.0, 0, 0
        for rec, gray, depth in recs:
            for ex in rec.extractions:
                i = ex["frame"] - 1
                g, d, feats = gray[i], depth[i], ex["features"]
                kps, desc = ex["kps"], ex["desc"]
                if self.gftt:
                    ref = ref_features.gftt_topk(g, kps.uv.shape[0])
                    got = (ref_features.gftt_topk(g, kps.uv.shape[0], control_dtype)
                           if control_dtype else kps.uv.round().long())
                    key = lambda uv: set((uv[:, 1] * g.shape[1] + uv[:, 0]).tolist())  # noqa: E731
                    miss = max(miss, 1 - len(key(got) & key(ref)) / len(key(ref)))
                k3 = ref_features.backproject(d, feats.uv, self.cam)
                prog3 = (ref_features.backproject(d, feats.uv, self.cam,
                                                  dtype=control_dtype).double()
                         if control_dtype else feats.kp3d.double())
                v = feats.kp_valid
                if bool(v.any()):
                    gap = max(gap, float(torch.linalg.vector_norm(prog3 - k3, dim=-1)[v].max()))
                rdesc = ref_features.sift_descriptors(g, kps.uv, kps.size, kps.valid)
                if control_dtype:
                    desc = ref_features.sift_descriptors(g, kps.uv, kps.size, kps.valid,
                                                         dtype=control_dtype)
                vv = kps.valid
                diff += int((desc[vv] != rdesc[vv]).sum())
                comps += int(vv.sum()) * desc.shape[1]
        out = {"kp3d_gap_m": gap, "desc_diff_share": diff / comps if comps else math.inf}
        if self.gftt:
            out["kp_miss"] = miss
        return out

    # -- registrations ----------------------------------------------------
    def true_pose(self, frames):
        """The true pose of frame a's points in frame b's camera, or None
        where a frame is unknown."""
        a, b = frames
        if a is None or b is None:
            return None
        return np.linalg.inv(self.poses[b - 1]) @ self.poses[a - 1]

    def registrations(self, recs, seed: int) -> dict:
        rows = [r for rec in recs for r in _registration_rows(rec)]
        rng = random.Random(seed)
        accepted = [r for r in rows if r[4]]
        if len(accepted) > MAX_REGISTRATIONS:
            accepted = rng.sample(accepted, MAX_REGISTRATIONS)
        decided = [r for r in rows if r[5][0] is not None and r[5][1] is not None]
        unknown = len(rows) - len(decided)
        if len(decided) > MAX_DECISIONS:
            decided = rng.sample(decided, MAX_DECISIONS)
        gap = 0.0 if accepted else math.inf
        for fa, fb, T, claimed, *_ in accepted:
            obj, img, good = ref_registration.correspondences(fa, fb)
            n = ref_registration.support(T, obj, img, good, self.cam)
            gap = max(gap, abs(claimed - n) / claimed)
        registrable, missed = [0, 0], [0, 0]
        for fa, fb, _, _, ok, frames, minimum, batched in decided:
            T_true = self.true_pose(frames)
            if _pose_norm(T_true) > 0.5 * self.error_threshold:
                continue
            obj, img, good = ref_registration.correspondences(fa, fb)
            n = ref_registration.support(T_true, obj, img, good, self.cam)
            if n >= 2 * minimum and n >= 0.5 * int(good.sum()):
                registrable[batched] += 1
                missed[batched] += not ok
        shares = [m / r for m, r in zip(missed, registrable) if r]
        return {"inlier_gap": gap, "missed_share": max(shares) if shares else math.inf,
                "registrations_checked": len(accepted), "decisions_checked": len(decided),
                "registrable": registrable, "frames_unknown": unknown}

    # -- backend ------------------------------------------------------------
    def backend(self, sessions, unchanged: bool = False) -> dict:
        """pose_gap_m; with `unchanged`, the reading of the fault that
        leaves the solve's state unchanged (final.g2o's vertices in place
        of final_after.g2o's)."""
        worst, n = 0.0, 0
        for s in sessions:
            data = os.path.join(s["workdir"], "data")
            start, fixed = _parse_g2o(os.path.join(data, "final.g2o"))
            final, _ = _parse_g2o(os.path.join(data, "final.g2o" if unchanged
                                               else "final_after.g2o"))
            ids = sorted(start)
            pos = {v: k for k, v in enumerate(ids)}
            edges = [(pos[e.id1], pos[e.id2], e.T, e.information, e.robust) for e in s["edges"]]
            if not edges:
                continue
            X = ref_posegraph.optimize(np.stack([start[v] for v in ids]),
                                       [v in fixed for v in ids], edges, self.optimize_step)
            gap = max(float(np.linalg.norm(final[v][:3, 3] - X[pos[v]][:3, 3])) for v in ids)
            worst = max(worst, gap)
            n += 1
        return {"pose_gap_m": worst if n else math.inf, "sessions_checked": n}

    def verdict(self, numbers: dict):
        """(correct, [(name, value, limit)]) over the numbers with limits."""
        rows = [(k, numbers.get(k, math.inf), lim) for k, lim in self.limits.items()]
        ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
        return ok, rows
