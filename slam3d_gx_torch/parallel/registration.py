"""Batched pairwise registration: the loop-closure verifier
(counterpart of slam3d_gx_tpu/parallel/registration.py).

The reference verifies loop-closure candidates one multiPnP call at a
time (30 random draws per keyframe, src/GraphicEnd.cpp:729-761). The
pairs are independent, so a round runs as one batched call: the
single-pair function of frontend/pipeline.py on features with a leading
batch axis, every tensor operation once for the whole round.

Used by the frontends' loopClosure, lostRecovery and findMoreLoops when
`loop_closure_batched` is 1 (the default). With `loop_closure_scored` a
loop-closure round is fused: the candidates that the keyframe database
(parallel/lcdb.py) selects on the device are gathered from the feature
store and verified without the host reading anything until the drain.

Random draws are an argument, as everywhere in this package: the caller
hands in `(B, P+2, H, 3)` uniforms for plane pairs and `(B, H, 3)` for
image pairs, one row a pair.

With a mesh (parallel/mesh.py) the batch is split over its "dp" axis:
the batch is padded to a multiple of dp (padding rows repeat row 0 and
are dropped), each dp rank registers its block of rows, and the packed
rows are all-gathered over the dp group, so every rank holds the whole
result. The caller draws the uniforms of the whole batch on every rank
and each rank takes its own rows, so a row is the same sharded or not
and every rank's generator stays in step.

Not carried from the reference module, as TPU matter: `fetch_all`'s
grouping of transfers by 8 (a tactic against a relay's latency; here a
drain is one copy); the padding of every batch to a fixed 32 (a guard
against recompiles; eager PyTorch has none, so a batch has its own
length).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..frontend import pipeline
from ..frontend.state import FrameFeatures, pack_result, unpack_result_row
from . import mesh as mesh_mod

# (packed (b,19) device tensor, rows of it that are results)
Pending = Tuple[torch.Tensor, int]


def stack_features(frames: Sequence[FrameFeatures]) -> FrameFeatures:
    """Stack FrameFeatures into one batch (B, ...), on their device."""
    return FrameFeatures(*(torch.stack([getattr(f, name) for f in frames])
                           for name in FrameFeatures._fields))


def build_batched_multipnp(intr: CameraIntrinsics, image_only: bool = False,
                           error_threshold: float = 1.0,
                           match_floor: float = 0.0) -> Callable:
    """Returns batched(fa, fb, u, min_inliers) -> MultiPnPResult with a
    leading batch axis on every field.

    fa/fb are FrameFeatures with leading batch axis B; u is (B, P+2, H, 3)
    for plane pairs and (B, H, 3) for image pairs; min_inliers a scalar.
    As in the reference, the plane verifier runs the default "tiered"
    refinement whatever `pnp_refine_mode` says."""
    build = pipeline.build_multipnp_image if image_only else pipeline.build_multipnp_planes
    single = build(intr, error_threshold=error_threshold, match_floor=match_floor)

    def batched(fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor, min_inliers):
        b = fa.uv.shape[0]
        if fa.uv.dim() != 4 or fb.uv.shape[0] != b or u.shape[0] != b:
            raise ValueError("batched multiPnP: features and uniforms need one "
                             "leading batch axis of equal length")
        return single(fa, fb, u, min_inliers)

    return batched


def fetch_all(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """fp32 device tensors of any shapes -> host arrays, in one
    device-to-host copy."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    ends = np.cumsum([t.numel() for t in tensors])
    return [flat[e - t.numel():e].reshape(t.shape) for t, e in zip(tensors, ends)]


def resolve_async(pending: Sequence[Pending]) -> List[tuple]:
    """Read back what `dispatch_against_one` launched: one device-to-host
    copy for all chunks, rows unpacked to (T, norm, inliers, ok) host
    tuples in launch order."""
    rows = fetch_all([packed[:n_valid] for packed, n_valid in pending])
    return [unpack_result_row(r) for part in rows for r in part]


class FeatureStore:
    """Keyframe features in device tensors of fixed capacity, grown by
    doubling: a candidate batch is one indexed read of each field instead
    of a stack over a growing Python list of keyframes."""

    def __init__(self, template: FrameFeatures, capacity: int = 64, chunk: int = 32):
        self.chunk = chunk
        self.count = 0
        self.capacity = capacity
        self._bufs = FrameFeatures(*(
            torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            for x in template))

    def add(self, f: FrameFeatures) -> int:
        if self.count == self.capacity:
            self.capacity *= 2
            self._bufs = FrameFeatures(*(torch.cat([b, torch.zeros_like(b)])
                                         for b in self._bufs))
        i = self.count
        for b, x in zip(self._bufs, f):
            b[i] = x  # in place: the store owns its buffers
        self.count += 1
        return i

    def gather(self, indices: Sequence[int]) -> FrameFeatures:
        """Host indices of stored keyframes -> (len(indices), ...) batch."""
        bad = [i for i in indices if not 0 <= int(i) < self.count]
        if bad:
            raise IndexError(f"FeatureStore.gather: {bad} outside 0..{self.count - 1}")
        idx = torch.as_tensor(list(indices), dtype=torch.int64,
                              device=self._bufs.uv.device)
        return FrameFeatures(*(b[idx] for b in self._bufs))

    def gather_dev(self, idx: torch.Tensor) -> FrameFeatures:
        """Device indices (e.g. the scored round's candidates) -> (B, ...)
        batch, with no host wait. Indices are clamped into the buffers: a
        CUDA gather out of range would be a device-side assert, so rows
        of invalid candidates come back as some stored row, which the
        caller masks."""
        idx = torch.clamp(idx, 0, self.capacity - 1)
        return FrameFeatures(*(b[idx] for b in self._bufs))

    def broadcast(self, f: FrameFeatures, n: int) -> FrameFeatures:
        """One frame -> (n, ...) batch of views of it."""
        return FrameFeatures(*(x[None].expand((n,) + tuple(x.shape)) for x in f))


class BatchedRegistrar:
    """Verifies all candidates of a round in one batched call instead of
    the reference's sequential loop (src/GraphicEnd.cpp:729-761).

    With `mesh`, each batch is split over the mesh's dp axis (see the
    module docstring). `calls` counts the batched calls launched, `pairs`
    the pairs they held and `fused` the scored rounds among them."""

    def __init__(self, intr: CameraIntrinsics, image_only: bool,
                 error_threshold: float = 1.0, match_floor: float = 0.0, mesh=None):
        self.fn = build_batched_multipnp(
            intr, image_only=image_only, error_threshold=error_threshold,
            match_floor=match_floor)
        self.mesh = mesh
        self.dp = mesh_mod.axis_size(mesh, mesh_mod.DP_AXIS)
        self.calls = 0
        self.pairs = 0
        self.fused = 0

    def _dispatch_stacked(self, fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor,
                          min_inliers: int, n_valid: int) -> Pending:
        """Launch one stacked batch; the packed result stays on the
        device until `resolve_async` copies it. With a mesh, this rank
        registers its dp block of the padded batch and the packed rows of
        all blocks are gathered, with no host wait."""
        self.calls += 1
        self.pairs += n_valid
        if self.mesh is None:
            return pack_result(self.fn(fa, fb, u, min_inliers)), n_valid
        b = u.shape[0]
        b_pad = mesh_mod.pad_to_multiple(b, self.dp)

        def mine(x):
            return mesh_mod.shard_rows(x, self.mesh, mesh_mod.DP_AXIS, b_pad)

        packed = pack_result(self.fn(FrameFeatures(*map(mine, fa)),
                                     FrameFeatures(*map(mine, fb)), mine(u), min_inliers))
        return mesh_mod.gather_rows(packed, self.mesh, mesh_mod.DP_AXIS)[:b], n_valid

    def run_stacked(self, fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor,
                    min_inliers: int, n_valid: int) -> List[tuple]:
        """Register stacked batches; host tuples for the first n_valid rows."""
        return resolve_async([self._dispatch_stacked(fa, fb, u, min_inliers, n_valid)])

    def dispatch_against_one(self, store: FeatureStore, indices: Sequence[int],
                             single: FrameFeatures, u: torch.Tensor, min_inliers: int,
                             single_is_target: bool = True) -> List[Pending]:
        """Launch store[indices] against one frame, in chunks of the
        store's chunk size, and return without reading anything back.
        u holds one row of uniforms per index. single_is_target: pairs
        are (store[i], single), the loop-closure direction; False flips
        them to (single, store[i]) (checknearby's outward walk)."""
        if u.shape[0] != len(indices):
            raise ValueError(f"{len(indices)} candidates need {len(indices)} rows of "
                             f"uniforms, got {u.shape[0]}")
        pending = []
        for c0 in range(0, len(indices), store.chunk):
            part = list(indices[c0:c0 + store.chunk])
            gathered = store.gather(part)
            bcast = store.broadcast(single, len(part))
            fa, fb = (gathered, bcast) if single_is_target else (bcast, gathered)
            pending.append(self._dispatch_stacked(
                fa, fb, u[c0:c0 + len(part)], min_inliers, len(part)))
        return pending

    def dispatch_fused(self, store: FeatureStore, idx: torch.Tensor, valid: torch.Tensor,
                       single: FrameFeatures, u: torch.Tensor, min_inliers: int) -> torch.Tensor:
        """A scored loop-closure round on the device: the candidates arrive
        as device indices (lcdb.select_candidates_device), are gathered
        from the store and verified against `single`, with no host wait.
        u holds one row of uniforms per candidate. Returns one (B, 21)
        device tensor: [:19] the packed result, [19] the candidate's
        index, [20] its valid flag, for a deferred drain."""
        b = idx.shape[0]
        self.fused += 1
        packed, _ = self._dispatch_stacked(store.gather_dev(idx), store.broadcast(single, b),
                                           u, min_inliers, b)
        return torch.cat([packed, idx.to(torch.float32)[:, None],
                          valid.to(torch.float32)[:, None]], dim=1)

    def run_against_one(self, store: FeatureStore, indices: Sequence[int],
                        single: FrameFeatures, u: torch.Tensor, min_inliers: int,
                        single_is_target: bool = True) -> List[tuple]:
        return resolve_async(self.dispatch_against_one(
            store, indices, single, u, min_inliers, single_is_target))

    def __call__(self, pairs: Sequence[Tuple[FrameFeatures, FrameFeatures]],
                 u: torch.Tensor, min_inliers: int, chunk: int = 32) -> List[tuple]:
        """pairs: list of (FrameFeatures, FrameFeatures); u one row of
        uniforms a pair. Returns (T 4x4 np, norm, inliers, ok) per pair;
        longer lists run in chunks."""
        if u.shape[0] != len(pairs):
            raise ValueError(f"{len(pairs)} pairs need {len(pairs)} rows of uniforms, "
                             f"got {u.shape[0]}")
        pending = []
        for c0 in range(0, len(pairs), chunk):
            part = pairs[c0:c0 + chunk]
            pending.append(self._dispatch_stacked(
                stack_features([p[0] for p in part]), stack_features([p[1] for p in part]),
                u[c0:c0 + len(part)], min_inliers, len(part)))
        return resolve_async(pending)
