"""Batched pairwise registration: the loop-closure verifier
(counterpart of slam3d_gx_tpu/parallel/registration.py).

The reference verifies loop-closure candidates one multiPnP call at a
time (30 random draws per keyframe, src/GraphicEnd.cpp:729-761). The
pairs are independent, so a round runs as one batched call: the
single-pair function of frontend/pipeline.py on features with a leading
batch axis, every tensor operation once for the whole round.

Used by the frontends' loopClosure, lostRecovery and findMoreLoops when
`loop_closure_batched` is 1 (the default).

Random draws are an argument, as everywhere in this package: the caller
hands in `(B, P+2, H, 3)` uniforms for plane pairs and `(B, H, 3)` for
image pairs, one row a pair.

Not carried from the reference module, as TPU or multi-device matter:
the device mesh and its shardings (ROADMAP.md queue 1 item 18);
`dispatch_fused` and `_pack_with_meta`, which serve the scored
candidate database `parallel/lcdb.py` (item 17); `fetch_all`'s grouping
of transfers by 8 (a tactic against a relay's latency; here a drain is
one copy); the padding of every batch to a fixed 32 (a guard against
recompiles; eager PyTorch has none, so a batch has its own length).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..config import CameraIntrinsics
from ..frontend import pipeline
from ..frontend.state import FrameFeatures, pack_result, unpack_result_row

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


def resolve_async(pending: Sequence[Pending]) -> List[tuple]:
    """Read back what `dispatch_against_one` launched: one device-to-host
    copy for all chunks, rows unpacked to (T, norm, inliers, ok) host
    tuples in launch order."""
    if not pending:
        return []
    rows = torch.cat([packed[:n_valid] for packed, n_valid in pending]).cpu().numpy()
    return [unpack_result_row(r) for r in rows]


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

    def broadcast(self, f: FrameFeatures, n: int) -> FrameFeatures:
        """One frame -> (n, ...) batch of views of it."""
        return FrameFeatures(*(x[None].expand((n,) + tuple(x.shape)) for x in f))


class BatchedRegistrar:
    """Verifies all candidates of a round in one batched call instead of
    the reference's sequential loop (src/GraphicEnd.cpp:729-761).

    `calls` counts the batched calls launched and `pairs` the pairs they
    held."""

    def __init__(self, intr: CameraIntrinsics, image_only: bool,
                 error_threshold: float = 1.0, match_floor: float = 0.0):
        self.fn = build_batched_multipnp(
            intr, image_only=image_only, error_threshold=error_threshold,
            match_floor=match_floor)
        self.calls = 0
        self.pairs = 0

    def _dispatch_stacked(self, fa: FrameFeatures, fb: FrameFeatures, u: torch.Tensor,
                          min_inliers: int, n_valid: int) -> Pending:
        """Launch one stacked batch; the packed result stays on the
        device until `resolve_async` copies it."""
        self.calls += 1
        self.pairs += n_valid
        return pack_result(self.fn(fa, fb, u, min_inliers)), n_valid

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
