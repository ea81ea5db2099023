"""Streaming frontend: `chunk` frames of tracking per dispatch and one
readback per chunk (counterpart of slam3d_gx_tpu/frontend/streaming.py).

The tracking state machine of GraphicEnd2::run and GraphicEnd::run
(src/GraphicEnd2.cpp:149-201, src/GraphicEnd.cpp:150-264: extract ->
multiPnP -> invert -> keyframe / small-motion / lost branches) runs over
a chunk of frames with its state on the device:

  carry = (keyframe features, kf_pos, robot, lost counter, last
           features, the registration that accepted `last`)
  per frame: features = extract(gray, depth)
             res = multiPnP(kf_feat, features); T = res.T^-1
             ok    -> robot' = T @ kf_pos; lost' = 0
             norm > max_pos_change -> promote: kf_feat' = features,
                                      kf_pos' = robot'
             !ok   -> lost' = lost + 1

The JAX `lax.scan` is a Python loop here, and every branch is a
`torch.where` over the carry's fields, so the loop launches work without
waiting for it. One packed (chunk, REC_WIDTH) record tensor carries every
decision the host needs; it is copied to pinned host memory without
blocking, and the host waits on an event recorded at the end of the
dispatch, so reading chunk k never waits for chunk k+1, which is
dispatched before chunk k is applied. Keyframe bookkeeping, graph edges,
loop closure and the logs are then replayed host-side from the records.

The last-frame rescue of the plane frontend (src/GraphicEnd.cpp:183-227)
runs in the loop when a frame fails against its keyframe. Torch has no
device-side branch in eager mode, so the loop reads that frame's `ok`
flag, one small readback per frame, and runs the rescue's registrations
only for a failed frame. The image-only frontend and odometry runs have
no rescue and read nothing inside the loop. The rescue keeps the port's
delta (graphic_end.py module docstring): the registration that accepted
`last` against the current keyframe is carried on the device and written
as the keyframe->last record; `kf_feat -> last_feat` is registered only
when the carry has none.

lostRecovery cannot run in the loop (it mutates the pose graph and scans
the history, src/GraphicEnd.cpp:764-838): when a chunk's lost counter
crosses `lost_frames`, the records after the trigger frame are discarded
and those frames are run again through the per-frame `run()`.

Draws come from the run's `torch.Generator`: per frame, the extraction's
plane sampler (plane frontend) and the PnP uniforms of the main, rescue
and keyframe->last registrations, all drawn when the chunk is dispatched.
They are another stream than the per-frame path's, so the two paths'
poses agree statistically, not bit for bit (as in the JAX package).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import os
import warnings
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..geometry import se3
from ..io import images
from ..ops import plane_ransac, pointcloud
from .graphic_end import INFO_VISUAL, GraphicEnd, GraphicEnd2
from .state import FrameFeatures, Keyframe

REC_WIDTH = 59  # per-frame packed record row (see build_tracker)


class TrackCarry(NamedTuple):
    """The tracker's state between frames and between chunks."""

    kf_feat: FrameFeatures
    kf_pos: torch.Tensor        # (4,4) float32
    robot: torch.Tensor         # (4,4) float32
    lost: torch.Tensor          # () int32
    last_feat: FrameFeatures
    last_reg: torch.Tensor      # (4,4) float32: res.T that accepted `last`
    has_last_reg: torch.Tensor  # () bool: last_reg is against kf_feat


class ChunkDraws(NamedTuple):
    """The random draws of one chunk. samplers: per frame the plane
    extraction's triplet sampler, or None for the image-only extractor;
    u: (chunk, 3, ...) PnP uniforms, per frame those of the main, the
    rescue and the keyframe->last registration."""

    samplers: Optional[Sequence]
    u: torch.Tensor


def _inv_se3(T: torch.Tensor) -> torch.Tensor:
    """[R^T, -R^T t; 0 0 0 1], built by concatenation: on the card an
    assignment into one element or one column of a tensor waits for the
    stream (torch.cuda.set_sync_debug_mode shows it), a concatenation
    does not."""
    Rt = T[:3, :3].T
    t = -torch.sum(Rt * T[:3, 3], dim=1, keepdim=True)
    return torch.cat([torch.cat([Rt, t], dim=1),
                      torch.eye(4, dtype=T.dtype, device=T.device)[3:]])


def _select(cond: torch.Tensor, new: FrameFeatures, old: FrameFeatures) -> FrameFeatures:
    return FrameFeatures(*(torch.where(cond, a, b) for a, b in zip(new, old)))


def build_tracker(extract_fn: Callable, multipnp: Callable, max_pos_change: float,
                  chunk: int, rescue: bool = False, rescue_inliers: int = 30,
                  rescue_error: float = 1.5) -> Callable:
    """track_chunk(carry, grays, depths, draws) -> (carry', features
    stacked over the chunk, records (chunk, REC_WIDTH) float32).

    extract_fn(gray, depth, sampler) -> FrameFeatures; multipnp(fa, fb,
    u, minimum_inliers) -> MultiPnPResult.

    With rescue=True a frame that fails against the keyframe is
    registered against the last tracked frame; on success (inliers >=
    rescue_inliers and norm <= rescue_error, the loop-closure gates the
    reference reuses here) both last and present become keyframes and
    present is the new reference keyframe.

    Record row layout: [0:16] T (inverted measurement), [16] norm, [17]
    inliers, [18] ok, [19] new_kf, [20] lost-after, [21:24] robot t,
    [24] rescued, [25:41] rescue T last->present, [41] rescue norm, [42]
    rescue inliers, [43:59] T keyframe->last (un-inverted, as multiPnP
    returns it)."""

    def step(carry: TrackCarry, gray, depth, sampler, u):
        kf_feat, kf_pos, robot, lost, last_feat, last_reg, has_reg = carry
        feat = extract_fn(gray, depth, sampler)
        res = multipnp(kf_feat, feat, u[0], 12)
        T = _inv_se3(res.T)
        ok = res.ok
        resc_ok = torch.zeros((), dtype=torch.bool, device=ok.device)
        r_T = rr_T = torch.zeros(16, dtype=torch.float32, device=ok.device)
        r_norm = r_inl = torch.zeros((), dtype=torch.float32, device=ok.device)
        if rescue:
            # the loop's one readback: whether this frame needs the rescue
            ok_h, has_reg_h = torch.stack([ok, has_reg]).tolist()
            if not ok_h:
                r = multipnp(last_feat, feat, u[1], 12)
                resc_ok = r.ok & (r.inliers >= rescue_inliers) & (r.norm <= rescue_error)
                r_T, r_norm, r_inl = r.T.reshape(16), r.norm, r.inliers
                rr_T = (last_reg if has_reg_h
                        else multipnp(kf_feat, last_feat, u[2], 12).T).reshape(16)

        new_kf = ok & (res.norm > max_pos_change)
        promote = new_kf | resc_ok
        robot_n = torch.where(ok, T @ kf_pos, robot)
        # a rescue leaves robot where it was, and generate_keyframe sets
        # kf_pos = robot: promote covers both
        kf_pos_n = torch.where(promote, robot_n, kf_pos)
        tracked = ok | resc_ok
        lost_n = torch.where(tracked, 0, lost + 1).to(torch.int32)
        carry_n = TrackCarry(
            _select(promote, feat, kf_feat), kf_pos_n, robot_n, lost_n,
            _select(tracked, feat, last_feat),
            torch.where(ok & ~new_kf, res.T, last_reg) if rescue else last_reg,
            torch.where(ok, ~new_kf, has_reg & ~resc_ok) if rescue else has_reg)
        f32 = torch.float32
        rec = torch.cat([
            T.reshape(16).to(f32),
            torch.stack([res.norm.to(f32), res.inliers.to(f32), ok.to(f32),
                         new_kf.to(f32), lost_n.to(f32)]),
            robot_n[:3, 3].to(f32),
            resc_ok.to(f32)[None],
            r_T.to(f32),
            torch.stack([r_norm.to(f32), r_inl.to(f32)]),
            rr_T.to(f32),
        ])
        return carry_n, feat, rec

    def track_chunk(carry: TrackCarry, grays, depths, draws: ChunkDraws):
        feats, recs = [], []
        for j in range(chunk):
            sampler = draws.samplers[j] if draws.samplers is not None else None
            carry, feat, rec = step(carry, grays[j], depths[j], sampler, draws.u[j])
            feats.append(feat)
            recs.append(rec)
        return carry, FrameFeatures(*(torch.stack(f) for f in zip(*feats))), torch.stack(recs)

    return track_chunk


def _source(filename: str) -> str:
    """A file as a sync log names it: relative to the repository for
    this package's files, its name alone for others (PyTorch's)."""
    rel = os.path.relpath(filename, os.path.dirname(_PACKAGE))
    return os.path.basename(filename) if rel.startswith("..") else rel


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _take(stack: FrameFeatures, i: int) -> FrameFeatures:
    return FrameFeatures(*(f[i] for f in stack))


class _StreamingMixin:
    """Chunked tracking shared by the image-only and plane frontends. Use
    run_streaming(n_frames) instead of n run() calls.

    Subclasses provide _make_extract_fn() -> extract(gray, depth,
    sampler)."""

    def _init_streaming(self, chunk: int):
        self.chunk = chunk
        # chunks decoded ahead of the dispatch by the loader threads
        # (config key streaming_prefetch_chunks); 0 loads, dispatches and
        # applies one chunk at a time
        self.chunk_prefetch = self.params.get_int("streaming_prefetch_chunks")
        self._tracker = None
        self.dispatches = 0
        self.replay_extractions = 0  # made by run() in lostRecovery replays
        # a list to record, per dispatch, whether its carry came from the
        # host and where each synchronizing CUDA operation in it came
        # from ("file:line"); None records nothing
        self.sync_log = None

    def _setup_prefetch(self, want_pcd: bool, **kw):
        """No per-frame native prefetch: chunks are decoded whole in the
        loader threads, and per-frame loaders would decode the frames a
        second time. The per-frame replays read synchronously."""
        del want_pcd, kw
        self._prefetch = None

    def _frame_files_exist(self, idx: int) -> bool:
        """Contiguous-prefix probe. The plane frontend also needs the
        frame's PCD: the chunk path backprojects the depth image and
        never reads it, but the per-frame replay after a lostRecovery
        does, so a frame without one ends the run here."""
        if not os.path.exists(os.path.join(self.rgb_path, f"{idx}.png")):
            return False
        if not self.image_only:
            return os.path.exists(os.path.join(self.pcl_path, f"{idx}.pcd"))
        return True

    def _ensure_tracker(self):
        if self._tracker is None:
            # as run(): only the plane frontend without odometry rescues
            rescue = (not self.image_only) and not self.use_odometry
            self._tracker = build_tracker(
                self._make_extract_fn(), self._multipnp, self.max_pos_change,
                self.chunk, rescue=rescue, rescue_inliers=self.loop_closure_inliers,
                rescue_error=self.loop_closure_error)

    def _load_frames(self, indices):
        """Decode a chunk's frames in threads into host tensors (uint8
        gray, int32 depth), padded to the chunk by repeating the last
        frame, pinned when the run is on the card. Touches no frontend
        state, so a loader thread may call it."""

        def load_one(idx):
            g = images.load_gray(os.path.join(self.rgb_path, f"{idx}.png"))
            d = images.load_depth(os.path.join(self.dep_path, f"{idx}.png"))
            return np.asarray(g, np.uint8), np.asarray(d).astype(np.int32)

        if len(indices) > 1:
            # PNG decoding releases the GIL for its heavy part
            with cf.ThreadPoolExecutor(max_workers=8) as ex:
                pairs = list(ex.map(load_one, indices))
        else:
            pairs = [load_one(idx) for idx in indices]
        pairs += [pairs[-1]] * (self.chunk - len(pairs))
        grays = torch.from_numpy(np.stack([g for g, _ in pairs]))
        depths = torch.from_numpy(np.stack([d for _, d in pairs]))
        if self.device.type == "cuda":
            grays, depths = grays.pin_memory(), depths.pin_memory()
        return grays, depths

    def _schedule_load(self, loader, start: int, budget: int):
        """Submit the next full chunk's decode to a loader thread.
        Returns (indices, future) or None (a partial chunk, a file gap or
        the frame budget spent: the tail path takes those)."""
        if budget < self.chunk:
            return None
        indices = []
        for idx in range(start, start + self.chunk):
            if not self._frame_files_exist(idx):
                return None
            indices.append(idx)
        return indices, loader.submit(self._load_frames, indices)

    def run_streaming(self, n_frames: int) -> int:
        """Process up to n_frames (stops at missing files). Returns the
        number of frames processed.

        Three stages: while chunk k's records are applied on the host,
        chunk k+1 is already dispatched (with k's device carry) and chunk
        k+2 decodes in a loader thread. If applying chunk k leaves the
        device's path (a lostRecovery and its per-frame replay), chunk
        k+1 was dispatched from a stale carry and is dispatched again
        from the host's state; its decoded frames stay valid."""
        self._ensure_tracker()
        if self.chunk_prefetch <= 0:
            return self._run_streaming_tail(n_frames, 0)
        done = 0
        inflight = carry_after = None
        next_fetch = self.index
        pending = collections.deque()  # (indices, future of the host frames)
        with cf.ThreadPoolExecutor(max_workers=self.chunk_prefetch) as loader:
            while True:
                committed = done + (len(inflight["indices"]) if inflight else 0)
                committed += sum(len(i) for i, _ in pending)

                def refill():
                    nonlocal next_fetch, committed
                    # a contiguous prefix only: a gap ends the run
                    while len(pending) < self.chunk_prefetch:
                        p = self._schedule_load(loader, next_fetch, n_frames - committed)
                        if p is None:
                            return
                        pending.append(p)
                        next_fetch = p[0][-1] + 1
                        committed += len(p[0])

                refill()
                nxt = None
                if pending:
                    indices, fut = pending.popleft()
                    carry = inflight["carry"] if inflight else None
                    nxt = self._dispatch_chunk(indices, carry=carry, frames=fut.result())
                    refill()
                if inflight is not None:
                    applied, clean = self._process_chunk(inflight)
                    done += applied
                    carry_after = inflight["carry"] if clean else None
                    if not clean and nxt is not None:
                        nxt = self._dispatch_chunk(nxt["indices"], frames=nxt["frames"])
                inflight = nxt
                if inflight is None:
                    break
        return self._run_streaming_tail(n_frames, done, carry_after)

    def _run_streaming_tail(self, n_frames: int, done: int,
                            carry: Optional[TrackCarry] = None) -> int:
        """Load, dispatch and apply one chunk at a time: the tail when
        fewer than `chunk` frames remain or a file gap broke the
        pipelined prefix, and the whole run with streaming_prefetch_chunks
        0. A partial chunk is padded by repeating its last frame; only
        its real frames are applied. carry: the device carry of the chunk
        applied last, when the host followed it."""
        while done < n_frames and self._frame_files_exist(self.index):
            indices = []
            idx = self.index
            while (done + len(indices) < n_frames and len(indices) < self.chunk
                   and self._frame_files_exist(idx)):
                indices.append(idx)
                idx += 1
            st = self._dispatch_chunk(indices, carry=carry,
                                      frames=self._load_frames(indices))
            applied, clean = self._process_chunk(st)
            done += applied
            carry = st["carry"] if clean else None
        return done

    def _host_carry(self) -> TrackCarry:
        """The tracker's carry from the host state (the first chunk, or
        after the host left the device's path)."""
        dev = self.device

        def mat(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        reg = self._last_reg
        has_reg = reg is not None and reg[0] == self.curr_kf.id
        return TrackCarry(
            self.curr_kf.features, mat(self.kf_pos), mat(self.robot),
            torch.tensor(self.lost, dtype=torch.int32, device=dev),
            self.last if self.last is not None else self.curr_kf.features,
            mat(se3.inverse(reg[1]) if has_reg else np.eye(4)),
            torch.tensor(has_reg, device=dev))

    def _chunk_draws(self) -> ChunkDraws:
        u = torch.rand((self.chunk, 3) + self._u_shape, generator=self._gen,
                       device=self.device)
        samplers = (None if self.image_only
                    else [plane_ransac.UniformSampler(self._gen)] * self.chunk)
        return ChunkDraws(samplers, u)

    @contextlib.contextmanager
    def _watch_syncs(self, from_host: bool):
        """With `sync_log` a list and the run on the card, record where
        each synchronizing CUDA operation in the block came from."""
        if self.sync_log is None or self.device.type != "cuda":
            yield
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        self.sync_log.append((from_host, [f"{_source(w.filename)}:{w.lineno}" for w in caught
                                          if "synchroniz" in str(w.message)]))

    def _dispatch_chunk(self, indices, carry: Optional[TrackCarry] = None, frames=None):
        """Launch the tracker over a chunk's frames. carry: the device
        carry of the previous chunk; None builds it from the host state.
        frames: the host tensors of _load_frames."""
        if frames is None:
            frames = self._load_frames(indices)
        with self._watch_syncs(from_host=carry is None):
            grays, depths = (f.to(self.device, non_blocking=True) for f in frames)
            if carry is None:
                carry = self._host_carry()
            carry_out, feats, recs = self._tracker(carry, grays, depths, self._chunk_draws())
            event = None
            if self.device.type == "cuda":
                # pinned, not waited for here: _process_chunk waits on the event
                recs = recs.to("cpu", non_blocking=True)
                event = torch.cuda.Event()
                event.record()
        self.extractions += self.chunk  # padded frames are extracted too
        self.dispatches += 1
        return {"indices": indices, "frames": frames, "carry": carry_out,
                "feats": feats, "recs": recs, "event": event}

    def _process_chunk(self, chunk_state) -> tuple:
        """Apply one tracked chunk's records on the host. Returns
        (frames applied, clean); clean is False when the per-frame replay
        ran, so that the host state no longer matches the device carry."""
        self.maybe_drain_loop_closures()
        indices = chunk_state["indices"]
        feats = chunk_state["feats"]
        if chunk_state["event"] is not None:
            chunk_state["event"].synchronize()
        recs = chunk_state["recs"].numpy()  # the chunk's one readback

        applied = 0
        last_ptr = -1  # the device's `last` frame within this chunk
        for j, idx in enumerate(indices):
            T = recs[j, :16].astype(np.float64).reshape(4, 4)
            norm = float(recs[j, 16])
            ok = recs[j, 18] != 0.0
            new_kf = recs[j, 19] != 0.0
            self.index = idx
            self._sync_odometry()
            if not ok:
                self._log("error_of_transform.log", "9999\n")
                if recs[j, 24] != 0.0:
                    # _rescue_with_last's bookkeeping: promote last, then
                    # present; robot stays where it was
                    r_T = recs[j, 25:41].astype(np.float64).reshape(4, 4)
                    Z = se3.inverse(recs[j, 43:59].astype(np.float64).reshape(4, 4))
                    self.lost = 0
                    new_id = self.curr_kf.id + 1
                    self.curr_kf = Keyframe(
                        id=new_id, frame_index=idx - 1,
                        features=_take(feats, last_ptr) if last_ptr >= 0 else self.last)
                    self._register_keyframe(self.curr_kf)
                    self.opt.add_vertex(new_id, self.odo_this if self.use_odometry
                                        else np.eye(4))
                    self.opt.add_edge(new_id - 1, new_id, Z, INFO_VISUAL)
                    self._chain_pose_hint(new_id, Z)
                    feat_j = _take(feats, j)
                    self.generate_keyframe(se3.inverse(r_T), feat_j)
                    self.last = feat_j
                    self.last_frame_index = idx
                    self._last_reg = None
                    last_ptr = j
                else:
                    self.lost = int(recs[j, 20])
            else:
                self._log("error_of_transform.log", f"{norm:g}\n")
                self.robot = T @ self.kf_pos
                self.lost = 0
                feat_j = _take(feats, j)
                if new_kf:
                    self.generate_keyframe(T, feat_j)
                    if self.loop_closure_detection:
                        self.loop_closure()
                    self._last_reg = None
                else:
                    self._last_reg = (self.curr_kf.id, T)
                self.last = feat_j
                self.last_frame_index = idx
                last_ptr = j
            applied += 1
            if self.lost > self.lost_frames:
                # recovery mutates the graph and the keyframe; the records
                # past this frame assumed none: replay the rest per frame.
                # run() recovers before its index increment, so the
                # recovery keyframe records frame_index == idx
                feat_j = _take(feats, j)
                self.lost_recovery(feat_j)
                self.last = feat_j
                self.last_frame_index = idx
                self._last_reg = None
                self.index = idx + 1
                before = self.extractions
                for k in range(j + 1, len(indices)):
                    self.index = indices[k]
                    self.run()
                    applied += 1
                self.replay_extractions += self.extractions - before
                return applied, False
            self.index = idx + 1
        return applied, True


class StreamingGraphicEnd2(_StreamingMixin, GraphicEnd2):
    """Image-only frontend with chunked tracking."""

    def __init__(self, params=None, data_dir: str = "./data", chunk: int = 8, device=None):
        super().__init__(params, data_dir=data_dir, device=device)
        self._init_streaming(chunk)

    def _make_extract_fn(self):
        extract_img = self.extract_img

        def ext(gray, depth, sampler):
            return extract_img(gray, depth)

        return ext


class StreamingGraphicEnd(_StreamingMixin, GraphicEnd):
    """Plane frontend with chunked tracking.

    The chunk path backprojects each frame's depth image on the device
    (convert2PCD's semantics, so the same cloud as the PCD files of a
    dataset made by the documented workflow) instead of reading the PCD
    file. `voxel_downsample_clouds` applies as in readimage, at the same
    capacity; `align_cloud_scale` has nothing to do here, since the cloud
    comes from the frame's own depth image. The last-frame rescue runs in
    the tracker's loop; only lostRecovery replays frames per frame (and
    reads the PCD files)."""

    def __init__(self, params=None, data_dir: str = "./data", chunk: int = 8, device=None):
        super().__init__(params, data_dir=data_dir, device=device)
        self._init_streaming(chunk)

    def _make_extract_fn(self):
        extract, intr, z_filter = self.extract, self.intr, self.z_filter

        def ext(gray, depth, sampler):
            xyz, valid = pointcloud.backproject(
                depth, intr.fx, intr.fy, intr.cx, intr.cy, intr.factor)
            xyz = xyz.reshape(-1, 3)
            valid = pointcloud.passthrough_z(xyz, valid.reshape(-1), 0.0, z_filter)
            if self.voxel_downsample_clouds:
                xyz, valid = self._voxel_grid(xyz, valid)
            return extract(gray, depth, xyz, valid, sampler)

        return ext
