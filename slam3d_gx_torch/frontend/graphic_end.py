"""Host SLAM state machine: GraphicEnd (planes) and GraphicEnd2
(image-only) (counterpart of slam3d_gx_tpu/frontend/graphic_end.py).

The reference's per-frame control flow, branch for branch:

- GraphicEnd::run (src/GraphicEnd.cpp:150-264): lost handling with
  last-frame rescue, keyframe decision at max_pos_change, loop closure,
  lost counter -> lostRecovery;
- generateKeyFrame edges with information diag(100) and optional odometry
  edges at 1/sigma^2 (src/GraphicEnd.cpp:304-351);
- loopClosure: deterministic -3/-4 checks + `loopclosure_frames` random
  draws over keyframes[0..size-4], dedup via `checked` (685-762);
- lostRecovery: unconstrained vertex + all-history scan or odometry edge
  (764-838);
- findMoreLoops/check/checknearby post-hoc loop expansion (864-947);
- saveFinalResult: findMoreLoops -> optimize(optimize_step) ->
  keyframe.txt + final_after.g2o (661-682);
- logs: error_of_transform.log (9999 = lost), lc.txt, lost.txt.

With `loop_closure_batched: 1` (the default) loop closure, recovery and
the findMoreLoops scans verify a round's candidates in one batched call
(parallel/registration.py); a loop-closure round is launched when its
keyframe is made and read back later, once `lc_drain_threshold` rounds
are pending or before anything reads loop edges (lostRecovery, save).
With 0 they verify candidates one at a time, the reference's sequential
check. Random draws come from one `torch.Generator` on the device,
seeded from the config key `seed`.

With `loop_closure_scored: 1` a round's candidates are the keyframes
that the retrieval database (parallel/lcdb.py) scores best against the
new keyframe, in place of uniform draws; with the batched verifier the
whole round (scores, top-k, gather, verification) is dispatched with no
host wait and read back at the drain. `finalize_prefilter: N` ranks the
history by the same score in findMoreLoops' scan and registers only the
N best pairs of each source; the rest are cached as failed verdicts.

`mesh_devices: N` runs the frontend on the N ranks of a process group
(one process a card: `torchrun --nproc-per-node N`), with a (dp, sp)
mesh (parallel/mesh.py) that the batched verifier, the retrieval
database and the final pose-graph solve split their work over. Every
rank runs this state machine with the same seed and reaches the same
decisions; only rank 0 writes the logs and the final files.

With the native library (native_io.py) built, frames after the first
are decoded ahead by its threaded loaders while the device works.

Two deliberate deltas:
- when the last-frame rescue promotes the last frame, the reference
  registers it against the current keyframe again
  (src/GraphicEnd.cpp:183-227) and adds that result as the edge without
  checking it, so a failed second RANSAC adds an identity edge. The port
  reuses the registration that accepted the last frame against that same
  keyframe one frame earlier (the same inputs) and registers again only
  when there is none;
- `finalize_prefilter` alone leaves the loop-closure sampler uniform, as
  the key's documentation says; the JAX package scores loop-closure
  candidates whenever the database exists, so there the pre-filter also
  switches the sampler. Only `loop_closure_scored` does that here.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from .. import native_io
from ..config import ParameterReader
from ..device import resolve_device
from ..geometry import se3
from ..io import images, pcd, tum
from ..ops import plane_ransac, pointcloud
from ..ops.features import registry as feat_registry
from ..parallel import lcdb, mesh as mesh_mod, registration
from . import pipeline
from .state import FrameFeatures, Keyframe, result_to_host, unpack_result_row

INFO_VISUAL = np.diag([100.0] * 6)


class GraphicEnd:
    """Plane-feature SLAM frontend."""

    image_only = False

    def __init__(self, params: Optional[ParameterReader] = None,
                 data_dir: str = "./data", device=None):
        self.params = params if params is not None else ParameterReader("./parameters.yaml")
        p = self.params
        self.device = resolve_device(device)
        self.mesh = self._make_mesh(p.get_int("mesh_devices"))
        # the rank that writes the logs and the final files
        self.writes = mesh_mod.is_main_rank()
        self.data_dir = data_dir
        self.intr = p.intrinsics

        self.detector_name = p.GetPara("detector_name")
        self.descriptor_name = p.GetPara("descriptor_name")
        self.start_index = p.get_int("start_index")
        self.step_time = p.get_int("step_time")  # accepted, headless
        self.distance_threshold = p.get_float("distance_threshold")
        self.error_threshold = p.get_float("error_threshold")
        self.percent = p.get_float("plane_percent")
        self.max_pos_change = p.get_float("max_pos_change")
        self.max_planes = p.get_int("max_planes")
        self.loopclosure_frames = p.get_int("loopclosure_frames")
        self.loop_closure_detection = p.get_bool("loop_closure_detection")
        self.loop_closure_error = p.get_float("loop_closure_error")
        self.loop_closure_inliers = p.get_int("loop_closure_inliers")
        self.lost_frames = p.get_int("lost_frames")
        self.use_odometry = p.get_bool("use_odometry")
        self.error_odometry = p.get_float("error_odometry")
        self.z_filter = p.get_float("z_filter")
        self.grid_leaf = p.get_float("grid_leaf")
        self.voxel_downsample_clouds = p.get_bool("voxel_downsample_clouds")
        self.max_kp = p.get_int("max_keypoints")
        self.hypotheses = p.get_int("ransac_hypotheses")
        self.seed = p.get_int("seed")
        self.cloud_capacity = p.get_int("cloud_capacity")
        self.frame_kp_budget = p.get_int("frame_kp_budget")
        self.align_cloud_scale = p.get_bool("align_cloud_scale")
        self.lc_max_drift = p.get_float("loop_closure_max_drift")
        self.loop_closure_scored = p.get_int("loop_closure_scored") != 0
        self.finalize_prefilter = p.get_int("finalize_prefilter")

        self.rgb_path, self.dep_path, self.pcl_path = tum.dataset_paths(
            p.GetPara("data_source"))

        self._rng = random.Random(self.seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self._build_pipeline()
        self.kf_store = None  # registration.FeatureStore: keyframe features on the device
        # lcdb.KeyframeDatabase, built with the first keyframe when
        # loop_closure_scored or finalize_prefilter is on
        self.lcdb = None
        # loop-closure rounds launched and not read back yet:
        # ("explicit", candidate indices, record flags, the round's
        # keyframe, pending results) or ("fused", the round's keyframe,
        # its (B,21) packed rows)
        self._pending_lc = []
        # nothing in the frontend reads loop edges before lostRecovery or
        # the final save, so rounds wait and are read back in one copy
        # once this many are pending
        self.lc_drain_threshold = 24

        # state
        self.robot = np.eye(4)
        self.kf_pos = np.eye(4)
        self.keyframes: List[Keyframe] = []
        self.curr_kf: Optional[Keyframe] = None
        self.present: Optional[FrameFeatures] = None
        self.last: Optional[FrameFeatures] = None
        self.last_frame_index = 0
        self.lost = 0
        self.index = self.start_index
        self.odometry: List[np.ndarray] = []
        self.odo_this = np.eye(4)
        self.odo_last = np.eye(4)
        self._lcfile = None
        self._check_cache = {}  # (k1,k2) -> (passed, T) pair verdicts
        self._kf_pose = {}  # kf id -> dead-reckoned pose for the drift gate
        self._pending_feat = None
        self._pending_index = None
        # (keyframe id, edge T) of the accepted registration of `last`
        # against that keyframe; None when `last` is itself the keyframe
        self._last_reg = None
        self.extractions = 0  # frames run through the extractor
        self._prefilter_pruned = 0  # pairs finalize_prefilter left unregistered
        self._prefetch = None  # native_io loaders of the frames ahead
        self.prefetched = 0  # frames read from them

    # -- construction ------------------------------------------------------
    def _make_mesh(self, n: int):
        """`mesh_devices`: 0 no mesh; N the (dp, sp) mesh over the N ranks
        of the process group, which must have N ranks (1 without a group
        starts a one-rank group); -1 all ranks of the group, and no mesh
        when there is one rank or no group."""
        if n == 0:
            return None
        if n == -1:
            n = mesh_mod.world_size()
            if n == 1:
                return None
        return mesh_mod.make_mesh(n, device=self.device)

    def _build_pipeline(self):
        self.extract = pipeline.build_plane_extractor(
            self.detector_name, self.descriptor_name, self.intr,
            max_planes=self.max_planes, max_kp=self.max_kp,
            dist_thresh=self.distance_threshold, percent=self.percent,
            hypotheses=self.hypotheses,
            plane_image_mode=self.params.GetPara("plane_image_mode"),
            detect_scope=self.params.GetPara("detect_scope"),
            frame_kp_budget=self.frame_kp_budget,
        )
        self._multipnp = pipeline.build_multipnp_planes(
            self.intr, error_threshold=self.error_threshold,
            match_floor=feat_registry.match_floor(self.descriptor_name),
            refine_mode=self.params.GetPara("pnp_refine_mode"),
        )
        # uniforms of one registration: a block per solve
        self._u_shape = (self.max_planes + 2, self.hypotheses, 3)
        self.batch_registrar = self._make_batch_registrar()

    def _make_batch_registrar(self):
        """The batched loop-closure / recovery verifier; config key
        `loop_closure_batched` 0 keeps the reference's sequential
        per-candidate checks."""
        if self.params.get_int("loop_closure_batched") == 0:
            return None
        return registration.BatchedRegistrar(
            self.intr, image_only=self.image_only,
            error_threshold=self.error_threshold,
            match_floor=feat_registry.match_floor(self.descriptor_name), mesh=self.mesh)

    def _uniforms(self, *batch: int) -> torch.Tensor:
        """Fresh PnP draws from the run's generator, for one
        registration or a batch of them."""
        return torch.rand(batch + self._u_shape, generator=self._gen, device=self.device)

    def multipnp(self, fa: FrameFeatures, fb: FrameFeatures, minimum_inliers: int):
        """One registration with fresh PnP draws."""
        return self._multipnp(fa, fb, self._uniforms(), minimum_inliers)

    def _register_keyframe(self, kf: Keyframe):
        self.keyframes.append(kf)
        if self.batch_registrar is not None:
            if self.kf_store is None:
                self.kf_store = registration.FeatureStore(kf.features)
            self.kf_store.add(kf.features)
        if self.lcdb is None and (self.loop_closure_scored or self.finalize_prefilter > 0):
            p, k, d = kf.features.desc.shape
            self.lcdb = lcdb.KeyframeDatabase(
                n_desc=p * k, dim=d, device=self.device, mesh=self.mesh,
                match_floor=feat_registry.match_floor(self.descriptor_name))
        if self.lcdb is not None:
            self.lcdb.add(kf.features)

    # -- prefetch ------------------------------------------------------------
    def _setup_prefetch(self, want_pcd: bool, queue_depth: int = 4, threads: int = 2):
        """Start the native threaded loaders on every frame after the
        current one, so that decoding overlaps the device's work (the
        reference decodes each frame when it reads it,
        src/GraphicEnd.cpp:266-302). Without the native library readimage
        decodes in Python."""
        self._prefetch = None
        if not native_io.available():
            return
        last = self.index
        while os.path.exists(os.path.join(self.rgb_path, f"{last + 1}.png")):
            last += 1
        if last <= self.index:
            return
        # the loaders' frame size: the first frame they read (one of
        # another size comes back as a failed item, read synchronously)
        with Image.open(os.path.join(self.rgb_path, f"{self.index + 1}.png")) as first:
            w, h = first.size
        idx = range(self.index + 1, last + 1)

        def loader(path, ext, mode, **kw):
            return native_io.PrefetchLoader([os.path.join(path, f"{i}.{ext}") for i in idx],
                                            mode, queue_depth=queue_depth, threads=threads, **kw)

        self._prefetch = {
            "gray": loader(self.rgb_path, "png", native_io.MODE_GRAY8, height=h, width=w),
            "depth": loader(self.dep_path, "png", native_io.MODE_DEPTH16, height=h, width=w)}
        if want_pcd:
            self._prefetch["pcd"] = loader(self.pcl_path, "pcd", native_io.MODE_PCD)
        self._prefetch_next = self.index + 1

    def _prefetch_pop(self):
        """(gray, depth, (xyz, rgba) or None) of this frame from the
        loaders, when they are at this frame; None sends the caller to
        the synchronous read."""
        if self._prefetch is None or self._prefetch_next != self.index:
            return None
        try:
            got = [self._prefetch[k].next() if k in self._prefetch else None
                   for k in ("gray", "depth", "pcd")]
        except StopIteration:
            self._prefetch = None
            return None
        self._prefetch_next += 1
        if got[0] is None or got[1] is None:
            return None
        self.prefetched += 1
        return tuple(got)

    # -- io ------------------------------------------------------------------
    def _log(self, name: str, text: str, append: bool = True):
        if not self.writes:
            return
        os.makedirs(self.data_dir, exist_ok=True)
        with open(os.path.join(self.data_dir, name), "a" if append else "w") as f:
            f.write(text)

    def readimage(self):
        pre = self._prefetch_pop()
        if pre is not None:
            gray, depth, points = pre
        else:
            gray = images.load_gray(os.path.join(self.rgb_path, f"{self.index}.png"))
            depth = images.load_depth(os.path.join(self.dep_path, f"{self.index}.png"))
            points = None
        if points is None:  # not prefetched, or the loader could not read it
            points = pcd.read_pcd(os.path.join(self.pcl_path, f"{self.index}.pcd"))
        xyz = points[0]
        # PCD clouds may use another depth unit than the depth image
        # (convert2PCD factor 1000 vs fr1's 5000): align them so the
        # membership images and kp3d agree
        if self.align_cloud_scale:
            s = pointcloud.estimate_depth_scale(
                xyz, depth, self.intr.fx, self.intr.fy, self.intr.cx,
                self.intr.cy, self.intr.factor)
            if s > 1.5 or s < 1 / 1.5:
                xyz = xyz / np.float32(s)
        # pad the raw cloud to one fixed capacity for the whole run
        # (default H*W); larger clouds are stride-decimated to fit. The
        # extractor's plane-point stride is taken over this capacity.
        if not hasattr(self, "_cloud_cap"):
            self._cloud_cap = (self.cloud_capacity if self.cloud_capacity > 0
                               else int(gray.size))
        cap = self._cloud_cap
        n = xyz.shape[0]
        if n > cap:
            xyz = xyz[::-(-n // cap)]
            n = xyz.shape[0]
        xyz_p = np.zeros((cap, 3), np.float32)
        xyz_p[:n] = xyz
        mask = np.zeros(cap, bool)
        mask[:n] = True
        dev = self.device
        cloud = torch.from_numpy(xyz_p).to(dev)
        # z passthrough (reference src/GraphicEnd.cpp:283-293)
        mask = pointcloud.passthrough_z(cloud, torch.from_numpy(mask).to(dev), 0.0,
                                        self.z_filter)
        if self.voxel_downsample_clouds:
            cloud, mask = self._voxel_grid(cloud, mask)
        self.curr_cloud = cloud
        self.curr_cloud_mask = mask
        self.curr_gray = torch.tensor(gray, device=dev)
        self.curr_depth = torch.from_numpy(depth.astype(np.int32)).to(dev)

    def _voxel_grid(self, cloud, mask):
        """The reference's VoxelGrid(grid_leaf) before the plane RANSAC
        (src/GraphicEnd.cpp:287-295), config key `voxel_downsample_clouds`;
        off, the extractor's strided decimation plays its part. The voxels
        are packed to the front of a capacity of 4x the extractor's point
        budget, so its stride stays 4 and keeps voxels uniformly."""
        xyz, _, mask = pointcloud.voxel_downsample(
            cloud, torch.zeros_like(cloud), mask, self.grid_leaf,
            capacity=min(cloud.shape[0], 4 * pipeline.PLANE_POINTS))
        return xyz, mask

    def _extract_present(self) -> FrameFeatures:
        self.extractions += 1
        return self.extract(self.curr_gray, self.curr_depth, self.curr_cloud,
                            self.curr_cloud_mask, plane_ransac.UniformSampler(self._gen))

    def _take_or_extract_present(self) -> FrameFeatures:
        """The extraction dispatched during the previous frame, or a
        synchronous read + extract."""
        if self._pending_feat is not None and self._pending_index == self.index:
            feat, self._pending_feat = self._pending_feat, None
            return feat
        self.readimage()
        return self._extract_present()

    def _dispatch_next_extract(self):
        """Read and enqueue the next frame's extraction after this
        frame's multiPnP is enqueued and before its result is read back,
        so the device works on it while the host waits."""
        nxt = self.index + 1
        if not os.path.exists(os.path.join(self.rgb_path, f"{nxt}.png")):
            self._pending_feat = None
            return
        cur = self.index
        self.index = nxt  # readimage keys off self.index
        try:
            self.readimage()
            self._pending_feat = self._extract_present()
            self._pending_index = nxt
        finally:
            self.index = cur

    # -- init -----------------------------------------------------------------
    def init(self, slam_end):
        self.slam_end = slam_end
        self.opt = slam_end.globalOptimizer
        if self.use_odometry:
            self.odometry = tum.read_odometry(
                os.path.join(self.params.GetPara("data_source"), "associate.txt"))
            self.odo_this = self.odo_last = self.odometry[self.index - 1]

        self._log("error_of_transform.log", "", append=False)

        self.readimage()
        self._setup_prefetch(want_pcd=not self.image_only)
        feats = self._extract_present()
        self.curr_kf = Keyframe(id=0, frame_index=self.index, features=feats)
        self._register_keyframe(self.curr_kf)
        self._kf_pose[0] = np.eye(4)
        self.opt.add_vertex(0, self.odo_this if self.use_odometry else self.robot,
                            fixed=True)
        self.last = feats
        self.last_frame_index = self.index
        self.index += 1

    # -- per-frame step ---------------------------------------------------------
    def _sync_odometry(self):
        if self.use_odometry and self.odometry:
            self.odo_this = self.odometry[min(self.index, len(self.odometry)) - 1]

    def run(self):
        self.maybe_drain_loop_closures()
        self._sync_odometry()
        present = self._take_or_extract_present()
        self.present = present

        res = self.multipnp(self.curr_kf.features, present, 12)
        self._dispatch_next_extract()
        T, norm, inliers, ok = result_to_host(res)
        T = se3.inverse(T)  # the reference inverts here (src/GraphicEnd.cpp:170)

        if not ok:
            self._log("error_of_transform.log", "9999\n")
            if self.use_odometry:
                self.lost += 1
            else:
                self._rescue_with_last(present)
        elif norm > self.max_pos_change:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.generate_keyframe(T, present)
            if self.loop_closure_detection:
                self.loop_closure()
            self.lost = 0
            self.last = present
            self.last_frame_index = self.index
            self._last_reg = None
        else:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.lost = 0
            self.last = present
            self.last_frame_index = self.index
            self._last_reg = (self.curr_kf.id, T)

        if self.lost > self.lost_frames:
            self.lost_recovery(present)
            self.last = present
            self.last_frame_index = self.index
            self._last_reg = None

        self.index += 1
        if self.use_odometry:
            self.odo_this = self.odometry[min(self.index, len(self.odometry)) - 1]
        return 1

    def _rescue_with_last(self, present: FrameFeatures):
        """Lost branch: try the last ordinary frame; on success promote
        both last and present to keyframes (src/GraphicEnd.cpp:183-227)."""
        r = self.multipnp(self.last, present, 12)
        r_T, r_norm, r_inl, r_ok = result_to_host(r)
        if (not r_ok) or r_inl < self.loop_closure_inliers \
                or r_norm > self.loop_closure_error:
            self.lost += 1
            return
        self.lost = 0
        if self._last_reg is not None and self._last_reg[0] == self.curr_kf.id:
            Z = self._last_reg[1]  # see the module docstring
        else:
            rr_T, _, _, _ = result_to_host(self.multipnp(self.curr_kf.features, self.last, 12))
            Z = se3.inverse(rr_T)
        new_id = self.curr_kf.id + 1
        self.curr_kf = Keyframe(id=new_id, frame_index=self.index - 1, features=self.last)
        self._register_keyframe(self.curr_kf)
        self.opt.add_vertex(new_id, self.odo_this if self.use_odometry else np.eye(4))
        self.opt.add_edge(new_id - 1, new_id, Z, INFO_VISUAL)
        self._chain_pose_hint(new_id, Z)
        self.generate_keyframe(se3.inverse(r_T), present)
        self.last = present
        self.last_frame_index = self.index
        self._last_reg = None

    def generate_keyframe(self, T: np.ndarray, present: FrameFeatures):
        new_id = self.curr_kf.id + 1
        self.kf_pos = self.robot
        self.curr_kf = Keyframe(id=new_id, frame_index=self.index, features=present)
        self._register_keyframe(self.curr_kf)
        self.opt.add_vertex(new_id, self.odo_this if self.use_odometry else np.eye(4))
        self.opt.add_edge(new_id - 1, new_id, T, INFO_VISUAL)
        self._chain_pose_hint(new_id, T)
        if self.use_odometry:
            To = se3.inverse(self.odo_last) @ self.odo_this
            self.opt.add_edge(new_id - 1, new_id, To,
                              np.eye(6) / (self.error_odometry**2))
            self.odo_last = self.odo_this

    # -- drift gate (config key loop_closure_max_drift; 0 = off) ---------------
    def _chain_pose_hint(self, new_id: int, Z) -> None:
        """hint_new = hint_prev @ Z for the sequential edge new-1 -> new;
        a missing predecessor leaves the chain broken (gate permissive)."""
        prev = self._kf_pose.get(new_id - 1)
        self._kf_pose[new_id] = None if prev is None else prev @ np.asarray(Z, np.float64)

    def _reanchor_pose_hint(self, new_id: int, anchor_id: int, Z) -> None:
        """Re-anchor a broken hint chain from an accepted edge anchor -> new."""
        if self._kf_pose.get(new_id) is not None:
            return
        pa = self._kf_pose.get(anchor_id)
        if pa is not None:
            self._kf_pose[new_id] = pa @ np.asarray(Z, np.float64)

    def _lc_within_drift(self, old_kf: Keyframe, new_kf: Keyframe, Z) -> bool:
        """Reject a loop edge whose measured relative translation deviates
        from the dead-reckoned prediction by more than the gate."""
        if self.lc_max_drift <= 0:
            return True
        pa = self._kf_pose.get(old_kf.id)
        pb = self._kf_pose.get(new_kf.id)
        if pa is None or pb is None:
            return True
        expected = se3.inverse(pa) @ pb
        return float(np.linalg.norm(expected[:3, 3] - Z[:3, 3])) <= self.lc_max_drift

    # -- loop closure -------------------------------------------------------
    # a scored round's first rows: the deterministic -3/-4 checks
    # (record=False, src/GraphicEnd.cpp:694-725)
    _LC_N_DET = 2

    def _apply_loop_result(self, old_kf: Keyframe, new_kf: Keyframe, res,
                           record: bool) -> bool:
        """Gate one verified candidate (host tuple of a registration
        old -> new) and, on a pass, add its loop edge."""
        T, norm, inl, ok = res
        if not ok or norm > self.loop_closure_error or inl < self.loop_closure_inliers:
            return False
        Z = se3.inverse(T)
        if not self._lc_within_drift(old_kf, new_kf, Z):
            return False
        if record:
            self.display_lc(old_kf.frame_index, new_kf.frame_index, norm, inl)
        self.opt.add_edge(old_kf.id, new_kf.id, Z, INFO_VISUAL, robust=True)
        # an accepted edge re-anchors a hint chain broken by a blackout
        self._reanchor_pose_hint(new_kf.id, old_kf.id, Z)
        return True

    def _try_loop_edge(self, kf: Keyframe, record: bool) -> bool:
        res = result_to_host(
            self.multipnp(kf.features, self.curr_kf.features, self.loop_closure_inliers))
        return self._apply_loop_result(kf, self.curr_kf, res, record)

    def maybe_drain_loop_closures(self):
        """Read pending rounds back once enough of them wait (see
        lc_drain_threshold)."""
        if len(self._pending_lc) >= self.lc_drain_threshold:
            self.drain_pending_loop_closures()

    def drain_pending_loop_closures(self):
        """Read back every launched loop-closure round, in one copy, and
        apply its edges and logs in launch order."""
        if not self._pending_lc:
            return
        parts = []
        for ent in self._pending_lc:
            if ent[0] == "fused":
                parts.append(ent[2])
            else:
                parts.extend(packed[:n] for packed, n in ent[4])
        fetched = iter(registration.fetch_all(parts))
        for ent in self._pending_lc:
            if ent[0] == "fused":
                kf = ent[1]
                for i, row in enumerate(next(fetched)):
                    if row[20] == 0.0:  # an invalid candidate
                        continue
                    # the first _LC_N_DET rows are the deterministic checks
                    record = i >= self._LC_N_DET
                    ki = int(row[19])
                    if self._apply_loop_result(self.keyframes[ki], kf,
                                               unpack_result_row(row), record) and record:
                        kf.connect.append(ki)
                continue
            _, cand, records, kf, pending = ent
            rows = [r for _ in pending for r in next(fetched)]
            for i, record, row in zip(cand, records, rows):
                if self._apply_loop_result(self.keyframes[i], kf, unpack_result_row(row),
                                           record) and record:
                    kf.connect.append(i)
        self._pending_lc = []

    def loop_closure(self):
        if len(self.keyframes) <= 3:
            return
        # deterministic keyframes -3/-4 (src/GraphicEnd.cpp:694-725) +
        # `loopclosure_frames` dedup'd uniform draws (729-761), or the best
        # scored keyframes with loop_closure_scored
        if self.loop_closure_scored and self.batch_registrar is not None:
            # the fused round: no host wait until the drain
            idx, valid = self.lcdb.select_candidates_device(
                self.curr_kf.features, self.loopclosure_frames, n_det=self._LC_N_DET)
            packed = self.batch_registrar.dispatch_fused(
                self.kf_store, idx, valid, self.curr_kf.features,
                self._uniforms(idx.shape[0]), self.loop_closure_inliers)
            self._pending_lc.append(("fused", self.keyframes[-1], packed))
            return
        nearby = [len(self.keyframes) + i for i in (-3, -4)
                  if len(self.keyframes) + i >= 0]
        checked: List[int] = []
        if self.loop_closure_scored:
            checked = self.lcdb.top_candidates(self.curr_kf.features, self.loopclosure_frames)
        else:
            for _ in range(self.loopclosure_frames):
                frame = self._rng.randrange(len(self.keyframes) - 3)
                if frame not in checked:
                    checked.append(frame)

        if self.batch_registrar is not None:
            # every candidate is judged on its own, so the round is one
            # batched launch, read back later (see the module docstring)
            cand = nearby + checked
            # record by position, not by membership: an index in both
            # lists gets its edge twice (both of the reference's loops add
            # one) and is logged and connected once
            records = [False] * len(nearby) + [True] * len(checked)
            pending = self.batch_registrar.dispatch_against_one(
                self.kf_store, cand, self.curr_kf.features,
                self._uniforms(len(cand)), self.loop_closure_inliers)
            self._pending_lc.append(("explicit", cand, records, self.keyframes[-1], pending))
            return

        for n in nearby:
            self._try_loop_edge(self.keyframes[n], record=False)
        for frame in checked:
            if self._try_loop_edge(self.keyframes[frame], record=True):
                self.keyframes[-1].connect.append(frame)

    def lost_recovery(self, present: FrameFeatures):
        self.drain_pending_loop_closures()
        new_id = self.curr_kf.id + 1
        self.kf_pos = self.robot
        self.curr_kf = Keyframe(id=new_id, frame_index=self.index, features=present)
        self._log("lost.txt", f"{new_id} {self.index}\n")
        self._register_keyframe(self.curr_kf)
        # pose unknown after a blackout: break the drift-gate hint chain
        self._kf_pose[new_id] = None
        self.opt.add_vertex(new_id, self.odo_this if self.use_odometry else np.eye(4))
        if self.use_odometry:
            To = se3.inverse(self.odo_last) @ self.odo_this
            self.opt.add_edge(new_id - 1, new_id, To,
                              np.eye(6) / (self.error_odometry**2))
            self._chain_pose_hint(new_id, To)
            self.odo_last = self.odo_this
            self.lost = 0
            return
        # brute-force re-localization against the whole history
        # (src/GraphicEnd.cpp:810-836), batched or one pair at a time
        cand = list(range(len(self.keyframes) - 1))
        if self.batch_registrar is not None:
            results = self.batch_registrar.run_against_one(
                self.kf_store, cand, self.curr_kf.features,
                self._uniforms(len(cand)), 12)
        else:
            results = (result_to_host(self.multipnp(
                self.keyframes[i].features, self.curr_kf.features, 12)) for i in cand)
        for i, (T, norm, inl, ok) in zip(cand, results):
            if not ok or inl < self.loop_closure_inliers or norm > self.loop_closure_error:
                continue
            Z = se3.inverse(T)
            self.opt.add_edge(self.keyframes[i].id, new_id, Z, INFO_VISUAL, robust=True)
            self.keyframes[-1].connect.append(i)
            self._reanchor_pose_hint(new_id, self.keyframes[i].id, Z)
        self.lost = 0

    def display_lc(self, frame1: int, frame2: int, norm: float, inliers: int):
        if self._lcfile is None:
            self._log("lc.txt", "", append=False)
            self._lcfile = True
        self._log("lc.txt", f"{frame1} {frame2} {norm:g} {inliers}\n")

    # -- post-hoc loop expansion (src/GraphicEnd.cpp:864-947) ---------------
    def _passes(self, norm: float, inl: int, ok: bool) -> bool:
        return bool(ok) and norm <= self.loop_closure_error \
            and inl >= self.loop_closure_inliers

    def _apply_check_verdict(self, k1: int, k2: int) -> bool:
        """Replay the cached verdict of pair (k1, k2) and, on a pass, add
        the loop edge. The reference re-checks pairs and adds duplicate
        edges each time (src/GraphicEnd.cpp:887-915); replaying keeps that
        accumulation of weight without registering again."""
        passed, T = self._check_cache[(k1, k2)]
        if not passed:
            return False
        Z = se3.inverse(T)
        # the walk honors the same drift gate as loopClosure; a rejection
        # stops the walk like a failed check
        if not self._lc_within_drift(self.keyframes[k1], self.keyframes[k2], Z):
            return False
        self.opt.add_edge(self.keyframes[k1].id, self.keyframes[k2].id, Z,
                          INFO_VISUAL, robust=True)
        self._more_loops += 1
        return True

    def check(self, k1: int, k2: int) -> bool:
        """Register keyframes k1 -> k2, unless the pair was checked
        before, and apply the verdict."""
        if (k1, k2) not in self._check_cache:
            T, norm, inl, ok = result_to_host(self.multipnp(
                self.keyframes[k1].features, self.keyframes[k2].features,
                self.loop_closure_inliers))
            self._check_cache[(k1, k2)] = (self._passes(norm, inl, ok), T)
        return self._apply_check_verdict(k1, k2)

    def _scan_source(self, source: int):
        """Fill the verdict cache for every unchecked pair (source, i) in
        one batched round: a walk stops at its first failure, but a
        verdict depends only on the pair, so the source is registered
        against the whole history on its first touch and all its walks
        replay from the cache.

        With finalize_prefilter N > 0, the history is first ranked by the
        retrieval score against the source and only the N best pairs are
        registered; the rest are cached as failed verdicts, so a walk
        stops there as at a failed registration."""
        fresh = [i for i in range(len(self.keyframes))
                 if i != source and (source, i) not in self._check_cache]
        if not fresh:
            return
        limit = self.finalize_prefilter
        if 0 < limit < len(fresh):
            s = self.lcdb.scores(self.keyframes[source].features)
            ranked = sorted(fresh, key=lambda i: -float(s[i]))  # stable: ties by index
            for i in ranked[limit:]:
                self._check_cache[(source, i)] = (False, np.eye(4))
            self._prefilter_pruned += len(ranked) - limit
            fresh = sorted(ranked[:limit])
        results = self.batch_registrar.run_against_one(
            self.kf_store, fresh, self.keyframes[source].features,
            self._uniforms(len(fresh)), self.loop_closure_inliers,
            single_is_target=False)
        for i, (T, norm, inl, ok) in zip(fresh, results):
            self._check_cache[(source, i)] = (self._passes(norm, inl, ok), T)

    def checknearby(self, source: int, target: int) -> List[int]:
        down = [i for i in range(target - 1, -1, -1) if i != source]
        up = [i for i in range(target + 1, len(self.keyframes)) if i != source]
        if self.batch_registrar is not None and (down or up):
            self._scan_source(source)
        checked = []
        for walk in (down, up):
            for i in walk:
                if not self.check(source, i):
                    break
                checked.append(i)
        return checked

    def find_more_loops(self):
        self._more_loops = 0
        for i, kf in enumerate(self.keyframes):
            for j in kf.connect:
                for k in self.checknearby(i, j):
                    self.checknearby(k, i)

    def save_final_result(self, fileaddr: str = ""):
        """Mirrors the reference in ignoring `fileaddr` and writing the
        fixed data-dir paths (src/GraphicEnd.cpp:661-682)."""
        self.drain_pending_loop_closures()
        self.find_more_loops()
        self.opt.optimize(self.params.get_int("optimize_step"), mesh=self.mesh)
        if self.writes:
            os.makedirs(self.data_dir, exist_ok=True)
            tum.write_keyframes(os.path.join(self.data_dir, "keyframe.txt"),
                                [(kf.id, kf.frame_index) for kf in self.keyframes])
            self.opt.save(os.path.join(self.data_dir, "final_after.g2o"))
        if self.mesh is not None:
            mesh_mod.barrier()

    # reference-name aliases
    saveFinalResult = save_final_result  # noqa: N815
    generateKeyFrame = generate_keyframe  # noqa: N815
    loopClosure = loop_closure  # noqa: N815
    lostRecovery = lost_recovery  # noqa: N815


class GraphicEnd2(GraphicEnd):
    """Image-only frontend (reference src/GraphicEnd2.cpp): the whole
    image as one pseudo-plane, no point clouds, no last-frame rescue."""

    image_only = True

    def _build_pipeline(self):
        self.extract_img = pipeline.build_image_extractor(
            self.detector_name, self.descriptor_name, self.intr, max_kp=self.max_kp)
        self._multipnp = pipeline.build_multipnp_image(
            self.intr, error_threshold=self.error_threshold,
            match_floor=feat_registry.match_floor(self.descriptor_name))
        self._u_shape = (self.hypotheses, 3)
        self.batch_registrar = self._make_batch_registrar()

    def readimage(self):
        pre = self._prefetch_pop()
        if pre is not None:
            gray, depth, _ = pre
        else:
            gray = images.load_gray(os.path.join(self.rgb_path, f"{self.index}.png"))
            depth = images.load_depth(os.path.join(self.dep_path, f"{self.index}.png"))
        self.curr_gray = torch.tensor(gray, device=self.device)
        self.curr_depth = torch.from_numpy(depth.astype(np.int32)).to(self.device)

    def _extract_present(self) -> FrameFeatures:
        self.extractions += 1
        return self.extract_img(self.curr_gray, self.curr_depth)

    def run(self):
        self.maybe_drain_loop_closures()
        self._sync_odometry()
        present = self._take_or_extract_present()
        self.present = present

        res = self.multipnp(self.curr_kf.features, present, 12)
        self._dispatch_next_extract()
        T, norm, inliers, ok = result_to_host(res)
        T = se3.inverse(T)

        if not ok:
            self._log("error_of_transform.log", "9999\n")
            self.lost += 1
        elif norm > self.max_pos_change:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.generate_keyframe(T, present)
            if self.loop_closure_detection:
                self.loop_closure()
            self.lost = 0
        else:
            self._log("error_of_transform.log", f"{norm:g}\n")
            self.robot = T @ self.kf_pos
            self.lost = 0

        if self.lost > self.lost_frames:
            self.lost_recovery(present)

        self.index += 1
        if self.use_odometry:
            # clamp: after the last frame the index points one past the
            # odometry table
            self.odo_this = self.odometry[min(self.index, len(self.odometry)) - 1]
        return 0
