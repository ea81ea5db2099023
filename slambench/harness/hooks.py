"""What the benchmark attaches to the program while it runs.

- `Recorder` keeps what the timed path produces, for the check after the
  window: each extraction (frame index, FrameFeatures, the keypoints the
  descriptor saw and the descriptors it returned) and each registration
  (the two feature sets, the frames they were extracted from, the
  inlier minimum it was asked for, the result as the program reported
  it, accepted or not). It holds references to the device tensors only:
  no copy, no host wait.
- `Spans` (traced runs only) times calls into the program's layers: each
  span synchronizes the device before and after, and keeps its interval
  on the wall clock (time.time_ns, the clock of the profiler's device
  timestamps) so that the trace's idle gaps can be charged to it.

Both wrap methods of one frontend instance, or a module attribute that
the frontend looks up when it is built, and take nothing else from the
program.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Recorder:
    def __init__(self):
        self.extractions = []     # dicts: frame, features, kps, desc
        self.registrations = []   # dicts: fa, fb, frames, min, and result or (packed, row)
        self._current = None      # the extraction being built
        self._frame_of = {}       # id(FrameFeatures) -> frame index, for live extractions

    def frame_of(self, features):
        """The frame an extraction's features came from, or None."""
        return self._frame_of.get(id(features))

    # -- extraction --------------------------------------------------------
    def note_describe(self, kps, desc):
        """The descriptor pass of the extraction in progress: its input
        keypoints and its output."""
        if self._current is not None:
            self._current["kps"] = kps
            self._current["desc"] = desc

    def attach(self, ge):
        """Wrap one frontend's extraction and registration entries."""
        extract = ge._extract_present
        multipnp = ge.multipnp

        def extract_present():
            ent = {"frame": ge.index}
            self._current = ent
            try:
                ent["features"] = extract()
            finally:
                self._current = None
            self.extractions.append(ent)
            self._frame_of[id(ent["features"])] = ent["frame"]
            return ent["features"]

        def recorded_multipnp(fa, fb, minimum_inliers):
            res = multipnp(fa, fb, minimum_inliers)
            self.registrations.append({"fa": fa, "fb": fb, "min": int(minimum_inliers),
                                       "frames": (self.frame_of(fa), self.frame_of(fb)),
                                       "result": res})
            return res

        ge._extract_present = extract_present
        ge.multipnp = recorded_multipnp
        reg = ge.batch_registrar
        if reg is not None:
            dispatch = reg.dispatch_against_one

            def recorded_dispatch(store, indices, single, u, min_inliers,
                                  single_is_target=True):
                pending = dispatch(store, indices, single, u, min_inliers, single_is_target)
                kfs = iter([ge.keyframes[int(i)].features for i in indices])
                one = self.frame_of(single)
                for packed, n in pending:
                    for r in range(n):
                        kf = next(kfs)
                        fa, fb = (kf, single) if single_is_target else (single, kf)
                        frames = ((self.frame_of(kf), one) if single_is_target
                                  else (one, self.frame_of(kf)))
                        self.registrations.append({"fa": fa, "fb": fb, "min": int(min_inliers),
                                                   "frames": frames, "packed": (packed, r)})
                return pending

            reg.dispatch_against_one = recorded_dispatch


class Spans:
    """Synchronized host-clock spans by name."""

    def __init__(self, sync=True):
        self.seconds = defaultdict(list)
        self.intervals = []  # (start ns, end ns, name) on the wall clock
        self.sync = sync

    @contextlib.contextmanager
    def span(self, name: str):
        if self.sync:
            torch.cuda.synchronize()
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        if self.sync:
            torch.cuda.synchronize()
        self.seconds[name].append(time.perf_counter() - t0)
        self.intervals.append((w0, time.time_ns(), name))

    def wrap(self, obj, attr: str, name: str):
        fn = getattr(obj, attr)

        def timed(*a, **kw):
            with self.span(name):
                return fn(*a, **kw)

        setattr(obj, attr, timed)

    def attach(self, ge, optimizer):
        """The per-layer spans of one frontend and its backend: read, extract, multiPnP,
        loop-closure round, findMoreLoops, the pose-graph solve."""
        self.wrap(ge, "readimage", "read")
        self.wrap(ge, "_extract_present", "extract")
        self.wrap(ge, "multipnp", "multipnp")
        self.wrap(ge, "loop_closure", "lc_round")
        self.wrap(ge, "find_more_loops", "find_more_loops")
        self.wrap(optimizer, "optimize", "optimize")
