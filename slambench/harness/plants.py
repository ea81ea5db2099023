"""The control and the planted faults that `correct` must reject.

Never used by a benchmark run: `calibrate.py` runs them on the card to
read the upper end of each limit, and the tests run them on the CPU to
see `correct` come out false.

- control "tf32": the program with its TensorFloat-32 path switched on
  (matrix products and convolutions in TF32 inside the window), the
  nearest precision below the float32 with TF32 off that the
  configuration states;
- control "bf16ref": the reference computed in bfloat16 put in the
  program's place for the extraction's outputs (keypoint list, 3-D
  points, descriptors), the nearest precision below float32 for
  arithmetic that is no matrix product;
- fault "unchanged": the pose-graph solve returns its state unchanged;
- fault "half_batch": the batched verifier computes the first half of
  each batch and answers the rest with repeats of it;
- fault "half_reject": the batched verifier computes the first half of
  each batch and leaves the rest out, answering it as rejected (the
  identity, no inliers), as a registration that failed answers;
- fault "altered": each registration's pose is moved 30 cm where the
  multiPnP produces it.
"""

from __future__ import annotations

import torch

KINDS = ("tf32", "bf16ref", "unchanged", "half_batch", "half_reject", "altered")


class Plant:
    def __init__(self, kind: str):
        if kind not in KINDS:
            raise ValueError(f"plant {kind!r}: one of {KINDS}")
        self.kind = kind
        self.control_dtype = torch.bfloat16 if kind == "bf16ref" else None
        self._undo = []

    def _patch(self, obj, attr, value):
        self._undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    def window_start(self):
        if self.kind == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        elif self.kind == "unchanged":
            from slam3d_gx_torch.backend import pose_graph
            self._patch(pose_graph.PoseGraphOptimizer, "optimize",
                        lambda self, *a, **k: 0.0)
        elif self.kind == "half_batch":
            from slam3d_gx_torch.parallel import registration
            cls = registration.BatchedRegistrar
            real = cls._dispatch_stacked

            def half(self, fa, fb, u, min_inliers, n_valid):
                b = u.shape[0]
                keep = max(1, b // 2)
                idx = torch.arange(b, device=u.device) % keep
                packed, n = real(self, *(type(x)(*(f[:keep] for f in x)) for x in (fa, fb)),
                                 u[:keep], min_inliers, min(n_valid, keep))
                return packed[idx], n_valid

            self._patch(cls, "_dispatch_stacked", half)
        elif self.kind == "half_reject":
            from slam3d_gx_torch.parallel import registration
            cls = registration.BatchedRegistrar
            real = cls._dispatch_stacked

            def first_half(self, fa, fb, u, min_inliers, n_valid):
                b = u.shape[0]
                keep = (b + 1) // 2
                packed, _ = real(self, *(type(x)(*(f[:keep] for f in x)) for x in (fa, fb)),
                                 u[:keep], min_inliers, min(n_valid, keep))
                rejected = torch.zeros((b - keep, packed.shape[1]), dtype=packed.dtype,
                                       device=packed.device)
                rejected[:, [0, 5, 10, 15]] = 1.0  # T = identity; norm, inliers, ok 0
                return torch.cat([packed, rejected]), n_valid

            self._patch(cls, "_dispatch_stacked", first_half)

    def window_end(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for obj, attr, old in reversed(self._undo):
            setattr(obj, attr, old)
        self._undo = []

    def frontend(self, ge):
        if self.kind != "altered":
            return
        real = ge._multipnp

        def moved(fa, fb, u, minimum_inliers):
            res = real(fa, fb, u, minimum_inliers)
            T = res.T.clone()
            T[..., 0, 3] += 0.3
            return res._replace(T=T)

        ge._multipnp = moved
