"""Agreement of two voxel-grid clouds (the fused maps of saveOutput).

Two fusions of the same keyframes on two devices, or by two packages,
sum in another order, so a centroid can move by rounding and, near a
voxel's face, land in the next voxel. The clouds are compared voxel by
voxel: a point matches when the other cloud has a point in the same
voxel of edge `leaf`, within `tol` m and with colors within `color_tol`.
"""

from __future__ import annotations

import numpy as np


def cloud_agreement(xyz_a, rgb_a, xyz_b, rgb_b, leaf: float, tol: float = 1e-4,
                    color_tol: float = 1.0) -> float:
    """Share of cloud a's points that match a point of cloud b."""
    xyz_a, xyz_b = np.asarray(xyz_a, np.float64), np.asarray(xyz_b, np.float64)
    if len(xyz_a) == 0:
        return 1.0 if len(xyz_b) == 0 else 0.0
    of_b = {tuple(k): i for i, k in enumerate(np.floor(xyz_b / leaf).astype(np.int64))}
    rgb_a, rgb_b = np.asarray(rgb_a, np.float64), np.asarray(rgb_b, np.float64)
    matched = 0
    for i, k in enumerate(np.floor(xyz_a / leaf).astype(np.int64)):
        j = of_b.get(tuple(k))
        matched += (j is not None and np.abs(xyz_a[i] - xyz_b[j]).max() <= tol
                    and np.abs(rgb_a[i] - rgb_b[j]).max() <= color_tol)
    return matched / len(xyz_a)
