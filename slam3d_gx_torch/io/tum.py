"""TUM RGB-D dataset file contracts: associate.txt, trajectories, logs.

Parity targets:
- associate.txt rows `rgb_ts rgb_path dep_ts dep_path [odo_ts tx ty tz qx qy qz qw]`
  consumed token-wise by GraphicEnd::readOdometry (reference
  src/GraphicEnd.h:148-170: skip 5 tokens, read 7 doubles per row);
- trajectory.txt rows `timestamp tx ty tz qx qy qz qw` (reference
  src/generateTrajectory.cpp:68-71), the TUM evaluation format;
- keyframe.txt rows `id frame_index` (reference src/GraphicEnd.cpp:678);
- lc.txt rows `frame1 frame2 norm inliers` (reference src/GraphicEnd.cpp:861);
- the timestamp join of generateTrajectory, which walks associate.txt by
  line offsets `frame - jump` (reference src/generateTrajectory.cpp:53-76).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..geometry import se3


@dataclasses.dataclass
class AssociateRow:
    rgb_ts: str
    rgb_path: str
    dep_ts: str
    dep_path: str
    odo_ts: Optional[str] = None
    pose: Optional[np.ndarray] = None  # (7,) x y z qx qy qz qw


def read_associate(path: str) -> List[AssociateRow]:
    rows: List[AssociateRow] = []
    with open(path, "r", encoding="ascii", errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if len(tok) < 4:
                continue
            row = AssociateRow(tok[0], tok[1], tok[2], tok[3])
            if len(tok) >= 12:
                row.odo_ts = tok[4]
                row.pose = np.array([float(x) for x in tok[5:12]])
            rows.append(row)
    return rows


def read_odometry(path: str) -> List[np.ndarray]:
    """All odometry poses from associate.txt through the reference remap.

    Mirrors GraphicEnd::init's use_odometry loop (src/GraphicEnd.cpp:105-120):
    one remapped 4x4 per associate row, in file order.
    """
    return [
        se3.odometry_remap(r.pose) for r in read_associate(path) if r.pose is not None
    ]


def read_trajectory(path: str) -> List[Tuple[float, np.ndarray]]:
    """TUM trajectory file -> [(timestamp, (7,) pose)] (comments skipped)."""
    out = []
    with open(path, "r", encoding="ascii", errors="replace") as f:
        for raw in f:
            line = raw.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if len(tok) < 8:
                continue
            out.append((float(tok[0]), np.array([float(x) for x in tok[1:8]])))
    return out


def write_trajectory(path: str, rows: List[Tuple[str, np.ndarray]]) -> None:
    """Write `timestamp x y z qx qy qz qw ` rows (reference trailing-space
    format: src/generateTrajectory.cpp:68-71 emits a space after every
    value)."""
    with open(path, "w", encoding="ascii") as f:
        for ts, data7 in rows:
            f.write(str(ts) + " " + " ".join(_g(x) for x in data7) + " \n")


def _g(x: float) -> str:
    return f"{x:.6g}"


def write_keyframes(path: str, pairs: List[Tuple[int, int]]) -> None:
    with open(path, "w", encoding="ascii") as f:
        for kid, frame in pairs:
            f.write(f"{kid} {frame}\n")


def read_keyframes(path: str) -> List[Tuple[int, int]]:
    out = []
    with open(path, "r", encoding="ascii", errors="replace") as f:
        for raw in f:
            tok = raw.split()
            if len(tok) >= 2:
                out.append((int(tok[0]), int(tok[1])))
    return out


def associate_timestamps(
    first: Dict[float, List[str]],
    second: Dict[float, List[str]],
    offset: float = 0.0,
    max_difference: float = 0.02,
) -> List[Tuple[float, float]]:
    """Nearest-timestamp join (the TUM associate algorithm).

    Re-implemented from the published TUM tool the reference vendors
    (tools/associate.py:71-101): greedily take pairs in order of |dt|.
    """
    potential = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first
        for b in second
        if abs(a - (b + offset)) < max_difference
    )
    first_left = set(first)
    second_left = set(second)
    matches = []
    for _, a, b in potential:
        if a in first_left and b in second_left:
            first_left.remove(a)
            second_left.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def read_timestamp_file(path: str) -> Dict[float, List[str]]:
    out: Dict[float, List[str]] = {}
    with open(path, "r", encoding="ascii", errors="replace") as f:
        for raw in f:
            line = raw.replace(",", " ").replace("\t", " ").strip()
            if not line or line.startswith("#"):
                continue
            tok = [t for t in line.split(" ") if t]
            if len(tok) > 1:
                out[float(tok[0])] = tok[1:]
    return out


def frame_timestamp_lookup(associate_path: str) -> List[str]:
    """frame index (1-based) -> rgb timestamp string, in file order."""
    return [r.rgb_ts for r in read_associate(associate_path)]


def dataset_paths(data_source: str) -> Tuple[str, str, str]:
    """(rgb_index/, dep_index/, pcd/) dirs (reference src/GraphicEnd.cpp:83-85)."""
    return (
        os.path.join(data_source, "rgb_index"),
        os.path.join(data_source, "dep_index"),
        os.path.join(data_source, "pcd"),
    )
