"""`.g2o` text codec: VERTEX_SE3:QUAT / EDGE_SE3:QUAT / FIX rows.

Parity target: g2o SparseOptimizer::save/load as used by the reference
(src/run_SLAM.cpp:36 saves data/final.g2o; src/saveOutput.cpp:30 and
src/generateTrajectory.cpp:29 load it; README's g2o_viewer workflow depends
on byte compatibility).

Format:
  VERTEX_SE3:QUAT id x y z qx qy qz qw
  FIX id
  EDGE_SE3:QUAT id1 id2 x y z qx qy qz qw  i11 i12 ... i16 i22 ... i66
with the information matrix serialized as its 21 upper-triangular entries
(row-major, diagonal included).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, TextIO, Tuple

import numpy as np

from ..geometry import se3


@dataclasses.dataclass
class Vertex:
    id: int
    T: np.ndarray  # 4x4 float64
    fixed: bool = False


@dataclasses.dataclass
class Edge:
    id1: int
    id2: int
    T: np.ndarray  # 4x4 float64 measurement (vertex1 -> vertex2)
    information: np.ndarray  # 6x6 float64
    robust: bool = False  # Cauchy kernel flag (not serialized by g2o either)


@dataclasses.dataclass
class Graph:
    vertices: Dict[int, Vertex] = dataclasses.field(default_factory=dict)
    edges: List[Edge] = dataclasses.field(default_factory=list)

    def add_vertex(self, vid: int, T: np.ndarray, fixed: bool = False) -> None:
        self.vertices[vid] = Vertex(vid, np.asarray(T, dtype=np.float64), fixed)

    def add_edge(self, id1: int, id2: int, T: np.ndarray, information: np.ndarray, robust: bool = False) -> None:
        self.edges.append(
            Edge(id1, id2, np.asarray(T, dtype=np.float64), np.asarray(information, dtype=np.float64), robust)
        )


_UPPER_IDX: List[Tuple[int, int]] = [(i, j) for i in range(6) for j in range(i, 6)]


def _fmt(x: float) -> str:
    return f"{x:.10g}"


def write_g2o(graph: Graph, f: TextIO) -> None:
    for vid in sorted(graph.vertices):
        v = graph.vertices[vid]
        d = se3.get_estimate_data(v.T)
        f.write("VERTEX_SE3:QUAT " + str(vid) + " " + " ".join(_fmt(x) for x in d) + "\n")
        if v.fixed:
            f.write(f"FIX {vid}\n")
    for e in graph.edges:
        d = se3.get_estimate_data(e.T)
        info = [e.information[i, j] for (i, j) in _UPPER_IDX]
        f.write(
            "EDGE_SE3:QUAT "
            + f"{e.id1} {e.id2} "
            + " ".join(_fmt(x) for x in d)
            + " "
            + " ".join(_fmt(x) for x in info)
            + "\n"
        )


def save_g2o(graph: Graph, path: str) -> None:
    with open(path, "w", encoding="ascii") as f:
        write_g2o(graph, f)


def read_g2o(f: TextIO) -> Graph:
    g = Graph()
    for raw in f:
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        tag = tok[0].upper()
        if tag == "VERTEX_SE3:QUAT":
            vid = int(tok[1])
            d = np.array([float(x) for x in tok[2:9]])
            g.add_vertex(vid, se3.set_estimate_data(d))
        elif tag == "FIX":
            for t in tok[1:]:
                vid = int(t)
                if vid in g.vertices:
                    g.vertices[vid].fixed = True
        elif tag == "EDGE_SE3:QUAT":
            id1, id2 = int(tok[1]), int(tok[2])
            d = np.array([float(x) for x in tok[3:10]])
            vals = [float(x) for x in tok[10:31]]
            info = np.zeros((6, 6))
            for (i, j), v in zip(_UPPER_IDX, vals):
                info[i, j] = v
                info[j, i] = v
            g.add_edge(id1, id2, se3.set_estimate_data(d), info)
        # PARAMS_*, other vertex/edge types: ignored (not produced by the
        # reference pipeline)
    return g


def load_g2o(path: str) -> Graph:
    with open(path, "r", encoding="ascii", errors="replace") as f:
        return read_g2o(f)
