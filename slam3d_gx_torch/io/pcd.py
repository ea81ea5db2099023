"""PCD v0.7 point-cloud codec (PointXYZRGBA), byte-compatible with PCL.

Parity target: pcl::io::loadPCDFile / savePCDFile as used by the reference
(src/GraphicEnd.cpp:281, src/convert2PCD.cpp:78, src/saveOutput.cpp:58,95;
format fixture: reference data/exp1/pcd/1.pcd). Binary layout is the packed
16-byte (x,y,z float32 + rgba uint32) record, little-endian; ASCII mirrors
PCL's writer (precision-8 floats, decimal unsigned rgba). The reference's
savePCDFile default is ASCII, so write_pcd defaults to ASCII too.

Clouds are plain numpy structured-free arrays: (N,3) float32 xyz plus an
(N,) uint32 rgba — the fixed-capacity/masked device layout is built on top
in ops/.
"""

from __future__ import annotations

import io as _io
from typing import Tuple

import numpy as np

_POINT_DTYPE = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgba", "<u4")])


def _make_header(n: int, data_kind: str, has_rgba: bool) -> str:
    fields = "x y z rgba" if has_rgba else "x y z"
    size = "4 4 4 4" if has_rgba else "4 4 4"
    typ = "F F F U" if has_rgba else "F F F"
    cnt = "1 1 1 1" if has_rgba else "1 1 1"
    return (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {size}\n"
        f"TYPE {typ}\n"
        f"COUNT {cnt}\n"
        f"WIDTH {n}\n"
        "HEIGHT 1\n"
        "VIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {data_kind}\n"
    )


def write_pcd(path: str, xyz: np.ndarray, rgba: np.ndarray | None = None, binary: bool = False) -> None:
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    n = xyz.shape[0]
    has_rgba = rgba is not None
    if has_rgba:
        rgba = np.asarray(rgba, dtype=np.uint32).reshape(-1)
        assert rgba.shape[0] == n
    header = _make_header(n, "binary" if binary else "ascii", has_rgba)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            if has_rgba:
                rec = np.empty(n, dtype=_POINT_DTYPE)
                rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
                rec["rgba"] = rgba
                f.write(rec.tobytes())
            else:
                f.write(np.ascontiguousarray(xyz, dtype="<f4").tobytes())
        else:
            buf = _io.StringIO()
            if has_rgba:
                for i in range(n):
                    buf.write(f"{xyz[i,0]:.8g} {xyz[i,1]:.8g} {xyz[i,2]:.8g} {int(rgba[i])}\n")
            else:
                for i in range(n):
                    buf.write(f"{xyz[i,0]:.8g} {xyz[i,1]:.8g} {xyz[i,2]:.8g}\n")
            f.write(buf.getvalue().encode("ascii"))


def read_pcd(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a PCD file -> ((N,3) float32 xyz, (N,) uint32 rgba).

    Supports DATA ascii and DATA binary, FIELDS `x y z [rgb|rgba]`.
    Missing color yields zeros. Trailing pad bytes after POINTS*stride
    are ignored (the reference fixture has them).

    The native codec (native/pcd_codec.cc, same field contract and
    float-rgb bit-pattern semantics) serves ASCII files ~10x faster
    than np.loadtxt; for DATA binary numpy's frombuffer is faster than
    the native per-point loop, so binary (and any exotic layout) uses
    the Python parser below.
    """
    with open(path, "rb") as f:
        head = f.read(4096)
        if b"\nDATA ascii" in head:
            # route by header only — don't slurp the file before
            # delegating, and fall through to the Python parser on any
            # native-codec failure (import, availability, or parse)
            try:
                from .. import native_io

                if native_io.available():
                    return native_io.pcd_read(path)
            except Exception:
                pass
        raw = head + f.read()

    # header: ascii lines until DATA line
    pos = 0
    meta = {}
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if not line or line.startswith("#"):
            continue
        key, _, val = line.partition(" ")
        meta[key.upper()] = val
        if key.upper() == "DATA":
            break

    fields = meta.get("FIELDS", "x y z").split()
    sizes = [int(s) for s in meta.get("SIZE", "4 4 4").split()]
    types = meta.get("TYPE", "F F F").split()
    counts = [int(c) for c in meta.get("COUNT", " ".join(["1"] * len(fields))).split()]
    n = int(meta.get("POINTS", meta.get("WIDTH", "0")))
    kind = meta["DATA"].split()[0].lower()

    np_types = {"F": "f", "U": "u", "I": "i"}
    dtype = np.dtype(
        [
            (name if counts[i] == 1 else f"{name}", f"<{np_types[types[i]]}{sizes[i]}", (counts[i],) if counts[i] > 1 else ())
            for i, name in enumerate(fields)
        ]
    )

    if kind == "binary":
        rec = np.frombuffer(raw, dtype=dtype, count=n, offset=pos)
    elif kind == "ascii":
        text = raw[pos:].decode("ascii", errors="replace")
        cols = np.loadtxt(_io.StringIO(text), dtype=np.float64, max_rows=n, ndmin=2)
        rec = np.empty(n, dtype=dtype)
        ci = 0
        for i, name in enumerate(fields):
            w = counts[i]
            col = cols[:, ci : ci + w]
            rec[name] = col.astype(dtype[name].base) if w > 1 else col[:, 0].astype(dtype[name])
            ci += w
    else:
        raise ValueError(f"unsupported PCD DATA kind: {kind}")

    xyz = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    if "rgba" in fields:
        rgba = rec["rgba"].astype(np.uint32)
    elif "rgb" in fields:
        # PCL packs rgb as a float bit-pattern; reinterpret
        f = rec["rgb"]
        rgba = f.view(np.uint32) if f.dtype.kind == "f" else f.astype(np.uint32)
    else:
        rgba = np.zeros(n, dtype=np.uint32)
    return xyz, rgba


def pack_rgba(r: np.ndarray, g: np.ndarray, b: np.ndarray) -> np.ndarray:
    """r<<16 | g<<8 | b, the reference's packing (src/convert2PCD.cpp:65)."""
    return (
        (r.astype(np.uint32) << 16) | (g.astype(np.uint32) << 8) | b.astype(np.uint32)
    )


def unpack_rgba(rgba: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rgba = rgba.astype(np.uint32)
    return (
        ((rgba >> 16) & 0xFF).astype(np.uint8),
        ((rgba >> 8) & 0xFF).astype(np.uint8),
        (rgba & 0xFF).astype(np.uint8),
    )
