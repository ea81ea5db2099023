"""K3 `min_eig_response`: the Shi-Tomasi corner response as one CUDA kernel.

It replaces the Pallas TPU kernel `_min_eig_kernel`
(slam3d_gx_tpu/ops/pallas_kernels.py, launched by
`min_eig_response_fused`), which the GFTT detector calls once per frame
extraction. Source, bound and design notes: csrc/min_eig.cu.

The kernel is one resident wave of 128-thread blocks. A thread owns
`cols` adjacent columns and slides down `rows` output rows; a warp
writes 30 * cols columns, and a block's four warps, stacked, make a tile
of 30 * cols columns by 4 * rows rows. `geometry` computes the launch
here (tiles, grid, the interior/border split), and the kernel walks the
tiles it is given with a grid stride. The image is read in place when
its columns are adjacent in memory, whatever its row pitch.

The wrapper takes the plain PyTorch version for a tensor on the CPU and
launches the kernel for a tensor on a CUDA device, or raises; it never
falls back. `LAUNCHES` counts kernel launches, and nothing else adds to
it.

Tolerance: the kernel does the plain version's operations in its order,
each rounded to nearest (no FMA; IEEE division and sqrt), and its output
is bit-identical to the first design's (`_min_eig_tile`, kept off every
path as the yardstick). The plain version differs in last bits only: on
the card PyTorch divides by a scalar as a product with its reciprocal,
and on the CPU its sqrt is not always correctly rounded. The two are
held to 1e-6 of the image's largest box sum (the response is a
difference of two such sums); on a 480x640 uint8 image that is 3e-6 of
the largest response.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..ops.features.common import box_filter, sobel_gradients
from . import build

SOURCE = "min_eig"
LAUNCHES = {"min_eig_response": 0}

WARPS = 4        # warps of a block, stacked vertically
LANES_OUT = 30   # lanes of a warp that write; lanes 0 and 31 feed their neighbours
VARIANTS = ((4, 1), (4, 2), (4, 3), (4, 4), (4, 8), (8, 2))  # (cols, rows) built
COLS, ROWS = 4, 2  # the main path's variant

_VP, _LL, _CI = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = {
    "slam_min_eig": [_VP, _VP, _CI, _CI, _CI, _LL, _CI, _CI, _CI, _CI, _CI, _VP],
    "slam_min_eig_resident": [_CI, _CI, _CI],
    "slam_min_eig_tile": [_VP, _CI, _CI, _CI, _VP, _VP],
    "slam_min_eig_selfcheck": [_VP, _VP],
    "slam_min_eig_empty": [_CI, _VP],
}
_entries = {}
_resident_blocks = {}  # (device index, is_u8, cols, rows) -> blocks held at once
_launch_args = {}  # (device index, H, W, pitch, dtype, cols, rows) -> the C entry's int arguments


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    if not _entries:
        _entries.update(build.bind(SOURCE, _ARGTYPES))
    return _entries[name]


class Geometry(NamedTuple):
    cols: int      # columns a thread owns
    rows: int      # output rows a thread slides down
    tile_w: int    # output columns of a tile: LANES_OUT * cols
    tile_h: int    # output rows of a tile: WARPS * rows
    tiles_x: int
    tiles_y: int
    n_tiles: int
    grid: int      # blocks launched: min(n_tiles, blocks the card holds at once)


def geometry(H: int, W: int, cols: int = COLS, rows: int = ROWS,
             resident: int = 1 << 30) -> Geometry:
    """The launch of K3 over an (H, W) image. Block b takes tiles
    b, b + grid, b + 2 grid, ...; tile t = ty * tiles_x + tx."""
    if (cols, rows) not in VARIANTS:
        raise ValueError(f"min_eig_response: no kernel built for (cols, rows) = "
                         f"{(cols, rows)}; built: {VARIANTS}")
    tile_w, tile_h = LANES_OUT * cols, WARPS * rows
    tiles_x, tiles_y = -(-W // tile_w), -(-H // tile_h)
    n = tiles_x * tiles_y
    return Geometry(cols, rows, tile_w, tile_h, tiles_x, tiles_y, n, min(n, resident))


def tile_origin(g: Geometry, t: int):
    """(first output row, first output column) of tile t."""
    ty, tx = divmod(t, g.tiles_x)
    return ty * g.tile_h, tx * g.tile_w


def tile_is_interior(g: Geometry, H: int, W: int, t: int) -> bool:
    """Whether every image row and column tile t reads lies inside the
    image, so that it takes the kernel's path without clamps: its lanes
    read columns [c0 - cols, c0 + 31 cols), its warps rows [r0 - 2,
    r0 + tile_h + 1]."""
    r0, c0 = tile_origin(g, t)
    return (c0 - g.cols >= 0 and c0 + 31 * g.cols <= W and r0 - 2 >= 0
            and r0 + g.tile_h + 1 <= H - 1)


def pitched(img: torch.Tensor):
    """(x, row pitch in elements): `img` as the kernel reads it, uint8 or
    float32 (other types are cast), in place when its columns are
    adjacent in memory and copied to a contiguous tensor only when they
    are not."""
    x = img if img.dtype in (torch.uint8, torch.float32) else img.to(torch.float32)
    H, W = x.shape
    if W > 1 and x.stride(1) != 1:
        x = x.contiguous()
    return x, (x.stride(0) if H > 1 else W)


def structure_tensor(img: torch.Tensor, block_radius: int = 1):
    """Box means of the Sobel gradient products: (sxx, syy, sxy)."""
    dx, dy = sobel_gradients(img)
    return (box_filter(dx * dx, block_radius), box_filter(dy * dy, block_radius),
            box_filter(dx * dy, block_radius))


def min_eig_response_plain(img: torch.Tensor, block_radius: int = 1) -> torch.Tensor:
    """Shi-Tomasi: the smaller eigenvalue of the 2x2 structure tensor.
    (H,W) uint8 or float -> (H,W) f32, in the reference's order of
    operations (harris.min_eig_response)."""
    sxx, syy, sxy = structure_tensor(img.to(torch.float32), block_radius)
    tr_half = (sxx + syy) * 0.5
    d = (sxx - syy) * 0.5
    return tr_half - torch.sqrt(d * d + sxy * sxy)


def _check_image(img: torch.Tensor) -> None:
    if img.dim() != 2 or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"min_eig_response: expected a non-empty (H,W) image, got "
                         f"{tuple(img.shape)}")
    if img.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"min_eig_response: unsupported device {img.device}")


def _resident(device: torch.device, is_u8: int, cols: int, rows: int) -> int:
    """Blocks of the (cols, rows) kernel that `device` holds at once."""
    key = (device.index, is_u8, cols, rows)
    n = _resident_blocks.get(key)
    if n is None:
        with torch.cuda.device(device):
            n = _entry("slam_min_eig_resident")(is_u8, cols, rows)
        if n < 1:
            raise RuntimeError(f"min_eig_response: no block fits on {device} "
                               f"(CUDA error {-n})")
        _resident_blocks[key] = n
    return n


def _launch_min_eig(img: torch.Tensor, cols: int = COLS, rows: int = ROWS) -> torch.Tensor:
    """One launch of K3 in variant (cols, rows) over a 2-D image on the
    card -> (H, W) f32."""
    x, pitch = pitched(img)
    H, W = x.shape
    dev = x.device
    key = (dev.index, H, W, pitch, x.dtype, cols, rows)
    args = _launch_args.get(key)
    if args is None:
        is_u8 = int(x.dtype == torch.uint8)
        g = geometry(H, W, cols, rows, _resident(dev, is_u8, cols, rows))
        args = _launch_args[key] = (is_u8, H, W, pitch, cols, rows, g.tiles_x, g.n_tiles,
                                    g.grid)
    out = torch.empty((H, W), dtype=torch.float32, device=dev)
    build.launch(_entry("slam_min_eig"), "min_eig_response", dev, x.data_ptr(),
                 out.data_ptr(), *args)
    LAUNCHES["min_eig_response"] += 1
    return out


def _min_eig_tile(img: torch.Tensor) -> torch.Tensor:
    """The first design of K3 (32x16 tiles staged in shared memory), on
    no path: the yardstick and bit-equality oracle of the kernel on the
    card. Not counted in LAUNCHES."""
    _check_image(img)
    x = img if img.dtype in (torch.uint8, torch.float32) else img.to(torch.float32)
    x = x.contiguous()
    H, W = x.shape
    out = torch.empty((H, W), dtype=torch.float32, device=x.device)
    build.launch(_entry("slam_min_eig_tile"), "min_eig_tile", x.device, x.data_ptr(),
                 int(x.dtype == torch.uint8), H, W, out.data_ptr())
    return out


def launch_empty(device, grid: int) -> None:
    """Launch a kernel that does nothing in `grid` blocks of K3's shape:
    the fixed cost of such a launch, for measurement. Counted nowhere."""
    build.launch(_entry("slam_min_eig_empty"), "min_eig_empty", torch.device(device), grid)


def rounding_selfcheck(device) -> dict:
    """Every float32 through the kernel's branch-free x / 9 and sqrt
    against the IEEE intrinsics (__fdiv_rn, __fsqrt_rn) on the card. Per
    operation: `differ`, the inputs on which they give another value
    (+0 and -0 agree, as do two NaNs);
    `differ_accepted`, those among them that the kernel would not hand
    to the intrinsics (must be 0); `refused`, the inputs it would; and the
    smallest and largest |x| that differ."""
    device = torch.device(device)
    c = torch.zeros(10, dtype=torch.int64, device=device)
    c[[3, 8]] = 2 ** 32 - 1
    build.launch(_entry("slam_min_eig_selfcheck"), "min_eig_selfcheck", device, c.data_ptr())
    v = c.cpu().tolist()
    keys = ("differ", "differ_accepted", "refused", "min_abs_bits", "max_abs_bits")
    return {op: dict(zip(keys, v[5 * i:5 * i + 5])) for i, op in enumerate(("div9", "sqrt"))}


def min_eig_response(img: torch.Tensor) -> torch.Tensor:
    """Shi-Tomasi response map of an (H,W) image, H, W >= 1, uint8 or
    float -> (H,W) f32 on the input's device. The kernel reads uint8 and
    f32 in place, at any row pitch; other types are cast to f32 first."""
    _check_image(img)
    if img.device.type == "cpu":
        return min_eig_response_plain(img)
    return _launch_min_eig(img)
