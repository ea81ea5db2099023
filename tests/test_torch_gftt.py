"""K3's plain version, GFTT and HARRIS against the JAX package.

On the CPU the port's `min_eig_response` runs its plain PyTorch version;
it is held against `harris.min_eig_response` and against the Pallas
kernel `_min_eig_kernel` in interpret mode (patched as
tests/test_pallas_kernels.py does). The CUDA kernel itself runs only on
the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances and why:
- response maps: the plain version follows the reference's order of
  operations (Sobel taps row-major; box rows, then columns, then /9), so
  against `harris.min_eig_response` only XLA:CPU's own fusing (FMA
  contraction, a sqrt that is not correctly rounded) can move a last
  bit of the box sums: 2e-6 of the map's largest box sum, which bounds
  the cancellation in `tr/2 - sqrt(...)`. On integer images every sum
  is exact in fp32 and the bound is the same. The Pallas kernel sums
  the box's 9 taps in another order: the repo's own tolerance for it,
  rtol 1e-5 and atol 1e-3 (tests/test_pallas_kernels.py:79), scaled to
  the image (atol 1e-3 holds for its +-50 image; here atol is 1e-6 of
  the largest box sum, which is the same size there);
- keypoints are compared as sets, because top-k orders equal responses
  differently; a keypoint within 1e-4 (relative) of the quality gate may
  be valid in one package only, and none is in these images.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch import kernels
from slam3d_gx_torch.kernels import min_eig as tk3
from slam3d_gx_torch.ops.features import harris as tharris
from slam3d_gx_torch.ops.features import registry as treg
from slam3d_gx_tpu.ops import pallas_kernels as jpk
from slam3d_gx_tpu.ops.features import harris as jharris
from slam3d_gx_tpu.ops.features import registry as jreg
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.testing import synthetic

INTR = CameraIntrinsics(fx=130.0, fy=130.0, cx=80.0, cy=60.0, factor=5000.0)


def interpret(fn, *args, **kw):
    from jax.experimental import pallas

    orig = pallas.pallas_call
    try:
        pallas.pallas_call = functools.partial(orig, interpret=True)
        return np.asarray(fn(*args, **kw))
    finally:
        pallas.pallas_call = orig


def images():
    rng = np.random.default_rng(7)
    return {
        "48x200": (rng.normal(size=(48, 200)) * 50).astype(np.float32),
        "37x53": (rng.normal(size=(37, 53)) * 50).astype(np.float32),
        "1xW": (rng.normal(size=(1, 23)) * 50).astype(np.float32),
        "Hx1": (rng.normal(size=(19, 1)) * 50).astype(np.float32),
        "constant": np.full((21, 34), 93.0, np.float32),
        "integer": rng.integers(0, 256, (40, 72)).astype(np.float32),
    }


def scale(img):
    """The largest box sum the response is a difference of."""
    sxx, syy, _ = tk3.structure_tensor(torch.from_numpy(img))
    return max(float((sxx + syy).max()), 1.0)


@pytest.mark.parametrize("name", sorted(images()))
def test_min_eig_plain_matches_jax_and_pallas(name):
    img = images()[name]
    port = kernels.min_eig_response(torch.from_numpy(img))
    assert port.dtype == torch.float32 and port.shape == img.shape
    s = scale(img)
    ref = np.asarray(jharris.min_eig_response(jnp.asarray(img)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=0, atol=2e-6 * s)
    ref_pallas = interpret(jpk.min_eig_response_fused, jnp.asarray(img), use_pallas=True)
    np.testing.assert_allclose(port.numpy(), ref_pallas, rtol=1e-5, atol=1e-6 * s)
    # the wrapper's other input type: uint8 holding the same integers
    if name in ("constant", "integer"):
        np.testing.assert_array_equal(
            kernels.min_eig_response(torch.from_numpy(img.astype(np.uint8))).numpy(),
            port.numpy())


def test_min_eig_corners_replicate_the_gradients_not_the_image():
    """At a corner both clamps bite: the box reads the gradient at the
    clamped position, not a Sobel of a doubly padded image (whose gy
    would vanish at row -1)."""
    rng = np.random.default_rng(8)
    img = rng.integers(0, 256, (6, 7)).astype(np.float32)
    port = kernels.min_eig_response(torch.from_numpy(img)).numpy()
    pad = np.pad(img, 1, mode="edge")
    gx = np.zeros_like(img)
    gy = np.zeros_like(img)
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    for dy in range(3):
        for dx in range(3):
            gx += kx[dy, dx] * pad[dy:dy + 6, dx:dx + 7]
            gy += kx.T[dy, dx] * pad[dy:dy + 6, dx:dx + 7]

    def box(a):
        p = np.pad(a, 1, mode="edge")
        return sum(p[dy:dy + 6, dx:dx + 7] for dy in range(3) for dx in range(3)) / 9.0

    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    want = (sxx + syy) / 2 - np.sqrt(((sxx - syy) / 2) ** 2 + sxy ** 2)
    np.testing.assert_allclose(port, want, rtol=0, atol=2e-6 * scale(img))
    doubly = np.pad(img, 2, mode="edge")  # the wrong border, for contrast
    gy_wrong_row = doubly[2, 2:-2] - doubly[0, 2:-2]
    assert not gy_wrong_row.any() and gy[0].any()


def test_harris_response_matches_jax():
    for name in ("48x200", "integer"):
        img = images()[name]
        port = tharris.harris_response(torch.from_numpy(img)).numpy()
        ref = np.asarray(jharris.harris_response(jnp.asarray(img)))
        # det - k tr^2 is a difference of products of box sums
        np.testing.assert_allclose(port, ref, rtol=0, atol=4e-6 * scale(img) ** 2)


@pytest.fixture(scope="module")
def frame():
    scene = synthetic.RoomScene(seed=3)
    pose = synthetic.orbit_trajectory(4, radius=0.2, yaw_amp=0.1)[1]
    gray, _ = synthetic.render_frame(scene, pose, INTR, 120, 160)
    return gray


def kp_rows(kps):
    """Valid keypoints as rows (u, v, response), sorted by position."""
    v = np.asarray(kps.valid).astype(bool)
    rows = np.c_[np.asarray(kps.uv)[v], np.asarray(kps.response)[v]]
    return rows[np.lexsort(rows[:, :2].T[::-1])]


@pytest.mark.parametrize("name", ["GFTT", "HARRIS"])
def test_detectors_give_the_reference_keypoint_sets(frame, name):
    K = 64
    ref = jreg.create_detector(name, K, unbatched=True)(jnp.asarray(frame))
    port = treg.create_detector(name, K)(torch.from_numpy(frame))
    r, p = kp_rows(ref), kp_rows(port)
    assert len(r) == len(p) and len(r) > K // 2
    np.testing.assert_array_equal(p[:, :2], r[:, :2])
    np.testing.assert_allclose(p[:, 2], r[:, 2], rtol=1e-5)
    np.testing.assert_array_equal(port.size.numpy(), np.full(K, 7.0, np.float32))
    assert not port.angle.any()
    # none of these sits at the quality gate, where the packages may differ
    resp = np.asarray(ref.response)[np.asarray(ref.valid)]
    gate = 0.01 * float(np.asarray(
        jharris.harris_response(jnp.asarray(frame, jnp.float32)) if name == "HARRIS"
        else jharris.min_eig_response(jnp.asarray(frame, jnp.float32))).max())
    assert np.all(np.abs(resp - gate) > 1e-4 * gate)


def test_detector_mask_form_matches_jax(frame):
    mask = np.zeros(frame.shape, bool)
    mask[:, : frame.shape[1] // 2] = True
    ref = jreg.create_detector("GFTT", 64)(jnp.asarray(frame), jnp.asarray(mask))
    port = treg.create_detector("GFTT", 64)(torch.from_numpy(frame), torch.from_numpy(mask))
    np.testing.assert_array_equal(kp_rows(port)[:, :2], kp_rows(ref)[:, :2])
    assert 0 < int(port.valid.sum()) < 64


def test_constant_image_has_no_keypoint():
    img = torch.full((32, 40), 117, dtype=torch.uint8)
    assert not kernels.min_eig_response(img).any()
    kps = tharris.detect_gftt(img, max_kp=16)
    assert not kps.valid.any()


def test_nms_keeps_plateaus_and_the_gate_cuts_them():
    """NMS is >=, so two equal neighbouring maxima both survive it; only
    `response > thresh` removes keypoints."""
    img = np.zeros((24, 24), np.float32)
    img[8:16, 8:16] = 200.0  # a square: four equal corners
    kps = tharris.detect_gftt(torch.from_numpy(img), max_kp=32)
    ref = jharris.detect_gftt(jnp.asarray(img), max_kp=32)
    np.testing.assert_array_equal(kp_rows(kps)[:, :2], kp_rows(ref)[:, :2])
    assert int(kps.valid.sum()) >= 4


def test_registry_builds_gftt_and_harris():
    for name in ("GFTT", "gftt", "HARRIS"):
        assert callable(treg.create_detector(name, 16))
    with pytest.raises(ValueError):
        treg.create_descriptor("GFTT")  # a detector name only, as in the reference


def test_wrapper_counts_only_kernel_launches_and_checks_its_input():
    kernels.reset_counts()
    kernels.min_eig_response(torch.zeros(4, 5))
    assert kernels.launch_counts()["min_eig_response"] == 0
    with pytest.raises(ValueError, match="non-empty"):
        kernels.min_eig_response(torch.zeros(0, 5))
    with pytest.raises(ValueError, match="non-empty"):
        kernels.min_eig_response(torch.zeros(3, 4, 5))
    with pytest.raises(RuntimeError, match="unsupported device"):
        kernels.min_eig_response(torch.zeros(4, 5, device="meta"))


# -- K3's launch geometry and a numpy model of its blocks ----------------------
#
# The CUDA kernel runs only on the card. What surrounds it runs here: the
# launch geometry the wrapper computes (tiles, grid, interior/border
# split, rows and columns per thread), and a float32 numpy model of what
# one block does over it (halo loads, clamps, the sliding order of rows,
# the neighbours' values taken by shuffle), which must equal the plain
# version bit for bit.

def tile_edge_shapes(cols=tk3.COLS, rows=tk3.ROWS):
    g = tk3.geometry(1, 1, cols, rows)
    th, tw = g.tile_h, g.tile_w
    return [(th - 1, tw - 1), (th, tw), (th + 1, tw + 1), (2 * th + 1, 2 * tw - 1),
            (3 * th - 1, 3 * tw + 1)]


GEOMETRY_SHAPES = [(480, 640), (37, 53), (1, 7), (7, 1), (1, 1), (2, 9), (9, 2),
                   (2160, 3840)] + tile_edge_shapes()


def block_tiles(g):
    """(block, tile) of every tile the grid-stride loop visits."""
    b = np.arange(g.grid)
    t = b[None, :] + g.grid * np.arange(-(-g.n_tiles // g.grid))[:, None]
    keep = t < g.n_tiles
    return np.broadcast_to(b, t.shape)[keep], t[keep]


def written_pixels(g, H, W):
    """Flat indices of every (row, column) the launch writes, once per write."""
    _, t = block_tiles(g)
    ty, tx = np.divmod(t, g.tiles_x)
    w, lane, c, j = np.meshgrid(np.arange(tk3.WARPS), np.arange(1, tk3.LANES_OUT + 1),
                                np.arange(g.cols), np.arange(g.rows), indexing="ij")
    r = (ty * g.tile_h)[:, None] + (w * g.rows + j).reshape(-1)[None]
    x = (tx * g.tile_w - g.cols)[:, None] + (lane * g.cols + c).reshape(-1)[None]
    assert x.min() >= 0
    keep = (r < H) & (x < W)
    return (r * W + x)[keep]


@pytest.mark.parametrize("variant", tk3.VARIANTS)
@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_k3_geometry_covers_every_pixel_once(shape, variant):
    H, W = shape
    cols, rows = variant
    for resident in (1 << 30, 660, 7):  # one wave of every tile, and grid-stride loops
        g = tk3.geometry(H, W, cols, rows, resident)
        assert g.grid == min(g.n_tiles, resident) >= 1
        assert (g.tile_w, g.tile_h) == (tk3.LANES_OUT * cols, tk3.WARPS * rows)
        assert g.tiles_x * g.tile_w >= W > (g.tiles_x - 1) * g.tile_w
        assert g.tiles_y * g.tile_h >= H > (g.tiles_y - 1) * g.tile_h
        counts = np.bincount(written_pixels(g, H, W), minlength=H * W)
        assert counts.shape == (H * W,) and (counts == 1).all()


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_k3_interior_tiles_read_and_write_inside_the_image(shape):
    """A tile takes the path without clamps only when every row its warps
    read (two above and below their rows) and every column its lanes read
    (lanes 0 and 31 included) lies inside the image, and when every
    column its writing lanes own is inside it too."""
    H, W = shape
    g = tk3.geometry(H, W)
    interior = [t for t in range(g.n_tiles) if tk3.tile_is_interior(g, H, W, t)]
    for t in interior:
        r0, c0 = tk3.tile_origin(g, t)
        rows_read = np.arange(r0 - 2, r0 + g.tile_h + 2)
        cols_read = c0 - g.cols + np.arange(32 * g.cols)
        assert rows_read.min() >= 0 and rows_read.max() <= H - 1
        assert cols_read.min() >= 0 and cols_read.max() <= W - 1
        assert c0 + g.tile_w <= W and r0 + g.tile_h <= H
    edge = [t for t in range(g.n_tiles)
            if tk3.tile_origin(g, t)[0] == 0 or tk3.tile_origin(g, t)[1] == 0]
    assert not set(edge) & set(interior)
    if shape == (480, 640):  # all but the outer ring of tiles take no clamp
        assert g.tiles_x == 6 and len(interior) == (g.tiles_x - 2) * (g.tiles_y - 2)


def model_k3(img, g, sqrt, separable=False):
    """float32 numpy model of K3's blocks over geometry `g`, in the
    kernel's order: each warp loads three image rows (clamped in border
    tiles), takes its lanes' side columns from the neighbouring lanes,
    and slides down its rows keeping the running vertical sum of two
    product rows. `sqrt` is the square root applied last. Like the
    kernel, its sums start at their first term where the plain version
    starts at +0: only the sign of a zero can differ, and the response
    does not see it. `separable` takes the gradients as the kernel does
    on bytes: each row's horizontal difference and smoothing once, then
    gx = dx0 + 2 dx1 + dx2 and gy = sm2 - sm0 (exact on bytes)."""
    f = np.float32
    H, W = img.shape
    C, R = g.cols, g.rows
    out = np.full((H, W), np.nan, np.float32)

    def up(a):    # __shfl_up_sync(.., 1): lane l takes lane l-1's, lane 0 its own
        return np.concatenate([a[:1], a[:-1]])

    def down(a):  # __shfl_down_sync(.., 1): lane l takes lane l+1's, lane 31 its own
        return np.concatenate([a[1:], a[-1:]])

    def sobel(i0, i1, i2):
        if separable:
            (dx0, sm0), (dx1, _), (dx2, sm2) = (
                (i[:, 2:] - i[:, :-2], f(2) * i[:, 1:-1] + (i[:, :-2] + i[:, 2:]))
                for i in (i0, i1, i2))
            gx = f(2) * dx1 + (dx0 + dx2)
            gy = sm2 - sm0
            return gx * gx, gy * gy, gx * gy
        a00, a01, a02 = i0[:, :-2], i0[:, 1:-1], i0[:, 2:]
        a10, a12 = i1[:, :-2], i1[:, 2:]
        a20, a21, a22 = i2[:, :-2], i2[:, 1:-1], i2[:, 2:]
        gx = -a00 + a02 + f(-2) * a10 + f(2) * a12 + -a20 + a22
        gy = -a00 + f(-2) * a01 + -a02 + a20 + f(2) * a21 + a22
        return gx * gx, gy * gy, gx * gy

    for _, t in zip(*block_tiles(g)):
        rb, c0 = tk3.tile_origin(g, t)
        border = not tk3.tile_is_interior(g, H, W, t)
        x = (c0 - C + np.arange(32) * C)[:, None] + np.arange(C)[None]  # (lane, column)
        xr = np.clip(x, 0, W - 1) if border else x
        assert xr.min() >= 0 and xr.max() < W

        def row(y):
            y = min(max(y, 0), H - 1) if border else y
            assert 0 <= y < H
            v = img[y][xr]
            return np.concatenate([up(v[:, -1])[:, None], v, down(v[:, 0])[:, None]], 1)

        for w in range(tk3.WARPS):
            r0 = rb + w * R
            if r0 >= H:
                continue
            i0, i1, i2 = row(r0 - 2), row(r0 - 1), row(r0)
            above = sobel(i0, i1, i2)
            i0, i1, i2 = i1, i2, row(r0 + 1)
            cur = sobel(i0, i1, i2)
            if border and r0 == 0:
                above = cur
            run = [a + b for a, b in zip(above, cur)]
            for j in range(R):  # rows past the image's last are computed, not stored
                r = r0 + j
                i0, i1, i2 = i1, i2, row(r + 2)
                nxt = cur if border and r + 1 > H - 1 else sobel(i0, i1, i2)
                vs = [a + b for a, b in zip(run, nxt)]
                run = [a + b for a, b in zip(cur, nxt)]
                cur = nxt
                means = []
                for v in vs:
                    left = np.concatenate([up(v[:, -1])[:, None], v[:, :-1]], 1)
                    right = np.concatenate([v[:, 1:], down(v[:, 0])[:, None]], 1)
                    if border:
                        left = np.where(x == 0, v, left)
                        right = np.where(x == W - 1, v, right)
                    means.append((left + v + right) / f(9))
                sxx, syy, sxy = means
                tr_half = (sxx + syy) * f(0.5)
                d = (sxx - syy) * f(0.5)
                res = tr_half - sqrt(d * d + sxy * sxy)
                if r >= H:
                    continue
                lanes = slice(1, tk3.LANES_OUT + 1)
                keep = x[lanes] < W
                assert np.isnan(out[r, x[lanes][keep]]).all()  # each pixel written once
                out[r, x[lanes][keep]] = res[lanes][keep]
    return out


def torch_sqrt(a):
    """The plain version's square root on the CPU (not always correctly
    rounded, so the model takes it to be compared bit for bit)."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(a))).numpy()


MODEL_SHAPES = [(37, 53), (1, 7), (7, 1), (1, 1), (2, 9), (9, 2), (50, 250)] + \
    tile_edge_shapes()[:3]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_k3_block_model_equals_plain_version_bit_for_bit(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    if dtype == "uint8":
        img = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        img = (rng.normal(size=shape) * 50).astype(np.float32)
    want = tk3.min_eig_response_plain(torch.from_numpy(img)).numpy()
    for resident in (1 << 30, 3):
        g = tk3.geometry(*shape, resident=resident)
        got = model_k3(img.astype(np.float32), g, torch_sqrt, separable=dtype == "uint8")
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", tk3.VARIANTS)
def test_k3_block_model_of_every_variant_equals_plain_version(variant):
    """Every (cols, rows) the kernel is built in, on an image with
    interior and border tiles and with the kernel's IEEE sqrt (np.sqrt)
    against the plain version held to 1e-6 of the largest box sum."""
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (70, 523)).astype(np.float32)
    g = tk3.geometry(*img.shape, *variant)
    assert any(tk3.tile_is_interior(g, *img.shape, t) for t in range(g.n_tiles))
    want = tk3.min_eig_response_plain(torch.from_numpy(img)).numpy()
    for separable in (False, True):  # the image holds bytes: both forms apply
        np.testing.assert_array_equal(model_k3(img, g, torch_sqrt, separable), want)
    np.testing.assert_allclose(model_k3(img, g, np.sqrt), want, rtol=0, atol=1e-6 * scale(img))


def test_k3_pitch_helper_copies_only_views_with_spread_columns():
    base = torch.from_numpy(np.random.default_rng(12).integers(0, 256, (40, 64)).astype(np.uint8))
    cases = {  # view -> whether the wrapper must copy it
        "contiguous": (base, False),
        "row-cropped": (base[3:30, 5:50], False),
        "misaligned base": (base.reshape(-1)[1:1 + 39 * 64].view(39, 64), False),
        "one column": (base[:, 7:8], False),
        "one row": (base[4:5, 2:40], False),
        "one row, every third column": (base[4:5, ::3], True),
        "every other column": (base[:, ::2], True),
        "transposed": (base.t(), True),
    }
    for name, (view, copies) in cases.items():
        x, pitch = tk3.pitched(view)
        assert (x.data_ptr() != view.data_ptr()) == copies, name
        assert x.dtype == torch.uint8 and torch.equal(x, view), name
        assert x.shape[1] == 1 or x.stride(1) == 1, name
        if x.shape[0] > 1:
            assert pitch == x.stride(0), name
    x, pitch = tk3.pitched(base[3:30, 5:50])
    assert pitch == 64
    x, _ = tk3.pitched(base.to(torch.float64)[:, 1:])
    assert x.dtype == torch.float32 and x.stride(1) == 1
