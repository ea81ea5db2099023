"""The port's native I/O (slam3d_gx_torch/native_io.py: the native/*.cc
codecs and prefetching loader, built with g++ into slam3d_gx_torch/_build)
against the JAX package's bindings of the same sources and against the
port's pure-Python readers, on the cases of tests/test_native_io.py:

- PNG gray8, depth16 and RGB -> gray, PCD binary and ASCII: equal to
  JAX's native_io and to io/images.py and io/pcd.py read in Python (RGB
  -> gray within 1 of the Python reader's float BT.601, as JAX's test
  holds it; the codec rounds in integers);
- the prefetch loader: order and content, PCD, a bad file, format and
  size mismatches;
- GraphicEnd2 makes the same keyframes and poses with the native
  prefetch and decoder as with the Python readers.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from slam3d_gx_torch import native_io
from slam3d_gx_torch.backend import SLAMEnd
from slam3d_gx_torch.config import CameraIntrinsics, ParameterReader
from slam3d_gx_torch.frontend import GraphicEnd2
from slam3d_gx_torch.io import images, pcd as pcd_io
from slam3d_gx_torch.testing import synthetic
from slam3d_gx_tpu import native_io as jax_native_io


def test_library_builds_into_the_package():
    assert native_io.available(), native_io.build_error
    path = native_io.lib_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == native_io.BUILD_DIR
    assert native_io.BUILD_DIR.endswith(os.path.join("slam3d_gx_torch", "_build"))


@pytest.fixture
def python_readers(monkeypatch):
    """io/images.py and io/pcd.py with the native codec switched off."""
    monkeypatch.setattr(native_io, "available", lambda: False)


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    depth = rng.integers(0, 60000, (48, 64), dtype=np.uint16)
    rgb = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    paths = [str(root / n) for n in ("gray.png", "depth.png", "rgb.png")]
    for p, a in zip(paths, (gray, depth, rgb)):
        Image.fromarray(a).save(p)
    return list(zip(paths, (gray, depth, rgb)))


@pytest.mark.parametrize("kind", ["gray8", "depth16", "rgb_to_gray"])
def test_png(png_files, kind, monkeypatch):
    path, arr = png_files[["gray8", "depth16", "rgb_to_gray"].index(kind)]
    to_gray = kind != "depth16"
    out = native_io.png_decode(path, to_gray=to_gray)
    if jax_native_io.available():
        np.testing.assert_array_equal(out, jax_native_io.png_decode(path, to_gray=to_gray))
    load = images.load_depth if kind == "depth16" else images.load_gray
    np.testing.assert_array_equal(load(path), out)  # the readers take the codec
    monkeypatch.setattr(native_io, "available", lambda: False)
    py = load(path)
    assert py.dtype == out.dtype and py.shape == out.shape
    if kind == "rgb_to_gray":
        assert np.abs(out.astype(int) - py.astype(int)).max() <= 1
    else:
        np.testing.assert_array_equal(out, arr)
        np.testing.assert_array_equal(py, arr)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_pcd(tmp_path, binary, python_readers):
    rng = np.random.default_rng(1 if binary else 2)
    n = 1000 if binary else 100
    xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
    rgba = rng.integers(0, 2**24, n, dtype=np.uint32)
    p = str(tmp_path / "a.pcd")
    pcd_io.write_pcd(p, xyz, rgba, binary=binary)
    nx, nr = native_io.pcd_read(p)
    if jax_native_io.available():
        jx, jr = jax_native_io.pcd_read(p)
        np.testing.assert_array_equal(nx, jx)
        np.testing.assert_array_equal(nr, jr)
    px, pr = pcd_io.read_pcd(p)  # the Python parser (python_readers)
    np.testing.assert_array_equal(nx, px)
    np.testing.assert_array_equal(nr, pr)
    if binary:
        np.testing.assert_array_equal(nx, xyz)
    else:
        np.testing.assert_allclose(nx, xyz, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(nr, rgba)


def test_prefetch_loader_order_and_content(tmp_path):
    rng = np.random.default_rng(3)
    frames, paths = [], []
    for i in range(10):
        img = rng.integers(0, 256, (32, 40), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(img).save(paths[-1])
        frames.append(img)
    loader = native_io.PrefetchLoader(paths, native_io.MODE_GRAY8, height=32, width=40,
                                      queue_depth=3, threads=2)
    for img in frames:
        np.testing.assert_array_equal(loader.next(), img)
    with pytest.raises(StopIteration):
        loader.next()
    loader.close()


def test_prefetch_loader_pcd(tmp_path):
    rng = np.random.default_rng(4)
    clouds, paths = [], []
    for i in range(4):
        n = 50 + 30 * i
        xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
        rgba = rng.integers(0, 2**24, n, dtype=np.uint32)
        paths.append(str(tmp_path / f"{i}.pcd"))
        pcd_io.write_pcd(paths[-1], xyz, rgba, binary=True)
        clouds.append((xyz, rgba))
    loader = native_io.PrefetchLoader(paths, native_io.MODE_PCD, max_points=4096,
                                      queue_depth=2, threads=2)
    for xyz, rgba in clouds:
        got_xyz, got_rgba = loader.next()
        np.testing.assert_array_equal(got_xyz, xyz)
        np.testing.assert_array_equal(got_rgba, rgba)
    loader.close()


def test_prefetch_loader_bad_file(tmp_path):
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(b"not a png")
    loader = native_io.PrefetchLoader([bad], native_io.MODE_GRAY8, height=8, width=8)
    assert loader.next() is None
    loader.close()


def test_prefetch_loader_rejects_format_and_size_mismatch(tmp_path):
    rng = np.random.default_rng(5)
    depth16 = rng.integers(0, 60000, (16, 16), dtype=np.uint16)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    ga = rng.integers(0, 256, (16, 16, 2), dtype=np.uint8)
    small = rng.integers(0, 256, (8, 8), dtype=np.uint8)
    good = rng.integers(0, 256, (16, 16), dtype=np.uint8)
    p16, prgb, pga, ps, pg = (str(tmp_path / n) for n in
                              ("d.png", "c.png", "ga.png", "s.png", "g.png"))
    Image.fromarray(depth16).save(p16)
    Image.fromarray(rgb).save(prgb)
    Image.fromarray(ga, mode="LA").save(pga)
    Image.fromarray(small).save(ps)
    Image.fromarray(good).save(pg)
    # 16-bit and gray+alpha under GRAY8 fail; RGB turns gray
    loader = native_io.PrefetchLoader([p16, pga, prgb], native_io.MODE_GRAY8,
                                      height=16, width=16)
    assert loader.next() is None and loader.next() is None
    assert loader.next() is not None
    loader.close()
    # 8-bit RGB under DEPTH16 fails
    loader = native_io.PrefetchLoader([prgb, p16], native_io.MODE_DEPTH16, height=16, width=16)
    assert loader.next() is None
    np.testing.assert_array_equal(loader.next(), depth16)
    loader.close()
    # a frame of another size fails
    loader = native_io.PrefetchLoader([ps, pg], native_io.MODE_GRAY8, height=16, width=16)
    assert loader.next() is None
    np.testing.assert_array_equal(loader.next(), good)
    loader.close()


INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
N_FRAMES = 8


def _run(root, data_dir):
    params = ParameterReader(None, overrides=dict(
        data_source=root, detector_name="GFTT", descriptor_name="SIFT",
        camera_fx=INTR.fx, camera_fy=INTR.fy, camera_cx=INTR.cx, camera_cy=INTR.cy,
        camera_factor=INTR.factor, max_keypoints=256, ransac_hypotheses=128,
        max_pos_change=0.05, end_index=100))
    ge = GraphicEnd2(params, data_dir=data_dir, device="cpu")
    slam = SLAMEnd(device="cpu")
    ge.init(slam)
    slam.init(ge)
    prefetched = ge._prefetch is not None
    for _ in range(N_FRAMES - 1):
        ge.run()
    ge.save_final_result()
    poses = np.stack([ge.opt.vertex_estimate(kf.id) for kf in ge.keyframes])
    return prefetched, [kf.frame_index for kf in ge.keyframes], poses


def test_graphic_end_same_keyframes_with_the_prefetch(tmp_path, monkeypatch):
    root = str(tmp_path / "room")
    traj = synthetic.orbit_trajectory(N_FRAMES, radius=0.2, yaw_amp=0.1)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, INTR, write_pcd=False)
    torch.manual_seed(0)
    native = _run(root, str(tmp_path / "native"))
    monkeypatch.setattr(native_io, "available", lambda: False)
    python = _run(root, str(tmp_path / "python"))
    assert native[0] and not python[0]
    assert native[1] == python[1] and len(native[1]) >= 3
    np.testing.assert_array_equal(native[2], python[2])
