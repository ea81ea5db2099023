"""Parity of the port's multiPnP (plane path registration) with the JAX package.

The JAX multiPnP runs jitted under `jitted_reference()`
(tests/test_torch_jaxref.py). So both refine modes are held against JAX:
"full", and "tiered", the frontend's default (no polish in the
per-plane solves, a 4-step polish in the pooled one), on an exact pair
and on a pair with pixel noise and outliers. "tiered" is also held
against "full" on an exact pair at frontend widths.

Both packages get the same features (JAX arrays handed across as numpy
through `slam3d_gx_torch.interop`) and the same draws: the uniforms of
the reference's split keys. Tolerances: `ok` and the inlier count are
exact; T within 1e-4 (fp32 Gauss-Newton on each side).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__
from slam3d_gx_torch import interop
from slam3d_gx_torch.config import CameraIntrinsics as TorchIntrinsics
from slam3d_gx_torch.frontend import pipeline as tpipe
from slam3d_gx_torch.frontend.state import result_to_host
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.frontend import pipeline as jpipe
from test_torch_jaxref import jitted  # noqa: F401  (a fixture)

INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
TINTR = TorchIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)
P, K, HYP = 3, 32, 32


def pair(seed, k=K):
    """An exact plane-frame pair. Its random float descriptors are
    rounded to non-negative integers, as SIFT's are: exact matches then
    have distance exactly 0 in both packages, where float descriptors
    would leave the 3*min_dist gate to rounding noise."""
    fa, fb = __graft_entry__._plane_frame_pair(INTR, np.random.default_rng(seed), p=P, k=k)
    return (fa._replace(desc=jnp.round(jnp.abs(fa.desc))),
            fb._replace(desc=jnp.round(jnp.abs(fb.desc))))


def noisy_pair(seed, k=K, sigma=0.5, outliers=0.25):
    """pair(seed) with Gaussian pixel noise (sigma px) on the target's
    keypoints and a share of them moved to random pixels."""
    fa, fb = pair(seed, k)
    rng = np.random.default_rng(100 + seed)
    uv = np.array(fb.uv) + rng.normal(0.0, sigma, fb.uv.shape)
    moved = rng.random(uv.shape[:2]) < outliers
    uv[moved] = rng.uniform([0.0, 0.0], [320.0, 240.0], (int(moved.sum()), 2))
    return fa, fb._replace(uv=jnp.asarray(uv, jnp.float32))


def to_port(f):
    return interop.features_from_numpy([np.asarray(a) for a in f], "cpu")


def reference_uniforms(key, p=P, hyp=HYP):
    return interop.pnp_uniforms(
        [np.asarray(jax.random.uniform(k, (hyp, 3))) for k in jax.random.split(key, p + 2)],
        "cpu")


@pytest.fixture(scope="module")
def reference_run(jitted):
    """One JAX multiPnP (refine_mode "full") on an exact pair, at the
    frontend's tracking gate of 12 inliers."""
    fa, fb = pair(0)
    key = jax.random.PRNGKey(0)
    fn = jpipe.build_multipnp_planes(INTR, hypotheses=HYP, refine_mode="full")
    ref = fn(fa, fb, key, 12)
    out = (np.asarray(ref.T), float(ref.norm), int(ref.inliers), bool(ref.ok))
    return fa, fb, key, out


@pytest.mark.parametrize("gate", ["tracking", "above_inliers"])
def test_multipnp_full_matches_jax(reference_run, gate):
    """The gate only decides acceptance: a minimum above the reference's
    inlier count must reject in both packages, with the identity."""
    fa, fb, key, (ref_T, ref_norm, ref_inl, ref_ok) = reference_run
    assert ref_ok
    min_inliers = 12 if gate == "tracking" else ref_inl + 1
    port_fn = tpipe.build_multipnp_planes(TINTR, refine_mode="full")
    T, norm, inl, ok = result_to_host(
        port_fn(to_port(fa), to_port(fb), reference_uniforms(key), min_inliers))
    assert inl == ref_inl
    if gate == "tracking":
        assert ok
        assert norm == pytest.approx(ref_norm, abs=1e-4)
        np.testing.assert_allclose(T, ref_T, atol=1e-4)
    else:
        # a gated result reports norm 0 and the identity, as the
        # reference's does (pipeline.py:393)
        assert not ok and norm == 0.0
        np.testing.assert_array_equal(T, np.eye(4))


@pytest.mark.parametrize("kind", ["exact", "noisy"])
def test_multipnp_tiered_matches_jax(jitted, kind):
    """The default refine mode against the JAX one on the same features
    and draws: the exact pair, and a pair with 0.5 px noise and a quarter
    of the target's keypoints moved to random pixels."""
    fa, fb = pair(0) if kind == "exact" else noisy_pair(1)
    key = jax.random.PRNGKey(7)
    ref = jpipe.build_multipnp_planes(INTR, hypotheses=HYP)(fa, fb, key, 12)
    ref_T, ref_norm, ref_inl, ref_ok = (np.asarray(ref.T), float(ref.norm), int(ref.inliers),
                                        bool(ref.ok))
    assert ref_ok
    T, norm, inl, ok = result_to_host(tpipe.build_multipnp_planes(TINTR)(
        to_port(fa), to_port(fb), reference_uniforms(key), 12))
    assert (ok, inl) == (ref_ok, ref_inl)
    assert norm == pytest.approx(ref_norm, abs=1e-4)
    np.testing.assert_allclose(T, ref_T, atol=1e-4)


def test_multipnp_tiered_and_full_agree_on_an_exact_pair():
    """The pair of __graft_entry__._plane_frame_pair as it is, at
    frontend widths (K=256, 128 hypotheses)."""
    fa, fb = __graft_entry__._plane_frame_pair(INTR, np.random.default_rng(3), p=P, k=256)
    fa, fb = to_port(fa), to_port(fb)
    u = torch.rand((P + 2, 128, 3), generator=torch.Generator().manual_seed(0))
    out = {}
    for mode in ("tiered", "full"):
        fn = tpipe.build_multipnp_planes(TINTR, refine_mode=mode)
        out[mode] = result_to_host(fn(fa, fb, u, 12))
    assert out["tiered"][3] and out["full"][3]
    assert out["tiered"][2] == out["full"][2] >= 12
    np.testing.assert_allclose(out["tiered"][0], out["full"][0], atol=1e-4)


def test_multipnp_rejects_unrelated_frames():
    fa, _ = pair(4)
    _, fb = pair(5)
    fn = tpipe.build_multipnp_planes(TINTR)
    T, norm, inl, ok = result_to_host(fn(to_port(fa), to_port(fb), reference_uniforms(
        jax.random.PRNGKey(0)), 12))
    assert not ok
    np.testing.assert_array_equal(T, np.eye(4))


def test_pooled_reproj_default_is_the_frontend_threshold(reference_run):
    """Left at its default, pooled_reproj computes exactly what the
    frontend's 8 px pooled solve computes."""
    fa, fb, key, _ = reference_run
    a, b, u = to_port(fa), to_port(fb), reference_uniforms(key)
    default = result_to_host(tpipe.build_multipnp_planes(TINTR, refine_mode="full")(a, b, u, 12))
    explicit = result_to_host(tpipe.build_multipnp_planes(
        TINTR, pooled_reproj=8.0, refine_mode="full")(a, b, u, 12))
    np.testing.assert_array_equal(default[0], explicit[0])
    assert default[1:] == explicit[1:]


def test_pooled_reproj_reaches_the_pooled_solve(reference_run):
    """exp1_2's MatchingPlanar passes ransac_accuracy as pooled_reproj: at
    3 px the port matches the JAX function given the same value."""
    fa, fb, key, (_, _, inl_8px, _) = reference_run
    ref = jpipe.build_multipnp_planes(INTR, hypotheses=HYP, pooled_reproj=3.0,
                                      refine_mode="full")(fa, fb, key, 12)
    ref_T, ref_inl, ref_ok = np.asarray(ref.T), int(ref.inliers), bool(ref.ok)
    port_fn = tpipe.build_multipnp_planes(TINTR, pooled_reproj=3.0, refine_mode="full")
    T, _, inl, ok = result_to_host(port_fn(to_port(fa), to_port(fb), reference_uniforms(key), 12))
    assert (inl, ok) == (ref_inl, ref_ok) and ok
    assert inl <= inl_8px
    np.testing.assert_allclose(T, ref_T, atol=1e-4)
