"""Parity of the port's multiPnP (plane path registration) with the JAX package.

The JAX multiPnP is run inside `jax.disable_jit()`: jitted, its
unrolled 24-step `quartic_roots` does not finish compiling on XLA:CPU.
Only `refine_mode="full"` can run that way (the default "tiered" mode
has a zero-length refine scan, which disable_jit refuses), so "tiered"
is held at stage level here: against "full" on an exact frame pair.

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


def to_port(f):
    return interop.features_from_numpy([np.asarray(a) for a in f], "cpu")


def reference_uniforms(key, p=P, hyp=HYP):
    return interop.pnp_uniforms(
        [np.asarray(jax.random.uniform(k, (hyp, 3))) for k in jax.random.split(key, p + 2)],
        "cpu")


@pytest.fixture(scope="module")
def reference_run():
    """One JAX multiPnP (refine_mode "full") on an exact pair, at the
    frontend's tracking gate of 12 inliers."""
    fa, fb = pair(0)
    key = jax.random.PRNGKey(0)
    fn = jpipe.build_multipnp_planes(INTR, hypotheses=HYP, refine_mode="full")
    with jax.disable_jit():
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
    with jax.disable_jit():
        ref = jpipe.build_multipnp_planes(INTR, hypotheses=HYP, pooled_reproj=3.0,
                                          refine_mode="full")(fa, fb, key, 12)
        ref_T, ref_inl, ref_ok = np.asarray(ref.T), int(ref.inliers), bool(ref.ok)
    port_fn = tpipe.build_multipnp_planes(TINTR, pooled_reproj=3.0, refine_mode="full")
    T, _, inl, ok = result_to_host(port_fn(to_port(fa), to_port(fb), reference_uniforms(key), 12))
    assert (inl, ok) == (ref_inl, ref_ok) and ok
    assert inl <= inl_8px
    np.testing.assert_allclose(T, ref_T, atol=1e-4)
