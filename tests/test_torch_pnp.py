"""Parity of the port's quartic solver, P3P and RANSAC PnP with the JAX package.

The JAX `quartic_roots`, `p3p_grunert`, `refine_pnp` and
`solve_pnp_ransac` run jitted, as the reference uses them, under
`jitted_reference()` (tests/test_torch_jaxref.py). Both packages get the same uniforms `u` (those of the
reference's key). Tolerances and why:
- roots: 1e-5 relative, complex64 arithmetic in the same order;
- P3P: the valid-candidate masks exactly; per triplet, the candidate
  nearest the true pose to 1e-4 in the median and 2e-3 at worst in both
  (an ill-conditioned triplet loses digits); 80% of all valid candidates
  to 1e-3, not
  all: the Newton polish of a seed beside a near-double quartic root
  (resolved only to ~sqrt(eps) in fp32) may land on either branch;
- RANSAC: inlier sets exactly; rvec/tvec within 1e-4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam3d_gx_torch.ops import lie as tlie
from slam3d_gx_torch.ops import pnp as tpnp
from slam3d_gx_torch.ops import polynomial as tpoly
from slam3d_gx_tpu.ops import pnp as jpnp
from slam3d_gx_tpu.ops import polynomial as jpoly
from test_torch_jaxref import jitted  # noqa: F401  (a fixture)

CAM = (260.0, 260.0, 160.0, 120.0)
RV = np.array([0.05, -0.1, 0.02], np.float32)
TV = np.array([0.1, 0.0, 0.2], np.float32)


def t(a):
    return torch.as_tensor(np.array(a))


def project(obj, rv=RV, tv=TV):
    R = tlie.rodrigues(t(rv)).numpy()
    pc = obj @ R.T + tv
    return np.stack([CAM[0] * pc[:, 0] / pc[:, 2] + CAM[2],
                     CAM[1] * pc[:, 1] / pc[:, 2] + CAM[3]], -1).astype(np.float32)


def problem(seed, n, outliers):
    rng = np.random.default_rng(seed)
    obj = rng.uniform([-1, -1, 2], [1, 1, 4], (n, 3)).astype(np.float32)
    img = project(obj)
    img[:outliers] += rng.normal(0, 20, (outliers, 2)).astype(np.float32)
    img += rng.normal(0, 0.3, (n, 2)).astype(np.float32)
    mask = rng.random(n) > 0.1
    return obj, img, mask


def test_quartic_roots_match_jax(jitted):
    rng = np.random.default_rng(0)
    co = rng.normal(size=(256, 5)).astype(np.float32)
    co[:8, 0] = 1e-14  # regularized leading coefficient
    ref = np.asarray(jpoly.quartic_roots(jnp.asarray(co)))
    port = tpoly.quartic_roots(t(co)).numpy()
    assert port.dtype == np.complex64
    ok = np.isfinite(ref).all(1)
    np.testing.assert_allclose(port[ok], ref[ok], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tpoly.real_roots_mask(t(port)).numpy(),
                                  np.asarray(jpoly.real_roots_mask(jnp.asarray(port))))


def test_p3p_grunert_matches_jax(jitted):
    rng = np.random.default_rng(1)
    P = rng.uniform([-1, -1, 2], [1, 1, 4], (32, 3, 3)).astype(np.float32)
    R = tlie.rodrigues(t(RV)).numpy()
    pc = P @ R.T + TV
    f = (pc / np.linalg.norm(pc, axis=-1, keepdims=True)).astype(np.float32)
    Rj, tj, vj = (np.asarray(a) for a in jax.jit(jpnp.p3p_grunert)(jnp.asarray(P),
                                                                    jnp.asarray(f)))
    Rt, tt, vt = (a.numpy() for a in tpnp.p3p_grunert(t(P), t(f)))
    assert Rt.shape == (32, 12, 3, 3) and tt.shape == (32, 12, 3)
    np.testing.assert_array_equal(vt, vj)
    same = (np.abs(Rt - Rj).max((-1, -2)) < 1e-3) & (np.abs(tt - tj).max(-1) < 1e-3)
    assert same[vt].mean() >= 0.8
    for Rc, tc, v in ((Rt, tt, vt), (Rj, tj, vj)):
        err = np.abs(Rc - R).max((-1, -2)) + np.abs(tc - TV).max(-1)
        best = np.where(v, err, np.inf).min(1)
        assert np.median(best) < 1e-4 and best.max() < 2e-3


def test_refine_pnp_matches_jax(jitted):
    obj, img, mask = problem(2, 96, 0)
    w = mask.astype(np.float32)
    rv0, tv0 = RV + 0.02, TV - 0.03
    ref = jpnp.refine_pnp(jnp.asarray(rv0), jnp.asarray(tv0), jnp.asarray(obj),
                          jnp.asarray(img), jnp.asarray(w), *CAM, iters=6)
    port = tpnp.refine_pnp(t(rv0), t(tv0), t(obj), t(img), t(w), *CAM, iters=6)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=1e-4)
    # a batch of problems solves each as alone
    both = tpnp.refine_pnp(t(np.stack([rv0, rv0])), t(np.stack([tv0, tv0])),
                           t(np.stack([obj, obj])), t(np.stack([img, img])),
                           t(np.stack([w, w])), *CAM, iters=6)
    np.testing.assert_allclose(both[0][1].numpy(), port[0].numpy(), atol=1e-6)


@pytest.mark.parametrize("n", [64, 200])
def test_solve_pnp_ransac_matches_jax(jitted, n):
    """n=64 scores every candidate on all points; n=200 takes the
    two-stage prescore (pnp.py:433-446). The second solve adds the
    extrinsic-guess hypothesis (pnp.py:448-454) at 3 px."""
    obj, img, mask = problem(3, n, n // 4)
    key = jax.random.PRNGKey(n)
    u = t(np.asarray(jax.random.uniform(key, (32, 3))))
    ref = jpnp.solve_pnp_ransac(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(mask),
                                *CAM, key, hypotheses=32, refine_iters=4)
    ref = [np.asarray(a) for a in ref]
    ref2 = jpnp.solve_pnp_ransac(jnp.asarray(obj), jnp.asarray(img), jnp.asarray(ref[2]),
                                 *CAM, key, reproj_thresh=3.0, hypotheses=32,
                                 refine_iters=4, guess_rvec=jnp.asarray(ref[0]),
                                 guess_tvec=jnp.asarray(ref[1]))
    ref2 = [np.asarray(a) for a in ref2]
    port = tpnp.solve_pnp_ransac(t(obj), t(img), t(mask), *CAM, u, refine_iters=4)
    port2 = tpnp.solve_pnp_ransac(t(obj), t(img), t(ref[2]), *CAM, u, reproj_thresh=3.0,
                                  refine_iters=4, guess_rvec=t(ref[0]), guess_tvec=t(ref[1]))
    for p, r in ((port, ref), (port2, ref2)):
        assert bool(p.ok) == bool(r[4]) and bool(r[4])
        np.testing.assert_array_equal(p.inliers.numpy(), r[2])
        assert int(p.n_inliers) == int(r[3])
        np.testing.assert_allclose(p.rvec.numpy(), r[0], atol=1e-4)
        np.testing.assert_allclose(p.tvec.numpy(), r[1], atol=1e-4)


def test_solve_pnp_ransac_fails_cleanly_without_enough_points():
    obj, img, _ = problem(4, 32, 0)
    mask = np.zeros(32, bool)
    mask[:2] = True
    u = torch.rand((16, 3), generator=torch.Generator().manual_seed(0))
    res = tpnp.solve_pnp_ransac(t(obj), t(img), t(mask), *CAM, u, refine_iters=2)
    assert not bool(res.ok)
    assert torch.isfinite(res.rvec).all() and torch.isfinite(res.tvec).all()
