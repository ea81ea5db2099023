"""Parity of the port's CG pose-graph solver with the JAX package's
`_optimize_cg` (jitted, as it runs), on graphs of
`testing/posegraph.make_loopy_graph` built from the same seed by each
package's own copy of the generator.

- ~64 vertices (a 64 bucket: 250 CG iterations a solve) and 600 vertices
  (just above 512: the automatic rule takes CG, and the 1,024 bucket caps
  each solve at 512 iterations). Both fp32 LM runs take 15 steps; the
  final robust chi2 agrees within 1e-3 relative and every pose entry
  within 1e-3 (measured on this CPU: 2e-6 and 8e-5).
- the automatic rule: dense up to a vertex bucket of 512 (V = 512),
  CG above (V = 513), with the JAX package's buckets.
- port only, marked slow: the 2,048-vertex and the outlier cases of
  tests/test_pose_graph_scale.py, to that file's bounds.
"""

import numpy as np
import pytest

from slam3d_gx_torch.backend import pose_graph as tpg
from slam3d_gx_torch.testing import posegraph as tposegraph
from slam3d_gx_tpu.backend import pose_graph as jpg
from slam3d_gx_tpu.testing import posegraph as jposegraph


@pytest.mark.parametrize("n,kw,cap", [(64, dict(revolutions=1.2), 250), (600, {}, 512)])
def test_cg_matches_jax(n, kw, cap):
    ref, gt, n_loops = jposegraph.make_loopy_graph(n, seed=0, **kw)
    port, _, _ = tposegraph.make_loopy_graph(n, seed=0, device="cpu", **kw)
    assert n_loops > 0
    chi_ref = ref.optimize(n_iters=15, solver="cg")
    chi_port = port.optimize(n_iters=15, solver="cg")
    assert port.last_solver == "cg" and port.last_iters == 15
    assert max(port.last_cg_iters) == cap  # the first steps run to the bucket's cap
    assert chi_port == pytest.approx(chi_ref, rel=1e-3)
    for i in range(n):
        np.testing.assert_allclose(port.vertex_estimate(i), ref.vertex_estimate(i), atol=1e-3)
    assert tposegraph.graph_ate(port, gt) == pytest.approx(jposegraph.graph_ate(ref, gt), abs=1e-3)


@pytest.mark.parametrize("n,solver", [(512, "dense"), (513, "cg")])
def test_auto_rule_takes_dense_up_to_512_vertices(n, solver):
    assert [tpg._bucket(v) for v in range(1, 2100, 7)] == [jpg._bucket(v) for v in range(1, 2100, 7)]
    assert tpg._DENSE_VMAX == jpg._DENSE_VMAX
    opt, gt, _ = tposegraph.make_loopy_graph(n, seed=3, device="cpu")
    ate0 = tposegraph.graph_ate(opt, gt)
    chi = opt.optimize(n_iters=2)
    assert opt.last_solver == solver and np.isfinite(chi)
    assert len(opt.last_cg_iters) == (opt.last_iters if solver == "cg" else 0)
    assert tposegraph.graph_ate(opt, gt) < ate0


@pytest.mark.slow
def test_cg_converges_at_2048_vertices():
    opt, gt, n_loops = tposegraph.make_loopy_graph(2048, seed=1, device="cpu")
    assert n_loops >= 300
    ate0 = tposegraph.graph_ate(opt, gt)
    assert ate0 > 0.05
    assert np.isfinite(opt.optimize(n_iters=15, solver="cg"))
    ate1 = tposegraph.graph_ate(opt, gt)
    assert ate1 < 0.06 and ate1 < ate0 / 30, (ate0, ate1)


@pytest.mark.slow
def test_cg_robust_to_outlier_loops_at_scale():
    opt, gt, _ = tposegraph.make_loopy_graph(1024, seed=2, outlier_frac=0.1, device="cpu")
    ate0 = tposegraph.graph_ate(opt, gt)
    opt.optimize(n_iters=15, solver="cg")
    ate1 = tposegraph.graph_ate(opt, gt)
    assert ate1 < 0.1 and ate1 < ate0 / 8, (ate0, ate1)
