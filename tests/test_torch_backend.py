"""Parity of the port's pose-graph LM with the JAX package's dense solver.

Both optimizers get the same graph: a noisy chain with loop edges, one
of them an outlier under the robust kernel. The port solves densely on
the CPU; the reference's `_optimize_dense` is jitted as it runs. The two
fp32 LM runs take the same accept/reject decisions on a well-posed
graph, so poses agree to 1e-4 and the final robust chi2 to 1e-3
relative.
"""

import numpy as np
import pytest

from slam3d_gx_torch.backend import PoseGraphOptimizer as TorchOptimizer
from slam3d_gx_torch.backend import SLAMEnd as TorchSLAMEnd
from slam3d_gx_torch.backend import pose_graph as tpg
from slam3d_gx_torch.geometry import se3 as tse3
from slam3d_gx_tpu.backend import PoseGraphOptimizer
from slam3d_gx_tpu.geometry import se3


def noisy_chain(seed, n=14):
    """(ground truth, [(vertex id, T, fixed)], [(i, j, Z, info, robust)])."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4)]
    for _ in range(1, n):
        step = se3.make_isometry(se3.rodrigues(rng.normal(size=3) * 0.1),
                                 rng.normal(size=3) * 0.3)
        gt.append(gt[-1] @ step)
    info = np.eye(6) * 100.0
    edges, init = [], [np.eye(4)]
    for i in range(n - 1):
        noise = se3.make_isometry(se3.rodrigues(rng.normal(size=3) * 0.02),
                                  rng.normal(size=3) * 0.03)
        Z = se3.inverse(gt[i]) @ gt[i + 1] @ noise
        edges.append((i, i + 1, Z, info, False))
        init.append(init[-1] @ Z)
    for i, j in ((0, n - 1), (2, n // 2), (n // 3, n - 2)):
        edges.append((i, j, se3.inverse(gt[i]) @ gt[j], info, True))
    # an outlier loop edge for the robust kernel to down-weight
    bad = se3.make_isometry(se3.rodrigues(np.array([0.3, 0.0, 0.0])), np.array([1.0, 0, 0]))
    edges.append((1, n - 3, se3.inverse(gt[1]) @ gt[n - 3] @ bad, info, True))
    vertices = [(i, init[i], i == 0) for i in range(n)]
    return gt, vertices, edges


def build(opt, vertices, edges):
    for vid, T, fixed in vertices:
        opt.add_vertex(vid, T, fixed=fixed)
    for i, j, Z, info, robust in edges:
        opt.add_edge(i, j, Z, info, robust=robust)
    return opt


@pytest.mark.parametrize("kernel", ["Cauchy", "Huber", "none"])
def test_dense_lm_matches_jax(kernel):
    gt, vertices, edges = noisy_chain(1)
    ref = build(PoseGraphOptimizer(robust_kernel=kernel), vertices, edges)
    port = build(TorchOptimizer(robust_kernel=kernel, device="cpu"), vertices, edges)
    chi_ref = ref.optimize(n_iters=30)
    chi_port = port.optimize(n_iters=30)
    assert chi_port == pytest.approx(chi_ref, rel=1e-3)
    for vid, _, _ in vertices:
        np.testing.assert_allclose(port.vertex_estimate(vid), ref.vertex_estimate(vid),
                                   atol=1e-4)
    before = np.mean([np.linalg.norm(v[1][:3, 3] - g[:3, 3]) for v, g in zip(vertices, gt)])
    after = np.mean([np.linalg.norm(port.vertex_estimate(i)[:3, 3] - gt[i][:3, 3])
                     for i in range(len(gt))])
    if kernel != "none":
        assert after < before


def test_save_load_roundtrip(tmp_path):
    _, vertices, edges = noisy_chain(2, n=6)
    opt = build(TorchOptimizer(device="cpu"), vertices, edges)
    path = str(tmp_path / "g.g2o")
    opt.save(path)
    back = TorchOptimizer(device="cpu")
    back.load(path)
    assert sorted(back.graph.vertices) == list(range(6))
    assert back.graph.vertices[0].fixed and len(back.graph.edges) == len(edges)
    np.testing.assert_allclose(back.vertex_estimate(3), opt.vertex_estimate(3), atol=1e-6)


def test_empty_graph_and_cg_branch():
    """An empty graph returns 0; 513 vertices take the CG solver (a
    1,024 bucket: 512 CG iterations at most) and optimize: vertex 1 moves
    onto its one edge's measurement."""
    assert TorchOptimizer(device="cpu").optimize() == 0.0
    big = TorchOptimizer(device="cpu")
    for i in range(tpg._DENSE_VMAX + 1):
        big.add_vertex(i, np.eye(4), fixed=i == 0)
    Z = se3.make_isometry(se3.rodrigues(np.array([0.0, 0.1, 0.0])), np.array([0.3, 0.0, 0.1]))
    big.add_edge(0, 1, Z, np.eye(6))
    chi = big.optimize(n_iters=10)
    assert big.last_solver == "cg" and big.last_iters >= 1
    assert 0 < max(big.last_cg_iters) <= 512
    assert chi < 1e-8
    np.testing.assert_allclose(big.vertex_estimate(1), Z, atol=1e-4)
    np.testing.assert_allclose(big.vertex_estimate(2), np.eye(4), atol=1e-6)


def test_slam_end_takes_the_configured_kernel():
    class Params:
        def GetPara(self, key):
            return {"robust_kernel": "Huber"}[key]

    class Front:
        params = Params()

    end = TorchSLAMEnd(device="cpu")
    end.init(Front())
    assert end.globalOptimizer.robust_kernel == "Huber"
    assert tse3.inverse(np.eye(4)).shape == (4, 4)
