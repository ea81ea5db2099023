"""The loop_closure_max_drift gate on the port's GraphicEnd: the five
host-only cases of tests/test_lc_gate.py, each also run through the JAX
package's GraphicEnd methods on the same hints, which must give the same
verdicts.

The gate compares a loop edge's measured translation with dead-reckoned
world-pose hints (hint_new = hint_prev @ Z_edge) kept at every promotion
site. The trajectory below does not commute (rotations about varying
axes), so a wrong composition convention would show.
"""

import numpy as np
import pytest

from slam3d_gx_torch.config import ParameterReader
from slam3d_gx_torch.frontend.graphic_end import GraphicEnd
from slam3d_gx_torch.frontend.state import Keyframe
from slam3d_gx_torch.geometry import se3
from slam3d_gx_tpu.frontend.graphic_end import GraphicEnd as JaxGraphicEnd


def gate_host(cls, max_drift):
    """The gate's state surface of one package's GraphicEnd, without its
    pipeline."""
    host = type("GateHost", (), {
        name: getattr(cls, name)
        for name in ("_lc_within_drift", "_chain_pose_hint", "_reanchor_pose_hint")})()
    host.lc_max_drift = max_drift
    host._kf_pose = {}
    return host


class BothGates:
    """The port's gate and the JAX package's, fed the same hints; every
    verdict is asked of both and must agree."""

    def __init__(self, max_drift):
        self.hosts = [gate_host(GraphicEnd, max_drift), gate_host(JaxGraphicEnd, max_drift)]

    def __getattr__(self, name):
        def call(*args):
            out = [getattr(h, name)(*args) for h in self.hosts]
            assert out[0] == out[1], (name, out)
            return out[0]
        return call

    def set_pose(self, kid, T):
        for h in self.hosts:
            h._kf_pose[kid] = T

    def pose(self, kid):
        return self.hosts[0]._kf_pose.get(kid)


def wandering_chain(n=12, seed=3):
    rng = np.random.default_rng(seed)
    g = [np.eye(4)]
    for _ in range(1, n):
        g.append(g[-1] @ se3.make_isometry(se3.rodrigues(rng.normal(0, 0.25, 3)),
                                           rng.normal(0, 0.15, 3)))
    return g


def gates_with_chain(gt, max_drift):
    """Hints built as the frontend builds them: identity at keyframe 0,
    then hint_new = hint_prev @ inv(g_prev) @ g_new."""
    h = BothGates(max_drift)
    h.set_pose(0, np.eye(4))
    for k in range(1, len(gt)):
        h._chain_pose_hint(k, se3.inverse(gt[k - 1]) @ gt[k])
    return h


def kf(i):
    return Keyframe(id=i, frame_index=i + 1, features=None)


def test_gate_off_accepts_everything():
    h = BothGates(0.0)
    h.set_pose(0, np.eye(4))
    h.set_pose(1, np.eye(4))
    assert h._lc_within_drift(kf(0), kf(1), se3.make_isometry(np.eye(3), [5.0, 0, 0]))


def test_gate_on_noncommuting_chain():
    gt = wandering_chain()
    h = gates_with_chain(gt, 0.5)
    a, b = 2, len(gt) - 1
    Z_true = se3.inverse(gt[a]) @ gt[b]
    assert h._lc_within_drift(kf(a), kf(b), Z_true)
    Z_drift = Z_true.copy()
    Z_drift[:3, 3] += [0.05, -0.02, 0.03]
    assert h._lc_within_drift(kf(a), kf(b), Z_drift)
    Z_alias = Z_true.copy()
    Z_alias[:3, 3] += [1.3, 0.0, 0.0]  # the aliasing class (~1.3 m off)
    assert not h._lc_within_drift(kf(a), kf(b), Z_alias)


def test_gate_exact_on_every_pair():
    """The chain telescopes: with noise-free measurements the prediction
    is the true relative pose for every pair."""
    gt = wandering_chain(n=10, seed=7)
    h = gates_with_chain(gt, 1e-6)
    for a in range(len(gt)):
        for b in range(a + 1, len(gt)):
            assert h._lc_within_drift(kf(a), kf(b), se3.inverse(gt[a]) @ gt[b]), (a, b)


def test_gate_permissive_across_broken_chain_and_reanchors():
    gt = wandering_chain()
    h = gates_with_chain(gt, 0.5)
    h.set_pose(5, None)  # a blackout at keyframe 5 breaks the chain
    h._chain_pose_hint(6, np.eye(4))
    assert h.pose(6) is None
    Z_bogus = se3.make_isometry(np.eye(3), [9.0, 0, 0])
    assert h._lc_within_drift(kf(2), kf(6), Z_bogus)
    Z_re = se3.inverse(gt[2]) @ gt[6]
    h._reanchor_pose_hint(6, 2, Z_re)  # an accepted edge re-anchors it
    assert h.pose(6) is not None
    assert h._lc_within_drift(kf(2), kf(6), Z_re)
    assert not h._lc_within_drift(kf(2), kf(6), Z_bogus)


@pytest.mark.parametrize("overrides,want", [({}, 0.0), ({"loop_closure_max_drift": "0.5"}, 0.5)])
def test_config_key_default_off(overrides, want):
    assert ParameterReader(None, overrides=overrides).get_float("loop_closure_max_drift") == want
