"""Parity of the port's keyframe retrieval database (parallel/lcdb.py)
with the JAX package's `KeyframeDatabase(mesh=None)`: the single-device
cases of tests/test_parallel.py on the same features, made from a seed.

Candidate lists must be equal. A score is a good-match count plus a
tiebreak in (0, 1]. The port's scores lie within 1e-5 of the same
score in float64 arithmetic, and within 1e-4 of the JAX package's plus
the JAX score's own distance from the float64 one: JAX expands
|a-b|^2 = |a|^2 + |b|^2 - 2ab, which leaves the distances of a
near-duplicate keyframe (~0.06 at norms ~57) to fp32 rounding (2.1e-4
off in test_lcdb_scores_and_top's frame 4, measured), where the port
subtracts first. The port scores in blocks of keyframes; a keyframe's
score does not depend on its block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam3d_gx_torch.frontend.state import FrameFeatures as TFeatures
from slam3d_gx_torch.ops.features import registry as tregistry
from slam3d_gx_torch.parallel import lcdb as tlcdb
from slam3d_gx_tpu.frontend.state import FrameFeatures as JFeatures
from slam3d_gx_tpu.geometry import se3
from slam3d_gx_tpu.parallel import lcdb as jlcdb

TOL = 1e-4
FX, FY, CX, CY = 517.0, 517.0, 318.6, 255.3


def synthetic_frame(rng, k=96):
    """Keypoints of random 3D points and random 32-wide descriptors, as
    tests/test_parallel.py's _synthetic_pair draws them."""
    pts = np.stack([rng.uniform(-1.5, 1.5, k), rng.uniform(-1.0, 1.0, k),
                    rng.uniform(1.5, 3.5, k)], axis=1)
    R = se3.rodrigues(np.array([0.0, np.deg2rad(4.0), 0.0]))
    _ = pts @ R.T
    uv = np.stack([FX * pts[:, 0] / pts[:, 2] + CX, FY * pts[:, 1] / pts[:, 2] + CY], axis=1)
    desc = rng.normal(size=(k, 32)).astype(np.float32) * 10
    return pts, uv, desc


def features(pts, uv, desc):
    """The same frame for both packages: (JAX, torch) FrameFeatures."""
    k = desc.shape[0]
    arrays = dict(coeffs=np.zeros((1, 4), np.float32), plane_valid=np.ones((1,), bool),
                  uv=np.asarray(uv, np.float32)[None], kp3d=np.asarray(pts, np.float32)[None],
                  desc=np.asarray(desc, np.float32)[None], kp_valid=np.ones((1, k), bool))
    return (JFeatures(**{n: jnp.asarray(a) for n, a in arrays.items()}),
            TFeatures(**{n: torch.from_numpy(a) for n, a in arrays.items()}))


def exact_scores(db, q: np.ndarray, floor: float) -> np.ndarray:
    """The stored keyframes' scores against query descriptors q (all
    valid), in float64."""
    out = []
    for c in range(db.count):
        stored = np.asarray(db.desc[c], np.float64)[np.asarray(db.valid[c])]
        dist = np.sqrt(((q[:, None].astype(np.float64) - stored[None]) ** 2).sum(-1)).min(1)
        good = dist <= max(3.0 * min(100.0, dist.min()), floor)
        out.append(good.sum() + 1.0 / (1.0 + dist.mean()))
    return np.array(out)


def assert_scores(s, s_ref, jdb, q, floor=0.0):
    exact = exact_scores(jdb, np.asarray(q, np.float32).reshape(-1, q.shape[-1]), floor)
    np.testing.assert_allclose(s, exact, atol=1e-5)
    assert np.all(np.abs(s - s_ref) <= TOL + np.abs(s_ref - exact)), (s, s_ref, exact)


def both_dbs(n_desc, dim, capacity, match_floor=0.0):
    return (jlcdb.KeyframeDatabase(n_desc=n_desc, dim=dim, capacity=capacity, mesh=None,
                                   match_floor=match_floor),
            tlcdb.KeyframeDatabase(n_desc=n_desc, dim=dim, capacity=capacity,
                                   match_floor=match_floor, device="cpu"))


def fill(dbs, rng, n):
    frames = []
    for i in range(n):
        f = features(*synthetic_frame(rng))
        frames.append(f)
        for db, fk in zip(dbs, f):
            assert db.add(fk) == i
    return frames


def test_lcdb_scores_and_top():
    rng = np.random.default_rng(11)
    jdb, tdb = both_dbs(96, 32, 8)
    frames = fill((jdb, tdb), rng, 10)  # one doubling, 8 -> 16
    assert tdb.count == 10 and tdb.capacity == 16
    jq, _ = frames[4]
    noise = 0.01 * rng.normal(size=jq.desc.shape).astype(np.float32)
    jq = jq._replace(desc=jq.desc + jnp.asarray(noise))
    tq = frames[4][1]._replace(desc=frames[4][1].desc + torch.from_numpy(noise))
    s_ref, s = jdb.scores(jq), tdb.scores(tq)
    assert s.shape == (10,)
    assert_scores(s, s_ref, jdb, jq.desc)
    assert int(np.argmax(s)) == 4
    top = tdb.top_candidates(tq, 3)
    assert top == jdb.top_candidates(jq, 3)
    assert top[0] == 4 and all(t < 7 for t in top)  # the newest 3 excluded


def test_lcdb_orb_floor_fixes_binary_degeneracy():
    rng = np.random.default_rng(17)
    k, d = 64, 32
    q_desc = rng.integers(0, 2, (k, d)).astype(np.float32) * 8
    near = q_desc.copy()
    near[1:] += rng.normal(0, 0.4, (k - 1, d)).astype(np.float32)
    far = rng.integers(0, 2, (k, d)).astype(np.float32) * 8
    zeros = np.zeros((k, 3))

    def feats(desc):
        return features(zeros, zeros[:, :2], desc)

    floor = tregistry.match_floor("ORB")
    assert floor > 0.0
    for match_floor in (floor, 0.0):
        jdb, tdb = both_dbs(k, d, 8, match_floor)
        for desc in (near, far):
            jf, tf = feats(desc)
            jdb.add(jf)
            tdb.add(tf)
        jq, tq = feats(q_desc)
        s = tdb.scores(tq)
        assert_scores(s, jdb.scores(jq), jdb, q_desc, match_floor)
        if match_floor:
            assert s[0] > 0.8 * k and s[0] > s[1], s
        else:
            assert s[0] < 3, s  # the degeneracy the floor fixes


def test_lcdb_grow_is_device_side_and_score_stable():
    rng = np.random.default_rng(23)
    jdb, tdb = both_dbs(96, 32, 4)
    frames = fill((jdb, tdb), rng, 4)
    jq, tq = frames[2]
    before = tdb.scores(tq).copy()
    f5 = features(*synthetic_frame(rng))
    jdb.add(f5[0])
    desc_before = tdb.desc
    tdb.add(f5[1])
    assert tdb.capacity == 8 and tdb.count == 5
    assert tdb.desc.device == desc_before.device and tdb.desc.shape[0] == 8
    after = tdb.scores(tq)
    np.testing.assert_array_equal(before, after[:4])
    assert_scores(after, jdb.scores(jq), jdb, jq.desc)


@pytest.mark.parametrize("block", [None, 2])
def test_lcdb_device_select_matches_host_topk(block):
    rng = np.random.default_rng(31)
    jdb, tdb = both_dbs(96, 32, 16)
    if block:
        tdb.block = block  # blocks of 2 keyframes: the same scores
    frames = fill((jdb, tdb), rng, 9)
    jq, tq = frames[3]
    n = 4
    assert_scores(tdb.scores(tq), jdb.scores(jq), jdb, jq.desc)
    host = tdb.top_candidates(tq, n)
    assert host == jdb.top_candidates(jq, n)
    idx, valid = (t.numpy() for t in tdb.select_candidates_device(tq, n))
    jidx, jvalid = (np.asarray(a) for a in jdb.select_candidates_device(jq, n))
    assert idx.shape == (2 + n,)
    assert idx[0] == tdb.count - 3 and idx[1] == tdb.count - 4 and valid[:2].all()
    assert [int(i) for i in idx[2:2 + len(host)]] == host and valid[2:2 + len(host)].all()
    np.testing.assert_array_equal(valid, jvalid)
    np.testing.assert_array_equal(idx[valid], jidx[jvalid])
    # over-asking pads with invalid rows; only the eligible prefix is real
    idx2, valid2 = tdb.select_candidates_device(tq, tdb.count + 5)
    jidx2, jvalid2 = (np.asarray(a) for a in jdb.select_candidates_device(jq, tdb.count + 5))
    assert int(valid2[2:].sum()) == tdb.count - 3
    np.testing.assert_array_equal(valid2.numpy(), jvalid2)
    np.testing.assert_array_equal(idx2.numpy()[valid2.numpy()], jidx2[jvalid2])
