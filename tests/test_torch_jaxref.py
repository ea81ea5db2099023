"""The jitted JAX reference on the CPU, and the replay of its draws into the port.

`jitted_reference()` lets the JAX package's PnP stack run jitted on
XLA:CPU. Two of its scans carry an `unroll` hint: the 24-step
Durand-Kerner sweep of `quartic_roots` (slam3d_gx_tpu/ops/polynomial.py:77)
and the LM polish of `refine_pnp` (slam3d_gx_tpu/ops/pnp.py:326) pass
`unroll=iters`. Fully unrolled, XLA:CPU does not finish compiling the
quartic within a minute. Inside the block `jax.lax.scan` is a wrapper
that forwards every argument but passes `unroll=1`. `unroll` only tells
XLA how many steps to lay out in one loop body: the steps, their ops and
their order stay the same, so the reference's arithmetic stays as it is
(this file holds that). It also lets the default `refine_mode="tiered"`
run, whose zero-length refine scan `jax.disable_jit()` refuses. The
block clears JAX's caches on entry and on exit, so no trace made under
the hint outlives it or reaches another test on the same worker. The JAX
package itself is not changed.

`KeyReplay` mirrors a JAX frontend's key sequence (`GraphicEnd.next_key`,
slam3d_gx_tpu/frontend/graphic_end.py:183) and turns each key into the
port's draws, as the reference consumes it: one registration's uniforms
(the blocks of `jax.random.split(key, P+2)` on the plane path, the key's
own block on the image path), a batched round's (a key split once more
per chunk of 32, then into 32 pair keys, parallel/registration.py:289,
316), the plane extraction's Gumbel noise (`jax.random.split(key, P)`,
one block a RANSAC round) and a streamed chunk's (`jax.random.split(key,
chunk)`, each split into the extraction, main, rescue and keyframe->last
keys, frontend/streaming.py:94). The whole-run holds patch a port
frontend with it, so that both packages run on the same draws.

Tolerances of this file's own tests:
- `quartic_roots`, hinted and jitted, against `disable_jit` on 4,096
  random quartics, finite in the same places. On the 3,072 plain ones
  within 1e-6 relative to 1 + |root| (measured 2.6e-7: XLA fuses the
  complex arithmetic of the loop body where the eager run rounds op by
  op). A quarter have a near-double root (the pair 1e-6 to 1e-3 apart):
  Durand-Kerner converges only linearly at a double root, so after 24
  steps those iterates are not converged and carry the rounding
  difference along; held at the measured bound, 2e-2 at worst (8.6e-3
  measured) and 1e-4 in the median (4.4e-5);
- the hinted, jitted multiPnP in `refine_mode="full"` against the
  `disable_jit` one, on the pair and draws of tests/test_torch_multipnp.py:
  `ok` and the inlier count exact, T within 1e-5;
- `jax.lax.scan` is the original object again after the block, an
  exception inside it included.
"""

from __future__ import annotations

import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from slam3d_gx_torch import interop
from slam3d_gx_torch.frontend.streaming import ChunkDraws
from slam3d_gx_tpu.config import CameraIntrinsics
from slam3d_gx_tpu.frontend import pipeline as jpipe
from slam3d_gx_tpu.ops import polynomial as jpoly

@contextlib.contextmanager
def jitted_reference():
    """Run the JAX package jitted, with every `jax.lax.scan` unrolled
    once (see the module docstring)."""
    original = jax.lax.scan

    def scan(*args, **kwargs):
        return original(*args, **dict(kwargs, unroll=1))

    jax.clear_caches()
    jax.lax.scan = scan
    try:
        yield
    finally:
        jax.lax.scan = original
        jax.clear_caches()


@pytest.fixture(scope="module")
def jitted():
    """jitted_reference() around a whole test module."""
    with jitted_reference():
        yield


# One intra-op thread for torch in the process that imports this module.
# The port's CPU paths issue many small operations, which torch's pool of a
# thread a core only slows when six test workers share the cores. Each
# worker imports every test module when it collects the suite, so every
# port test it runs gets one thread; a port file run alone keeps torch's
# default unless it imports this module.
torch.set_num_threads(1)


# -- the reference's draws, replayed into the port ---------------------------

BATCH_CHUNK = 32  # the registrars' FeatureStore chunk, in both packages

class ReplaySampler:
    """The plane RANSAC's draws of one extraction from its JAX key: round
    p takes `jax.random.categorical(split(key, planes)[p], logits,
    shape=(B, 3))`, the argmax of Gumbel noise over the remaining points
    (slam3d_gx_tpu/ops/plane_ransac.py:78). The noise is drawn when a
    round asks for it, at the cloud's size."""

    def __init__(self, key, planes: int):
        self.keys = jax.random.split(key, planes)

    def __call__(self, p: int, remaining: torch.Tensor, hypotheses: int):
        g = np.array(jax.random.gumbel(self.keys[p], (hypotheses, 3, remaining.shape[-1]),
                                         jnp.float32))
        logits = torch.where(remaining, 0.0, -1e30)[..., None, None, :]
        return torch.argmax(torch.from_numpy(g).to(remaining.device) + logits, dim=-1)


class KeyReplay:
    """A JAX frontend's `next_key()` sequence from PRNGKey(seed), turned
    into the port's draws (module docstring). planes: the frontend's
    max_planes, or None for the image-only frontend. `drawn` counts the
    keys taken."""

    def __init__(self, seed: int, hypotheses: int, planes=None):
        self.key = jax.random.PRNGKey(seed)
        self.hypotheses = hypotheses
        self.planes = planes
        self.drawn = 0

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        self.drawn += 1
        return sub

    def pair_uniforms(self, key) -> np.ndarray:
        """One registration's uniforms from its key: (H,3) on the image
        path, (P+2,H,3) on the plane path."""
        shape = (self.hypotheses, 3)
        if self.planes is None:
            return np.array(jax.random.uniform(key, shape))
        return np.stack([np.asarray(jax.random.uniform(k, shape))
                         for k in jax.random.split(key, self.planes + 2)])

    def uniforms(self, *batch: int) -> torch.Tensor:
        """The port frontend's `_uniforms(*batch)`: one registration, or a
        batched round of n pairs."""
        key = self.next_key()
        if not batch:
            return torch.from_numpy(self.pair_uniforms(key))
        return self.round_uniforms(key, *batch)

    def round_uniforms(self, key, n: int) -> torch.Tensor:
        """A batched round of n pairs from its key, as
        `BatchedRegistrar.dispatch_against_one` splits it."""
        rows = []
        for c0 in range(0, n, BATCH_CHUNK):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, BATCH_CHUNK)
            rows += [self.pair_uniforms(k) for k in keys[:min(BATCH_CHUNK, n - c0)]]
        return interop.pnp_uniforms_batch(rows, "cpu")

    def sampler(self, generator=None) -> ReplaySampler:
        """Stands in for `plane_ransac.UniformSampler(generator)`."""
        return ReplaySampler(self.next_key(), self.planes)

    def chunk_draws(self, key, chunk: int) -> ChunkDraws:
        """A streamed chunk's draws from its key (the port's
        `_chunk_draws()`)."""
        u, samplers = [], []
        for k in jax.random.split(key, chunk):
            k_ext, k_pnp, k_r, k_rr = jax.random.split(k, 4)
            u.append(np.stack([self.pair_uniforms(x) for x in (k_pnp, k_r, k_rr)]))
            samplers.append(ReplaySampler(k_ext, self.planes) if self.planes else None)
        return ChunkDraws(samplers if self.planes else None, torch.from_numpy(np.stack(u)))


# -- the file's own tests ----------------------------------------------------

def _quartics(n=4096, seed=0):
    """Random quartics; every fourth one has a near-double root."""
    rng = np.random.default_rng(seed)
    co = rng.normal(size=(n, 5))
    r = rng.normal(size=(n // 4, 3))
    eps = 10.0 ** rng.uniform(-6, -3, n // 4)
    roots = np.c_[r[:, 0], r[:, 0] + eps, r[:, 1], r[:, 2]]
    co[: n // 4] = np.array([np.poly(x) for x in roots]) * rng.uniform(0.5, 2.0, (n // 4, 1))
    return co.astype(np.float32)


def test_hinted_quartic_roots_equal_the_eager_ones():
    co = jnp.asarray(_quartics())
    with jitted_reference():
        hinted = np.asarray(jpoly.quartic_roots(co))
    with jax.disable_jit():
        eager = np.asarray(jpoly.quartic_roots(co))
    np.testing.assert_array_equal(np.isfinite(hinted), np.isfinite(eager))
    assert np.isfinite(eager).all()
    rel = (np.abs(hinted - eager) / (1.0 + np.abs(eager))).max(1)
    plain, near_double = rel[len(rel) // 4:], rel[:len(rel) // 4]
    assert plain.max() <= 1e-6, plain.max()
    assert near_double.max() <= 2e-2 and np.median(near_double) <= 1e-4


INTR = CameraIntrinsics(fx=260.0, fy=260.0, cx=160.0, cy=120.0, factor=5000.0)


def _exact_pair(seed, k=32):
    fa, fb = __graft_entry__._plane_frame_pair(INTR, np.random.default_rng(seed), p=3, k=k)
    return (fa._replace(desc=jnp.round(jnp.abs(fa.desc))),
            fb._replace(desc=jnp.round(jnp.abs(fb.desc))))


def test_hinted_multipnp_full_equals_the_eager_one():
    """The pair and draws of tests/test_torch_multipnp.py's reference run."""
    fa, fb = _exact_pair(0)
    key = jax.random.PRNGKey(0)
    out = {}
    with jitted_reference():
        res = jpipe.build_multipnp_planes(INTR, hypotheses=32, refine_mode="full")(fa, fb, key, 12)
        out["hinted"] = [np.asarray(x) for x in res]
    with jax.disable_jit():
        res = jpipe.build_multipnp_planes(INTR, hypotheses=32, refine_mode="full")(fa, fb, key, 12)
        out["eager"] = [np.asarray(x) for x in res]
    (hT, hn, hi, hok), (eT, en, ei, eok) = out["hinted"], out["eager"]
    assert bool(hok) == bool(eok) and bool(eok) and int(hi) == int(ei)
    np.testing.assert_allclose(hT, eT, atol=1e-5)
    assert float(hn) == pytest.approx(float(en), abs=1e-5)


def test_scan_is_restored_after_the_block_and_an_exception():
    original = jax.lax.scan
    with jitted_reference():
        assert jax.lax.scan is not original
    assert jax.lax.scan is original
    with pytest.raises(RuntimeError, match="inside"):
        with jitted_reference():
            raise RuntimeError("inside")
    assert jax.lax.scan is original


def test_hint_passes_unroll_1():
    """Both scans of the reference pass `unroll` by keyword."""
    seen = []
    original = jax.lax.scan

    def spy(*args, **kwargs):
        seen.append(kwargs.get("unroll"))
        return original(*args, **kwargs)

    jax.lax.scan = spy
    try:
        with jitted_reference():
            c, _ = jax.lax.scan(lambda c, _: (c + 1, None), 0, None, length=4, unroll=4)
    finally:
        jax.lax.scan = original
    assert seen == [1] and int(c) == 4


def test_plane_multipnp_compiles_under_the_hint(capsys):
    """The default (tiered) plane multiPnP at frontend widths (256
    keypoints a plane, 128 hypotheses): compile and run seconds."""
    fa, fb = _exact_pair(3, k=256)
    with jitted_reference():
        fn = jpipe.build_multipnp_planes(INTR, hypotheses=128)
        t0 = time.perf_counter()
        res = fn(fa, fb, jax.random.PRNGKey(1), 12)
        jax.block_until_ready(res)
        t1 = time.perf_counter()
        res = fn(fa, fb, jax.random.PRNGKey(2), 12)
        jax.block_until_ready(res)
        t2 = time.perf_counter()
    assert bool(res.ok) and int(res.inliers) >= 12
    with capsys.disabled():
        print(f"\njitted tiered plane multiPnP: compile+run {t1 - t0:.2f} s, run {t2 - t1:.3f} s")


def test_replayed_draws_are_the_reference_keys():
    """KeyReplay splits as next_key() does, and a batched round's rows are
    the pair keys of dispatch_against_one."""
    rep = KeyReplay(7, hypotheses=8, planes=3)
    key = jax.random.PRNGKey(7)
    key, k1 = jax.random.split(key)
    key, k2 = jax.random.split(key)
    single = rep.uniforms()
    np.testing.assert_array_equal(single.numpy()[4], np.asarray(
        jax.random.uniform(jax.random.split(k1, 5)[4], (8, 3))))
    batch = rep.uniforms(33)
    assert batch.shape == (33, 5, 8, 3) and rep.drawn == 2
    k2, sub = jax.random.split(k2)
    row0 = jax.random.split(sub, 32)[0]
    _, sub = jax.random.split(k2)
    row32 = jax.random.split(sub, 32)[0]
    for row, k in ((0, row0), (32, row32)):
        np.testing.assert_array_equal(batch.numpy()[row, 0], np.asarray(
            jax.random.uniform(jax.random.split(k, 5)[0], (8, 3))))
    img = KeyReplay(7, hypotheses=8)
    np.testing.assert_array_equal(img.uniforms().numpy(),
                                  np.asarray(jax.random.uniform(k1, (8, 3))))
