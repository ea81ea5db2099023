"""`equalize_hist256`, K1, K2 (exactly) and K3 (to a last bit) on the card
against their plain versions, K3 bit for bit against its first design,
and `refine_lm` against its plain version on the card.

Marked `cuda`: a CUDA kernel has no CPU mode, so these skip without a
card. The file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(tests/conftest.py configures JAX for the rest of the suite.)
"""

import numpy as np
import pytest
import torch

from slam3d_gx_torch import kernels
from slam3d_gx_torch.kernels import equalize as teq
from slam3d_gx_torch.kernels import min_eig as tk3
from slam3d_gx_torch.kernels import refine_lm as tlm
from slam3d_gx_torch.ops import imageproc as timg
from slam3d_gx_torch.ops import lie as tlie


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (37, 53), (1, 1), (7, 3)])
def test_cuda_kernels_match_plain_versions(cuda_device, shape):
    rng = np.random.default_rng(6)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    x = torch.from_numpy(img).to(cuda_device)
    torch.testing.assert_close(kernels.histogram256(x).cpu(),
                               teq.histogram256_plain(x.cpu()), rtol=0, atol=0)
    lut = torch.from_numpy(rng.integers(0, 256, 256).astype(np.float32))
    torch.testing.assert_close(kernels.apply_lut256(x, lut.to(cuda_device)).cpu(),
                               teq.apply_lut256_plain(x.cpu(), lut), rtol=0, atol=0)
    torch.testing.assert_close(timg.equalize_hist(x).cpu(),
                               timg.equalize_hist(x.cpu()), rtol=0, atol=0)


def equalize_case(name):
    rng = np.random.default_rng(13)
    H, W = 480, 640
    one = np.zeros((H, W), np.uint8)
    one[H // 3, W // 5] = 9
    if name == "random":
        return rng.integers(0, 256, (H, W))
    if name == "constant":
        return np.full((H, W), 77)
    if name == "empty_bins":
        return rng.choice([0, 3, 128, 255], (H, W))
    if name == "skewed":
        return np.clip(rng.normal(60, 9, (H, W)), 0, 255)
    if name == "ragged":
        return rng.integers(0, 256, (37, 53))
    if name == "one_pixel":
        return np.array([[200]])
    if name == "one_nonzero_pixel":
        return one
    if name == "total_minus_first_is_one":
        return np.where(one > 0, 200, 31)
    if name == "half_ties":  # scale 0.5: every odd cumulative count is a tie
        ties = np.concatenate([[0, 0, 1], np.repeat(np.arange(2, 256), 2), [255]])
        return rng.permutation(ties).reshape(16, 32)
    assert name == "loop_form"  # more pixels than the cluster's registers hold
    return rng.integers(0, 256, (1080, 1920))


EQUALIZE_CASES = ["random", "constant", "empty_bins", "skewed", "ragged", "one_pixel",
                  "one_nonzero_pixel", "total_minus_first_is_one", "half_ties", "loop_form"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uint8", "float32", "view", "misaligned"])
@pytest.mark.parametrize("name", EQUALIZE_CASES)
def test_equalize_hist256_kernel_matches_plain_version(cuda_device, name, kind):
    """Tolerance 0 (integers; the LUT's two float32 operations are single
    IEEE operations on both sides). `equalize_hist` on the card is one
    launch of this kernel and of no other."""
    img = torch.from_numpy(equalize_case(name).astype(np.uint8))
    if kind == "float32":
        img = img.float()
    elif kind == "view":  # non-contiguous
        img = torch.stack([img, img], dim=-1)[..., 0]
    elif kind == "misaligned":  # contiguous, off a 16-byte boundary
        img = torch.cat([img.reshape(-1)[:1], img.reshape(-1)])[1:]
    x = img.to(cuda_device)
    if kind == "view":
        x = torch.stack([x, x], dim=-1)[..., 0]
        assert not x.is_contiguous() or x.numel() == 1
    elif kind == "misaligned":
        x = torch.cat([x[:1], x])[1:]
        assert x.data_ptr() % 16 == 1
    before = kernels.launch_counts()
    got = timg.equalize_hist(x)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "equalize_hist256": 1, "histogram256": 0, "apply_lut256": 0, "min_eig_response": 0,
        "refine_lm": 0}
    assert got.dtype == torch.uint8 and got.shape == img.shape
    torch.testing.assert_close(got.cpu(), teq.equalize_hist256_plain(img), rtol=0, atol=0)
    torch.testing.assert_close(got, teq.equalize_hist256_plain(x), rtol=0, atol=0)


@pytest.mark.cuda
def test_equalize_hist256_back_to_back_launches_are_independent(cuda_device):
    """1,000 launches on alternating images with no synchronise between
    them: the cluster's barriers and tables leave nothing behind."""
    imgs = [torch.from_numpy(equalize_case(k).astype(np.uint8)) for k in ("random", "skewed")]
    want = [teq.equalize_hist256_plain(i).to(cuda_device) for i in imgs]
    xs = [i.to(cuda_device) for i in imgs]
    outs = [kernels.equalize_hist256(xs[i % 2]) for i in range(1000)]
    torch.cuda.synchronize()
    assert [i for i, o in enumerate(outs) if not torch.equal(o, want[i % 2])] == []


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (37, 53), (1, 7), (7, 1), (1, 1), (16, 32)])
@pytest.mark.parametrize("kind", ["uint8", "float", "constant", "view"])
def test_min_eig_kernel_matches_plain_version(cuda_device, shape, kind):
    """K3 does the plain version's operations in its order, each rounded
    to nearest. The plain version differs in last bits: on the card
    PyTorch divides by a scalar as a product with its reciprocal, on the
    CPU its sqrt is not always correctly rounded. Both are held to 1e-6
    of the largest box sum (the response is a difference of two such
    sums). `view` is a non-contiguous input, which the wrapper makes
    contiguous."""
    rng = np.random.default_rng(9)
    if kind == "uint8":
        img = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
    elif kind == "float":
        img = torch.from_numpy((rng.normal(size=shape) * 50).astype(np.float32))
    elif kind == "constant":
        img = torch.full(shape, 93, dtype=torch.uint8)
    else:
        wide = rng.integers(0, 256, (shape[0], 2 * shape[1])).astype(np.uint8)
        img = torch.from_numpy(wide)[:, ::2]
    x = img.to(cuda_device)
    if kind == "view":
        x = torch.from_numpy(wide).to(cuda_device)[:, ::2]
        assert not x.is_contiguous() or shape[1] == 1
    before = kernels.launch_counts()["min_eig_response"]
    got = kernels.min_eig_response(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["min_eig_response"] == before + 1
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    sxx, syy, _ = tk3.structure_tensor(img.to(torch.float32))
    atol = 1e-6 * float((sxx + syy).max())
    torch.testing.assert_close(got, tk3.min_eig_response_plain(x), rtol=0, atol=atol)
    torch.testing.assert_close(got.cpu(), tk3.min_eig_response_plain(img), rtol=0, atol=atol)


def k3_case(shape, kind, seed=10):
    """(image on the CPU, the same image on the card as the wrapper gets it)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    if kind == "float":
        img = torch.from_numpy((rng.normal(size=shape) * 50).astype(np.float32))
        return img, img.to(CUDA)
    big = torch.from_numpy(rng.integers(0, 256, (H + 3, W + 9)).astype(np.uint8))
    if kind == "uint8":
        img = big[:H, :W].contiguous()
        return img, img.to(CUDA)
    dev = big.to(CUDA)
    if kind == "pitched":  # a row-cropped view: read in place at the parent's pitch
        return big[2:2 + H, 5:5 + W], dev[2:2 + H, 5:5 + W]
    assert kind == "misaligned"  # contiguous rows one byte off an aligned base
    flat = dev.reshape(-1)[1:1 + H * W]
    assert flat.data_ptr() % 16 == 1
    return big.reshape(-1)[1:1 + H * W].view(H, W), flat.view(H, W)


CUDA = "cuda"
K3_SHAPES = [(15, 119), (16, 120), (17, 121), (33, 239), (47, 241), (2, 640), (480, 2),
             (2, 2), (1080, 1920), (2160, 3840)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uint8", "float", "pitched", "misaligned"])
@pytest.mark.parametrize("shape", K3_SHAPES)
def test_min_eig_kernel_is_bit_identical_to_its_first_design(cuda_device, shape, kind):
    """The one-wave kernel does the first design's rounded operations in
    the same order: equal to the last bit on every shape (tile edges
    either side, 2-pixel images, the grid-stride sizes) and view. The
    plain version is held as in test_min_eig_kernel_matches_plain_version.
    A pitched view is read in place, not copied."""
    img, x = k3_case(shape, kind)
    before = kernels.launch_counts()["min_eig_response"]
    got = kernels.min_eig_response(x)
    old = tk3._min_eig_tile(x)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["min_eig_response"] == before + 1
    assert got.shape == tuple(shape) and got.dtype == torch.float32
    assert torch.equal(got, old)
    if kind == "pitched":
        assert tk3.pitched(x)[0].data_ptr() == x.data_ptr()
    sxx, syy, _ = tk3.structure_tensor(img.to(torch.float32))
    atol = 1e-6 * float((sxx + syy).max())
    torch.testing.assert_close(got, tk3.min_eig_response_plain(x), rtol=0, atol=atol)
    if shape[0] * shape[1] <= 480 * 640:  # the CPU's plain version is slow above
        torch.testing.assert_close(got.cpu(), tk3.min_eig_response_plain(img), rtol=0,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", tk3.VARIANTS)
def test_min_eig_every_built_variant_is_bit_identical(cuda_device, variant):
    for kind in ("uint8", "float", "misaligned"):
        for shape in ((480, 640), (37, 53), (70, 523)):
            _, x = k3_case(shape, kind)
            got = tk3._launch_min_eig(x, *variant)
            assert torch.equal(got, tk3._min_eig_tile(x)), (kind, shape)


@pytest.mark.cuda
def test_min_eig_back_to_back_launches_are_independent(cuda_device):
    """1,000 launches on alternating images with no synchronise between."""
    xs = [k3_case((480, 640), "uint8", seed)[1] for seed in (1, 2)]
    want = [tk3._min_eig_tile(x) for x in xs]
    outs = [kernels.min_eig_response(xs[i % 2]) for i in range(1000)]
    torch.cuda.synchronize()
    assert [i for i, o in enumerate(outs) if not torch.equal(o, want[i % 2])] == []


@pytest.mark.cuda
def test_min_eig_fast_division_and_root_round_as_the_intrinsics(cuda_device):
    """All 2^32 float32 inputs: the kernel's branch-free x / 9 and sqrt
    agree with __fdiv_rn and __fsqrt_rn wherever the kernel uses them."""
    # the division leaves +-inf and NaN to the intrinsic; the root keeps +-0
    # and the finite floats from 2^-100 up (exponent fields 27 to 254)
    refused = {"div9": 2 ** 24, "sqrt": 2 ** 32 - (2 + 228 * 2 ** 23)}
    for op, r in tk3.rounding_selfcheck(cuda_device).items():
        assert r["differ_accepted"] == 0, (op, r)
        assert r["refused"] == refused[op], (op, r)


LM_CAM = (517.0, 517.0, 318.6, 255.3)  # the fr1 Kinect preset


def lm_problem(G, N, seed, kind="inliers"):
    """G independent polishes of N correspondences, float32 on the CPU:
    points 1-4 m before the camera, a pose within ~0.05 of the identity,
    pixels to 0.5 px, and a start 0.02 off the pose, as a RANSAC winner
    hands them over. From N = 100 on, a quarter are outliers moved ~40 px
    with weight 0 (the winner's inlier mask). Degenerate kinds:
    `zero_weights` (every weight 0), `behind` (every point behind the
    camera), `two_weighted` (two points of weight 1, too few to fix 6
    parameters)."""
    rng = np.random.default_rng(seed)
    obj = rng.uniform([-1.5, -1.2, 1.0], [1.5, 1.2, 4.0], (G, N, 3))
    rv, tv = rng.normal(0, 0.05, (G, 3)), rng.normal(0, 0.05, (G, 3))
    if kind == "behind":
        obj[..., 2] *= -1
    R = tlie.rodrigues(torch.from_numpy(rv.astype(np.float32))).double().numpy()
    pc = np.einsum("gij,gnj->gni", R, obj) + tv[:, None]
    img = np.stack([LM_CAM[0] * pc[..., 0] / pc[..., 2] + LM_CAM[2],
                    LM_CAM[1] * pc[..., 1] / pc[..., 2] + LM_CAM[3]], -1)
    img += rng.normal(0, 0.5, img.shape)
    w = np.ones((G, N))
    if N >= 100:
        out = rng.random((G, N)) < 0.25
        img[out] += rng.normal(0, 40, (int(out.sum()), 2))
        w[out] = 0
    if kind == "zero_weights":
        w[:] = 0
    if kind == "two_weighted":
        w[:] = 0
        w[:, :2] = 1
    rv0, tv0 = rv + rng.normal(0, 0.02, rv.shape), tv + rng.normal(0, 0.02, tv.shape)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in (rv0, tv0, obj, img, w))


# The kernel and the plain version take the sums of J^T J, J^T r and r^T r
# and the 6x6 LU in other orders (a shuffle tree against cuBLAS's bmm and
# the batched LU behind solve_ex), so their iterates differ in last bits
# after the first step and by what those bits move the accepted steps
# after: near the minimum the objective's change is itself at rounding
# level. 1e-4 rad and m is the JAX comparison's bound
# (tests/test_torch_pnp.py); a pixel at 517 px a radian moves 0.05 px.
# Four points (eight residuals for six parameters) leave a shallow valley
# along which last bits move the iterate further: 1e-3 there. (On an H100
# 30 problems of 512 points read 6.4e-6 apart after 10 iterations.)
LM_ATOL = 1e-4
LM_ATOL_FOUR_POINTS = 1e-3


def lm_on_card(args, dev, iters, single=False):
    """(kernel's (rvec, tvec), plain version's), both computed on the card,
    and the kernel's launches."""
    xs = [a.to(dev) for a in args]
    if single:
        xs = [a[0] for a in xs]
    before = kernels.launch_counts()["refine_lm"]
    got = tlm.refine_lm(*xs, *LM_CAM, iters=iters)
    launched = kernels.launch_counts()["refine_lm"] - before
    want = tlm.refine_lm_plain(*xs, *LM_CAM, iters=iters)
    torch.cuda.synchronize()
    return got, want, launched


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 4, 10])
@pytest.mark.parametrize("N", [4, 100, 512, 2048])
@pytest.mark.parametrize("G", [1, 30, 4 * 8])
def test_refine_lm_kernel_matches_plain_version(cuda_device, G, N, iters):
    """G = 1 is the per-frame solve, 30 a verifier round's candidates, 4 x 8
    the plane path's B x P; N = 2048 reads its points past the first
    1,024 from L2 on every pass. One launch a call with iters > 0, none
    at iters = 0 (the start comes back unchanged)."""
    args = lm_problem(G, N, seed=G * 1000 + N + iters)
    got, want, launched = lm_on_card(args, cuda_device, iters)
    assert launched == (1 if iters else 0)
    atol = LM_ATOL_FOUR_POINTS if N == 4 else LM_ATOL
    for a, b, start in zip(got, want, args[:2]):
        assert a.shape == b.shape == (G, 3) and a.device.type == "cuda"
        if iters == 0:
            assert torch.equal(a.cpu(), start) and torch.equal(b.cpu(), start)
        torch.testing.assert_close(a, b, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [4, 10])
@pytest.mark.parametrize("kind", ["zero_weights", "behind", "two_weighted"])
def test_refine_lm_kernel_on_degenerate_problems(cuda_device, kind, iters):
    """Every weight 0: J and r vanish, the damped system is diagonal, and
    no step is accepted, so both return the start to the bit. Every point
    behind the camera, or two weighted points (four residuals for six
    parameters: two directions are the damping's alone): held as the
    well-posed cases, with every value finite in both."""
    args = lm_problem(30, 100, seed=77, kind=kind)
    got, want, launched = lm_on_card(args, cuda_device, iters)
    assert launched == 1
    for a, b, start in zip(got, want, args[:2]):
        assert torch.isfinite(a).all() and torch.isfinite(b).all()
        if kind == "zero_weights":
            assert torch.equal(a.cpu(), start) and torch.equal(b.cpu(), start)
        torch.testing.assert_close(a, b, rtol=0, atol=LM_ATOL)


@pytest.mark.cuda
def test_refine_lm_one_problem_is_a_batch_of_one(cuda_device):
    """The unbatched form ((N,3) and so on) launches the same kernel on
    G = 1: the same bits as the batch of one."""
    args = lm_problem(1, 512, seed=5)
    one, _, launched = lm_on_card(args, cuda_device, 10, single=True)
    batch, _, _ = lm_on_card(args, cuda_device, 10)
    assert launched == 1 and one[0].shape == (3,)
    for a, b in zip(one, batch):
        assert torch.equal(a, b[0])


@pytest.mark.cuda
def test_refine_lm_back_to_back_launches_are_independent(cuda_device):
    """200 launches on alternating problems (G = 1 and G = 30) with no
    synchronise between them: each equals its problem's result alone, to
    the bit (the kernel's sums take a fixed order)."""
    probs = [[a.to(cuda_device) for a in lm_problem(G, 512, seed=G)] for G in (1, 30)]
    alone = []
    for p in probs:
        alone.append(tlm.refine_lm(*p, *LM_CAM, iters=10))
        torch.cuda.synchronize()
    outs = [tlm.refine_lm(*probs[i % 2], *LM_CAM, iters=10) for i in range(200)]
    torch.cuda.synchronize()
    bad = [i for i, (rv, tv) in enumerate(outs)
           if not (torch.equal(rv, alone[i % 2][0]) and torch.equal(tv, alone[i % 2][1]))]
    assert bad == []


@pytest.mark.cuda
def test_refine_lm_launches_on_the_current_stream(cuda_device):
    """On a side stream, and inside a CUDA graph's capture (whose stream is
    the current one), the kernel runs on that stream: the same bits as on
    the default stream. A launch on any other stream during the capture
    would end it with an error, and a stream handle cut to 32 bits would
    not launch at all."""
    probs = [a.to(cuda_device) for a in lm_problem(30, 512, seed=11)]
    want = tlm.refine_lm(*probs, *LM_CAM, iters=10)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    before = kernels.launch_counts()["refine_lm"]
    with torch.cuda.stream(side):
        on_side = tlm.refine_lm(*probs, *LM_CAM, iters=10)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = tlm.refine_lm(*probs, *LM_CAM, iters=10)
    assert kernels.launch_counts()["refine_lm"] == before + 2
    graph.replay()
    torch.cuda.synchronize()
    for got in (on_side, captured):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_refine_lm_takes_a_view_as_its_contiguous_copy(cuda_device):
    """The batched verifier hands one frame's points expanded against
    many (batch stride 0): the same bits as the packed copy, one launch."""
    rv, tv, obj, img, w = (a.to(cuda_device) for a in lm_problem(1, 512, seed=3))
    G = 30
    views = [a.expand((G,) + a.shape[1:]) for a in (rv, tv, obj, img, w)]
    assert not views[2].is_contiguous()
    before = kernels.launch_counts()["refine_lm"]
    got = tlm.refine_lm(*views, *LM_CAM)
    assert kernels.launch_counts()["refine_lm"] == before + 1
    want = tlm.refine_lm(*(a.contiguous() for a in views), *LM_CAM)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b) and torch.equal(a, a[:1].expand_as(a))
