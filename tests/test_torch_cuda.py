"""K1, K2 (exactly) and K3 (to a last bit) on the card against their plain versions.

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
from slam3d_gx_torch.ops import imageproc as timg


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
