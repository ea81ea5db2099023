"""K1 and K2 on the card against their plain versions, exactly.

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
