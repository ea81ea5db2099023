"""slam3d_gx_torch — the RGB-D plane SLAM of slam3d_gx_tpu on PyTorch and CUDA.

A port of the JAX package for NVIDIA H100 cards. Module paths mirror
`slam3d_gx_tpu/` so each function has an obvious counterpart; the JAX
package stays the reference that the tests hold this one to.

- plain tensor code is PyTorch, fp32 throughout, TF32 off (the reference
  runs its matmuls at HIGH/HIGHEST precision);
- the TPU's Pallas kernels become CUDA kernels written by hand for
  Hopper (`kernels/`, sources in `csrc/`), each beside a plain PyTorch
  version that runs only for tensors on the CPU;
- entry points run on `cuda` unless the caller passes `device="cpu"`
  (`device.resolve_device`);
- several cards run as one process a card in a `torch.distributed`
  group (`torchrun`), laid out as the JAX package's (dp, sp) mesh
  (`parallel/mesh.py`, config key `mesh_devices`).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
