"""`refine_lm`: the Levenberg-Marquardt polish of the PnP solve as one CUDA kernel.

It replaces no TPU kernel: the JAX package's `refine_pnp`
(slam3d_gx_tpu/ops/pnp.py) is a jitted loop that XLA fuses, while
PyTorch runs it eagerly as ~6,400 small operations a call at 10
iterations, ~2,900 of them device launches (`vmap(jacfwd)` through
Rodrigues' formula, a batched J^T J, `solve_ex`, a second residual
pass). Every multiPnP runs one polish, so their issuing was most of the
frontend's host time. The kernel runs all
the iterations in one launch, one thread block per problem. Source,
bound and design notes: csrc/refine_lm.cu.

The wrapper takes the plain PyTorch version for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises; it never
falls back. It refuses other than float32 and a batch rank above 1 on
either device, and on the card copies a non-contiguous input first.
`iters = 0` returns the start and launches nothing.
`LAUNCHES` counts kernel launches, and nothing else adds to it.

Tolerance: the kernel computes the plain version's residuals and
forward derivatives operation for operation in float32 with each
product, sum, division and root rounded on its own, but it takes the
sums of J^T J, J^T r and r^T r and the 6x6 LU in another order than
cuBLAS's batched product and the LU behind `solve_ex`. The two start
apart in last bits and drift further as the iterations accept
different trial points near the minimum, where the objective's change
is itself at rounding level; tests/test_torch_cuda.py states each bound.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import lie
from . import build

SOURCE = "refine_lm"
LAUNCHES = {"refine_lm": 0}

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {"slam_refine_lm": [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CF, _CF, _CF,
                                _CF, _VP]}
_entries = {}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _entry(name: str):
    if not _entries:
        _entries.update(build.bind(SOURCE, _ARGTYPES))
    return _entries[name]


def _residuals(x, obj, img, weights, fx, fy, cx, cy):
    """One problem: x (6,) -> (2N,) weighted reprojection residuals."""
    R = lie.rodrigues(x[:3])
    pc = obj @ R.T + x[3:]
    z = pc[:, 2]
    safe_z = torch.where(torch.abs(z) > 1e-9, z, 1e-9)
    uv = torch.stack([pc[:, 0] * fx / safe_z + cx, pc[:, 1] * fy / safe_z + cy], -1)
    r = (uv - img) * torch.sqrt(weights)[:, None]
    return torch.where(torch.isfinite(r), r, 0.0).reshape(-1)


def refine_lm_plain(rvec, tvec, obj, img, weights, fx, fy, cx, cy, iters: int = 10):
    """Levenberg-damped Gauss-Newton on the reprojection objective.

    weights: (...,N) float (0 masks a correspondence out). Leading batch
    dims (at most one) solve independent problems together.
    """
    single = obj.dim() == 2
    if single:
        rvec, tvec, obj, img, weights = (a[None] for a in (rvec, tvec, obj, img, weights))

    def res(x, o, im, w):
        return _residuals(x, o, im, w, fx, fy, cx, cy)

    res_b = torch.func.vmap(res)
    jac_b = torch.func.vmap(torch.func.jacfwd(res))

    x = torch.cat([rvec, tvec], dim=-1)
    G = x.shape[0]
    lam = torch.full((G,), 1e-3, dtype=x.dtype, device=x.device)
    e = torch.sum(res_b(x, obj, img, weights) ** 2, dim=-1)
    eye = torch.eye(6, dtype=x.dtype, device=x.device)
    for _ in range(iters):
        r = res_b(x, obj, img, weights)
        J = jac_b(x, obj, img, weights)  # (G,2N,6)
        Jt = J.transpose(-1, -2)
        H = Jt @ J
        g = (Jt @ r[..., None])[..., 0]
        H = H + lam[:, None, None] * (torch.diagonal(H, dim1=-2, dim2=-1) + 1e-9)[:, None, :] * eye
        dx = torch.linalg.solve_ex(H, -g)[0]
        x_new = x + dx
        e_new = torch.sum(res_b(x_new, obj, img, weights) ** 2, dim=-1)
        better = e_new < e
        x = torch.where(better[:, None], x_new, x)
        e = torch.where(better, e_new, e)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    rv, tv = x[..., :3], x[..., 3:]
    return (rv[0], tv[0]) if single else (rv, tv)


def _check(rvec, tvec, obj, img, weights) -> None:
    """Refuse what neither version takes: other than float32, a batch rank
    above 1, shapes that disagree, tensors on two devices or on one
    without a kernel."""
    named = {"rvec": rvec, "tvec": tvec, "obj": obj, "img": img, "weights": weights}
    for name, a in named.items():
        if a.dtype != torch.float32:
            raise TypeError(f"refine_lm: {name} is {a.dtype}; the polish takes float32")
    if obj.dim() not in (2, 3) or obj.shape[-1] != 3:
        raise ValueError(f"refine_lm: obj must be (N,3) or (G,N,3), got {tuple(obj.shape)}")
    lead, N = tuple(obj.shape[:-2]), obj.shape[-2]
    want = {"rvec": lead + (3,), "tvec": lead + (3,), "img": lead + (N, 2),
            "weights": lead + (N,)}
    for name, shape in want.items():
        if tuple(named[name].shape) != shape:
            raise ValueError(f"refine_lm: {name} must be {shape} beside obj "
                             f"{tuple(obj.shape)}, got {tuple(named[name].shape)}")
    devices = {a.device for a in named.values()}
    if len(devices) != 1:
        raise RuntimeError(f"refine_lm: inputs on several devices {sorted(map(str, devices))}")
    if obj.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"refine_lm: unsupported device {obj.device}")


def refine_lm(rvec, tvec, obj, img, weights, fx, fy, cx, cy, iters: int = 10):
    """`refine_lm_plain`'s contract: (rvec, tvec) polished by `iters`
    damped Gauss-Newton steps, for one problem ((3,), (3,), (N,3),
    (N,2), (N,)) or a batch of G (a leading axis on each). float32."""
    _check(rvec, tvec, obj, img, weights)
    if obj.device.type == "cpu":
        return refine_lm_plain(rvec, tvec, obj, img, weights, fx, fy, cx, cy, iters)
    # the kernel reads each problem's rows packed; a view (the verifier's
    # one frame expanded against many) is copied first
    rvec, tvec, obj, img, weights = (a.contiguous() for a in (rvec, tvec, obj, img, weights))
    single = obj.dim() == 2
    G, N = (1 if single else obj.shape[0]), obj.shape[-2]
    if iters <= 0 or G == 0:
        x = torch.cat([rvec, tvec], dim=-1)
    else:
        x = torch.empty(obj.shape[:-2] + (6,), dtype=torch.float32, device=obj.device)
        build.launch(_entry("slam_refine_lm"), "refine_lm", obj.device, rvec.data_ptr(),
                     tvec.data_ptr(), obj.data_ptr(), img.data_ptr(), weights.data_ptr(),
                     x.data_ptr(), G, N, int(iters), float(fx), float(fy), float(cx),
                     float(cy))
        LAUNCHES["refine_lm"] += 1
    return x[..., :3], x[..., 3:]
