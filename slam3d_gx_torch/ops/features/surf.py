"""SURF fast-Hessian keypoint detector
(counterpart of slam3d_gx_tpu/ops/features/surf.py).

cv::SURF detection as the reference experiments sweep it: the integral
image, box-filter approximations of the Gaussian second derivatives
(Dxx, Dyy, Dxy) at the filter sizes 9, 15, 21, 27, the approximate
det(H) = Dxx*Dyy - (0.9*Dxy)^2, non-max suppression over (x, y, scale),
and a top-k with a size per keypoint.

The integral image is an f32 double cumsum, as in the JAX package. Its
sums of a uint8 image are exact while H*W*255 < 2^24 (about 65,000
pixels); above that both packages round them, each in its own summation
order, so responses that nearly tie may order differently.
"""

from __future__ import annotations

import functools

import torch

from .common import Keypoints, _edge_pad, nms, top_k

# filter sizes of the first octave ladder
_SIZES = (9, 15, 21, 27)
# their keypoint diameters 6s, s = 1.2 * filter size / 9, rounded to f32
_KP_SIZES = tuple((torch.tensor(_SIZES, dtype=torch.float32) * (1.2 / 9.0) * 6.0).tolist())


def _integral(img: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(torch.cumsum(img.to(torch.float32), dim=0), dim=1)


def _pad_integral(ii: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-pad the integral image so every window read stays in bounds."""
    return _edge_pad(ii, pad + 1, pad, pad + 1, pad)


def _box(iip: torch.Tensor, y0: int, x0: int, y1: int, x1: int, pad: int, H: int, W: int):
    """Sum of img[y0:y1, x0:x1] around each pixel (offsets relative to the
    pixel, end exclusive) from four shifted slices of the padded integral
    image."""
    o = pad + 1

    def at(dy, dx):
        return iip[o + dy - 1:o + dy - 1 + H, o + dx - 1:o + dx - 1 + W]

    return at(y1, x1) - at(y0, x1) - at(y1, x0) + at(y0, x0)


def _hessian_response(iip: torch.Tensor, size: int, pad: int, H: int, W: int):
    """det(H_approx) for one box-filter size (SURF Fig. 2 layouts)."""
    lobe = size // 3       # 3, 5, 7, 9
    h = size // 2          # the full 3-lobe span is -h..h
    hl = lobe // 2         # the middle lobe is the centered `lobe` rows
    w = lobe - 1           # 2*lobe-1 columns span -w..w

    def b(y0, x0, y1, x1):
        return _box(iip, y0, x0, y1, x1, pad, H, W)

    # Dyy: three stacked lobes, weights 1, -2, 1 = full(1) - 3*middle
    dyy = b(-h, -w, h + 1, w + 1) - 3.0 * b(-hl, -w, hl + 1, w + 1)
    dxx = b(-w, -h, w + 1, h + 1) - 3.0 * b(-w, -hl, w + 1, hl + 1)
    # Dxy: four lobe x lobe squares in the quadrants
    dxy = (b(-lobe, -lobe, 0, 0) + b(1, 1, lobe + 1, lobe + 1)
           - b(-lobe, 1, 0, lobe + 1) - b(1, -lobe, lobe + 1, 0))
    inv_area = 1.0 / (size * size)
    dxx = dxx * inv_area
    dyy = dyy * inv_area
    dxy = 0.9 * (dxy * inv_area)
    return dxx * dyy - dxy * dxy


@functools.lru_cache(maxsize=None)
def _size_table(sizes: tuple, device: torch.device) -> torch.Tensor:
    """`sizes` as an f32 tensor on `device`, copied there once: a copy
    from the host waits for the stream."""
    return torch.tensor(sizes, dtype=torch.float32, device=device)


def scale_space_topk(resp: torch.Tensor, border: int, max_kp: int, threshold: float,
                     sizes: tuple, reject=None) -> Keypoints:
    """(S,H,W) responses -> the top max_kp maxima over (x, y, scale) inside
    `border`, each with the size of its scale (SURF's and STAR's
    selection). `sizes`: the (S,) keypoint diameters; `reject`: an
    optional (H,W) mask of pixels whose maxima are dropped."""
    S, H, W = resp.shape
    ninf = torch.full((1, H, W), -torch.inf, dtype=resp.dtype, device=resp.device)
    up = torch.cat([resp[1:], ninf])
    down = torch.cat([ninf, resp[:-1]])
    keep = (nms(resp) > -torch.inf) & (resp >= up) & (resp >= down)
    r = torch.where(keep, resp, -torch.inf)
    if reject is not None:
        r = torch.where(reject, -torch.inf, r)
    inside = torch.zeros((H, W), dtype=torch.bool, device=resp.device)
    inside[border:H - border, border:W - border] = True
    r = torch.where(inside, r, -torch.inf)

    vals, idx = top_k(r.reshape(-1), max_kp)
    s_idx = idx // (H * W)
    v = ((idx % (H * W)) // W).to(torch.float32)
    u = (idx % W).to(torch.float32)
    size = _size_table(sizes, resp.device)[s_idx]
    valid = vals > threshold
    return Keypoints(
        uv=torch.stack([u, v], dim=-1),
        response=torch.where(valid, vals, 0.0),
        size=torch.where(valid, size, 7.0),
        angle=torch.zeros((max_kp,), dtype=torch.float32, device=resp.device),
        valid=valid,
    )


def detect_surf(img: torch.Tensor, max_kp: int = 512, threshold: float = 10.0) -> Keypoints:
    """img (H,W) uint8/float -> fixed-capacity Keypoints with sizes. A
    keypoint's size is 6s, s = 1.2 * filter size / 9 (surf_desc reads it
    back as its unit scale)."""
    H, W = img.shape
    pad = _SIZES[-1]
    iip = _pad_integral(_integral(img), pad)
    resp = torch.stack([_hessian_response(iip, s, pad, H, W) for s in _SIZES])
    return scale_space_topk(resp, pad // 2 + 1, max_kp, threshold, _KP_SIZES)
