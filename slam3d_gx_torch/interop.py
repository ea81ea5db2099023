"""Hand state and random draws across from the JAX package, as numpy arrays.

SLAM has no weights: what carries across is the keyframe features
(`FrameFeatures`) and the random draws of the RANSAC stages. This module
turns numpy arrays into the port's tensors and back; it imports nothing
of the JAX package, so a caller converts JAX arrays with `np.asarray`
first.

Draws: the JAX plane RANSAC picks each round's triplets with
`jax.random.categorical`, i.e. the argmax of Gumbel noise over the
remaining points; `plane_sampler` replays it from that noise. The JAX
PnP RANSAC draws `jax.random.uniform(key, (B,3))` per solve;
`pnp_uniforms` stacks those blocks in the order the port's multiPnP
consumes them.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .frontend.state import FrameFeatures
from .ops.plane_ransac import GumbelSampler

_FIELDS = FrameFeatures._fields
_BOOL_FIELDS = ("plane_valid", "kp_valid")


def features_from_numpy(arrays, device) -> FrameFeatures:
    """FrameFeatures fields as numpy arrays (a mapping by field name, or
    a sequence in field order such as a JAX FrameFeatures after
    np.asarray of each field) -> the port's FrameFeatures on `device`."""
    if not isinstance(arrays, Mapping):
        arrays = dict(zip(_FIELDS, arrays))
    out = {}
    for name in _FIELDS:
        dtype = torch.bool if name in _BOOL_FIELDS else torch.float32
        out[name] = torch.as_tensor(np.array(arrays[name]), device=device).to(dtype)
    return FrameFeatures(**out)


def features_to_numpy(feats: FrameFeatures) -> dict:
    """The port's FrameFeatures -> {field: numpy array} on the host."""
    return {name: getattr(feats, name).cpu().numpy() for name in _FIELDS}


def plane_sampler(gumbel: np.ndarray, device) -> GumbelSampler:
    """(P,B,3,N) float32 Gumbel noise of the reference's per-round keys
    (`jax.random.gumbel(keys[p], (B,3,N))` with `keys =
    jax.random.split(key, P)`) -> a sampler that draws the reference's
    exact triplet indices."""
    return GumbelSampler(torch.as_tensor(np.array(gumbel, np.float32), device=device))


def pnp_uniforms(blocks: Sequence[np.ndarray], device) -> torch.Tensor:
    """Per-solve (B,3) uniforms (`jax.random.uniform(k, (B,3))` for each
    split key k, in the reference's order) -> one (S,B,3) tensor."""
    return torch.as_tensor(np.stack([np.asarray(b, np.float32) for b in blocks]),
                           device=device)
