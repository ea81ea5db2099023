"""Hand state and random draws across from the JAX package, as numpy arrays.

SLAM has no weights: what carries across is the keyframe features
(`FrameFeatures`) and the random draws of the RANSAC stages. This module
turns numpy arrays into the port's tensors and back; it imports nothing
of the JAX package, so a caller converts JAX arrays with `np.asarray`
first.

Draws: the JAX plane RANSAC picks each round's triplets with
`jax.random.categorical`, i.e. the argmax of Gumbel noise over the
remaining points; `plane_sampler` replays it from that noise. The JAX
PnP RANSAC draws `jax.random.uniform(key, (H,3))` per solve;
`pnp_uniforms` stacks those blocks in the order the port's multiPnP
consumes them: for a plane pair the blocks of `jax.random.split(key,
P+2)`, for an image pair the one block of the key itself (no split).
A batched round gives pair i the key `jax.random.split(key, B)[i]`
(the frontends split `key` once more per chunk of 32 first);
`pnp_uniforms_batch` stacks the pairs' draws into the batch the port's
batched multiPnP takes.

A streamed chunk (frontend/streaming.py) draws per frame from the key
`keys[j]` of `jax.random.split(chunk_key, chunk)`, split again as
`k_ext, k_pnp, k_r, k_rr = jax.random.split(keys[j], 4)`: the
extraction's Gumbel noise from `k_ext` (plane frontend only) and the
uniforms of the main, rescue and keyframe->last registrations from
`k_pnp`, `k_r` and `k_rr`, each as for one pair above. `chunk_draws`
turns them into the port tracker's draws for the whole chunk.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .frontend.state import FrameFeatures
from .frontend.streaming import ChunkDraws
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


def stacked_features_from_numpy(frames: Sequence, device) -> FrameFeatures:
    """A sequence of frames, each as `features_from_numpy` takes it (a
    plane frame, or an image frame with its one pseudo-plane) -> one
    FrameFeatures with a leading batch axis, as the batched multiPnP
    takes it."""
    each = [features_from_numpy(f, device) for f in frames]
    return FrameFeatures(*(torch.stack(field) for field in zip(*each)))


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


def pnp_uniforms_batch(pairs: Sequence, device) -> torch.Tensor:
    """The draws of a batched round, one entry a pair: for a plane pair
    its P+2 (H,3) blocks -> (B,P+2,H,3); for an image pair its one (H,3)
    block -> (B,H,3)."""
    return torch.as_tensor(np.stack([np.asarray(p, np.float32) for p in pairs]),
                           device=device)


def chunk_draws(frames: Sequence[Mapping], device) -> ChunkDraws:
    """Per frame of a chunk, a mapping with the uniforms of its three
    registrations, "pnp", "rescue" and "keyframe_last" (each (H,3) for
    an image pair or (P+2,H,3) for a plane pair, as `pnp_uniforms`
    stacks them), and on the plane path its extraction's "gumbel" noise
    ((P,B,3,N), as `plane_sampler` takes it) -> the tracker's draws."""
    u = np.stack([np.stack([np.asarray(f[k], np.float32)
                            for k in ("pnp", "rescue", "keyframe_last")]) for f in frames])
    samplers = ([plane_sampler(f["gumbel"], device) for f in frames]
                if "gumbel" in frames[0] else None)
    return ChunkDraws(samplers, torch.as_tensor(u, device=device))
