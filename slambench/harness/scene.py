"""The benchmark's traffic generator: a textured room rendered on the card.

A frozen PyTorch copy of `slam3d_gx_torch/testing/synthetic.py` (commit
329caf3: `RoomScene`, `render_frame`, `multi_loop_trajectory`, the
write_dataset sensor noise), rewritten so that a run renders its frames
on the device instead of on the host. The geometry (three
walls and a floor of a room corner, the textures' tile sizes, the
trajectory) is the original's; the textures and the noise come from a
`torch.Generator` on the device, so the same seeds give the same frames on
any H100. A run draws both seeds from its `--seed` (harness/bench.py), so
every seed renders another room and another sensor noise over the same
trajectory.

Everything here is the yardstick: it imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

TEXTURE = 128  # texture tile side, texels
OCTAVES = 4


def _texture(gen: torch.Generator, device) -> torch.Tensor:
    """Value-noise texture in [30, 230] (the original's _make_texture):
    OCTAVES bilinearly upsampled uniform grids, each half the weight of
    the one before, then rescaled."""
    size = TEXTURE
    tex = torch.zeros((size, size), dtype=torch.float64, device=device)
    yy, xx = torch.meshgrid(torch.arange(size, device=device, dtype=torch.float64),
                            torch.arange(size, device=device, dtype=torch.float64),
                            indexing="ij")
    for o in range(OCTAVES):
        step = size // (4 * 2**o)
        if step < 1:
            break
        n = size // step + 2
        coarse = torch.rand((n, n), generator=gen, device=device, dtype=torch.float64)
        y, x = yy / step, xx / step
        y0, x0 = y.long(), x.long()
        fy, fx = y - y0, x - x0
        v = (coarse[y0, x0] * (1 - fy) * (1 - fx) + coarse[y0 + 1, x0] * fy * (1 - fx)
             + coarse[y0, x0 + 1] * (1 - fy) * fx + coarse[y0 + 1, x0 + 1] * fy * fx)
        tex = tex + v / 2**o
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    return 30 + 200 * tex


class Room:
    """Three textured walls of a room corner and a floor (RoomScene):
    per plane its normal n and offset d (n.x + d = 0), an in-plane origin
    and axes, half-extents, a texture and the world size of one tile."""

    def __init__(self, gen: torch.Generator, device):
        ex, ey, ez = np.eye(3)
        rows = [  # normal, d, origin, axis_u, axis_v, extent, tile
            (-ez, 3.2, (0, 0, 3.2), ex, ey, (3.0, 2.2), 1.3),   # back wall
            (ex, 2.0, (-2.0, 0, 1.5), ez, ey, (2.0, 2.2), 1.1),  # left wall
            (-ex, 2.0, (2.0, 0, 1.5), ez, ey, (2.0, 2.2), 1.2),  # right wall
            (-ey, 1.4, (0, 1.4, 1.5), ex, ez, (3.0, 2.0), 0.9),  # floor
        ]
        self.device = device
        self.planes = []
        for normal, d, origin, au, av, extent, tile in rows:
            def t(a):
                return torch.tensor(np.asarray(a, np.float64), device=device)
            self.planes.append(dict(normal=t(normal), d=d, origin=t(origin), au=t(au), av=t(av),
                                    extent=extent, tile=tile, tex=_texture(gen, device)))

    @staticmethod
    def _sample(p, pts: torch.Tensor) -> torch.Tensor:
        """Bilinear, wrapped texture lookup at world points (N,3)."""
        rel = pts - p["origin"]
        T = TEXTURE
        ui = torch.remainder(rel @ p["au"] / p["tile"] * T, T)
        vi = torch.remainder(rel @ p["av"] / p["tile"] * T, T)
        u0 = ui.long() % T
        v0 = vi.long() % T
        fu = ui - torch.floor(ui)
        fv = vi - torch.floor(vi)
        t = p["tex"]
        u1, v1 = (u0 + 1) % T, (v0 + 1) % T
        return (t[v0, u0] * (1 - fu) * (1 - fv) + t[v0, u1] * fu * (1 - fv)
                + t[v1, u0] * (1 - fu) * fv + t[v1, u1] * fu * fv)

    def render(self, T_wc: np.ndarray, cam: dict):
        """(gray uint8, depth uint16) tensors on the device for the
        camera-to-world pose T_wc: a ray per pixel, the nearest plane hit
        within its extent, depth = z in the camera (raw units, factor)."""
        dev = self.device
        H, W = cam["height"], cam["width"]
        v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float64),
                              torch.arange(W, device=dev, dtype=torch.float64), indexing="ij")
        d_cam = torch.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                             torch.ones_like(u)], -1)
        R = torch.tensor(T_wc[:3, :3], device=dev)
        C = torch.tensor(T_wc[:3, 3], device=dev)
        d_w = d_cam @ R.T
        best = torch.full((H, W), math.inf, dtype=torch.float64, device=dev)
        gray = torch.zeros((H, W), dtype=torch.float64, device=dev)
        for p in self.planes:
            denom = d_w @ p["normal"]
            ok_d = denom.abs() > 1e-9
            t = -(C @ p["normal"] + p["d"]) / torch.where(ok_d, denom, 1e-9)
            pts = C + t[..., None] * d_w
            rel = pts - p["origin"]
            hit = (ok_d & (t > 0.05) & ((rel @ p["au"]).abs() <= p["extent"][0])
                   & ((rel @ p["av"]).abs() <= p["extent"][1]) & (t < best))
            gray = torch.where(hit, self._sample(p, pts.reshape(-1, 3)).reshape(H, W), gray)
            best = torch.where(hit, t, best)
        depth_m = torch.where(torch.isfinite(best), best, 0.0)
        depth = torch.clamp(torch.round(depth_m * cam["factor"]), 0, 65535).to(torch.int32)
        return torch.clamp(torch.round(gray), 0, 255), depth


def multi_loop_trajectory(n: int, laps: int, radius: float, yaw_amp: float,
                          drift: float) -> List[np.ndarray]:
    """Camera-to-world poses of `laps` passes around the room with a
    drifting centre and a breathing radius, so later laps revisit the
    first one's viewpoints near but not exactly (the original's
    multi_loop_trajectory)."""
    out = []
    for i in range(n):
        s = i / n
        a = 2 * math.pi * laps * s
        r = radius * (1.0 + 0.1 * math.sin(2 * math.pi * s))
        t = np.array([r * math.sin(a),
                      0.05 * math.sin(2 * a) + drift * math.sin(2 * math.pi * s),
                      0.15 * (1 - math.cos(a)) + drift * s])
        yaw = yaw_amp * math.sin(a)
        c, s_ = math.cos(yaw), math.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = [[c, 0, s_], [0, 1, 0], [-s_, 0, c]]  # about +y
        T[:3, 3] = t
        out.append(T)
    return out


def render_sequence(scene_seed: int, noise_seed: int, poses: Sequence[np.ndarray], cam: dict,
                    noise_sigma: float, device) -> tuple:
    """Every frame of the sequence, rendered on `device`: (gray (N,H,W)
    uint8, depth (N,H,W) uint16-valued int32). The room's textures draw
    from a generator seeded with `scene_seed`, the gray noise N(0,
    noise_sigma) of every frame from one seeded with `noise_seed`."""
    tex_gen = torch.Generator(device=device)
    tex_gen.manual_seed(int(scene_seed))
    noise_gen = torch.Generator(device=device)
    noise_gen.manual_seed(int(noise_seed))
    room = Room(tex_gen, device)
    grays, depths = [], []
    for T_wc in poses:
        g, d = room.render(T_wc, cam)
        if noise_sigma > 0:
            g = g + noise_sigma * torch.randn(g.shape, generator=noise_gen, device=device,
                                              dtype=torch.float64)
        grays.append(torch.clamp(torch.round(g), 0, 255).to(torch.uint8))
        depths.append(d)
    return torch.stack(grays), torch.stack(depths)
