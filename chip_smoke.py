#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slam3d_gx_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the main path from slam3d_gx_torch/csrc
   (one nvcc per source, all started together) and print ptxas' report;
3. hold each kernel against its plain PyTorch version on the card: K1
   and K2 exactly (480x640, a constant image, an image with empty bins,
   ragged 37x53 and 1x1); the fused `equalize_hist256` exactly, against
   its plain version on the card and on the CPU (those cases and: one
   non-zero pixel, two values one of them on a single pixel, an image
   whose LUT products land on .5 ties, a skewed frame, a non-contiguous
   and a 16-byte-misaligned view, float32 input, 1080x1920 for the loop
   form, and 1,000 back-to-back calls on alternating images without a
   synchronise between them); K3's branch-free division and root
   against the IEEE intrinsics on all 2^32 floats, then K3 bit for bit
   against its first design (the tiled kernel, entry slam_min_eig_tile)
   and within 1e-6 of the image's largest box sum against its plain
   version on the card and on the CPU (480x640 uint8 and f32, constant, 37x53, 1x7, 7x1, 2x640,
   480x2, 2x2, one row and one column either side of the tile's edges,
   1080x1920 and 2160x3840 for the grid-stride loop, a non-contiguous
   view, a row-cropped view read in place at its pitch, a 1-byte-
   misaligned base), every built variant bit for bit, and 1,000
   back-to-back calls on alternating images; `refine_lm` (the PnP
   polish, which replaces no TPU kernel) within 1e-4 of its plain
   version on the card at G = 1 and G = 30 problems of 512
   correspondences, one launch a call. Then time kernel, plain
   version and, where there is one, one PyTorch library call on the card
   (torch.profiler's device times, median of 200 calls after warm-up),
   one wrapper call on the stream with CUDA events and on the host;
   beside `equalize_hist256`, the two-kernel composition it replaced
   (K1, `equalize_lut`, K2) with its device operations; beside K3, the
   tiled kernel and its first wrapper's host path; beside each, an empty
   kernel launched in the same shape;
4. `equalize_hist` on the card against the plain CPU path, exactly;
5. the plane path: `run_SLAM 29` (slam3d_gx_torch.cli.run_slam.run) over a
   synthetic 30-frame 640x480 orbit with the repo's parameters.yaml
   defaults (SIFT/SIFT, 512 keypoints, 256 hypotheses, loop closure on
   and batched), with every kernel's launch count set to 0 just before
   it and read just after; checks the four output files, the keyframe
   count, ATE against the ground truth (< 0.05 m) and that
   `equalize_hist256` ran once per frame extraction, K1 and K2 not at all;
   the card's keyframes, lost frames, ATE and RPE beside the JAX
   package's on the same configuration (the record
   slam3d_gx_torch/testing/jax_reference_outcomes.json, which
   tests/test_torch_seed_protocol.py writes from jitted JAX runs on the
   CPU), failing where the card's ATE exceeds JAX's by more than the
   seed protocol's largest port-minus-JAX gap plus 0.01 m (phases 6, 9
   and 10 the same);
6. the image-only path: `run_SLAM_imageonly 29`
   (slam3d_gx_torch.cli.run_slam_imageonly) on the same orbit with
   GFTT/SIFT, counts reset and read the same way: the same checks, K3
   once per extraction, none of the equalize kernels, the batched
   verifier used;
7. a short plane run with GFTT: `equalize_hist256` and K3 once per
   extraction each;
8. the per-frame stages of both paths (extract, multiPnP) re-run on the
   last frame, and one batched round of N candidates against N single
   registrations: wall ms, device-busy ms and device operations;
9. the streamed image-only path: `run_SLAM_streaming 29 8 imageonly`
   (slam3d_gx_torch.cli.run_slam_streaming) on the same orbit with
   GFTT/SIFT, counts reset and read the same way: the output files,
   keyframes within one of phase 6's, ATE, K3 once per extraction (the
   padded frames of the last chunk included) and the equalize kernels
   never, and no synchronizing CUDA operation in any chunk dispatch
   that continues from the device's carry, i.e. all but the first and
   one after a lostRecovery replay (torch.cuda.set_sync_debug_mode);
   frames/s beside phase 6's;
10. the streamed plane path: `run_SLAM_streaming 29 8 planes` with
   SIFT/SIFT: the same checks against phase 5, `equalize_hist256` once
   per extraction; the synchronizing operations of each chunk dispatch
   and where they come from;
11. the parity modes: `run_SLAM 4` with GFTT/SIFT, `detect_scope: plane`,
   `plane_image_mode: splat` and `voxel_downsample_clouds: 1`:
   `equalize_hist256` and K3 `max_planes` times per extraction, ATE;
12. the zoo and the experiment CLIs: each detector/descriptor pair of
   ZOO through `detect_and_describe` on frame 1, on the card against the
   plain CPU path (keypoint-set overlap, descriptor rows on the CPU's
   keypoints), with its device ms, device operations and synchronized
   wall; `exp1_2 1 3 GFTT SIFT n` and `p` and `exp1_2 1 3 ORB ORB n`
   (slam3d_gx_torch.cli.exp1_2) over seeds 0-7: the error row,
   time.log's labels, K3 once per frame in `n`, `equalize_hist256` and
   K3 once per extraction in `p`, neither with ORB, the seeds that land
   under the ground-truth bounds (printed); and on every seed the
   registration on the card against the CPU with the same draws (made
   on the host): the matches (`n`) or plane features (`p`) equal, the
   inliers equal on at least 95% of its hypotheses registered one at a
   time, the whole registration's agreement printed; planarFeatures on
   frame 1 (a nonzero count of planar keypoints); `run_SLAM_imageonly 8`
   with ORB/ORB and with SURF/SURF, a keyframe a frame, on the card and
   on the CPU with the same draws: the output files, no kernel launched,
   ATE < 0.05 m on the card, keyframes, lost frames and ATE of both
   printed, with ORB frame 1's features equal, the descriptor width in
   the keyframe store, and the batched verifier with 256- and 64-wide
   descriptors on the first and last keyframes, inliers equal on at
   least 95% of 256 single hypotheses;
13. the post-tracking half: the CG pose-graph solver on the card on
   `make_loopy_graph(2048, seed=1)` and `(1024, seed=2, outlier_frac=0.1)`
   with 15 LM iterations, to tests/test_pose_graph_scale.py's bounds (ATE
   < 0.06 m and < ATE0/30; < 0.1 m and < ATE0/8), with wall, LM and CG
   iterations, host waits per LM step and their sources, and one LM step
   profiled (device-busy ms, device operations); the 600-vertex graph of
   tests/test_torch_posegraph_cg.py on the card against the CPU (the same
   LM iterations, poses within 1e-3 m and 1e-3 rad), and a second one
   (seed 3) printed beside the CPU's own move under a start nudged at
   fp32's rounding; `run_SLAM_imageonly 29` (GFTT) with `loop_closure_scored: 1`
   and `finalize_prefilter: 8` (ATE < 0.05 m, K3 once per extraction;
   keyframes, lost frames, scored rounds, loop edges, pairs pruned), one
   more scored round whose dispatch may not synchronize and whose
   candidates equal the host path's, and `run_SLAM_streaming 29 8
   imageonly` with scored loop closure to the same gate; `convert2pcd 1
   31` over the orbit's frames (frame 1 equal to the CPU's), and
   `generateTrajectory` and `saveOutput` over phase 6's keyframe.txt and
   final_after.g2o: the trajectory's ATE equal to the run's within 1e-6 m,
   the card's result.pcd against the CPU's (point counts within 0.1%,
   99.9% of the points matched within 1e-4 m and colors within 1);
14. the mesh on the card: a one-rank NCCL group (file:// rendezvous in
   the run's directory) and `make_mesh(1)`. `run_SLAM_imageonly 29` with
   phase 13's scored parameters and `mesh_devices: 1`, against phase
   13's unmeshed scored run: keyframes, lost frames and loop edges
   equal, ATE within 1e-6 m, K3 launches equal, and no synchronizing
   operation in one more scored round's dispatch; the 2,048-vertex CG
   solve through `optimize_sharded` against the unsharded one (poses
   within 1e-6 m), with the host waits and device operations of an LM
   step both ways; the native I/O library (native_io.py, g++) built and
   used by the runs' prefetch, the loaders' frames equal to the Python
   readers', and the decode ms a frame both ways.

Prints a `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {...}}`; each kernel's row also carries its
launches on phase 12's paths ("launches_zoo") and on phases 13 and 14's
("launches_post"). Without a CUDA device it exits 2 and prints no result.

    python3 chip_smoke.py --kernels   # phases 1-4 only
    python3 chip_smoke.py --zoo       # phases 1-4 and 12 only
    python3 chip_smoke.py --post      # phases 1-4, 6, 13 and 14 only
    python3 chip_smoke.py --sweep     # phases 1-2, then equalize_hist256 in
                                      # clusters of 8 and 16 blocks against K1 + K2,
                                      # and K3 in every built (columns, rows) a
                                      # thread against the tiled kernel, uint8 and
                                      # f32, from 480x640 to 2160x3840
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_SCALAR_OPS = 67e12      # H100 SXM fp32 outside the tensor cores
ATE_BOUND_M = 0.05           # tests/test_e2e.py's image-only bound
FRAMES = 30
H, W = 480, 640


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def device_ms(fn, calls: int = 200, warmup: int = 20):
    """Device time of one call of `fn`: every kernel, memset and copy it
    launches, each at its median duration over `calls` calls, as
    torch.profiler records them on the card. Host time between launches
    does not count. Returns (ms, method, device operations a call); when
    the profiler records no device activity, falls back to CUDA events
    around each call, which then include the host's launch gaps."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    durations = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if durations:
        us = sum(statistics.median(v) * len(v) / calls for v in durations.values())
        return us / 1e3, "profiler", sum(len(v) for v in durations.values()) / calls
    return event_ms(fn, calls), "events", None


def event_ms(fn, calls: int = 200, warmup: int = 20) -> float:
    """Median of CUDA-event times around each call: what one call costs
    the stream, launch gaps included."""
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def host_us(fn, calls: int = 200, warmup: int = 20) -> float:
    """Median host time of one call of `fn`, in us: what issuing it costs
    the Python thread, whatever the card does meanwhile."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_equalize_kernels(dev, kernels, equalize):
    """Exact agreement with the plain versions on awkward inputs."""
    rng = np.random.default_rng(0)
    cases = {
        "480x640": rng.integers(0, 256, (H, W)),
        "constant": np.full((H, W), 77),
        "empty_bins": rng.choice([0, 3, 128, 255], (H, W)),
        "37x53": rng.integers(0, 256, (37, 53)),
        "1x1": np.array([[200]]),
    }
    lut = torch.from_numpy(rng.integers(0, 256, 256).astype(np.float32))
    err = {"histogram256": 0, "apply_lut256": 0}
    for name, img in cases.items():
        x = torch.from_numpy(img.astype(np.uint8)).to(dev)
        h = kernels.histogram256(x)
        o = kernels.apply_lut256(x, lut.to(dev))
        # an odd offset takes the kernels' unaligned path
        xs = x.reshape(-1)[1:]
        hs = kernels.histogram256(xs)
        torch.cuda.synchronize()
        for got, want, k in (
                (h, equalize.histogram256_plain(x.cpu()), "histogram256"),
                (hs, equalize.histogram256_plain(xs.cpu()), "histogram256"),
                (o, equalize.apply_lut256_plain(x.cpu(), lut), "apply_lut256")):
            diff = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
            err[k] = max(err[k], diff)
            if diff != 0:
                raise AssertionError(f"{k} differs from its plain version on {name}: {diff}")
        print(f"  {name}: histogram256 and apply_lut256 exact", flush=True)
    return err


def equalize_cases():
    """uint8 images that exercise `equalize_hist256`'s corners."""
    rng = np.random.default_rng(7)
    one = np.zeros((H, W), np.uint8)
    one[H // 3, W // 5] = 9
    single_low = np.full((H, W), 200, np.uint8)
    single_low[0, 0] = 3  # total - h0 = n - 1, the first bin holds one pixel
    # total - h0 = 510, so scale = 0.5 and every odd cumulative count is a tie
    ties = np.concatenate([[0, 0, 1], np.repeat(np.arange(2, 256), 2), [255]])
    return {
        "480x640": rng.integers(0, 256, (H, W)),
        "constant": np.full((H, W), 77),
        "empty_bins": rng.choice([0, 3, 128, 255], (H, W)),
        "skewed": np.clip(rng.normal(60, 9, (H, W)), 0, 255),
        "37x53": rng.integers(0, 256, (37, 53)),
        "1x1": np.array([[200]]),
        "one non-zero pixel": one,
        "total - h0 == 1": np.where(one > 0, 200, 31),
        "one pixel in the first bin": single_low,
        ".5 ties": rng.permutation(ties).reshape(16, 32),
        "1080x1920 (loop form)": rng.integers(0, 256, (1080, 1920)),
    }


def check_equalize_hist256(dev, kernels, equalize):
    """The fused kernel against its plain version, exactly (tolerance 0:
    every value is an integer, and the LUT's two float32 operations are
    single IEEE operations on both sides). The truth is the plain version
    on the CPU; the plain version on the card is compared too."""
    def held(name, x_dev, x_cpu):
        got = kernels.equalize_hist256(x_dev)
        torch.cuda.synchronize()
        want = equalize.equalize_hist256_plain(x_cpu)
        on_card = equalize.equalize_hist256_plain(x_dev).cpu()
        assert got.shape == x_cpu.shape and got.dtype == torch.uint8, name
        diff = int((got.cpu().int() - want.int()).abs().max())
        diff_card = int((got.cpu().int() - on_card.int()).abs().max())
        print(f"  {name}: equalize_hist256 max abs err {diff} against the plain version "
              f"on the CPU, {diff_card} against it on the card", flush=True)
        if diff != 0 or diff_card != 0:
            raise AssertionError(f"equalize_hist256 differs from its plain version on {name}")

    cases = {k: torch.from_numpy(v.astype(np.uint8)) for k, v in equalize_cases().items()}
    for name, img in cases.items():
        held(name, img.to(dev), img)
    img = cases["480x640"]
    held("float32 input", img.to(dev).float(), img.float())
    wide = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (H, 2 * W)).astype(np.uint8))
    held("non-contiguous view", wide.to(dev)[:, ::2], wide[:, ::2])
    held("misaligned view", img.to(dev).reshape(-1)[1:], img.reshape(-1)[1:])

    # a barrier or a table that one launch leaves unclean shows in the next
    pair = [cases["480x640"].to(dev), cases["skewed"].to(dev)]
    want = [equalize.equalize_hist256_plain(cases[k]).to(dev) for k in ("480x640", "skewed")]
    outs = [kernels.equalize_hist256(pair[i % 2]) for i in range(1000)]
    torch.cuda.synchronize()
    bad = [i for i, o in enumerate(outs) if not torch.equal(o, want[i % 2])]
    print(f"  1,000 back-to-back calls on alternating images: {len(bad)} wrong", flush=True)
    if bad:
        raise AssertionError(f"equalize_hist256: back-to-back calls {bad[:10]} are wrong")
    return 0


def time_equalize_hist256(dev, kernels, equalize):
    """The fused kernel at the main path's shape (the 480x640 uint8 gray
    frame) beside its plain version, the two-kernel composition it
    replaced and an empty kernel launched in the same shape. No single
    PyTorch call computes equalizeHist."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
    n = x.numel()

    def old():
        return kernels.apply_lut256(x, equalize.equalize_lut(kernels.histogram256(x), n))

    # the image read once and written once; a count and a lookup a pixel
    b, by = bound(2 * n, 2 * n)
    ms, how, ops = device_ms(lambda: kernels.equalize_hist256(x))
    old_ms, _, old_ops = device_ms(old)
    empty_ms = device_ms(lambda: equalize.launch_empty(x.device))[0]
    r = dict(ms=ms, plain_ms=device_ms(lambda: equalize.equalize_hist256_plain(x))[0],
             library_ms=None, bound_ms=b, bound_by=by,
             stream_ms=event_ms(lambda: kernels.equalize_hist256(x)))
    print(f"  equalize_hist256 at {H}x{W} ({how}): kernel {r['ms'] * 1e3:.3f} us in {ops:g} "
          f"device operation(s), plain {r['plain_ms'] * 1e3:.3f} us, library none, bound "
          f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); one wrapper call on the stream "
          f"{r['stream_ms'] * 1e3:.3f} us, on the host "
          f"{host_us(lambda: kernels.equalize_hist256(x)):.3f} us", flush=True)
    print(f"  the composition it replaced (histogram256, equalize_lut, apply_lut256): "
          f"{old_ms * 1e3:.3f} us in {old_ops:g} device operations; one call on the stream "
          f"{event_ms(old) * 1e3:.3f} us, on the host {host_us(old):.3f} us", flush=True)
    other = {"a constant image": torch.full_like(x, 77),
             "a skewed frame": torch.from_numpy(
                 np.clip(rng.normal(60, 9, (H, W)), 0, 255).astype(np.uint8)).to(dev)}
    print("  equalize_hist256 on " + ", ".join(
        f"{k} {device_ms(lambda: kernels.equalize_hist256(v))[0] * 1e3:.3f} us"
        for k, v in other.items()) + " (its counting does not depend on the data)", flush=True)
    print(f"  an empty kernel in the same launch shape (one cluster of "
          f"{equalize.CLUSTER_BLOCKS} blocks of 1,024 threads): {empty_ms * 1e3:.3f} us",
          flush=True)
    return r


def sweep_equalize(dev, kernels, equalize):
    """Device time of `equalize_hist256` in clusters of 8 and of 16 blocks
    against K1 + K2 alone (their memset included, the LUT given), from
    the main path's frame up to 2160x3840: which cluster size, and from
    which image size on one cluster loses to two full-width launches."""
    rng = np.random.default_rng(11)
    lut = torch.from_numpy(np.sort(rng.integers(0, 256, 256)).astype(np.float32)).to(dev)
    for h, w in ((H, W), (720, 1280), (1080, 1920), (2160, 3840)):
        x = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8)).to(dev)
        flat = x.reshape(-1)
        want = equalize.equalize_hist256_plain(x.cpu()).reshape(-1)
        us = {}
        for blocks in (8, 16):
            assert torch.equal(equalize._launch_equalize256(flat, blocks).cpu(), want), blocks
            us[blocks] = device_ms(lambda: equalize._launch_equalize256(flat, blocks))[0] * 1e3
        k12 = device_ms(lambda: (kernels.histogram256(x), kernels.apply_lut256(x, lut)))[0] * 1e3
        b = bound(2 * x.numel(), 2 * x.numel())[0] * 1e3
        print(f"  {h}x{w}: equalize_hist256 {us[8]:.3f} us in a cluster of 8, {us[16]:.3f} us "
              f"in a cluster of 16; histogram256 + apply_lut256 {k12:.3f} us; bound {b:.3f} us",
              flush=True)
    for blocks in (8, 16):
        us = device_ms(lambda: equalize.launch_empty(dev, blocks))[0] * 1e3
        print(f"  an empty kernel in a cluster of {blocks}: {us:.3f} us", flush=True)


K3_REL_TOL = 1e-6  # of the image's largest box sum


def min_eig_cases(rng, dev):
    """(image on the CPU, the same image on the card as the wrapper gets
    it) for K3's checks: the main path's shapes and types, awkward
    sizes, one row and one column either side of the tile's edges, the
    grid-stride sizes, and views read in place or copied."""
    from slam3d_gx_torch.kernels import min_eig

    def u8(shape):
        return torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))

    def f32(shape):
        return torch.from_numpy((rng.normal(size=shape) * 50).astype(np.float32))

    g = min_eig.geometry(1, 1)
    th, tw = g.tile_h, g.tile_w
    cases = {"480x640 uint8": u8((H, W)), "480x640 f32": f32((H, W)),
             "constant": torch.full((H, W), 77, dtype=torch.uint8),
             "37x53": u8((37, 53)), "1x7": u8((1, 7)), "7x1": f32((7, 1)),
             "2x640": u8((2, 640)), "480x2": u8((480, 2)), "2x2": f32((2, 2))}
    for dh, dw in ((-1, -1), (0, 0), (1, 1), (1, -1), (-1, 1)):
        cases[f"{2 * th + dh}x{2 * tw + dw} (tile edge {dh:+d}, {dw:+d})"] = u8(
            (2 * th + dh, 2 * tw + dw))
    cases["1080x1920 (grid stride)"] = u8((1080, 1920))
    cases["2160x3840 (grid stride)"] = u8((2160, 3840))
    cases["2160x3840 f32 (grid stride)"] = f32((2160, 3840))
    out = {k: (v, v.to(dev)) for k, v in cases.items()}
    wide = u8((H, 2 * W))
    out["non-contiguous view (copied)"] = (wide[:, ::2], wide.to(dev)[:, ::2])
    big = u8((H + 7, W + 13))
    out["row-cropped view (read in place at its pitch)"] = (
        big[3:3 + H, 5:5 + W], big.to(dev)[3:3 + H, 5:5 + W])
    flat = big.to(dev).reshape(-1)[1:1 + H * W]
    assert flat.data_ptr() % 16 == 1
    out["1-byte-misaligned base"] = (big.reshape(-1)[1:1 + H * W].view(H, W), flat.view(H, W))
    return out


def check_min_eig(dev, kernels, min_eig):
    """K3 bit for bit against its first design (the tiled kernel, entry
    slam_min_eig_tile), and against its plain version on the card and on
    the CPU within K3_REL_TOL of the largest box sum: the response is a
    difference of two such sums, and the plain version differs from the
    kernel's IEEE operations in last bits (on the card PyTorch's scalar
    division is a product with the reciprocal, on the CPU its sqrt is
    not always correctly rounded). Returns the largest error on the card."""
    sc = min_eig.rounding_selfcheck(dev)
    for op, r in sc.items():
        print(f"  every float32 through the kernel's branch-free {op} against the IEEE "
              f"intrinsic: {r['differ']} differ, {r['differ_accepted']} of them taken by the "
              f"fast form, {r['refused']} handed to the intrinsic (|x| bits of those that differ "
              f"from {r['min_abs_bits']:#x} to {r['max_abs_bits']:#x})", flush=True)
        if r["differ_accepted"]:
            raise AssertionError(f"min_eig_response: the fast {op} differs from the intrinsic")
    worst = 0.0
    for name, (img, x) in min_eig_cases(np.random.default_rng(4), dev).items():
        got = kernels.min_eig_response(x)
        old = min_eig._min_eig_tile(x)
        torch.cuda.synchronize()
        if not (got.shape == img.shape and torch.isfinite(got).all()):
            raise AssertionError(f"min_eig_response: bad output on {name}")
        if "in place" in name and min_eig.pitched(x)[0].data_ptr() != x.data_ptr():
            raise AssertionError(f"min_eig_response copied the {name}")
        if not torch.equal(got, old):
            raise AssertionError(f"min_eig_response differs from the tiled kernel on {name}: "
                                 f"{float((got - old).abs().max())}")
        sxx, syy, _ = min_eig.structure_tensor(x.to(torch.float32))
        tol = K3_REL_TOL * float((sxx + syy).max())
        err = float((got - min_eig.min_eig_response_plain(x)).abs().max())
        err_cpu = float((got.cpu() - min_eig.min_eig_response_plain(img)).abs().max())
        print(f"  {name}: min_eig_response bit-identical to the tiled kernel; max abs err "
              f"{err:.6g} against the plain version on the card (tolerance {tol:.6g}, "
              f"largest response {float(got.max()):.6g}), {err_cpu:.6g} against it on the "
              f"CPU", flush=True)
        if err > tol or err_cpu > tol:
            raise AssertionError(f"min_eig_response differs from its plain version on {name}: "
                                 f"{err} (tolerance {tol}), {err_cpu} on the CPU")
        worst = max(worst, err)
    rng = np.random.default_rng(14)
    for cols, rows in min_eig.VARIANTS:
        for shape in ((H, W), (37, 53), (70, 523)):
            for x in (torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8)).to(dev),
                      torch.from_numpy((rng.normal(size=shape) * 50).astype(np.float32)).to(dev)):
                if not torch.equal(min_eig._launch_min_eig(x, cols, rows),
                                   min_eig._min_eig_tile(x)):
                    raise AssertionError(f"K3 variant {(cols, rows)} differs from the tiled "
                                         f"kernel at {shape} {x.dtype}")
    print(f"  variants {min_eig.VARIANTS} (cols, rows): bit-identical to the tiled kernel at "
          f"{H}x{W}, 37x53 and 70x523, uint8 and f32", flush=True)

    # a register or a tile that one launch leaves unclean shows in the next
    pair = [torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
            for _ in range(2)]
    want = [min_eig._min_eig_tile(p) for p in pair]
    outs = [kernels.min_eig_response(pair[i % 2]) for i in range(1000)]
    torch.cuda.synchronize()
    bad = [i for i, o in enumerate(outs) if not torch.equal(o, want[i % 2])]
    print(f"  1,000 back-to-back calls on alternating images: {len(bad)} wrong", flush=True)
    if bad:
        raise AssertionError(f"min_eig_response: back-to-back calls {bad[:10]} are wrong")
    return worst


def min_eig_bound(x):
    """K3's least time for image x: its bytes read once and the f32
    response written once, or ~55 flop a pixel (2 Sobels of 6 taps ~16,
    3 products, 3 box sums of 9 ~27, the closed form ~9)."""
    n = x.numel()
    return bound(n * x.element_size() + 4 * n, 55 * n)


def first_wrapper(min_eig):
    """The first wrapper's host path around the tiled kernel, as it was:
    enter the device, take the build lock, copy to contiguous, wrap each
    pointer. For the host time of one call, before against after."""
    import ctypes

    from slam3d_gx_torch.kernels import build

    fn = min_eig._entry("slam_min_eig_tile")

    def call(img):
        x = img.contiguous()
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            build.load(min_eig.SOURCE)
            rc = fn(ctypes.c_void_p(x.data_ptr()), int(x.dtype == torch.uint8), x.shape[0],
                    x.shape[1], ctypes.c_void_p(out.data_ptr()),
                    ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        build.check(rc, "min_eig_tile")
        return out
    return call


def time_min_eig(dev, kernels, min_eig):
    """K3 at the main path's shape and type: the image-only extractor
    hands it the 480x640 uint8 gray frame. The f32 form, which the plane
    extractor's equalized frame takes, is printed beside it, and beside
    each the tiled kernel's time in this run. No single PyTorch call
    computes this function."""
    rng = np.random.default_rng(5)
    x8 = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
    x32 = x8.to(torch.float32)
    old_call = first_wrapper(min_eig)
    row = None
    for label, x in (("uint8", x8), ("f32", x32)):
        b, by = min_eig_bound(x)
        ms, how, ops = device_ms(lambda: kernels.min_eig_response(x))
        old_ms = device_ms(lambda: min_eig._min_eig_tile(x))[0]
        r = dict(ms=ms, plain_ms=device_ms(lambda: min_eig.min_eig_response_plain(x))[0],
                 library_ms=None, bound_ms=b, bound_by=by, old_ms=old_ms,
                 stream_ms=event_ms(lambda: kernels.min_eig_response(x)))
        print(f"  min_eig_response at {H}x{W} {label} ({how}): kernel {r['ms'] * 1e3:.3f} us in "
              f"{ops:g} device operation(s), the tiled kernel {old_ms * 1e3:.3f} us "
              f"({r['ms'] / old_ms:.3f}x), plain {r['plain_ms'] * 1e3:.3f} us, library none, "
              f"bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}, "
              f"{100 * b / ms:.1f}% of it); one wrapper call on the stream "
              f"{r['stream_ms'] * 1e3:.3f} us, on the host "
              f"{host_us(lambda: kernels.min_eig_response(x)):.3f} us (the first wrapper "
              f"{host_us(lambda: old_call(x)):.3f} us)", flush=True)
        row = row or r
    g = min_eig.geometry(H, W, resident=min_eig._resident(dev, 1, min_eig.COLS, min_eig.ROWS))
    print(f"  an empty kernel in the same launch shape ({g.grid} blocks of 128 threads): "
          f"{device_ms(lambda: min_eig.launch_empty(dev, g.grid))[0] * 1e3:.3f} us", flush=True)
    return row


def sweep_min_eig(dev, min_eig):
    """Device time of K3 in every built variant (columns and rows a
    thread owns) against the tiled kernel, uint8 and f32, from the main
    path's frame to 2160x3840, with each size's bound."""
    rng = np.random.default_rng(12)
    for h, w in ((H, W), (720, 1280), (1080, 1920), (2160, 3840)):
        x8 = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(np.uint8)).to(dev)
        for label, x in (("uint8", x8), ("f32", x8.to(torch.float32))):
            old = min_eig._min_eig_tile(x)
            old_us = device_ms(lambda: min_eig._min_eig_tile(x))[0] * 1e3
            us = {}
            for cols, rows in min_eig.VARIANTS:
                assert torch.equal(min_eig._launch_min_eig(x, cols, rows), old), (cols, rows)
                us[cols, rows] = device_ms(
                    lambda: min_eig._launch_min_eig(x, cols, rows))[0] * 1e3
            main = (min_eig.COLS, min_eig.ROWS)
            g = min_eig.geometry(h, w, *main, min_eig._resident(
                x.device, int(x.dtype == torch.uint8), *main))
            variants = ", ".join(f"{k}: {v:.3f} us" for k, v in us.items())
            print(f"  {h}x{w} {label}: tiled kernel {old_us:.3f} us; (cols, rows) {variants}; "
                  f"the main path's {main}: {g.n_tiles} tiles in {g.grid} blocks; bound "
                  f"{min_eig_bound(x)[0] * 1e3:.4f} us", flush=True)


def time_equalize_kernels(dev, kernels, equalize):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(np.uint8)).to(dev)
    lut = torch.from_numpy(np.sort(rng.integers(0, 256, 256)).astype(np.float32)).to(dev)
    lut_u8 = lut.to(torch.uint8)
    flat = x.reshape(-1)
    n = x.numel()
    calls = {
        # K1: the image read once, 256 int32 counts written; one add a pixel
        "histogram256": (n + 256 * 4, n, lambda: kernels.histogram256(x),
                         lambda: equalize.histogram256_plain(x),
                         lambda: torch.bincount(flat, minlength=256)),
        # K2: the image read and written once, the f32 LUT read; one lookup a pixel
        "apply_lut256": (2 * n + 256 * 4, n, lambda: kernels.apply_lut256(x, lut),
                         lambda: equalize.apply_lut256_plain(x, lut),
                         lambda: torch.take(lut_u8, x.long())),
    }
    rows = {}
    for name, (nbytes, ops, kernel, plain, library) in calls.items():
        b, by = bound(nbytes, ops)
        ms, how, _ = device_ms(kernel)
        rows[name] = dict(ms=ms, plain_ms=device_ms(plain)[0], library_ms=device_ms(library)[0],
                          bound_ms=b, bound_by=by, stream_ms=event_ms(kernel))
        r = rows[name]
        print(f"  {name} at {H}x{W} ({how}): kernel {r['ms'] * 1e3:.3f} us, plain "
              f"{r['plain_ms'] * 1e3:.3f} us, library {r['library_ms'] * 1e3:.3f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); one wrapper call on the "
              f"stream {r['stream_ms'] * 1e3:.3f} us", flush=True)
    return rows


# refine_lm: the main path's polish, N = 512 correspondences (max_keypoints)
LM_N, LM_ITERS = 512, 10
LM_ATOL = 1e-4  # rad and m: tests/test_torch_cuda.py's bound, and why
# operations of one correspondence in one pass: its projection (~28), its
# 2x6 Jacobian (~105), its terms of J^T J, J^T r and r^T r (~112)
LM_OPS_PER_POINT = 245


def refine_lm_case(G: int, seed: int, dev):
    """G polishes of LM_N correspondences as a RANSAC winner hands them
    over: points 1-4 m away, a pose near the identity, 0.5 px noise, a
    quarter outliers at weight 0, a start 0.02 off."""
    from slam3d_gx_torch.ops import lie

    rng = np.random.default_rng(seed)
    cam = (INTR_KW["fx"], INTR_KW["fy"], INTR_KW["cx"], INTR_KW["cy"])
    obj = rng.uniform([-1.5, -1.2, 1.0], [1.5, 1.2, 4.0], (G, LM_N, 3))
    rv, tv = rng.normal(0, 0.05, (G, 3)), rng.normal(0, 0.05, (G, 3))
    R = lie.rodrigues(torch.from_numpy(rv.astype(np.float32))).double().numpy()
    pc = np.einsum("gij,gnj->gni", R, obj) + tv[:, None]
    img = np.stack([cam[0] * pc[..., 0] / pc[..., 2] + cam[2],
                    cam[1] * pc[..., 1] / pc[..., 2] + cam[3]], -1)
    img += rng.normal(0, 0.5, img.shape)
    out = rng.random((G, LM_N)) < 0.25
    img[out] += rng.normal(0, 40, (int(out.sum()), 2))
    rv0, tv0 = rv + rng.normal(0, 0.02, rv.shape), tv + rng.normal(0, 0.02, tv.shape)
    args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev)
            for a in (rv0, tv0, obj, img, ~out)]
    return args, cam


def check_refine_lm(dev, kernels, refine_lm):
    """The kernel against its plain version on the card, at G = 1 (the
    per-frame solve) and G = 30 (a verifier round), N = LM_N, 10
    iterations, within LM_ATOL; one launch a call. Returns the largest
    error."""
    worst = 0.0
    for G in (1, 30):
        args, cam = refine_lm_case(G, 40 + G, dev)
        before = kernels.launch_counts()["refine_lm"]
        got = refine_lm.refine_lm(*args, *cam, iters=LM_ITERS)
        launched = kernels.launch_counts()["refine_lm"] - before
        want = refine_lm.refine_lm_plain(*args, *cam, iters=LM_ITERS)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        print(f"  refine_lm G={G} N={LM_N}: {launched} launch, max abs err {err:.3g} against "
              f"the plain version on the card (tolerance {LM_ATOL})", flush=True)
        if launched != 1 or not err <= LM_ATOL:
            raise AssertionError(f"refine_lm at G={G}: {launched} launches, error {err}")
        worst = max(worst, err)
    return worst


def time_refine_lm(dev, refine_lm):
    """Device time of one call at G = 1 and G = 30, N = LM_N, 10
    iterations (median of 200 calls), the plain version's (median of 10:
    each is ~6,400 launches), and the bound: the points read once, and
    LM_OPS_PER_POINT a point in each of the 11 passes. No single PyTorch
    call computes this function. Returns G = 1's row."""
    rows = {}
    for G in (1, 30):
        args, cam = refine_lm_case(G, 50 + G, dev)
        nbytes = G * LM_N * 6 * 4 + G * 12 * 4
        b, by = bound(nbytes, G * LM_N * (LM_ITERS + 1) * LM_OPS_PER_POINT)
        ms, how, ops = device_ms(lambda: refine_lm.refine_lm(*args, *cam, iters=LM_ITERS))
        plain_ms, _, plain_ops = device_ms(
            lambda: refine_lm.refine_lm_plain(*args, *cam, iters=LM_ITERS), calls=10, warmup=2)
        r = rows[G] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b, bound_by=by)
        print(f"  refine_lm G={G} N={LM_N} iters={LM_ITERS} ({how}): kernel "
              f"{ms * 1e3:.3f} us in {ops:g} device operation(s), plain {plain_ms * 1e3:.3f} us "
              f"in {plain_ops:g}, library none, bound {b * 1e3:.4f} us ({by}, "
              f"{100 * b / ms:.3f}% of it); one wrapper call on the stream "
              f"{event_ms(lambda: refine_lm.refine_lm(*args, *cam, iters=LM_ITERS)) * 1e3:.3f} "
              f"us, on the host "
              f"{host_us(lambda: refine_lm.refine_lm(*args, *cam, iters=LM_ITERS)):.3f} us",
              flush=True)
    return rows[1]


INTR_KW = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0, factor=5000.0)
OUTPUTS = ("final.g2o", "final_after.g2o", "keyframe.txt", "error_of_transform.log")


def write_dataset(base: str):
    """The synthetic 30-frame 640x480 orbit every path runs on."""
    from slam3d_gx_torch.config import CameraIntrinsics
    from slam3d_gx_torch.testing import synthetic

    root = os.path.join(base, "dataset")
    traj = synthetic.orbit_trajectory(FRAMES, radius=0.25, yaw_amp=0.15)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj,
                            CameraIntrinsics(**INTR_KW), height=H, width=W, write_pcd=True)
    return root, traj


def write_run_dir(base: str, name: str, root: str, **extra) -> str:
    """A working directory with the repo's parameters.yaml, then this
    dataset, its intrinsics and `extra` (the parameter reader lets a
    later key win)."""
    work = os.path.join(base, name)
    os.makedirs(work)
    with open(os.path.join(REPO, "parameters.yaml")) as f:
        text = f.read()
    text += "\n# chip_smoke: synthetic dataset\n"
    text += f"data_source: {root}\n"
    text += "".join(f"camera_{k}: {v}\n" for k, v in INTR_KW.items())
    text += "".join(f"{k}: {v}\n" for k, v in extra.items())
    with open(os.path.join(work, "parameters.yaml"), "w") as f:
        f.write(text)
    return work


def run_path(kernels, entry, work: str, traj, loops: int, expect: dict,
             min_keyframes: int = 2, argv=None):
    """Drive one entry point for `loops` frames with every launch count
    set to 0 just before and read just after. `expect` maps each kernel
    to its launches per extraction (True: one, False: none, or a count).
    Checks the output files, the keyframes, the extractions (one per
    frame read; a streamed run: init's, every frame of every chunk
    dispatched, the padded ones included, and those of lostRecovery's
    per-frame replays) and ATE below ATE_BOUND_M.
    Returns the launches, the frontend and the entry point's stats, with
    the tracked frames/s added ("fps")."""
    from slam3d_gx_torch.io import tum
    from slam3d_gx_torch.testing import synthetic

    cwd = os.getcwd()
    os.chdir(work)
    try:
        stats = {}
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = entry(argv=argv or [str(loops)], stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        os.chdir(cwd)
    assert rc == 0, rc
    ge = stats["graphic_end"]
    data = os.path.join(work, "data")
    kf = tum.read_keyframes(os.path.join(data, "keyframe.txt"))
    est = [ge.opt.vertex_estimate(k.id) for k in ge.keyframes]
    gt = [traj[k.frame_index - 1] for k in ge.keyframes]
    ate = synthetic.ate_rmse(gt, est)
    lc_path = os.path.join(data, "lc.txt")
    loops_closed = sum(1 for _ in open(lc_path)) if os.path.exists(lc_path) else 0
    lost = open(os.path.join(data, "error_of_transform.log")).read().split().count("9999")
    if "frame_seconds" in stats:
        frames, tracking = len(stats["frame_seconds"]), sum(stats["frame_seconds"])
        frame_ms = [s * 1e3 for s in stats["frame_seconds"]]
        per_frame = (f"per-frame run() median {statistics.median(frame_ms):.3f} ms "
                     f"(max {max(frame_ms):.3f}), ")
    else:
        frames, tracking = stats["frames"], stats["seconds"]
        per_frame = f"{ge.dispatches} chunk dispatches of {ge.chunk}, "
    stats["fps"] = frames / tracking
    reg = ge.batch_registrar
    print(f"  {type(ge).__name__}: frames {frames + 1}, extractions {ge.extractions}, "
          f"keyframes {len(kf)}, loop closures {loops_closed}, lost frames {lost}, graph edges "
          f"{len(ge.opt.graph.edges)}, LM iterations {ge.opt.last_iters}, batched verifier "
          f"calls {reg.calls} over {reg.pairs} pairs", flush=True)
    print(f"  ATE {ate:.6f} m (bound {ATE_BOUND_M}), {per_frame}tracking {tracking:.3f} s for "
          f"{frames} frames ({stats['fps']:.3f} frames/s), whole run {wall:.3f} s", flush=True)
    print(f"  launches in this path: {launches}", flush=True)
    for name in OUTPUTS:
        assert os.path.getsize(os.path.join(data, name)) > 0, name
    assert len(kf) == len(ge.keyframes) >= min_keyframes, (len(kf), len(ge.keyframes))
    assert frames == loops, (frames, loops)
    if "frame_seconds" in stats:
        # one extraction per frame read: the last run() also extracts the
        # frame after it, when the dataset has one
        assert ge.extractions in (loops + 1, loops + 2), ge.extractions
    else:
        print(f"  extractions: 1 + {ge.dispatches} dispatches x {ge.chunk} + "
              f"{ge.replay_extractions} in lostRecovery replays", flush=True)
        assert ge.dispatches >= -(-loops // ge.chunk), ge.dispatches
        assert ge.extractions == 1 + ge.chunk * ge.dispatches + ge.replay_extractions, (
            ge.extractions, ge.dispatches, ge.replay_extractions)
    assert np.isfinite(ate) and ate < ATE_BOUND_M, ate
    feats = ge.keyframes[-1].features
    assert feats.desc.device.type == "cuda" and feats.uv.device.type == "cuda"
    for k, per in expect.items():
        want = ge.extractions * int(per)
        assert launches[k] == want, f"{k}: {launches[k]} launches, expected {want}"
    return launches, ge, stats


# the JAX package's outcomes on this orbit (scene 3, draws 0), jitted on
# the CPU by tests/test_torch_seed_protocol.py, with the protocol's largest
# port-minus-JAX ATE gap of each configuration over 8 scenes x 2 draws
JAX_RECORD = os.path.join(REPO, "slam3d_gx_torch", "testing", "jax_reference_outcomes.json")
# the card's ATE may exceed JAX's by the protocol's largest gap (0 when
# the port was never worse) and this margin: the card draws from its own
# stream, so its run is one more sample of the port's spread
JAX_GAP_MARGIN_M = 0.01


def against_jax(ge, work: str, traj, config: str) -> None:
    """The card's keyframes, lost frames, ATE and RPE beside the JAX
    package's on the same configuration; fails where the card's ATE
    exceeds JAX's by more than the protocol's largest gap plus
    JAX_GAP_MARGIN_M."""
    from slam3d_gx_torch.testing import synthetic

    with open(JAX_RECORD) as f:
        ref = json.load(f)["configs"][config]
    rows = open(os.path.join(work, "data", "error_of_transform.log")).read().split()
    start = ge.params.get_int("start_index")
    est = [np.asarray(ge.opt.vertex_estimate(k.id), np.float64) for k in ge.keyframes]
    gt = [traj[k.frame_index - 1] for k in ge.keyframes]
    card = dict(keyframes=[int(k.frame_index) for k in ge.keyframes],
                lost=[start + 1 + i for i, r in enumerate(rows) if r == "9999"],
                ate=synthetic.ate_rmse(gt, est), rpe=synthetic.rpe_rmse(gt, est))
    gate = ref["ate"] + max(ref["max_port_gap"], 0.0) + JAX_GAP_MARGIN_M
    print(f"  against JAX ({config}) {ref['label']}: keyframes {card['keyframes']} card, "
          f"{ref['keyframes']} JAX; lost frames {card['lost']} card, {ref['lost']} JAX; ATE "
          f"{card['ate']:.6f} m card, {ref['ate']:.6f} m JAX (gate {gate:.6f} m: JAX + the "
          f"protocol's largest gap {ref['max_port_gap']:.6f} + {JAX_GAP_MARGIN_M}); RPE "
          f"{card['rpe']:.6f} m card, {ref['rpe']:.6f} m JAX", flush=True)
    assert card["ate"] <= gate, f"({config}) ATE {card['ate']} above the JAX gate {gate}"


def check_streamed(stats, per_frame_ge, per_frame_stats, label: str, syncs_allowed: bool):
    """A streamed run beside its per-frame run: keyframes within one,
    frames/s side by side, and the synchronizing operations of each chunk
    dispatch with where they come from. Without `syncs_allowed` every
    dispatch that continues from the device's carry must have none (the
    first, and one after a lostRecovery replay, build it from the host)."""
    import collections

    ge = stats["graphic_end"]
    n_kf, n_ref = len(ge.keyframes), len(per_frame_ge.keyframes)
    print(f"  keyframes {n_kf} streamed, {n_ref} per frame; {stats['fps']:.3f} frames/s "
          f"streamed in chunks of {ge.chunk}, {per_frame_stats['fps']:.3f} frames/s per frame "
          f"({stats['fps'] / per_frame_stats['fps']:.3f}x)", flush=True)
    assert abs(n_kf - n_ref) <= 1, (n_kf, n_ref)
    syncs = stats["chunk_syncs"]
    assert len(syncs) == ge.dispatches and syncs[0][0], (len(syncs), ge.dispatches)
    later = collections.Counter(src for from_host, d in syncs if not from_host for src in d)
    first = collections.Counter(src for from_host, d in syncs if from_host for src in d)
    print(f"  {label}: synchronizing operations per chunk dispatch "
          f"{[len(d) for _, d in syncs]} ({sum(h for h, _ in syncs)} with the carry from the "
          f"host); in those with the device's carry, by source: {dict(later) or 'none'}; in "
          f"those with the host's: {dict(first)}", flush=True)
    if not syncs_allowed:
        assert not later, f"{label}: a chunk dispatch on the device's carry synchronized: {later}"


def profiled(name: str, fn, reps: int = 5):
    """Median synchronized wall ms of `fn`, and for one more call under
    torch.profiler its wall, the device-busy ms inside it (kernels,
    memsets and copies) and the number of device operations. Returns
    (median wall ms, device-busy ms, device operations)."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev) / 1e3
    print(f"  {name}: wall median {statistics.median(walls):.3f} ms; profiled call wall "
          f"{wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), "
          f"{len(dev)} device operations", flush=True)
    return statistics.median(walls), busy, len(dev)


def stage_times(ge, work: str, rounds: bool) -> None:
    """The per-frame stages re-run on a path's last frame; with `rounds`,
    also one batched verification round of N candidates against the same
    N candidates registered one at a time."""
    from slam3d_gx_torch.frontend.state import result_to_host

    label = type(ge).__name__
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ge.index -= 1  # the last frame of the run
        ge.readimage()
        feats = ge._extract_present()
    finally:
        os.chdir(cwd)
    profiled(f"{label} extract", ge._extract_present)
    profiled(f"{label} multipnp", lambda: result_to_host(
        ge.multipnp(ge.keyframes[-1].features, feats, 12)))
    if not rounds:
        return
    n = max(8, len(ge.keyframes))
    cand = [i % len(ge.keyframes) for i in range(n)]
    profiled(f"{label} batched round of {n} candidates",
             lambda: ge.batch_registrar.run_against_one(
                 ge.kf_store, cand, feats, ge._uniforms(n), ge.loop_closure_inliers))
    profiled(f"{label} {n} single registrations",
             lambda: [result_to_host(ge.multipnp(ge.keyframes[i].features, feats,
                                                 ge.loop_closure_inliers)) for i in cand])


# phase 12: the detector/descriptor pairs of the zoo, card against CPU
ZOO = (("SIFT", "SIFT"), ("SURF", "SURF"), ("SURF", "SURF_SIFT"), ("STAR", "SIFT"),
       ("FAST", "SIFT"), ("GridFAST", "SIFT"), ("ORB", "ORB"), ("GFTT", "SIFT"),
       ("HARRIS", "SIFT"))
# keypoint-set overlap, card against CPU: SURF and STAR read an f32
# integral image whose sums pass 2^24 at 640x480 and round in each
# device's summation order (the 95% of tests/test_torch_zoo.py at
# 320x240); every other detector 99%
KP_OVERLAP = {"SURF": 0.95, "STAR": 0.95}
# per-entry tolerance of a float descriptor on the same keypoints: SIFT's
# are integers that may round the other way, SURF's unit vectors
DESC_TOL = {"SIFT": 1.0, "SURF_SIFT": 1.0, "SURF": 1e-3}
DESC_ROWS = 0.99  # share of valid keypoints whose descriptor row agrees
EXP_BOUND_M, EXP_BOUND_RAD = 0.05, 0.05  # a right registration against the ground truth
# exp1_2 registers frames 1 and 3 right on about half the seeds (the plain
# CPU path, seeds 0-7: GFTT/SIFT n 5, p 4, ORB/ORB n 5 under the bounds;
# the others take a wrong consensus, ~1.3 m off with few inliers, which
# no norm gate rejects in exp1_2). So on the card each is run over
# EXP_SEEDS seeds and the right ones are printed; what is checked is the
# card against the CPU on the same draws, on every seed
EXP_SEEDS = 8
# T (m and rotation entries), each frame's pose change and the ATE, card
# against CPU on the same inputs and draws: fp32 Gauss-Newton on 17-30
# inliers, whose reductions the card orders otherwise (up to 1.75e-4
# measured on an H100; the CPU test holds 1e-4 against JAX at 160x120),
# 50x under the ground-truth bounds
PARITY_TOL = 1e-3
# single-hypothesis registrations compared for each registration (n:
# every hypothesis of the draws; p: the first 128, each a multiPnP of all
# planes; the verifier: 256) and the share whose inliers must agree, card
# against CPU on the same inputs. fp32 P3P (Durand-Kerner roots) resolves
# ill-conditioned triplets differently on the two devices: on an H100
# 0-3.1% of the hypotheses got other inliers, 0-5.1% other inliers or T
# beyond PARITY_TOL (exp1_2 seeds 0-7 in its three runs, both verifiers).
# RANSAC's argmax may pick such a candidate, so a whole registration may
# differ while its stages agree (exp1_2 p seed 1, ORB seed 3): printed
EXP_HYPOTHESES = {"n": 256, "p": 128}
HYP_SHARE = 0.95
# detectors whose keypoints are the same on both devices (integer scores):
# the image-only runs hold the first keyframe's features equal. SURF's f32
# integral image rounds in each device's summation order (KP_OVERLAP)
EXACT_READS = {"ORB"}
HYP_SHARE = 0.95
EXP_MIN_CONSENSUS = 10
NO_KERNELS = {"equalize_hist256": 0, "histogram256": 0, "apply_lut256": 0,
              "min_eig_response": 0, "refine_lm": 0}


KP_POS_TOL = 0.01  # px: SIFT's sub-pixel positions differ in last bits between devices


def kp_overlap(a, b) -> tuple:
    """Valid keypoints of `a` and `b` (counts) and the share of the larger
    set that has a partner in the other: a position within KP_POS_TOL and
    a size within 0.1%."""
    def rows(k):
        v = k.valid.cpu().numpy()
        return np.c_[k.uv.cpu().numpy()[v], k.size.cpu().numpy()[v]]

    ra, rb = rows(a), rows(b)
    if not len(ra) or not len(rb):
        return len(ra), len(rb), 0.0
    near = ((np.abs(ra[:, None, :2] - rb[None, :, :2]) <= KP_POS_TOL).all(axis=-1)
            & (np.abs(ra[:, None, 2] - rb[None, :, 2]) <= 1e-3 * rb[None, :, 2]))
    return len(ra), len(rb), min(near.any(1).sum(), near.any(0).sum()) / max(len(ra), len(rb))


def check_zoo(kernels, dev, gray: np.ndarray, max_kp: int = 512) -> dict:
    """Each pair of ZOO through `detect_and_describe` on the card against
    the plain CPU path: keypoint sets, and the card's descriptors of the
    CPU's keypoints against the CPU's. Then device ms, device operations
    and the synchronized wall of one card call. Returns each pair's
    launches."""
    from slam3d_gx_torch.ops.features import registry
    from slam3d_gx_torch.ops.features.common import Keypoints

    g_cpu = torch.from_numpy(gray)
    g_dev = g_cpu.to(dev)
    launches = {}
    for det, desc in ZOO:
        label = f"{det}/{desc}"
        run = registry.detect_and_describe(det, desc, max_kp)
        kernels.reset_counts()
        k_dev, d_own = run(g_dev)
        torch.cuda.synchronize()
        launches[label] = kernels.launch_counts()
        k_cpu, d_cpu = run(g_cpu)
        d_dev = registry.create_descriptor(desc)(
            g_dev, Keypoints(*(f.to(dev) for f in k_cpu))).cpu()
        n_dev, n_cpu, overlap = kp_overlap(k_dev, k_cpu)
        v = k_cpu.valid.numpy()
        if desc == "ORB":
            rows = (d_dev[v] == d_cpu[v]).all(dim=1)
            what = "bits equal"
        else:
            rows = (d_dev[v] - d_cpu[v]).abs().amax(dim=1) <= DESC_TOL[desc]
            what = f"within {DESC_TOL[desc]:g}"
        agree = float(rows.float().mean())
        wall, busy, ops = profiled(f"{label} detect_and_describe at {H}x{W}",
                                   lambda: run(g_dev))
        print(f"  {label}: {n_dev} keypoints on the card, {n_cpu} on the CPU, overlap "
              f"{overlap:.4f} (bound {KP_OVERLAP.get(det, 0.99)}); descriptor D="
              f"{d_own.shape[1]}, rows {what} on the CPU's keypoints {agree:.4f} (bound "
              f"{DESC_ROWS}); launches {launches[label]}; device {busy:.3f} ms in {ops} "
              f"operations, wall {wall:.3f} ms", flush=True)
        assert d_own.device.type == "cuda" and d_own.shape == (max_kp, registry.descriptor_dim(
            desc)), (label, d_own.shape)
        assert n_cpu >= 10, f"{label}: {n_cpu} keypoints"
        assert overlap >= KP_OVERLAP.get(det, 0.99), f"{label}: keypoint overlap {overlap}"
        assert agree >= DESC_ROWS, f"{label}: descriptor rows agree {agree}"
        want_k3 = 1 if det == "GFTT" else 0
        assert launches[label] == dict(NO_KERNELS, min_eig_response=want_k3), launches[label]
    return launches


def host_draws(graphic_end_cls):
    """`graphic_end_cls` drawing its PnP uniforms from a CPU generator
    seeded like the run's, moved to its device: a card run and a CPU run
    get the same draws."""
    class HostDraws(graphic_end_cls):
        def __init__(self, params, device=None):
            super().__init__(params, device=device)
            self._host_gen = torch.Generator().manual_seed(self.seed)

        def _uniforms(self, *batch: int) -> torch.Tensor:
            return torch.rand(batch + self._u_shape, generator=self._host_gen).to(self.device)

    return HostDraws


def exp1_2_register(work: str, argv, seed: int, device) -> tuple:
    """exp1_2's registration of `argv` (f1 f2 detector descriptor p|n) on
    `device`, every draw made on the host from a CPU generator seeded by
    `seed`. Returns (T^-1, inliers, what the registration read: in `n`
    the matches' (u1, v1, u2, v2) rows, in `p` both frames' plane
    features, `single`): single(device, G) registers the same inputs,
    moved to `device`, once for each of the first G hypotheses of the
    draws alone and returns (T (G,4,4), inliers (G,)) on the host."""
    from slam3d_gx_torch.cli import exp1_2
    from slam3d_gx_torch.config import ParameterReader
    from slam3d_gx_torch.frontend import FrameFeatures, pipeline
    from slam3d_gx_torch.ops import lie, plane_ransac, pnp

    class HostSampler(plane_ransac.UniformSampler):
        def __call__(self, p, remaining, hypotheses):
            return super().__call__(p, remaining.cpu(), hypotheses).to(remaining.device)

    f1, f2, det, desc, mode = argv
    params = ParameterReader(os.path.join(work, "parameters.yaml"))
    intr, ds = params.intrinsics, params.GetPara("data_source")
    max_kp, hyp = params.get_int("max_keypoints"), params.get_int("ransac_hypotheses")
    gen = torch.Generator().manual_seed(seed)
    gray1, dep1, g1, d1 = exp1_2.load_frame(ds, f1, device)
    _, dep2, g2, d2 = exp1_2.load_frame(ds, f2, device)
    if mode == "n":
        u = torch.rand((hyp, 3), generator=gen).to(device)
        k1, k2, midx, good, res = exp1_2.register_normal(g1, d1, g2, intr, det, desc, max_kp, u)
        obj, _ = pipeline.compute_kp3d_drop(d1, k1.uv, intr)
        inputs = (obj, k2.uv[midx], good)

        def single(dev, G):
            obj, img, mask = (x[None].expand(G, *x.shape).to(dev) for x in inputs)
            r = pnp.solve_pnp_ransac(obj, img, mask, intr.fx, intr.fy, intr.cx, intr.cy,
                                     u[:G, None].to(dev), reproj_thresh=8.0)
            return lie.make_T(lie.rodrigues(r.rvec), r.tvec).cpu(), r.n_inliers.cpu()

        rows = torch.cat([k1.uv, k2.uv[midx]], dim=1)[good].cpu().numpy()
        return exp1_2.pose_inverse(res.rvec, res.tvec), int(res.n_inliers), rows, single
    u = torch.rand((params.get_int("max_planes") + 2, hyp, 3), generator=gen).to(device)
    sampler = HostSampler(gen)
    z_max, grid, cap, align = exp1_2.cloud_settings(params, gray1)
    c1 = exp1_2.load_cloud(os.path.join(ds, f"pcd/{f1}.pcd"), z_max, grid, cap, device,
                           dep1, intr, align)
    c2 = exp1_2.load_cloud(os.path.join(ds, f"pcd/{f2}.pcd"), z_max, grid, cap, device,
                           dep2, intr, align)
    extract, multipnp = exp1_2.build_planar(intr, params, det, desc, max_kp, hyp)
    fa, fb = extract(g1, d1, *c1, sampler), extract(g2, d2, *c2, sampler)
    res = multipnp(fa, fb, u, 0)

    def single(dev, G):
        fa_g, fb_g = (FrameFeatures(*(x[None].expand(G, *x.shape).to(dev) for x in f))
                      for f in (fa, fb))
        r = multipnp(fa_g, fb_g, u[:, :G].transpose(0, 1)[:, :, None].to(dev), 0)
        return r.T.cpu(), r.inliers.cpu()

    T = res.T.cpu().numpy().astype(np.float64)
    return np.linalg.inv(T), int(res.inliers), (fa, fb), single


def features_differ(a, b, desc_tol: float) -> list:
    """What differs between two frames' plane features (FrameFeatures),
    card against CPU, on the valid planes and keypoints: which are valid,
    the keypoints' positions (in order) beyond KP_POS_TOL, the plane
    coefficients and keypoints' 3-d positions beyond PARITY_TOL, the
    descriptor entries beyond `desc_tol`."""
    coeffs, plane_valid, uv, kp3d, desc, kp_valid = (x.cpu() for x in a)
    if not (torch.equal(plane_valid, b.plane_valid) and torch.equal(kp_valid, b.kp_valid)):
        return ["valid planes or keypoints"]
    out = []
    for name, x, y, tol in (("coeffs", coeffs[plane_valid], b.coeffs[plane_valid], PARITY_TOL),
                            ("uv", uv[kp_valid], b.uv[kp_valid], KP_POS_TOL),
                            ("kp3d", kp3d[kp_valid], b.kp3d[kp_valid], PARITY_TOL),
                            ("desc", desc[kp_valid], b.desc[kp_valid], desc_tol)):
        d = float((x - y).abs().max()) if x.numel() else 0.0
        if d > tol:
            out.append(f"{name} by {d:.3g}")
    return out


def hypotheses_agree(single, dev, G: int) -> tuple:
    """G single-hypothesis registrations on the card against the CPU, on
    the same inputs: the share with the same inliers, and the share with
    the same inliers and T within PARITY_TOL."""
    T_d, n_d = single(dev, G)
    T_c, n_c = single("cpu", G)
    counts = n_d == n_c
    same = counts & ((T_d - T_c).abs().amax(dim=(1, 2)) <= PARITY_TOL)
    return float(counts.float().mean()), float(same.float().mean())


def run_exp1_2(kernels, dev, base: str, root: str, argv, expect: dict) -> dict:
    """`exp1_2` on the card over EXP_SEEDS seeds, each in its own working
    directory, with every launch count set to 0 just before each call and
    read just after: the launches `expect`ed in every call and its error
    row; the rows under the bounds are printed. Then, for each seed, the
    registration on the card and on the CPU with the same draws: what it
    reads must agree (features_differ; in `n` the matches), and so must
    the inliers of at least HYP_SHARE of the single-hypothesis
    registrations of the CPU's inputs (hypotheses_agree); whether the
    whole registrations agree is printed. Returns one call's launches."""
    from slam3d_gx_torch.cli import exp1_2

    cwd = os.getcwd()
    label = "exp1_2 " + " ".join(argv)
    G = EXP_HYPOTHESES[argv[4]]
    right, walls, cpu_s, same = [], [], [], []
    for seed in range(EXP_SEEDS):
        work = write_run_dir(base, f"exp1_2_{'_'.join(argv)}_{seed}", root, seed=seed)
        os.chdir(work)
        try:
            kernels.reset_counts()
            t0 = time.perf_counter()
            rc = exp1_2.main(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = kernels.launch_counts()
        finally:
            os.chdir(cwd)
        assert rc == 0, rc
        row = open(os.path.join(work, "data/exp1/error.log")).read().split()
        assert row[:2] == argv[:2] and len(row) == 7, row
        assert launches == dict(NO_KERNELS, **expect), launches
        if float(row[4]) < EXP_BOUND_M and float(row[5]) < EXP_BOUND_RAD:
            right.append(seed)

        T_dev, n_dev, read_dev, _ = exp1_2_register(work, argv, seed, dev)
        t0 = time.perf_counter()
        T_cpu, n_cpu, read_cpu, single = exp1_2_register(work, argv, seed, "cpu")
        cpu_s.append(time.perf_counter() - t0)
        if argv[4] == "n":
            differ = [] if read_dev.shape == read_cpu.shape and np.allclose(
                read_dev, read_cpu, rtol=0, atol=KP_POS_TOL) else ["matches"]
        else:
            differ = [f"frame {f}: {d}" for f, x, y in zip(argv[:2], read_dev, read_cpu)
                      for d in features_differ(x, y, DESC_TOL[argv[3]])]
        share_n, share = hypotheses_agree(single, dev, G)
        dT = float(np.abs(T_dev - T_cpu).max())
        if n_dev == n_cpu and dT <= PARITY_TOL:
            same.append(seed)
        print(f"  {label} seed {seed}: row '{' '.join(row)}' (f1 f2 gt_trans gt_rot err_trans "
              f"err_rot inliers); on the host's draws, card against CPU: reads "
              f"{differ or 'the same'}; of {G} single hypotheses, inliers agree on "
              f"{share_n:.4f} (bound {HYP_SHARE}), inliers and T on {share:.4f}; the "
              f"registration: inliers {n_dev} and {n_cpu}, max |dT| {dT:.3g}", flush=True)
        assert not differ and share_n >= HYP_SHARE, (label, seed, differ, share_n)
    print(f"  {label}: under {EXP_BOUND_M} m and {EXP_BOUND_RAD} rad on seeds {right} of "
          f"{EXP_SEEDS}; on the host's draws the card's registration is the CPU's (inliers "
          f"equal, T within {PARITY_TOL:g}) on seeds {same} (both printed, not gated); card "
          f"wall median {statistics.median(walls):.3f} s, CPU registration median "
          f"{statistics.median(cpu_s):.3f} s; launches a call {launches}", flush=True)
    return launches


def image_only_decisions(ge, work: str, traj) -> tuple:
    """(keyframes' frame indices, lost frames, ATE) of a finished
    image-only run."""
    from slam3d_gx_torch.testing import synthetic

    est = [ge.opt.vertex_estimate(k.id) for k in ge.keyframes]
    gt = [traj[k.frame_index - 1] for k in ge.keyframes]
    rows = open(os.path.join(work, "data", "error_of_transform.log")).read().split()
    return ([k.frame_index for k in ge.keyframes], [i for i, r in enumerate(rows) if r == "9999"],
            synthetic.ate_rmse(gt, est))


def verifier_single(ges: dict, fa, fb):
    """single(device, G) for hypotheses_agree: the pair (fa, fb) through
    the batched verifier of the frontend on `device` (`ges` maps a device
    type to one), G times in one stacked call, each with one hypothesis
    of a host draw."""
    from slam3d_gx_torch.frontend import FrameFeatures

    u_all = torch.rand((256, 1, 3), generator=torch.Generator().manual_seed(0))

    def single(device, G):
        ge = ges[torch.device(device).type]
        fa_g, fb_g = (FrameFeatures(*(x[None].expand(G, *x.shape).to(ge.device) for x in f))
                      for f in (fa, fb))
        rows = ge.batch_registrar.run_stacked(fa_g, fb_g, u_all[:G].to(ge.device),
                                              ge.loop_closure_inliers, G)
        return (torch.from_numpy(np.stack([r[0] for r in rows])).to(torch.float32),
                torch.tensor([int(r[2]) for r in rows]))

    return single


def run_image_only_pair(kernels, dev, base: str, root: str, traj, name: str, dim: int,
                        loops: int = 8) -> dict:
    """`run_SLAM_imageonly loops` with `name`/`name` features on the card
    (run_path's checks, ATE below ATE_BOUND_M) and on the CPU, both on the
    host's draws, their keyframes, lost frames and ATE printed side by
    side; the descriptor width `dim` in the keyframe store; with ORB the
    first keyframe's features equal on both devices (same keypoints in
    order, same bits); the batched verifier with `dim`-wide descriptors
    on the card's first and last keyframes, hypothesis by hypothesis on
    both devices: the inliers of at least HYP_SHARE agree
    (hypotheses_agree). Returns the card run's launches."""
    from slam3d_gx_torch.cli import run_slam
    from slam3d_gx_torch.frontend import GraphicEnd2

    entry = host_draws(GraphicEnd2)
    extra = dict(detector_name=name, descriptor_name=name, max_pos_change=0.05)
    work = write_run_dir(base, f"image_{name}", root, **extra)
    # run_path counts launches an extraction; refine_lm launches once a solve
    launches, ge, _ = run_path(kernels, lambda argv, stats: run_slam.run(
        entry, argv, stats=stats), work, traj, loops,
        {k: False for k in NO_KERNELS if k != "refine_lm"}, min_keyframes=1)
    work_cpu = write_run_dir(base, f"image_{name}_cpu", root, **extra)
    cwd = os.getcwd()
    os.chdir(work_cpu)
    try:
        stats = {}
        t0 = time.perf_counter()
        assert run_slam.run(entry, [str(loops)], device="cpu", stats=stats) == 0
        cpu_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    ge_cpu = stats["graphic_end"]
    (kf, lost, ate), (kf_cpu, lost_cpu, ate_cpu) = (
        image_only_decisions(g, w, traj) for g, w in ((ge, work), (ge_cpu, work_cpu)))
    differ = features_differ(ge.keyframes[0].features, ge_cpu.keyframes[0].features, 0.0)
    first, last = ge.keyframes[0].features, ge.keyframes[-1].features
    share_n, share = hypotheses_agree(
        verifier_single({"cuda": ge, "cpu": ge_cpu}, first, last), dev, 256)
    print(f"  on the host's draws, card against CPU: keyframes at frames {kf} and {kf_cpu}, "
          f"lost frames {lost} and {lost_cpu}, ATE {ate:.6f} and {ate_cpu:.6f} m (printed, "
          f"not gated), CPU run {cpu_s:.3f} s; frame 1's features differ in "
          f"{differ or 'nothing'}; the verifier on frames 1 and {kf[-1]}, of 256 single "
          f"hypotheses inliers agree on {share_n:.4f} (bound {HYP_SHARE}), inliers and T on "
          f"{share:.4f}", flush=True)
    if name in EXACT_READS:
        assert not differ, differ
    assert share_n >= HYP_SHARE, share_n
    for g in (ge, ge_cpu):
        assert g.keyframes[-1].features.desc.shape[-1] == dim
        assert g.kf_store.gather([0]).desc.shape[-1] == dim
    return launches


def run_planar_features(kernels, work: str, root: str) -> dict:
    """planarFeatures on frame 1: a nonzero count of planar keypoints (the
    synthetic room is all planes), its PNG, and no kernel launched."""
    import contextlib
    import io

    from slam3d_gx_torch.cli import planar_features

    cwd = os.getcwd()
    os.chdir(work)
    out = io.StringIO()
    try:
        kernels.reset_counts()
        with contextlib.redirect_stdout(out):
            rc = planar_features.main([os.path.join(root, "rgb_index/1.png"),
                                       os.path.join(root, "dep_index/1.png")])
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    finally:
        os.chdir(cwd)
    text = out.getvalue()
    print("  " + text.strip().replace("\n", "; ") + f"; launches {launches}", flush=True)
    assert rc == 0 and os.path.getsize(os.path.join(work, "planar_features.png")) > 0
    counts = dict(part.split(": ") for part in text.splitlines()[0].split(", "))
    assert int(counts["planar"]) > 0 and int(counts["keypoints"]) > 0, counts
    assert launches == NO_KERNELS, launches
    return launches


def zoo_phase(kernels, dev, base: str, root: str, traj) -> dict:
    """Phase 12: the zoo's pairs card against CPU, exp1_2 in both modes,
    planarFeatures and two short image-only runs with 256- and 64-wide
    descriptors. Returns the launches of each path."""
    from slam3d_gx_torch.io import images

    phase("the zoo: each detector/descriptor pair on the card against the CPU (frame 1)")
    gray = images.load_gray(os.path.join(root, "rgb_index/1.png"))
    zoo = {f"detect_and_describe {k}": v for k, v in check_zoo(kernels, dev, gray).items()}

    phase(f"exp1_2 1 3: GFTT/SIFT n and p, ORB/ORB n, seeds 0-{EXP_SEEDS - 1}, card "
          "against CPU")
    for det, desc, mode, expect in (
            # refine_lm: one polish in `n`; the pooled (4 steps) and the 3 px
            # (10 steps) solves in `p`, whose per-plane solves polish nothing
            ("GFTT", "SIFT", "n", {"min_eig_response": 2, "refine_lm": 1}),
            ("GFTT", "SIFT", "p", {"min_eig_response": 2, "equalize_hist256": 2,
                                   "refine_lm": 2}),
            ("ORB", "ORB", "n", {"refine_lm": 1})):
        argv = ["1", "3", det, desc, mode]
        zoo["exp1_2 " + " ".join(argv)] = run_exp1_2(kernels, dev, base, root, argv, expect)
    time_log = os.path.join(base, "exp1_2_1_3_GFTT_SIFT_p_0", "data", "time.log")
    labels = [r.split()[0] for r in open(time_log)]
    assert labels == ["ExtractPlane", "DetectKeypoints", "Descriptor", "Compute3dPosition",
                      "RANSAC"], labels

    phase("planarFeatures on frame 1")
    zoo["planar_features"] = run_planar_features(kernels, write_run_dir(base, "planar", root),
                                                 root)

    # a keyframe a frame where tracking holds (max_pos_change 0.05)
    for name, dim in (("ORB", 256), ("SURF", 64)):
        phase(f"image-only path with {name}/{name} (D = {dim}): run_SLAM_imageonly 8, card "
              "against CPU")
        zoo[f"run_SLAM_imageonly 8 {name}"] = run_image_only_pair(
            kernels, dev, base, root, traj, name, dim)
    return zoo


# phase 13: the post-tracking half: the CG solver, scored loop closure,
# the finalize pre-filter and the offline CLIs
CG_CASES = ((2048, 1, {}, 0.06, 30), (1024, 2, {"outlier_frac": 0.1}, 0.1, 8))
CG_PARITY_V = 600  # above 512 vertices: CG with the 1,024 bucket's cap of 512
CG_PARITY_TOL = 1e-3  # m and rad, card against CPU on the seed-0 graph
TRAJ_ATE_TOL = 1e-6  # m, trajectory.txt's 6 significant digits against the run
CLOUD_SHARE = 0.999  # fused points matched within 1e-4 m, colors within 1
CLOUD_COUNT_TOL = 1e-3


@contextlib.contextmanager
def sync_sources(out: list):
    """Append the source line of every synchronizing CUDA operation in
    the block to `out` (torch.cuda.set_sync_debug_mode)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode("default")
    out.extend(f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
               if "synchroniz" in str(w.message))


def rotation_angle(Ra, Rb) -> float:
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


def cg_phase(kernels, dev) -> dict:
    """The CG solver on the card: the two graphs of
    tests/test_pose_graph_scale.py to its bounds, one LM step profiled,
    and a 600-vertex graph on the card against the CPU."""
    import collections

    from slam3d_gx_torch.testing import posegraph

    kernels.reset_counts()
    for n, seed, kw, ate_max, ratio in CG_CASES:
        opt, gt, n_loops = posegraph.make_loopy_graph(n, seed=seed, device=dev, **kw)
        ate0 = posegraph.graph_ate(opt, gt)
        syncs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_sources(syncs):
            chi = opt.optimize(n_iters=15, solver="cg")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ate1 = posegraph.graph_ate(opt, gt)
        print(f"  {n} vertices, {len(opt.graph.edges)} edges ({n_loops} loops{', ' + str(kw) if kw else ''}): "
              f"ATE {ate0:.6f} -> {ate1:.6f} m (bounds {ate_max} and ATE0/{ratio}), chi2 {chi:.6g}, "
              f"wall {wall:.3f} s, LM iterations {opt.last_iters}, CG iterations per LM step "
              f"{opt.last_cg_iters}, host waits {len(syncs)} ({len(syncs) / opt.last_iters:.2f} per LM "
              f"step) from {dict(collections.Counter(syncs))}", flush=True)
        assert opt.last_solver == "cg" and np.isfinite(chi)
        assert ate1 < ate_max and ate1 < ate0 / ratio, (ate0, ate1)
    # one LM step of the 2,048-vertex graph, from its drifted start
    opt, _, _ = posegraph.make_loopy_graph(CG_CASES[0][0], seed=CG_CASES[0][1], device=dev)
    start = {v: x.T.copy() for v, x in opt.graph.vertices.items()}

    def one_step():
        for v, T in start.items():
            opt.graph.vertices[v].T = T.copy()
        opt.optimize(n_iters=1, solver="cg")

    profiled(f"CG LM step at {CG_CASES[0][0]} vertices", one_step, reps=2)
    print(f"  CG iterations of that step: {opt.last_cg_iters}", flush=True)

    def solve(where, seed: int, nudge: bool = False):
        """The CG solve of a CG_PARITY_V-vertex graph; with `nudge`, its
        start translations scaled by 1 + 2^-23, a change at fp32's
        rounding."""
        opt, _, _ = posegraph.make_loopy_graph(CG_PARITY_V, seed=seed, device=where)
        if nudge:
            for x in opt.graph.vertices.values():
                if not x.fixed:
                    x.T[:3, 3] *= 1.0 + 2.0 ** -23
        t0 = time.perf_counter()
        opt.optimize(n_iters=15)
        if where != "cpu":
            torch.cuda.synchronize()
        return opt, time.perf_counter() - t0

    def apart(a, b):
        """(m, rad): the largest translation and rotation between the two
        solves' poses."""
        vs = sorted(a.graph.vertices)
        return (max(np.abs(a.vertex_estimate(v)[:3, 3] - b.vertex_estimate(v)[:3, 3]).max()
                    for v in vs),
                max(rotation_angle(a.vertex_estimate(v)[:3, :3], b.vertex_estimate(v)[:3, :3])
                    for v in vs))

    # seed 0: tests/test_torch_posegraph_cg.py's 600-vertex graph, gated;
    # seed 3: a graph whose LM result moves by millimetres under rounding
    # (the capped CG solves stop far from converged), printed beside the
    # CPU's own move under a start nudged at fp32's rounding
    for seed in (0, 3):
        (card, t_card), (cpu, t_cpu) = solve(dev, seed), solve("cpu", seed)
        dt, dr = apart(card, cpu)
        print(f"  {CG_PARITY_V} vertices (seed {seed}), automatic solver {card.last_solver}: card "
              f"{card.last_iters} LM iterations in {t_card:.3f} s, CPU {cpu.last_iters} in "
              f"{t_cpu:.3f} s; CG iterations per step {card.last_cg_iters} (card), "
              f"{cpu.last_cg_iters} (CPU); card against CPU: poses within {dt:.3g} m and "
              f"{dr:.3g} rad", flush=True)
        assert card.last_solver == cpu.last_solver == "cg"
        if seed == 0:
            assert card.last_iters == cpu.last_iters, (card.last_iters, cpu.last_iters)
            assert dt <= CG_PARITY_TOL and dr <= CG_PARITY_TOL, (dt, dr)
        else:
            nt, nr = apart(solve("cpu", seed, nudge=True)[0], cpu)
            print(f"  the CPU against itself from the nudged start: {nt:.3g} m and {nr:.3g} rad",
                  flush=True)
    return kernels.launch_counts()


SCORED = dict(detector_name="GFTT", descriptor_name="SIFT", loop_closure_scored=1,
              finalize_prefilter=8)
IMAGE_ONLY_EXPECT = {"equalize_hist256": False, "histogram256": False, "apply_lut256": False,
                     "min_eig_response": True}


def scored_round_syncs(ge) -> tuple:
    """One more scored round on a run's final state: the synchronizing
    operations of its dispatch, the candidates it verified and the host
    path's."""
    from slam3d_gx_torch.parallel import registration

    reg = ge.batch_registrar
    q = ge.curr_kf.features
    syncs = []
    torch.cuda.synchronize()
    with sync_sources(syncs):
        idx, valid = ge.lcdb.select_candidates_device(q, ge.loopclosure_frames,
                                                      n_det=ge._LC_N_DET)
        packed = reg.dispatch_fused(ge.kf_store, idx, valid, q, ge._uniforms(idx.shape[0]),
                                    ge.loop_closure_inliers)
    rows = registration.fetch_all([packed])[0]
    count = len(ge.keyframes)
    host = ([count + i for i in (-3, -4) if count + i >= 0]
            + ge.lcdb.top_candidates(q, ge.loopclosure_frames))
    print(f"  a scored round of {rows.shape[0]} rows: synchronizing operations in its dispatch "
          f"{len(syncs)} {syncs or ''}", flush=True)
    return syncs, [int(r[19]) for r in rows if r[20] != 0.0], host


def run_summary(ge, work: str) -> dict:
    """What two runs of one configuration must share."""
    log = os.path.join(work, "data", "error_of_transform.log")
    return {"keyframes": [k.frame_index for k in ge.keyframes],
            "lost": open(log).read().split().count("9999"),
            "loop edges": [(e.id1, e.id2) for e in ge.opt.graph.edges if e.robust]}


def scored_phase(kernels, dev, base: str, root: str, traj) -> tuple:
    """run_SLAM_imageonly 29 with scored loop closure and the finalize
    pre-filter, one scored round's dispatch watched for host waits and
    held to the host path's candidates, and the streamed run. Returns the
    launches of each run and the per-frame run (frontend, directory)."""
    from slam3d_gx_torch.cli import run_slam_imageonly, run_slam_streaming

    expect = IMAGE_ONLY_EXPECT
    out = {}
    work = write_run_dir(base, "scored", root, **SCORED)
    out[f"run_SLAM_imageonly {FRAMES - 1} scored"], ge, _ = run_path(
        kernels, run_slam_imageonly.main, work, traj, FRAMES - 1, expect)
    scored_run = (ge, work)
    reg = ge.batch_registrar
    loops = sum(e.robust for e in ge.opt.graph.edges)
    print(f"  keyframes {len(ge.keyframes)} (database {ge.lcdb.count}, capacity "
          f"{ge.lcdb.capacity}), scored rounds {reg.fused}, loop edges {loops}, pairs pruned by "
          f"finalize_prefilter {ge._prefilter_pruned}", flush=True)
    assert ge.lcdb.count == len(ge.keyframes) and reg.fused > 0

    # one more scored round on the final state: its dispatch may not wait
    syncs, picked, host = scored_round_syncs(ge)
    print(f"  candidates {picked}, the host path's {host}", flush=True)
    assert not syncs, f"the dispatch of a scored round synchronized: {syncs}"
    assert picked == host, (picked, host)

    work = write_run_dir(base, "scored_stream", root, detector_name="GFTT", descriptor_name="SIFT",
                         loop_closure_scored=1)
    chunk = 8
    out[f"run_SLAM_streaming {FRAMES - 1} {chunk} imageonly scored"], ge, _ = run_path(
        kernels, run_slam_streaming.main, work, traj, FRAMES - 1, expect,
        argv=[str(FRAMES - 1), str(chunk), "imageonly"])
    print(f"  streamed: keyframes {len(ge.keyframes)}, scored rounds {ge.batch_registrar.fused}, "
          f"loop edges {sum(e.robust for e in ge.opt.graph.edges)}", flush=True)
    assert ge.lcdb.count == len(ge.keyframes) and ge.batch_registrar.fused > 0
    return out, scored_run


def offline_phase(kernels, dev, base: str, root: str, traj, work_image: str, ge_image) -> dict:
    """convert2pcd over the orbit's frames; generateTrajectory and
    saveOutput over the image-only run's keyframe.txt and final graph,
    saveOutput on the card against the CPU."""
    from slam3d_gx_torch.cli import convert2pcd, generate_trajectory, save_output
    from slam3d_gx_torch.config import ParameterReader
    from slam3d_gx_torch.geometry import se3
    from slam3d_gx_torch.io import pcd, tum
    from slam3d_gx_torch.testing import synthetic
    from slam3d_gx_torch.testing.clouds import cloud_agreement

    cwd = os.getcwd()
    work = os.path.join(base, "offline")
    os.makedirs(work)
    for d in ("rgb_index", "dep_index"):
        os.symlink(os.path.join(root, d), os.path.join(work, d))
    kernels.reset_counts()
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        assert convert2pcd.main(["1", str(FRAMES + 1)]) == 0
        t_convert = time.perf_counter() - t0
        xyz, rgba = pcd.read_pcd(os.path.join(work, "pcd", "1.pcd"))
        n_ref = convert2pcd.convert_one("rgb_index/1.png", "dep_index/1.png", "cpu_1.pcd",
                                        device="cpu")
        xyz_c, rgba_c = pcd.read_pcd("cpu_1.pcd")
        os.chdir(work_image)
        assert generate_trajectory.main(["data/keyframe.txt", "data/final_after.g2o"]) == 0
        t0 = time.perf_counter()
        assert save_output.main(["data/keyframe.txt", "data/final_after.g2o"]) == 0
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        assert save_output.fuse_map("data/keyframe.txt", "data/final_after.g2o",
                                    out_path="result_cpu.pcd", device="cpu") == 0
        t_cpu = time.perf_counter() - t0
        leaf = ParameterReader("./parameters.yaml").get_float("grid_leaf")
    finally:
        os.chdir(cwd)
    launches = kernels.launch_counts()
    print(f"  convert2pcd 1 {FRAMES + 1}: {FRAMES} frames in {t_convert:.3f} s; frame 1 "
          f"{len(xyz)} points, the CPU's {n_ref}", flush=True)
    assert len(xyz) == n_ref and np.array_equal(rgba, rgba_c)
    assert np.abs(xyz - xyz_c).max() <= 1e-6

    rows = tum.read_trajectory(os.path.join(work_image, "trajectory.txt"))
    kf = tum.read_keyframes(os.path.join(work_image, "data", "keyframe.txt"))
    stamps = [float(line.split()[0]) for line in open(os.path.join(root, "associate.txt"))]
    assert [ts for ts, _ in rows] == [stamps[f - 1] for _, f in kf]
    ate_file = synthetic.ate_rmse([traj[f - 1] for _, f in kf],
                                  [se3.set_estimate_data(d7) for _, d7 in rows])
    ate_run = synthetic.ate_rmse([traj[k.frame_index - 1] for k in ge_image.keyframes],
                                 [ge_image.opt.vertex_estimate(k.id) for k in ge_image.keyframes])
    print(f"  generateTrajectory: {len(rows)} rows, ATE {ate_file:.9f} m, the run's "
          f"{ate_run:.9f} m", flush=True)
    assert abs(ate_file - ate_run) <= TRAJ_ATE_TOL, (ate_file, ate_run)

    clouds = {}
    for name in ("result.pcd", "result_cpu.pcd"):
        xyz, rgba = pcd.read_pcd(os.path.join(work_image, name))
        clouds[name] = (xyz, np.stack(pcd.unpack_rgba(rgba), -1))
    (xa, ca), (xb, cb) = clouds["result.pcd"], clouds["result_cpu.pcd"]
    share = min(cloud_agreement(xa, ca, xb, cb, leaf), cloud_agreement(xb, cb, xa, ca, leaf))
    print(f"  saveOutput over {len(kf)} keyframes: {len(xa)} fused points on the card in "
          f"{t_card:.3f} s, {len(xb)} on the CPU in {t_cpu:.3f} s; {share:.6f} of the points "
          f"matched (bound {CLOUD_SHARE})", flush=True)
    assert abs(len(xa) - len(xb)) <= CLOUD_COUNT_TOL * len(xb) and share >= CLOUD_SHARE
    return launches


# phase 14: the mesh on the card, as a one-rank NCCL group
MESH_ATE_TOL = 1e-6  # m, the meshed run's ATE against the unmeshed one's
MESH_CG_TOL = 1e-6   # m, the sharded CG solve's poses against the unsharded one's


def mesh_cg(dev, mesh) -> None:
    """The 2,048-vertex CG solve of phase 13 unsharded and through
    optimize_sharded: poses, and the host waits and device operations
    of an LM step both ways."""
    import collections

    from slam3d_gx_torch.parallel import optimize_sharded
    from slam3d_gx_torch.testing import posegraph

    n, seed = CG_CASES[0][:2]
    solved = {}
    for label, m in (("unsharded", None), ("optimize_sharded", mesh)):
        opt, _, _ = posegraph.make_loopy_graph(n, seed=seed, device=dev)
        start = {v: x.T.copy() for v, x in opt.graph.vertices.items()}

        def solve(n_iters):
            for v, T in start.items():
                opt.graph.vertices[v].T = T.copy()
            if m is None:
                return opt.optimize(n_iters=n_iters, solver="cg")
            return optimize_sharded(opt, m, n_iters=n_iters, solver="cg")

        syncs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with sync_sources(syncs):
            chi = solve(15)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        solved[label] = {v: opt.vertex_estimate(v).copy() for v in opt.graph.vertices}
        print(f"  {label}: chi2 {chi:.6g}, wall {wall:.3f} s, LM iterations {opt.last_iters}, "
              f"CG iterations per LM step {opt.last_cg_iters}, host waits {len(syncs)} "
              f"({len(syncs) / opt.last_iters:.2f} per LM step) from "
              f"{dict(collections.Counter(syncs))}", flush=True)
        profiled(f"{label} CG LM step at {n} vertices", lambda: solve(1), reps=2)
    a, b = solved["unsharded"], solved["optimize_sharded"]
    dt = max(np.abs(a[v][:3, 3] - b[v][:3, 3]).max() for v in a)
    print(f"  optimize_sharded against unsharded: poses within {dt:.3g} m (bound {MESH_CG_TOL})",
          flush=True)
    assert dt <= MESH_CG_TOL, dt


def native_io_phase(root: str, ges) -> None:
    """The native library built here and used by the runs' prefetch; its
    loaders' frames against the Python readers', and the decode ms a
    frame both ways."""
    from slam3d_gx_torch import native_io
    from slam3d_gx_torch.io import images, pcd

    t0 = time.perf_counter()
    assert native_io.available(), f"native I/O library not built: {native_io.build_error}"
    print(f"  {os.path.relpath(native_io.lib_path(), REPO)} loaded in "
          f"{time.perf_counter() - t0:.3f} s (built by the first run that read a frame)",
          flush=True)
    for label, ge in ges.items():
        print(f"  {label}: {ge.prefetched} frames from the native prefetch", flush=True)
        assert ge.prefetched >= FRAMES - 2, (label, ge.prefetched)
    idx = range(1, FRAMES + 1)
    gray = [os.path.join(root, "rgb_index", f"{i}.png") for i in idx]
    depth = [os.path.join(root, "dep_index", f"{i}.png") for i in idx]
    clouds = [os.path.join(root, "pcd", f"{i}.pcd") for i in idx]
    t0 = time.perf_counter()
    loaders = [native_io.PrefetchLoader(gray, native_io.MODE_GRAY8, height=H, width=W),
               native_io.PrefetchLoader(depth, native_io.MODE_DEPTH16, height=H, width=W),
               native_io.PrefetchLoader(clouds, native_io.MODE_PCD)]
    native = [tuple(ld.next() for ld in loaders) for _ in idx]
    t_loader = time.perf_counter() - t0
    for ld in loaders:
        ld.close()
    t0 = time.perf_counter()
    for g, d in zip(gray, depth):
        native_io.png_decode(g)
        native_io.png_decode(d, to_gray=False)
    t_decode = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = [(images.read_gray_pil(g), images.read_depth_pil(d), pcd.read_pcd(c))
              for g, d, c in zip(gray, depth, clouds)]
    t_python = time.perf_counter() - t0
    for (g, d, (x, c)), (gp, dp, (xp, cp)) in zip(native, python):
        assert np.array_equal(g, gp) and np.array_equal(d, dp), "native PNG decode differs"
        assert np.array_equal(x, xp) and np.array_equal(c, cp), "native PCD read differs"
    ms = 1e3 / FRAMES
    print(f"  {FRAMES} frames (gray, depth, cloud) equal to the Python readers'; per frame: "
          f"prefetch loaders {t_loader * ms:.3f} ms, native png_decode of gray and depth in "
          f"this thread {t_decode * ms:.3f} ms, Python (PIL and numpy) {t_python * ms:.3f} ms",
          flush=True)


def mesh_phase(kernels, dev, base: str, root: str, traj, scored_run, scored_launches: dict,
               ge_image) -> dict:
    import torch.distributed as dist

    from slam3d_gx_torch.cli import run_slam_imageonly
    from slam3d_gx_torch.parallel import mesh as mesh_mod

    print(card_line(), flush=True)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(base, 'rendezvous')}",
                            world_size=1, rank=0)
    try:
        mesh = mesh_mod.make_mesh(1)
        print(f"  mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, backend "
              f"{dist.get_backend()}", flush=True)
        ge13, work13 = scored_run
        work = write_run_dir(base, "mesh_scored", root, mesh_devices=1, **SCORED)
        out = {}
        label = f"run_SLAM_imageonly {FRAMES - 1} scored, mesh_devices 1"
        out[label], ge, _ = run_path(kernels, run_slam_imageonly.main, work, traj,
                                     FRAMES - 1, IMAGE_ONLY_EXPECT)
        assert ge.mesh is not None and ge.batch_registrar.mesh is ge.mesh
        assert ge.lcdb.mesh is ge.mesh
        got, want = run_summary(ge, work), run_summary(ge13, work13)
        ates = [synthetic_ate(g, traj) for g in (ge, ge13)]
        k3 = [out[label]["min_eig_response"],
              scored_launches[f"run_SLAM_imageonly {FRAMES - 1} scored"]["min_eig_response"]]
        print(f"  meshed against phase 13's unmeshed run: keyframes {len(got['keyframes'])} and "
              f"{len(want['keyframes'])}, lost frames {got['lost']} and {want['lost']}, loop "
              f"edges {len(got['loop edges'])} and {len(want['loop edges'])}, ATE {ates[0]:.9f} "
              f"and {ates[1]:.9f} m, K3 launches {k3[0]} and {k3[1]}", flush=True)
        assert got == want, (got, want)
        assert abs(ates[0] - ates[1]) <= MESH_ATE_TOL, ates
        assert k3[0] == k3[1], k3
        syncs, picked, host = scored_round_syncs(ge)
        assert not syncs, f"the dispatch of a scored round under the mesh synchronized: {syncs}"
        assert picked == host, (picked, host)

        kernels.reset_counts()
        mesh_cg(dev, mesh)
        out["CG under the mesh"] = kernels.launch_counts()
        native_io_phase(root, {"phase 6 run_SLAM_imageonly": ge_image,
                               "phase 13 scored run": ge13, "phase 14 meshed run": ge})
    finally:
        dist.destroy_process_group()
    return out


def synthetic_ate(ge, traj) -> float:
    from slam3d_gx_torch.testing import synthetic

    return synthetic.ate_rmse([traj[k.frame_index - 1] for k in ge.keyframes],
                              [ge.opt.vertex_estimate(k.id) for k in ge.keyframes])


def post_phase(kernels, dev, base: str, root: str, traj, work_image: str, ge_image) -> dict:
    phase("the CG pose-graph solver on the card (make_loopy_graph, n_iters 15)")
    post = {"CG": cg_phase(kernels, dev)}
    phase(f"scored loop closure: run_SLAM_imageonly {FRAMES - 1} (GFTT) with loop_closure_scored 1 "
          "and finalize_prefilter 8, and streamed")
    launches, scored_run = scored_phase(kernels, dev, base, root, traj)
    post.update(launches)
    phase("offline CLIs: convert2pcd, generateTrajectory, saveOutput (card against CPU)")
    post["offline CLIs"] = offline_phase(kernels, dev, base, root, traj, work_image, ge_image)
    phase("the mesh on the card: a one-rank NCCL group, mesh_devices 1, optimize_sharded, "
          "native I/O")
    post.update(mesh_phase(kernels, dev, base, root, traj, scored_run, launches, ge_image))
    return post


def main(argv=()) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from slam3d_gx_torch import kernels
    from slam3d_gx_torch.cli import run_slam, run_slam_imageonly, run_slam_streaming
    from slam3d_gx_torch.kernels import build, equalize, min_eig, refine_lm
    from slam3d_gx_torch.ops import imageproc

    dev = torch.device("cuda")
    phase("card")
    print(card_line(), flush=True)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    phase("build")
    t0 = time.perf_counter()
    reports = build.build_all(kernels.SOURCES)
    print(f"  built {sorted(reports)} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, rep in reports.items():
        print("\n".join(f"  [{name}] {ln}" for ln in rep.strip().splitlines()), flush=True)

    if "--sweep" in argv:
        phase("equalize_hist256: cluster sizes and image sizes")
        sweep_equalize(dev, kernels, equalize)
        phase("min_eig_response: variants and image sizes against the tiled kernel")
        sweep_min_eig(dev, min_eig)
        return 0

    phase("kernels against their plain versions")
    kernels.reset_counts()
    err = check_equalize_kernels(dev, kernels, equalize)
    err["equalize_hist256"] = check_equalize_hist256(dev, kernels, equalize)
    err["min_eig_response"] = check_min_eig(dev, kernels, min_eig)
    err["refine_lm"] = check_refine_lm(dev, kernels, refine_lm)
    timing = time_equalize_kernels(dev, kernels, equalize)
    timing["equalize_hist256"] = time_equalize_hist256(dev, kernels, equalize)
    timing["min_eig_response"] = time_min_eig(dev, kernels, min_eig)
    timing["refine_lm"] = time_refine_lm(dev, refine_lm)

    phase("equalize_hist on the card against the CPU")
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (H, W)), np.clip(rng.normal(60, 9, (H, W)), 0, 255),
                np.full((H, W), 9)):
        x = torch.from_numpy(img.astype(np.uint8))
        got = imageproc.equalize_hist(x.to(dev)).cpu()
        assert torch.equal(got, imageproc.equalize_hist(x)), "equalize_hist differs"
    print("  exact on random, skewed and constant images", flush=True)
    # K1 and K2 run on no path: their launches are those of phases 3 and 4
    off_path = kernels.launch_counts()
    if "--kernels" in argv:
        return 0

    base = tempfile.mkdtemp(prefix="chip_smoke_")
    root, traj = write_dataset(base)
    if "--zoo" in argv:
        zoo_phase(kernels, dev, base, root, traj)
        return 0
    post_only = "--post" in argv

    if not post_only:
        phase("plane path: run_SLAM on a synthetic 640x480 orbit (SIFT)")
        work_planes = write_run_dir(base, "planes", root)
        launches, ge_planes, stats_planes = run_path(
            kernels, run_slam.run, work_planes, traj, FRAMES - 1,
            {"equalize_hist256": True, "histogram256": False, "apply_lut256": False,
             "min_eig_response": False})
        against_jax(ge_planes, work_planes, traj, "a")

    phase("image-only path: run_SLAM_imageonly on the same orbit (GFTT)")
    work_image = write_run_dir(base, "image", root, detector_name="GFTT",
                               descriptor_name="SIFT")
    launches_image, ge_image, stats_image = run_path(
        kernels, run_slam_imageonly.main, work_image, traj, FRAMES - 1,
        {"equalize_hist256": False, "histogram256": False, "apply_lut256": False,
         "min_eig_response": True})
    assert ge_image.image_only and ge_image.params.get_int("loop_closure_batched") == 1
    against_jax(ge_image, work_image, traj, "b")
    assert ge_image.batch_registrar.calls > 0, "the batched verifier was not used"
    if post_only:
        post_phase(kernels, dev, base, root, traj, work_image, ge_image)
        return 0
    launches["min_eig_response"] = launches_image["min_eig_response"]
    launches["refine_lm"] = launches_image["refine_lm"]

    phase("plane path with GFTT, a few frames: equalize_hist256 and K3 once per extraction")
    work_gftt = write_run_dir(base, "planes_gftt", root, detector_name="GFTT",
                              descriptor_name="SIFT")
    run_path(kernels, run_slam.run, work_gftt, traj, 4,
             {"equalize_hist256": True, "histogram256": False, "apply_lut256": False,
              "min_eig_response": True},
             min_keyframes=1)

    phase("per-frame stages, re-run on each path's last frame")
    stage_times(ge_planes, work_planes, rounds=False)
    stage_times(ge_image, work_image, rounds=True)

    chunk = 8
    phase(f"streamed image-only path: run_SLAM_streaming {FRAMES - 1} {chunk} imageonly (GFTT)")
    work = write_run_dir(base, "stream_image", root, detector_name="GFTT",
                         descriptor_name="SIFT")
    _, _, stats = run_path(
        kernels, run_slam_streaming.main, work, traj, FRAMES - 1,
        {"equalize_hist256": False, "histogram256": False, "apply_lut256": False,
         "min_eig_response": True},
        argv=[str(FRAMES - 1), str(chunk), "imageonly"])
    check_streamed(stats, ge_image, stats_image, "image-only", syncs_allowed=False)
    against_jax(stats["graphic_end"], work, traj, "d")

    phase(f"streamed plane path: run_SLAM_streaming {FRAMES - 1} {chunk} planes (SIFT)")
    work = write_run_dir(base, "stream_planes", root)
    _, _, stats = run_path(
        kernels, run_slam_streaming.main, work, traj, FRAMES - 1,
        {"equalize_hist256": True, "histogram256": False, "apply_lut256": False,
         "min_eig_response": False},
        argv=[str(FRAMES - 1), str(chunk), "planes"])
    check_streamed(stats, ge_planes, stats_planes, "planes", syncs_allowed=True)
    against_jax(stats["graphic_end"], work, traj, "e")

    planes = 3
    phase("parity modes: run_SLAM 4 with GFTT, detect_scope plane, plane_image_mode splat, "
          "voxel_downsample_clouds 1")
    work = write_run_dir(base, "parity_modes", root, detector_name="GFTT",
                         descriptor_name="SIFT", max_planes=planes, detect_scope="plane",
                         plane_image_mode="splat", voxel_downsample_clouds=1)
    run_path(kernels, run_slam.run, work, traj, 4,
             {"equalize_hist256": planes, "histogram256": False, "apply_lut256": False,
              "min_eig_response": planes},
             min_keyframes=1)

    zoo = zoo_phase(kernels, dev, base, root, traj)
    post = post_phase(kernels, dev, base, root, traj, work_image, ge_image)

    tpu = "slam3d_gx_tpu/ops/pallas_kernels.py"
    eq_cu = "slam3d_gx_torch/csrc/equalize.cu"
    sources = {"equalize_hist256": (eq_cu, [f"{tpu}:24", f"{tpu}:102"], True),
               "histogram256": (eq_cu, f"{tpu}:24", False),
               "apply_lut256": (eq_cu, f"{tpu}:102", False),
               "min_eig_response": ("slam3d_gx_torch/csrc/min_eig.cu", f"{tpu}:144", True),
               "refine_lm": ("slam3d_gx_torch/csrc/refine_lm.cu", [], True)}
    rows = []
    covered = set()
    for name, (source, replaces, on_path) in sources.items():
        t = timing[name]
        count = launches[name] if on_path else off_path[name]
        assert count > 0, f"{name} was not launched"
        if on_path:
            covered.update([replaces] if isinstance(replaces, str) else replaces)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "ok": True, "on_main_path": on_path, "launches": count,
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "launches_zoo": {path: n[name] for path, n in zoo.items()},
            "launches_post": {path: n[name] for path, n in post.items()},
        })
    missing = {f"{tpu}:{line}" for line in (24, 102, 144)} - covered
    assert not missing, f"no kernel launched on a path replaces {sorted(missing)}"
    print(card_line(), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
