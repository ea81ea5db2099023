#!/usr/bin/env python3
"""Smoke run of the PyTorch port (slam3d_gx_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:
1. the card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build every CUDA kernel of the main path from slam3d_gx_torch/csrc
   (one nvcc per source, all started together) and print ptxas' report;
3. hold each kernel exactly equal to its plain PyTorch version on the
   card (480x640, a constant image, an image with empty bins, ragged
   37x53 and 1x1), then time kernel, plain version and one PyTorch
   library call on the card (torch.profiler's device times, median of
   200 calls after warm-up), and one wrapper call on the stream with
   CUDA events;
4. `equalize_hist` on the card against the plain CPU path, exactly;
5. the main path: `run_SLAM 29` (slam3d_gx_torch.cli.run_slam.run) over a
   synthetic 30-frame 640x480 orbit with the repo's parameters.yaml
   defaults (SIFT/SIFT, 512 keypoints, 256 hypotheses, loop closure on),
   with every kernel's launch count set to 0 just before it and read
   just after; checks the four output files, the keyframe count, ATE
   against the ground truth (< 0.05 m) and that each kernel ran once per
   frame extraction;
6. the per-frame stages (extract, multiPnP) re-run on the last frame:
   wall ms, device-busy ms and device operations per call.

Prints a `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {...}}`. Without a CUDA device it exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
    does not count. Returns (ms, method); when the profiler records no
    device activity, falls back to CUDA events around each call, which
    then include the host's launch gaps."""
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
        return us / 1e3, "profiler"
    return event_ms(fn, calls), "events"


def event_ms(fn, calls: int = 200) -> float:
    """Median of CUDA-event times around each call: what one call costs
    the stream, launch gaps included."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(calls)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernels(dev, kernels, equalize):
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


def time_kernels(dev, kernels, equalize):
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
        ms, how = device_ms(kernel)
        rows[name] = dict(ms=ms, plain_ms=device_ms(plain)[0], library_ms=device_ms(library)[0],
                          bound_ms=b, bound_by=by, stream_ms=event_ms(kernel))
        r = rows[name]
        print(f"  {name} at {H}x{W} ({how}): kernel {r['ms'] * 1e3:.3f} us, plain "
              f"{r['plain_ms'] * 1e3:.3f} us, library {r['library_ms'] * 1e3:.3f} us, bound "
              f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}); one wrapper call on the "
              f"stream {r['stream_ms'] * 1e3:.3f} us", flush=True)
    return rows


def write_run_dir(work: str, intr_kw: dict) -> tuple:
    from slam3d_gx_torch.config import CameraIntrinsics
    from slam3d_gx_torch.testing import synthetic

    intr = CameraIntrinsics(**intr_kw)
    root = os.path.join(work, "dataset")
    traj = synthetic.orbit_trajectory(FRAMES, radius=0.25, yaw_amp=0.15)
    synthetic.write_dataset(root, synthetic.RoomScene(seed=3), traj, intr,
                            height=H, width=W, write_pcd=True)
    with open(os.path.join(REPO, "parameters.yaml")) as f:
        text = f.read()
    # the repo's defaults, then this dataset and its intrinsics (the
    # parameter reader lets a later key win)
    text += "\n# chip_smoke: synthetic dataset\n"
    text += f"data_source: {root}\n"
    text += "".join(f"camera_{k}: {v}\n" for k, v in intr_kw.items())
    with open(os.path.join(work, "parameters.yaml"), "w") as f:
        f.write(text)
    return traj


def run_main_path(kernels):
    from slam3d_gx_torch.cli import run_slam
    from slam3d_gx_torch.io import tum
    from slam3d_gx_torch.testing import synthetic

    intr_kw = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0, factor=5000.0)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    cwd = os.getcwd()
    traj = write_run_dir(work, intr_kw)
    os.chdir(work)
    try:
        stats = {}
        kernels.reset_counts()
        t0 = time.perf_counter()
        rc = run_slam.run(argv=[str(FRAMES - 1)], stats=stats)
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
    loops = sum(1 for _ in open(lc_path)) if os.path.exists(lc_path) else 0
    lost = open(os.path.join(data, "error_of_transform.log")).read().split().count("9999")
    frame_ms = [s * 1e3 for s in stats["frame_seconds"]]
    print(f"  frames {len(frame_ms) + 1}, extractions {ge.extractions}, keyframes {len(kf)}, "
          f"loop closures {loops}, lost frames {lost}, graph edges {len(ge.opt.graph.edges)}, "
          f"LM iterations {ge.opt.last_iters}", flush=True)
    print(f"  ATE {ate:.6f} m (bound {ATE_BOUND_M}), per-frame run() median "
          f"{statistics.median(frame_ms):.3f} ms (max {max(frame_ms):.3f}), whole run "
          f"{wall:.3f} s", flush=True)
    print(f"  launches in the main path: {launches}", flush=True)
    for name in ("final.g2o", "final_after.g2o", "keyframe.txt", "error_of_transform.log"):
        assert os.path.getsize(os.path.join(data, name)) > 0, name
    assert len(kf) == len(ge.keyframes) >= 2, (len(kf), len(ge.keyframes))
    feats = ge.keyframes[-1].features
    assert feats.desc.device.type == "cuda" and feats.uv.device.type == "cuda"
    for k, v in launches.items():
        assert v >= ge.extractions, f"{k}: {v} launches for {ge.extractions} extractions"
    assert np.isfinite(ate) and ate < ATE_BOUND_M, ate
    return launches, ge, work


def stage_times(ge, work, reps: int = 5):
    """The per-frame stages re-run on the main path's last frame: median
    synchronized wall ms, the device-busy ms inside one call (kernels,
    memsets and copies that torch.profiler records) and the number of
    device operations it launches."""
    from torch.profiler import ProfilerActivity, profile

    from slam3d_gx_torch.frontend.state import result_to_host

    cwd = os.getcwd()
    os.chdir(work)
    try:
        ge.index -= 1  # the last frame of the run
        ge.readimage()
        feats = ge._extract_present()
    finally:
        os.chdir(cwd)
    stages = {
        "extract": ge._extract_present,
        "multipnp": lambda: result_to_host(ge.multipnp(ge.keyframes[-1].features, feats, 12)),
    }
    for name, fn in stages.items():
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from slam3d_gx_torch import kernels
    from slam3d_gx_torch.kernels import build, equalize
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

    phase("kernels against their plain versions")
    err = check_kernels(dev, kernels, equalize)
    timing = time_kernels(dev, kernels, equalize)

    phase("equalize_hist on the card against the CPU")
    rng = np.random.default_rng(2)
    for img in (rng.integers(0, 256, (H, W)), np.clip(rng.normal(60, 9, (H, W)), 0, 255),
                np.full((H, W), 9)):
        x = torch.from_numpy(img.astype(np.uint8))
        got = imageproc.equalize_hist(x.to(dev)).cpu()
        assert torch.equal(got, imageproc.equalize_hist(x)), "equalize_hist differs"
    print("  exact on random, skewed and constant images", flush=True)

    phase("main path: run_SLAM on a synthetic 640x480 orbit")
    launches, ge, work = run_main_path(kernels)

    phase("per-frame stages, re-run on the last frame")
    stage_times(ge, work)

    rows = []
    for name in ("histogram256", "apply_lut256"):
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": "slam3d_gx_torch/csrc/equalize.cu",
            "replaces": {"histogram256": "slam3d_gx_tpu/ops/pallas_kernels.py:24",
                         "apply_lut256": "slam3d_gx_tpu/ops/pallas_kernels.py:102"}[name],
            "ok": True, "launches": launches[name], "max_abs_err": err[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
