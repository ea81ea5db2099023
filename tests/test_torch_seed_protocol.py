"""The seed protocol: whole 640x480 runs of the port and of the jitted JAX
reference over many scenes and draws, on the CPU (ROADMAP item 12).

Every run is `chip_smoke.py`'s: the 30-frame orbit
(`orbit_trajectory(30, radius=0.25, yaw_amp=0.15)`, 640x480, fx=fy=520)
with the repo's parameters.yaml defaults, `RoomScene(seed=scene)` and the
config key `seed` set to `draws`. The cells are {planes SIFT/SIFT,
image-only GFTT/SIFT} x {per frame, streamed in chunks of 8} over
SCENES x DRAWS. Each package draws from its own stream (JAX keys, a
torch.Generator), so a cell compares two samples of the same process,
not two computations of one sample: that is what the same-draws holds do
(tests/test_torch_wholerun.py, and here `test_same_draws_at_640x480`).
Recorded per run: keyframes, lost frames, ATE and RPE (m) and the CPU
wall (s).

    python tests/test_torch_seed_protocol.py [--workers 6] [--out FILE]

runs the protocol in worker processes (one torch and one XLA thread
each), prints the table of port against JAX, writes every run to FILE
(JSON; by default in its temporary directory) and writes the JAX
package's outcomes for chip_smoke.py's configurations (a), (b), (d) and
(e) (scene 3, draws 0), with the
protocol's largest port-minus-JAX ATE gap of each configuration, to
slam3d_gx_torch/testing/jax_reference_outcomes.json, which chip_smoke.py
reads on the card. The tests are marked slow: tier-1 deselects them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RECORD = os.path.join(REPO, "slam3d_gx_torch", "testing", "jax_reference_outcomes.json")

SCENES = tuple(range(8))
DRAWS = (0, 1)
FRAMES, CHUNK = 30, 8
H, W = 480, 640
INTR = dict(fx=520.0, fy=520.0, cx=320.0, cy=240.0, factor=5000.0)
# name: (image_only, chunk, detector); chip_smoke.py's letters
CONFIGS = {
    "a": (False, None, "SIFT"),   # run_SLAM 29
    "b": (True, None, "GFTT"),    # run_SLAM_imageonly 29
    "d": (True, CHUNK, "GFTT"),   # run_SLAM_streaming 29 8 imageonly
    "e": (False, CHUNK, "SIFT"),  # run_SLAM_streaming 29 8 planes
}
LABELS = {"a": "planes SIFT/SIFT, per frame", "b": "image-only GFTT/SIFT, per frame",
          "d": "image-only GFTT/SIFT, streamed in 8", "e": "planes SIFT/SIFT, streamed in 8"}


def repo_parameters() -> dict:
    """parameters.yaml's keys, as both packages' readers take them."""
    out = {}
    with open(os.path.join(REPO, "parameters.yaml")) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = v.strip()
    return out


def write_scene(base: str, scene: int):
    from slam3d_gx_torch.config import CameraIntrinsics
    from slam3d_gx_torch.testing import synthetic

    root = os.path.join(base, f"scene{scene}")
    traj = synthetic.orbit_trajectory(FRAMES, radius=0.25, yaw_amp=0.15)
    if not os.path.isdir(root):
        synthetic.write_dataset(root, synthetic.RoomScene(seed=scene), traj,
                                CameraIntrinsics(**INTR), height=H, width=W, write_pcd=True)
    return root, traj


def run_cell(package: str, config: str, scene: int, draws: int, base: str,
             replay: bool = False) -> dict:
    """One run; replay: the port on the reference's draws (package "port")."""
    from test_torch_wholerun import jax_run, port_run

    image_only, chunk, detector = CONFIGS[config]
    root, traj = write_scene(base, scene)
    over = dict(repo_parameters(), detector_name=detector, seed=draws,
                **{f"camera_{k}": v for k, v in INTR.items()})
    out = tempfile.mkdtemp(dir=base)
    t0 = time.perf_counter()
    if package == "jax":
        res = jax_run(root, over, FRAMES - 1, image_only, traj, out, chunk)
    else:
        res = port_run(root, over, FRAMES - 1, image_only, traj, out, chunk, replay=replay)
    res["seconds"] = time.perf_counter() - t0
    return res


def _row(res: dict) -> dict:
    return {k: res[k] for k in ("keyframes", "lost", "ate", "rpe", "seconds")}


def _worker_init():
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                               " intra_op_parallelism_threads=1").strip()
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)


def _job(args):
    package, config, scene, draws, base = args
    try:
        row = _row(run_cell(package, config, scene, draws, base))
    except Exception as e:  # recorded and reported; the table leaves the cell out
        row = dict(error=f"{type(e).__name__}: {e}")
    return (package, config, scene, draws), row


def run_protocol(base: str, workers: int, scenes=SCENES, draws=DRAWS, configs=tuple(CONFIGS),
                 partial=None):
    import multiprocessing as mp

    jobs = [(p, c, s, d, base) for c in configs for s in scenes for d in draws
            for p in ("jax", "port")]
    for s in scenes:  # each scene written once, before the workers read it
        write_scene(base, s)
    # the slowest first: the plane runs
    jobs.sort(key=lambda j: (CONFIGS[j[1]][0], j[0] == "jax"))
    results = {}
    with mp.get_context("spawn").Pool(workers, initializer=_worker_init) as pool:
        for key, row in pool.imap_unordered(_job, jobs):
            if partial is not None:
                with open(partial, "a") as f:
                    f.write(json.dumps([list(key), row]) + "\n")
            if "error" in row:
                print(f"  {key}: {row['error']}", flush=True)
                continue
            results[key] = row
            print(f"  {key}: keyframes {len(row['keyframes'])}, lost {len(row['lost'])}, ATE "
                  f"{row['ate']:.6f} m, {row['seconds']:.1f} s", flush=True)
    return results


def gaps(results: dict) -> dict:
    """Per configuration, the largest port-minus-JAX ATE over its cells."""
    out = {}
    for c in CONFIGS:
        g = [results[("port", c, s, d)]["ate"] - results[("jax", c, s, d)]["ate"]
             for (p, cc, s, d) in results if p == "jax" and cc == c
             and ("port", c, s, d) in results]
        if g:
            out[c] = max(g)
    return out


def table(results: dict) -> str:
    """The markdown table of PERF.md: per configuration and cell, port
    against JAX."""
    lines = ["| config | scene | draws | keyframes port / JAX | lost port / JAX | "
             "ATE port / JAX (m) | RPE port / JAX (m) |", "|---|---|---|---|---|---|---|"]
    for c in CONFIGS:
        cells = sorted({(s, d) for (p, cc, s, d) in results if cc == c})
        for s, d in cells:
            pr, jr = results.get(("port", c, s, d)), results.get(("jax", c, s, d))
            if pr is None or jr is None:
                continue
            lines.append(f"| ({c}) | {s} | {d} | {len(pr['keyframes'])} / {len(jr['keyframes'])} | "
                         f"{len(pr['lost'])} / {len(jr['lost'])} | {pr['ate']:.4f} / "
                         f"{jr['ate']:.4f} | {pr['rpe']:.4f} / {jr['rpe']:.4f} |")
    return "\n".join(lines)


def protocol_summary(results: dict) -> str:
    import numpy as np

    lines = ["| config | runs | mean ATE port / JAX (m) | median | worse than 0.05 m port / JAX | "
             "mean lost port / JAX | mean keyframes port / JAX | port ATE above JAX's |",
             "|---|---|---|---|---|---|---|---|"]
    for c in CONFIGS:
        keys = [(s, d) for (p, cc, s, d) in results if p == "jax" and cc == c
                and ("port", c, s, d) in results]
        if not keys:
            continue
        pa = np.array([results[("port", c, s, d)]["ate"] for s, d in keys])
        ja = np.array([results[("jax", c, s, d)]["ate"] for s, d in keys])
        pl = [len(results[("port", c, s, d)]["lost"]) for s, d in keys]
        jl = [len(results[("jax", c, s, d)]["lost"]) for s, d in keys]
        pk = [len(results[("port", c, s, d)]["keyframes"]) for s, d in keys]
        jk = [len(results[("jax", c, s, d)]["keyframes"]) for s, d in keys]
        lines.append(f"| ({c}) {LABELS[c]} | {len(keys)} | {pa.mean():.4f} / {ja.mean():.4f} | "
                     f"{np.median(pa):.4f} / {np.median(ja):.4f} | {(pa > 0.05).sum()} / "
                     f"{(ja > 0.05).sum()} | {np.mean(pl):.2f} / {np.mean(jl):.2f} | "
                     f"{np.mean(pk):.2f} / {np.mean(jk):.2f} | {(pa > ja).sum()} of {len(keys)} |")
    return "\n".join(lines)


def record(results: dict) -> dict:
    """The JAX outcomes of chip_smoke.py's configurations (scene 3, draws
    0) and the protocol's largest gap of each."""
    g = gaps(results)
    out = {"source": "tests/test_torch_seed_protocol.py (JAX package jitted on the CPU)",
           "orbit": f"RoomScene(seed=3), orbit_trajectory({FRAMES}, radius=0.25, yaw_amp=0.15), "
                    f"{W}x{H}, fx=fy=520, parameters.yaml defaults, seed 0",
           "configs": {}}
    for c in CONFIGS:
        jr = results[("jax", c, 3, 0)]
        out["configs"][c] = dict(label=LABELS[c], keyframes=jr["keyframes"], lost=jr["lost"],
                                 ate=jr["ate"], rpe=jr["rpe"], max_port_gap=g.get(c))
    return out


# -- the slow tests ------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("config", list(CONFIGS))
def test_jax_record_is_reproduced(config, tmp_path):
    """The committed record against a fresh JAX run: keyframes and lost
    frames exact, ATE and RPE within 1e-4 m."""
    with open(RECORD) as f:
        want = json.load(f)["configs"][config]
    got = run_cell("jax", config, 3, 0, str(tmp_path))
    assert got["keyframes"] == want["keyframes"] and got["lost"] == want["lost"]
    assert got["ate"] == pytest.approx(want["ate"], abs=1e-4)
    assert got["rpe"] == pytest.approx(want["rpe"], abs=1e-4)


@pytest.mark.slow
@pytest.mark.parametrize("scene", [3, 0])
def test_same_draws_at_640x480(scene, tmp_path):
    """Image-only per frame at full size, the port on the reference's
    draws: held frame by frame as tests/test_torch_wholerun.py holds the
    320x240 runs."""
    from test_torch_wholerun import hold

    from test_torch_wholerun import summary as run_summary

    ref = run_cell("jax", "b", scene, 0, str(tmp_path))
    port = run_cell("port", "b", scene, 0, str(tmp_path), replay=True)
    print("\n" + run_summary(f"image-only 640x480, scene {scene}", port, ref,
                             (port["seconds"], ref["seconds"])))
    hold(port, ref)


@pytest.mark.slow
def test_seed_protocol(tmp_path):
    """The whole protocol: every run ends with a finite ATE."""
    import math

    results = run_protocol(str(tmp_path), workers=6)
    assert len(results) == 2 * len(CONFIGS) * len(SCENES) * len(DRAWS)
    assert all(math.isfinite(r["ate"]) for r in results.values())
    print(protocol_summary(results))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--out", help="the runs as JSON (default: seed_protocol.json in the "
                    "protocol's temporary directory)")
    ap.add_argument("--scenes", type=int, nargs="*", default=list(SCENES))
    ap.add_argument("--draws", type=int, nargs="*", default=list(DRAWS))
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS))
    ap.add_argument("--no-record", action="store_true",
                    help="do not rewrite the committed JAX record")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(0, REPO)
    base = tempfile.mkdtemp(prefix="seed_protocol_")
    args.out = args.out or os.path.join(base, "seed_protocol.json")
    t0 = time.perf_counter()
    results = run_protocol(base, args.workers, args.scenes, args.draws, args.configs,
                           partial=args.out + ".partial")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump([dict(package=p, config=c, scene=s, draws=d, **row)
                   for (p, c, s, d), row in sorted(results.items())], f, indent=1)
    print(table(results))
    print()
    print(protocol_summary(results))
    print(f"\nlargest port-minus-JAX ATE gap per configuration: {gaps(results)}")
    print(f"protocol CPU wall {time.perf_counter() - t0:.1f} s with {args.workers} workers; "
          f"runs in {args.out}")
    if not args.no_record:
        with open(RECORD, "w") as f:
            json.dump(record(results), f, indent=1)
            f.write("\n")
        print(f"wrote {RECORD}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
