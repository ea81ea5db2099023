"""CPU tests of the benchmark harness (slambench/).

    python -m pytest slambench/tests -q

Most run the harness on the CPU at a small copy of a cell (160x120 or
320x240, a short sequence), which skips run.py's look for a card and
drives the rest of a run. The test marked `cuda` needs a card and skips
without one.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from slambench.harness import bench, check, plants, roofline, scene  # noqa: E402

DATA_DIRS = ("configs", "traffic", "drivers", "metrics", "checks")
SMALL = {  # 160x120: the fr1 intrinsics scaled by a quarter
    "bench_image_height": "120", "bench_image_width": "160", "camera_fx": "129.25",
    "camera_fy": "129.25", "camera_cx": "79.65", "camera_cy": "63.825",
    "max_keypoints": "128", "ransac_hypotheses": "64"}
MEDIUM = {  # 320x240, half the intrinsics
    "bench_image_height": "240", "bench_image_width": "320", "camera_fx": "258.5",
    "camera_fy": "258.5", "camera_cx": "159.3", "camera_cy": "127.65",
    "max_keypoints": "256", "ransac_hypotheses": "128"}


def make_root(dst, sizes: dict, frames: int, warm: int) -> str:
    """A copy of the benchmark's data files (not its code) with every
    configuration set to `sizes` and the traffic to `frames` frames."""
    root = str(dst)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for d in DATA_DIRS:
        shutil.copytree(os.path.join(ROOT, "slambench", d), os.path.join(root, "slambench", d))
    cdir = os.path.join(root, "slambench", "configs")
    for name in os.listdir(cdir):
        path = os.path.join(cdir, name)
        with open(path) as f:
            text = f.read()
        for k, v in sizes.items():
            text = re.sub(rf"^{k}: .*$", f"{k}: {v}", text, flags=re.M)
        with open(path, "w") as f:
            f.write(text)
    tdir = os.path.join(root, "slambench", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as f:
            t = json.load(f)
        t.update(frames=frames, warm_frames=warm)
        with open(path, "w") as f:
            json.dump(t, f)
    return root


def run(root, cell, seconds=4.0, trace=False, plant=None, seed=3000000123, log=sys.stderr):
    torch.set_num_threads(2)
    return bench.run_cell(root, cell, seed, seconds, trace, time.perf_counter(), device="cpu",
                          plant=plants.Plant(plant) if plant else None, log=log)


def info_line(text: str) -> dict:
    """sessions, lost_by_session and window_s of a run's info line."""
    line = [ln for ln in text.splitlines() if re.match(r"slambench: \S+ seed \d+: ", ln)][-1]
    lost = re.search(r"lost_by_session \[([^\]]*)\]", line).group(1)
    return {"sessions": int(re.search(r" sessions (\d+),", line).group(1)),
            "lost_by_session": [int(x) for x in lost.split(",") if x.strip()],
            "window_s": float(re.search(r" window_s ([0-9.]+),", line).group(1))}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("small"), SMALL, frames=14, warm=6)


def test_every_cell_resolves_by_name():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for w in spec["workloads"]:
        cell = bench.Cell(ROOT, w["name"])
        assert cell.metrics(False) and cell.metrics(True)
        assert hasattr(cell.driver, "run_session")
        assert cell.limits


def test_new_cell_from_new_files_only(tmp_path):
    """A configuration, a traffic mix, a driver and a per-layer metric
    added as new files (and entries in BENCHMARK.json) run without an
    edit to any file that is there."""
    root = make_root(tmp_path, SMALL, frames=10, warm=4)
    data = os.path.join(root, "slambench")
    shutil.copy(os.path.join(data, "configs", "fr1-imageonly-gftt.yaml"),
                os.path.join(data, "configs", "fr1-imageonly-new.yaml"))
    shutil.copy(os.path.join(data, "checks", "fr1-imageonly-gftt.json"),
                os.path.join(data, "checks", "fr1-imageonly-new.json"))
    with open(os.path.join(data, "traffic", "loop5x30x2.json")) as f:
        mix = json.load(f)
    mix.update(driver="perframe_new", laps=1, sessions=1)
    with open(os.path.join(data, "traffic", "onelap.json"), "w") as f:
        json.dump(mix, f)
    shutil.copy(os.path.join(data, "drivers", "perframe.py"),
                os.path.join(data, "drivers", "perframe_new.py"))
    with open(os.path.join(data, "metrics", "frames_seen.py"), "w") as f:
        f.write("def read(run):\n    return float(run.frames)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    spec["configs"].append(dict(spec["configs"][0], name="fr1-imageonly-new",
                                file="slambench/configs/fr1-imageonly-new.yaml"))
    spec["workloads"].append({"name": "new-cell", "config": "fr1-imageonly-new",
                              "traffic": "onelap", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "device_ms_per_frame", "workloads": ["new-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = bench.Cell(root, "new-cell")
    assert cell.traffic["laps"] == 1
    assert "frames_seen" in [m[0] for m in cell.metrics(True)]
    out = run(root, "new-cell", seconds=2.0, trace=True)
    assert out["metrics"]["frames_seen"]["value"] >= 10


def test_generator_repeats_for_a_seed_and_differs_across_seeds():
    cam = {"fx": 129.25, "fy": 129.25, "cx": 79.65, "cy": 63.825, "factor": 5000.0,
           "height": 120, "width": 160}
    poses = scene.multi_loop_trajectory(3, 2, 0.25, 0.15, 0.03)
    cpu = torch.device("cpu")
    g1, d1 = scene.render_sequence(0, 2**31 + 7, poses, cam, 2.0, cpu)
    g2, d2 = scene.render_sequence(0, 2**31 + 7, poses, cam, 2.0, cpu)
    g3, d3 = scene.render_sequence(0, 2**31 + 8, poses, cam, 2.0, cpu)
    g4, _ = scene.render_sequence(1, 2**31 + 7, poses, cam, 2.0, cpu)
    assert torch.equal(g1, g2) and torch.equal(d1, d2)
    assert not torch.equal(g1, g3)  # another run's sensor noise
    assert (g1.int() - g3.int()).abs().float().mean() < 4  # ... on the same room
    assert not torch.equal(g1, g4)  # another room
    assert torch.equal(d1, d3)  # depth is the room's geometry, not the run's
    assert g1.dtype == torch.uint8 and int(d1.min()) > 0


def test_run_seed_draws_the_rooms_the_noise_and_the_draws():
    tags = ("room0", "room1", "noise0", "noise1", "ransac0", "warm")
    one = [bench.drawn(2**31 + 11, t) for t in tags]
    assert one == [bench.drawn(2**31 + 11, t) for t in tags]
    assert len(set(one)) == len(tags)  # every use its own seed
    other = [bench.drawn(2**31 + 12, t) for t in tags]
    assert all(a != b for a, b in zip(one, other))
    assert all(0 <= x < 2**63 for x in one + other)
    assert 0 <= bench.drawn(2**70 + 3, "ransac0", 31) < 2**31


@pytest.mark.parametrize("n_seq", [1, 2, 3])
def test_window_holds_whole_passes_of_the_same_draws(n_seq):
    """Pass p's session j runs sequence j with the draws tagged ransac{j}
    for every p, and a window whose time runs out after t sessions have
    begun holds the whole passes that those sessions began."""
    for p in range(4):
        for j in range(n_seq):
            assert bench.session_plan(p * n_seq + j, n_seq) == (j, f"ransac{j}")
    for t in range(3 * n_seq + 2):
        k = 0
        while bench.runs_session(k, n_seq, k < t):
            k += 1
        assert k == max(1, -(-t // n_seq)) * n_seq


def test_roofline_byte_counts_at_480x640():
    assert roofline.equalize_bytes(480, 640) == 614_400
    assert roofline.min_eig_bytes(480, 640) == 1_536_000
    assert roofline.bound_s(614_400) == pytest.approx(0.1834e-6, rel=1e-3)
    assert roofline.bound_s(1_536_000) == pytest.approx(0.4585e-6, rel=1e-3)


def test_result_line_shape(small_root):
    out = run(small_root, "imageonly-gftt-perframe")
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"setup_s"}  # device_ms_per_frame needs a card
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_later_passes_repeat_the_first(small_root):
    """One seed with `seconds` 0 runs one pass; with time for two or more,
    the window holds whole passes whose lost frames repeat pass 0's, so
    the share of frames lost is the same."""
    cell = bench.Cell(small_root, "imageonly-gftt-perframe")
    n_seq = int(cell.traffic["sessions"])
    log = io.StringIO()
    one = run(small_root, "imageonly-gftt-perframe", seconds=0.0, log=log)
    first = info_line(log.getvalue())
    assert first["sessions"] == n_seq and len(first["lost_by_session"]) == n_seq
    log = io.StringIO()
    more = run(small_root, "imageonly-gftt-perframe", seconds=2 * first["window_s"], log=log)
    again = info_line(log.getvalue())
    assert again["sessions"] % n_seq == 0 and again["sessions"] >= 2 * n_seq
    assert again["lost_by_session"] == first["lost_by_session"] * (again["sessions"] // n_seq)
    assert one["correct"] is True and more["correct"] is True
    assert more["attempted"] == one["attempted"] * again["sessions"] // n_seq
    assert more["failed"] * one["attempted"] == one["failed"] * more["attempted"]


def test_traced_line_has_per_layer_metrics(small_root):
    out = run(small_root, "imageonly-gftt-perframe", seconds=1.0, trace=True)
    assert out["correct"] is True
    assert {"frames_per_s_traced", "multipnp_ms", "extract_ms", "read_ms",
            "optimize_s"} <= set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_device_ms_per_frame_reads_the_union_of_device_intervals():
    from slambench.harness import trace
    dev = [(0, 100, "a"), (50, 150, "b"), (400, 500, ""), (900, 1200, "c")]
    assert trace.busy_seconds(dev, 0, 1000) == pytest.approx(350e-9)
    reader = bench.load_module(os.path.join(ROOT, "slambench", "metrics",
                                            "device_ms_per_frame.py"))

    class Run:
        frames, window_busy_s = 300, 3.6

    assert reader.read(Run) == pytest.approx(12.0)
    Run.window_busy_s = None  # nothing collected: left out, never 0
    assert reader.read(Run) is None


def test_without_a_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                        "imageonly-gftt-perframe", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax", "jax.numpy", "jaxlib.xla", "flax.linen", "slam3d_gx_tpu.ops",
             "slam3d_gx_torch", "slam3d_gx_torch.ops", "jaxtyping", "flaxen", "numpy"]
    assert bench.forbidden(names) == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla",
                                      "slam3d_gx_tpu.ops"]


def test_a_run_loads_no_jax(small_root):
    code = ("import sys, time; sys.path.insert(0, %r)\n"
            "from slambench.harness import bench\n"
            "bench.run_cell(%r, 'imageonly-gftt-perframe', 5, 1.0, False, time.perf_counter(),"
            " device='cpu')\n"
            "print(bench.forbidden(sys.modules))\n") % (ROOT, small_root)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("plant", ["bf16ref", "altered", "unchanged"])
def test_control_and_faults_fail_small(small_root, plant):
    out = run(small_root, "imageonly-gftt-perframe", seconds=6.0, plant=plant)
    assert out["correct"] is False


@pytest.fixture(scope="module")
def medium_root(tmp_path_factory):
    """320x240, one 60-frame session of 2 laps of 30: the batched
    verifier accepts registrations and meets plainly registrable pairs."""
    root = make_root(tmp_path_factory.mktemp("medium"), MEDIUM, frames=60, warm=4)
    path = os.path.join(root, "slambench", "traffic", "loop5x30x2.json")
    with open(path) as f:
        mix = json.load(f)
    mix.update(laps=2, sessions=1)
    with open(path, "w") as f:
        json.dump(mix, f)
    return root


@pytest.mark.parametrize("plant", ["half_batch", "half_reject"])
def test_half_batch_faults_fail(medium_root, plant):
    """The batched verifier answering half a batch with the other half's
    rows, or leaving that half out as rejected."""
    out = run(medium_root, "imageonly-gftt-perframe", seconds=1.0, plant=plant)
    assert out["correct"] is False
    if plant == "half_reject":
        assert out["checks"]["missed_share"]["value"] > out["checks"]["missed_share"]["limit"]


def test_decisions_hold_on_medium(medium_root):
    """The program's own run at 320x240 passes, with registrable pairs of
    both kinds checked."""
    stats = {}
    real = check.Checker.registrations

    def kept(self, recs, seed):
        stats.update(real(self, recs, seed))
        return stats

    check.Checker.registrations = kept
    try:
        out = run(medium_root, "imageonly-gftt-perframe", seconds=1.0)
    finally:
        check.Checker.registrations = real
    assert out["correct"] is True
    assert out["checks"]["missed_share"]["value"] == 0.0
    assert stats["frames_unknown"] == 0  # every registration's frames are known
    assert min(stats["registrable"]) > 0


@pytest.mark.cuda
def test_tf32_control_fails_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    root = make_root(tmp_path, MEDIUM, frames=24, warm=4)
    out = bench.run_cell(root, "imageonly-gftt-perframe", 7, 1.0, False, time.perf_counter(),
                         plant=plants.Plant("tf32"))
    assert out["correct"] is False
