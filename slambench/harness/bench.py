"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name under `<root>/slambench/`:
configs/<config>.yaml (the parameters as run and the benchmark's
`bench_*` keys), traffic/<mix>.json (the sequence; its "driver" names
drivers/<driver>.py), metrics/<metric>.py (one reader per metric) and
checks/<config>.json (the numbers `correct` compares and their limits).
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import types

FORBIDDEN = {"jax", "jaxlib", "flax", "slam3d_gx_tpu"}


def forbidden(module_names) -> list:
    """The names whose top-level package, compared whole, is JAX's or the
    JAX package's (slam3d_gx_torch and jaxtyping are not)."""
    return sorted(n for n in module_names if n.split(".")[0] in FORBIDDEN)


def load_module(path: str):
    name = "slambench_" + os.path.splitext(os.path.basename(path))[0].replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_config(path: str) -> tuple:
    """(parameters, bench keys) of a configuration file: flat `key: value`
    lines, `#` comments; keys starting with `bench_` are the benchmark's,
    the rest are written to the session's parameters.yaml."""
    params, bench = {}, {}
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if ":" not in line:
                continue
            key, _, value = line.partition(":")
            key, value = key.strip(), value.strip()
            (bench if key.startswith("bench_") else params)[key] = value
    return params, bench


class Cell:
    """A workload of BENCHMARK.json with its files resolved."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.spec = found[0]
        self.name = name
        data = os.path.join(root, "slambench")
        self.params, self.keys = read_config(
            os.path.join(data, "configs", self.spec["config"] + ".yaml"))
        with open(os.path.join(data, "traffic", self.spec["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(data, "checks", self.spec["config"] + ".json")) as f:
            self.limits = json.load(f)
        self.driver = load_module(os.path.join(data, "drivers", self.traffic["driver"] + ".py"))
        self.data = data
        self.cam = {"fx": float(self.params["camera_fx"]), "fy": float(self.params["camera_fy"]),
                    "cx": float(self.params["camera_cx"]), "cy": float(self.params["camera_cy"]),
                    "factor": float(self.params["camera_factor"]),
                    "height": int(self.keys["bench_image_height"]),
                    "width": int(self.keys["bench_image_width"])}

    def metrics(self, trace: bool) -> list:
        """(name, unit, reader) of the metrics this cell reports."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [(m["name"], m["unit"],
                 load_module(os.path.join(self.data, "metrics", m["name"] + ".py")))
                for m in group if self.name in m.get("workloads", [self.name])]


class Context:
    """What a driver uses: the device, the frontend class, a synchronize,
    and `instrument`, which attaches the recorder (and in traced runs
    the spans, and in calibration the planted fault) to a new frontend."""

    def __init__(self, device, frontend_cls, spans=None, plant=None):
        self.device = device
        self.frontend_cls = frontend_cls
        self.spans = spans
        self.plant = plant
        self.recorder = None

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def instrument(self, ge, optimizer):
        if self.plant is not None:
            self.plant.frontend(ge)
        self.recorder.attach(ge)
        if self.spans is not None:
            self.spans.attach(ge, optimizer)


def _lost_frames(workdir: str) -> int:
    path = os.path.join(workdir, "data", "error_of_transform.log")
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return sum(1 for line in f if line.strip() == "9999")


def drawn(seed: int, tag: str, bits: int = 63) -> int:
    """A seed of `bits` bits for one use (`tag`) within a run, drawn from
    the run's --seed: the same --seed gives the same seeds, any whole
    number (also past 64 bits) is taken."""
    h = hashlib.blake2b(f"{seed}/{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> (64 - bits)


def session_plan(k: int, n_seq: int) -> tuple:
    """(sequence, tag of its RANSAC draws) of a window's session k. A pass
    is the traffic's n_seq sessions, session j over sequence j with the
    draws tagged ransac{j}; every pass repeats the first."""
    j = k % n_seq
    return j, f"ransac{j}"


def runs_session(k: int, n_seq: int, time_left: bool) -> bool:
    """Whether the window runs its session k: all of the first pass, the
    rest of a pass once begun, and a new pass only while time is left."""
    return k < n_seq or k % n_seq != 0 or time_left


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool, t_start: float,
             device=None, plant=None, log=sys.stderr, readings=False) -> dict:
    """One run; returns the result object (see run.py), its last key
    "checks". With `readings` (calibration only) it adds "readings": the
    control's and a state-left-unchanged fault's numbers, read on the
    same run's outputs."""
    import torch
    from slam3d_gx_torch import frontend
    from slam3d_gx_torch.ops.features import sift_desc

    from . import check, dataset, hooks, scene
    from . import trace as trace_mod

    cell = Cell(root, name)
    device = torch.device(device or "cuda")
    frontend_cls = {"imageonly": frontend.GraphicEnd2}[cell.keys["bench_frontend"]]
    traffic = cell.traffic
    frames = int(traffic["frames"])
    n_seq = int(traffic["sessions"])
    poses = scene.multi_loop_trajectory(frames, traffic["laps"], traffic["radius"],
                                        traffic["yaw_amp"], traffic["drift"])
    spans = hooks.Spans(sync=device.type == "cuda") if trace else None
    ctx = Context(device, frontend_cls, spans, plant)

    # the descriptor pass reports its keypoints and output to the recorder
    describe = sift_desc.sift_descriptors

    def recorded_describe(img, kps):
        out = describe(img, kps)
        ctx.recorder.note_describe(kps, out)
        return out

    sift_desc.sift_descriptors = recorded_describe
    tmp_root = tempfile.mkdtemp(prefix="slambench-", dir=os.environ.get("TMPDIR"))
    try:
        # -- set-up: the sequences on the device, the TUM layout, one warm
        # session. Sequence k is the traffic's trajectory through a room
        # whose textures, and a sensor noise, are drawn from --seed.
        stages = {"imports": time.perf_counter() - t_start}
        t = time.perf_counter()
        seqs = []
        for k in range(n_seq):
            gray, depth = scene.render_sequence(drawn(seed, f"room{k}"), drawn(seed, f"noise{k}"),
                                                poses, cell.cam, traffic["noise_sigma"], device)
            d = os.path.join(tmp_root, f"frames{k}")
            os.makedirs(d)
            dataset.write_tum(d, gray, depth, poses)
            seqs.append((d, gray, depth))
        stages["frames"] = time.perf_counter() - t
        t = time.perf_counter()

        def session_dir(label: str, seq: int, ransac_seed: int) -> str:
            # the RANSAC draws of a session come from the configuration's
            # `seed` key (the reference system draws anew each run)
            d = os.path.join(tmp_root, label)
            os.makedirs(d)
            params = dict(cell.params, data_source=seqs[seq][0], seed=ransac_seed)
            with open(os.path.join(d, "parameters.yaml"), "w") as f:
                f.writelines(f"{k}: {v}\n" for k, v in params.items())
            return d

        ctx.recorder = hooks.Recorder()
        if spans is not None:
            ctx.spans = None  # the warm session carries no spans
        cell.driver.run_session(ctx, session_dir("warm", 0, drawn(seed, "warm", 31)),
                                int(traffic["warm_frames"]))
        ctx.spans = spans
        stages["warm_session"] = time.perf_counter() - t
        if plant is not None:
            plant.window_start()
        setup_s = time.perf_counter() - t_start
        print("slambench: set-up " + ", ".join(f"{k} {v:.2f} s" for k, v in stages.items()),
              file=log)

        # -- the window: whole passes back to back. A pass is one session
        # over each of the traffic's sequences (session_plan); a new pass,
        # with the same sequences and draws as the first, starts only
        # while `seconds` have not passed, and none is cut. So a run does
        # whole copies of one piece of work drawn from its seed, and a
        # faster program does more copies of it, not other work. An
        # untraced run collects the device activity of the whole window
        # (device_ms_per_frame); a traced one profiles its first session
        # alone, under the spans.
        sessions, events = [], None
        whole = (contextlib.nullcontext(None) if trace
                 else trace_mod.profiled(device.type == "cuda", names=False))
        with whole as window_events:
            t0 = time.perf_counter()
            q0 = time.time_ns()
            deadline = t0 + seconds
            while runs_session(len(sessions), n_seq, time.perf_counter() < deadline):
                k = len(sessions)
                seq, tag = session_plan(k, n_seq)
                ctx.recorder = hooks.Recorder()
                workdir = session_dir(f"s{k}", seq, drawn(seed, tag, 31))
                if trace and not sessions:
                    with trace_mod.profiled(device.type == "cuda") as events:
                        p0 = time.time_ns()
                        w0 = time.perf_counter()
                        s = cell.driver.run_session(ctx, workdir, frames)
                        prof_wall = time.perf_counter() - w0
                        p1 = time.time_ns()
                else:
                    s = cell.driver.run_session(ctx, workdir, frames)
                ge = s.pop("ge")
                s.update(workdir=workdir, recorder=ctx.recorder,
                         edges=list(ge.opt.graph.edges), seq=seq, lost=None)
                del ge
                sessions.append(s)
            window_s = time.perf_counter() - t0
            q1 = time.time_ns()
        if plant is not None:
            plant.window_end()
        memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        bad = forbidden(list(sys.modules))
        if bad:
            raise SystemExit(f"slambench: forbidden modules loaded: {bad}")

        run = types.SimpleNamespace(
            setup_s=setup_s, window_s=window_s, cam=cell.cam,
            frames=sum(s["frames"] for s in sessions),
            walls=[w for s in sessions for w in s["walls"]],
            finalize=[s["finalize_s"] for s in sessions],
            spans=dict(spans.seconds) if spans is not None else {}, trace=None,
            window_busy_s=None, window_ops=None)
        if window_events:
            run.window_busy_s = trace_mod.busy_seconds(window_events, q0, q1)
            run.window_ops = len(window_events)
        del window_events
        if events is not None:
            t_red = time.perf_counter()
            run.trace = trace_mod.reduce(events, spans.intervals, p0, p1)
            run.trace.update(window_s=prof_wall, frames=sessions[0]["frames"])
            del events
            print(f"slambench: trace of {run.trace['frames']} frames reduced in "
                  f"{time.perf_counter() - t_red:.1f} s", file=log)
        for s in sessions:
            s["lost"] = _lost_frames(s["workdir"])
        if device.type == "cuda":
            torch.cuda.empty_cache()

        # -- the check, on the program's outputs, after the window
        t_check = time.perf_counter()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        checker = check.Checker(
            cell.cam, gftt=cell.params["detector_name"].strip().upper() == "GFTT",
            optimize_step=int(cell.params["optimize_step"]),
            error_threshold=float(cell.params["error_threshold"]), poses=poses,
            limits=cell.limits)
        recs = [(s["recorder"], seqs[s["seq"]][1], seqs[s["seq"]][2]) for s in sessions]
        numbers = {}
        numbers.update(checker.extraction(
            recs, control_dtype=plant.control_dtype if plant else None))
        numbers.update(checker.registrations([r for r, _, _ in recs], seed))
        numbers.update(checker.backend(sessions))
        correct, rows = checker.verdict(numbers)
        numbers["check_s"] = time.perf_counter() - t_check
        extra = None
        if readings:
            extra = {"control_bf16ref": checker.extraction(recs, control_dtype=torch.bfloat16),
                     "fault_unchanged": checker.backend(sessions, unchanged=True)}

        metrics = {}
        for mname, unit, reader in cell.metrics(trace):
            v = reader.read(run)
            if v is not None:
                metrics[mname] = {"value": v, "unit": unit}
        out = {"correct": correct, "attempted": run.frames,
               "failed": sum(s["lost"] for s in sessions), "metrics": metrics,
               "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                          "kind": (torch.cuda.get_device_name(device)
                                   if device.type == "cuda" else "cpu"),
                          "count": int(cell.spec["chips"]),
                          "memory_peak_bytes": int(memory_peak)}}
        if run.trace is not None:
            out["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
            out["breakdown"] = {"device_ops": run.trace["device_ops"],
                                "idle_gaps": run.trace["idle_gaps"]}
        info = {"sessions": len(sessions),
                "lost_frames": out["failed"],
                "lost_by_session": [s["lost"] for s in sessions],
                "registrations_checked": numbers.get("registrations_checked"),
                "decisions_checked": numbers.get("decisions_checked"),
                "registrable": numbers.get("registrable"),
                "frames_unknown": numbers.get("frames_unknown"),
                "sessions_checked": numbers.get("sessions_checked"),
                "window_s": round(window_s, 3), "host_frames_per_s": run.frames / window_s,
                "window_busy_s": run.window_busy_s, "window_ops": run.window_ops,
                "check_s": round(numbers["check_s"], 3)}
        print(f"slambench: {name} seed {seed}: " + ", ".join(f"{k} {v}" for k, v in info.items()),
              file=log)
        for k, v, lim in rows:
            print(f"check {k} {v!r} limit {lim!r}", file=log)
        if extra is not None:
            out["readings"] = extra
        out["checks"] = {k: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                         for k, v, lim in rows}
        return out
    finally:
        sift_desc.sift_descriptors = describe
        shutil.rmtree(tmp_root, ignore_errors=True)
