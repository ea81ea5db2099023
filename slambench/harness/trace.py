"""Reduce a torch.profiler trace of one session to what the metrics read.

The arithmetic of `chip_smoke.py`'s `profiled()` (device-busy time and
device operations from the profiler's device events around a
synchronized call), extended to a whole session: the union of the device
intervals gives the busy seconds (overlapping operations count once),
every kernel, copy and memset counts as one device operation, and the
idle gaps between the busy intervals are charged to the innermost
benchmark span (hooks.Spans) that the host was in, or to "host".

Only device activity is collected: with the host's operations as well, a
plane session's millions of events slowed it by half and took minutes to
read back.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch


@contextlib.contextmanager
def profiled(cuda: bool, names: bool = True):
    """torch.profiler's device activity (CUPTI) around the block; yields a
    list that receives (start ns, end ns, name) of every device operation
    (kernel, copy, memset) at the end, on the wall clock ("" for the name
    without `names`). Without `cuda` (a CPU run) nothing is collected."""
    out = []
    if not cuda:
        yield out
        return
    from torch.autograd import profiler as autograd_profiler
    p = autograd_profiler.profile(use_cpu=False, use_device="cuda", use_kineto=True)
    cfg, acts = p.config(), p.kineto_activities
    torch.autograd._prepare_profiler(cfg, acts)
    torch.autograd._enable_profiler(cfg, acts)
    try:
        yield out
    finally:
        cuda = torch.autograd.DeviceType.CUDA
        for e in torch.autograd._disable_profiler().events():
            if e.device_type() == cuda and not e.is_user_annotation():
                s = e.start_ns()
                out.append((s, s + e.duration_ns(), e.name() if names else ""))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(dev, t0_ns: int, t1_ns: int) -> float:
    """Seconds of [t0_ns, t1_ns) in which some device operation of `dev`
    ((start ns, end ns, name) each) ran: the union of their intervals."""
    clipped = [(max(s, t0_ns), min(e, t1_ns)) for s, e, _ in dev if e > t0_ns and s < t1_ns]
    return sum(e - s for s, e in _union(clipped)) * 1e-9


def _innermost_segments(spans, t0, t1):
    """[(start, end, name)] covering [t0, t1): the innermost span open at
    each instant ('host' where none is)."""
    marks = sorted([(s, 1, -(e - s), name) for s, e, name in spans]
                   + [(e, 0, 0, name) for s, e, name in spans])
    open_spans, segs, t = [], [], t0
    for tm, kind, neg_len, name in marks:
        tm = min(max(tm, t0), t1)
        if tm > t:
            segs.append((t, tm, open_spans[-1] if open_spans else "host"))
            t = tm
        if kind:
            open_spans.append(name)
        elif name in open_spans:
            open_spans.reverse()
            open_spans.remove(name)
            open_spans.reverse()
    if t < t1:
        segs.append((t, t1, open_spans[-1] if open_spans else "host"))
    return segs


def reduce(dev, spans, t0_ns: int, t1_ns: int, top: int = 10) -> dict:
    """dev: device operations, spans: benchmark spans, each (start ns,
    end ns, name) on the wall clock, of the window [t0_ns, t1_ns).
    Returns busy_s, ops, kernels {name: [seconds]}, and the breakdown's
    device_ops and idle_gaps (seconds by name, largest first, at most
    `top` each)."""
    dev = [(max(s, t0_ns), min(e, t1_ns), n) for s, e, n in dev if e > t0_ns and s < t1_ns]
    busy = _union([(s, e) for s, e, _ in dev])
    kernels = defaultdict(list)
    for s, e, n in dev:
        kernels[n].append((e - s) * 1e-9)
    gaps, t = [], t0_ns
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < t1_ns:
        gaps.append((t, t1_ns))
    segs = _innermost_segments(spans, t0_ns, t1_ns)
    starts = [s for s, _, _ in segs]
    idle = defaultdict(float)
    for gs, ge in gaps:
        k = max(0, bisect.bisect_right(starts, gs) - 1)
        while k < len(segs) and segs[k][0] < ge:
            s, e, name = segs[k]
            idle[name] += (min(e, ge) - max(s, gs)) * 1e-9
            k += 1
    by_time = sorted(((n, sum(v)) for n, v in kernels.items()), key=lambda x: -x[1])
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "ops": len(dev),
        "kernels": dict(kernels),
        "device_ops": [[n, v] for n, v in by_time[:top]],
        "idle_gaps": [[n, v] for n, v in sorted(idle.items(), key=lambda x: -x[1])[:top]],
    }
