"""The port's debug checks and profiling helpers (slam3d_gx_torch/utils/
debug.py, profiling.py), the cases of tests/test_utils.py:12-66:

- `checked` catches a NaN and names the op, passes clean input with its
  output; `strict` raises; `strict` on the port's match_nn runs clean
  (its inf masking is a constant, not a fault); an index out of bounds
  is caught before the op runs;
- StageTimer writes the same `stage seconds` rows as the JAX package's;
- trace() writes a Chrome trace.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam3d_gx_torch.ops import match
from slam3d_gx_torch.utils import debug, profiling
from slam3d_gx_tpu.utils import profiling as jax_profiling


def test_checked_catches_nan():
    err, out = debug.checked(torch.log)(torch.tensor([-1.0]))
    assert "nan generated by aten.log" in err.get()
    with pytest.raises(debug.CheckError):
        err.throw()


def test_checked_passes_clean():
    err, out = debug.checked(lambda x: x * 2.0)(torch.tensor([1.0, 2.0]))
    err.throw()
    assert err.get() is None
    np.testing.assert_allclose(out.numpy(), [2.0, 4.0])


@pytest.mark.parametrize("fn, x, what", [
    (torch.sqrt, [-4.0], "nan generated by aten.sqrt"),
    (lambda x: 1.0 / x, [0.0, 1.0], "inf generated by"),
    (lambda x: torch.log(x) * 2 + 1, [-1.0], "nan generated by aten.log"),
], ids=["sqrt", "division", "first_op"])
def test_strict_raises(fn, x, what):
    with pytest.raises(debug.CheckError, match=what):
        debug.strict(fn)(torch.tensor(x))


def test_strict_on_pipeline_op():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    v = torch.ones(32, dtype=torch.bool)
    out = debug.strict(lambda x: match.match_nn(x, v, x, v)[1])(a)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("fn, what", [
    (lambda x, i: x[i], "aten.index.Tensor: index 7 outside [-5, 5)"),
    (lambda x, i: x.index_select(0, i), "aten.index_select.default: index 7 outside [0, 5)"),
    (lambda x, i: torch.gather(x, 0, i), "aten.gather.default: index 7"),
], ids=["index", "index_select", "gather"])
def test_checked_index_out_of_bounds(fn, what):
    x = torch.arange(5.0)
    err, out = debug.checked(fn)(x, torch.tensor([1, 7]))
    assert out is None and what in err.get()
    err, out = debug.checked(fn)(x, torch.tensor([1, 4]))
    assert err.get() is None and out.tolist() == [1.0, 4.0]


def _rows(timer_cls, log, sync):
    t = timer_cls(log)
    with t.stage("ExtractPlane"):
        _ = sum(range(1000))
    t.start("RANSAC")
    t.stop(sync)
    t.write()
    return [r.split() for r in open(log).read().strip().splitlines()]


def test_stage_timer_schema(tmp_path):
    rows = _rows(profiling.StageTimer, str(tmp_path / "time.log"), torch.ones(4))
    jax_rows = _rows(jax_profiling.StageTimer, str(tmp_path / "jax.log"), jnp.ones(4))
    assert [r[0] for r in rows] == [r[0] for r in jax_rows] == ["ExtractPlane", "RANSAC"]
    assert all(len(r) == 2 and float(r[1]) >= 0 for r in rows)


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("SLAM3D_TRACE_DIR", str(tmp_path / "env"))
    with profiling.trace() as d:
        _ = torch.ones(8) * 2
    assert d == str(tmp_path / "env")
    with profiling.trace(str(tmp_path / "tr")) as d:
        _ = torch.ones(8) * 2
    for where in (tmp_path / "env", tmp_path / "tr"):
        with open(os.path.join(where, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        assert any("mul" in e.get("name", "") for e in events)
