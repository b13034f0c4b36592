"""``atlasvae_torch.utils.profiling`` as tests/test_aux.py:10-27 holds the
JAX package's: the step timer's report line, a trace written to disk with
a named span in it."""

import json
import os

import torch

from atlasvae_torch.utils.profiling import StepTimer, annotate, trace


def test_step_timer_sync_and_report(capsys):
    timer = StepTimer("op")
    for _ in range(3):
        with timer:
            out = StepTimer.sync({"x": [torch.ones(64, 64) @ torch.ones(64, 64)]})
    assert len(timer.times) == 3 and torch.is_tensor(out["x"][0])
    line = timer.report(items_per_step=64)
    assert "op: median" in line and "items/s" in line and "over 3 steps" in line
    assert line in capsys.readouterr().out
    assert StepTimer("empty").report() == ""


def test_trace_writes_files(tmp_path):
    with trace(tmp_path / "trace") as prof:
        with annotate("matmul"):
            StepTimer.sync(torch.ones(32, 32) @ torch.ones(32, 32))
    files = [os.path.join(d, f) for d, _, fs in os.walk(tmp_path) for f in fs]
    assert len(files) == 1
    with open(files[0]) as f:
        names = {event.get("name") for event in json.load(f)["traceEvents"]}
    assert "matmul" in names
    assert any(e.key == "matmul" for e in prof.key_averages())
    with trace(tmp_path / "off", enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
