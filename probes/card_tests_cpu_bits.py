#!/usr/bin/env python3
"""Run the card tests and then probes/cpu_bits.py's measurement in the same
process (ROADMAP Queue 3: the CPU side of
tests/test_torch_cuda_kernels.py::test_vae_apply_on_cuda_matches_cpu, which
goes astray only late in a long pytest process on the chip machine).

    python3 probes/card_tests_cpu_bits.py [--calls 20] [-- pytest arguments]

Runs ``pytest.main`` over the card tests (``--noconftest -m cuda``, the
README's command) with a plugin that reads the process-wide float32 settings
(``cpu_bits.precision_state``) after each test and records every test after
which they changed, and the outcome of test_vae_apply_on_cuda_matches_cpu.
Then, in the same process, ``cpu_bits.measure``: the test's CPU side
``--calls`` times under each thread count and mkldnn setting, each against
float64.  Prints one JSON object as its last line.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import cpu_bits  # noqa: E402

CARD_TESTS = ["tests/test_torch_cuda_kernels.py", "tests/test_torch_cuda_stats.py"]


class StateWatch:
    """pytest plugin: the settings after each test, where they changed."""

    def __init__(self):
        self.state = cpu_bits.precision_state()
        self.changes, self.outcomes = [], {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.outcomes[report.nodeid] = report.outcome
        if report.when != "teardown":
            return
        now = cpu_bits.precision_state()
        if now != self.state:
            self.changes.append(dict(after=report.nodeid, before=self.state, now=now))
            self.state = now


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("pytest_args", nargs="*")
    args = ap.parse_args()
    watch = StateWatch()
    start = dict(watch.state)
    code = int(pytest_main(args.pytest_args or ["--noconftest", "-q", "-m", "cuda",
                                                "-p", "no:cacheprovider", *CARD_TESTS], watch))
    failed = sorted(k for k, v in watch.outcomes.items() if v == "failed")
    vae = {k: v for k, v in watch.outcomes.items() if "test_vae_apply_on_cuda_matches_cpu" in k}
    report = dict(pytest_exit=code, tests=len(watch.outcomes), failed=failed,
                  vae_apply_test=vae, state_at_start=start, state_changes=watch.changes)
    print("[card_tests] " + json.dumps(report), flush=True)
    report["cpu_bits"] = cpu_bits.measure(args.calls)
    print(json.dumps(report))
    return 0


def pytest_main(args, plugin):
    import pytest
    return pytest.main(args, plugins=[plugin])


if __name__ == "__main__":
    sys.exit(main())
