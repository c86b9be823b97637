"""On a card: each cell's command once, short, with a fresh seed; the
last line is the result and it is correct.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from gpubench import harness

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", name, "--seed",
         str(2 ** 31 + 97), "--seconds", "2", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["device"]["busy_s"] > 0
