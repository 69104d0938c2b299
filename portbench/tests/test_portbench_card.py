"""One short run of each cell on the card (marked ``cuda``; skips here)."""

import json
import subprocess
import sys

import pytest

from pb_helpers import CELLS
from portbench import spec


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name,
                          "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert "setup_s" in line["metrics"]
