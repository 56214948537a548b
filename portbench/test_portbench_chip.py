"""The control on the card: the reference in fp8 put in the program's place
fails one of each cell's numbers against the float32 reference, on three
seeds, at the CPU tests' cut size (a test run holds it; the cells' own
sizes are read by ``portbench/calibrate.py``).  Skips where there is no
card.

    python -m pytest -q -m cuda portbench/test_portbench_chip.py
"""

import pytest
import torch

from portbench import calibrate, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    limits = spec.limits(cell)
    for seed in (4_000_000_001, 4_000_000_002, 4_000_000_003):
        out = calibrate.reading(cell, seed, card, "control", cut=True,
                                traffic_over={"seq_len": 512, "rows": 2})
        # the numbers the cell compares (those with a limit)
        over = [k for k, v in out["checks"].items()
                if k in limits and not v["value"] <= v["limit"]]
        assert over and not out["correct"], (seed, out["checks"])
