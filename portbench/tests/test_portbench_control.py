"""Each cell's control comes out not correct: the cell's own comparison
and limits, at the cell's own sizes on the card, three seeds.  The
controls: the program's int8 path for bf16 serving, the reference in
float8 for bf16 training, the reference with its int8 sites in int4 for
int8 serving."""

from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests.toy import manifest

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_control_is_not_correct(cuda, cell):
    seconds = 0.01 if harness.load_cell(cell).workload["driver"] == "train_step" else 1.0
    for seed in SEEDS:
        result = harness.run(cell, seed, seconds, False, control=True)
        assert not result["correct"], (seed, result["checks"])
