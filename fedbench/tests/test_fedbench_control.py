"""On the card, at each cell's own size: the control (the reference in
the program's place with TF32 on, one precision below the configuration's
float32) and the half-batch fault fail a limit, and the program passes
every limit, on three seeds. Skips where no card is present.

    python3 -m pytest fedbench/tests/test_fedbench_control.py -m gpu
"""

import pytest
import torch

from fedbench import calibrate, check, spec

pytestmark = pytest.mark.gpu
CELLS = ("gpt2-sketch-w4", "gpt2-uncompressed-w4")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("name", CELLS)
def test_control_and_fault_fail_program_passes(card, name):
    c = spec.cell(name)
    for seed in (9101, 9102, 9103):
        r = calibrate.readings(c, seed, faults=True)
        assert check.verdict(r["sound"], c.limits)[0], r
        assert not check.verdict(r["control"], c.limits)[0], r
        assert not check.verdict(r["half_batch"], c.limits)[0], r
