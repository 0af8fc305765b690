"""The check against faults planted under the timed path, and the
lower-precision control: each comes out not correct. The control's run on
the card, at the cell's size, is hevcbench/control.py; here it runs on the
CPU at a test's size, and once more on the card where one is present."""

import pytest

from hevcbench import run
from hevcbench.tests.helpers import small_cell

SEED = 2 ** 31 + 78
CELLS = ["ai720_cu16.qp32", "ippp720_fpel.ldp_qp32"]


def _run(name, fault, device="cpu"):
    import torch
    torch.set_num_threads(1)
    return run.run_cell(small_cell(name), SEED, 1.0, False, device=device,
                        fault=fault)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_a_planted_fault_is_not_correct(name, fault):
    res = _run(name, fault)
    assert res["correct"] is False, res["limits"]


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_is_not_correct(name):
    res = _run(name, "bf16")
    assert res["correct"] is False
    assert res["limits"]["mismatch"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_is_not_correct_on_the_card(card, name):
    res = _run(name, "bf16", device=card)
    assert res["correct"] is False
    assert res["limits"]["mismatch"]["value"] > 0
