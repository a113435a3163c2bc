"""On the card: one short run of every cell, and its control, at the
cell's own size (python -m pytest portbench/tests -m cuda on the card)."""

import pytest

from benchlib import catalog


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["sedov_dgp1.64", "mm_sod_dgp1.64"])
def test_cell_and_control_on_the_card(cell, card):
    from benchlib.check import LOWER
    from benchlib.harness import run_cell

    r = run_cell(cell, 2**31 + 7, 3.0)
    assert r["correct"], r["checks"]
    lower = LOWER[catalog.cell(cell)["config"]["precision"]]
    c = run_cell(cell, 2**31 + 7, 3.0, control_dtype=lower)
    assert not c["correct"], c["checks"]
