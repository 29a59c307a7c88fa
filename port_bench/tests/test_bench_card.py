"""On the card, at each cell's own size: the control (the reference in
the program's place, its convolutions in float8) comes out not correct,
and a run of the program on a seed no limit was set from comes out
correct. Run on the chip: ``python3 -m pytest port_bench/tests -m card``."""

import pytest

from port_bench.controls import fp8
from port_bench.harness import run_cell

CELLS = ["custom_b64.train", "custom_b64.serve_streams8"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    r = run_cell(cell, 4000000099, 2.0, False, hooks={"control_quant": fp8})
    assert r["correct"] is False, r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(card, cell):
    r = run_cell(cell, 4000000098, 2.0, False)
    assert r["correct"] is True, r["checks"]
