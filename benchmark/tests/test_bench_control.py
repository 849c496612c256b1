"""The control, the plain reference computed with bfloat16 products and put
in the program's place, fails the comparison of every cell, while the
program passes it on the same inputs (tiny sizes on the CPU; the readings
at the cells' own sizes on the card are in PERF.md)."""

import pytest

from conftest import CELLS

from benchmark import control, harness


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(tiny_root, cell):
    spec = harness.load_cell(tiny_root, cell)
    row = control.readings(spec, 987654321987, "cpu", control=True)
    assert harness.judged(row["program"], spec.limits)[0] is True, row["program"]
    assert harness.judged(row["control"], spec.limits)[0] is False, row["control"]
