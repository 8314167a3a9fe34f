"""The readings above the limits, on a card: the precision control (the
plain reference computed with TF32 on, put in the program's place) and the
program with a fault planted underneath (the map left unchanged; B1 handing
MO or LO a wrong neighbour) must each fail one of the cell's numbers, read
against the reference in float32 with TF32 off, as the configuration
states.  At the cell's own sizes, over its judged frames."""

import pytest

from conftest import ROOT
from vbench import spec

CELLS = ["klt.street1", "orb.street1"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, card):
    from control import FAULTS, readings
    c = spec.load_cell(ROOT, cell)
    got = readings(c, 2**31 + 99, card, control=True)
    gap_limits = {k: v for k, v in c.limits.items() if k.endswith("_gap_m")}
    for variant in ("tf32",) + tuple(FAULTS):
        assert any(got[variant][k] > v for k, v in gap_limits.items()), (variant, got[variant])
    assert all(got["program"][k] <= v for k, v in gap_limits.items()), got["program"]
