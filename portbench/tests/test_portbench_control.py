"""The control, the reference computed one step below the configuration's
precision, comes out not correct under each cell's limits while the
program comes out correct, on the card at a size a test run holds (three
cameras of 240x320, 8-frame chunks).  ``portbench/control.py`` reads the
same at the cells' own sizes.  On the card: ``pytest portbench/tests -m
card``; elsewhere the ``card`` fixture skips them (the marker is left
unregistered: a conftest here would shadow the suite's ``conftest``)."""
import sys
from pathlib import Path

# the harness and the port, after everything else on the path: these
# tests share their processes with the repository's own
for _p in (Path(__file__).resolve().parents[1],
           Path(__file__).resolve().parents[2] / "src"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

import pytest  # noqa: E402

import control  # noqa: E402
from harness import check, spec  # noqa: E402


@pytest.fixture
def card():
    """Skips without a CUDA card, decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the chip)")


CELLS = ["static9-paper", "adaptive9-links"]
SMALL = dict(n_streams=3, frame_hw=(240, 320), chunk_frames=8)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_card_control_fails_where_the_program_passes(card, name):
    cell = spec.find_cell(name)
    r = control.readings(cell, 2 ** 31 + 77, 1.0, True, shrink=SMALL)
    assert check.judge(r["lower"], cell.limits)[0], r
    assert not check.judge(r["upper"], cell.limits)[0], r
