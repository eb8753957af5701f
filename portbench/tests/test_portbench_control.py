"""The output check's control: the reference computed with bfloat16
results in the program's place must come out not correct, and the
program correct. At a size a test run holds on the CPU, and (marked
`gpu`) at each cell's own size on the card."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
sys.path[:0] = [str(ROOT), str(BENCH / "reference")]

from portbench import control, harness  # noqa: E402

CELLS = ("disney.frame512", "disney.hd")


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes_tiny(cell):
    limits = harness.cell_spec(cell)["check"]["limits"]
    over = {"xres": 16, "yres": 9, "tile_pixels": 40,
            "check": dict(harness.cell_spec(cell)["check"], blocks=2,
                          block=4)}
    (row,) = control.readings(cell, [2 ** 31 + 5], device="cpu",
                              overrides=over)
    assert not fails(row["program"], limits), row
    assert fails(row["control"], limits), row


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    return torch.cuda.get_device_name(0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(card, cell):
    limits = harness.cell_spec(cell)["check"]["limits"]
    (row,) = control.readings(cell, [2 ** 31 + 9], device="cuda")
    assert not fails(row["program"], limits), row
    assert fails(row["control"], limits), row
