"""The control comes out not correct, on the card: the program with its
float32 matrix products in TF32, at a size a test run holds. The full-size
readings that set the limits come from control.py (see PERF.md)."""

import pytest
import torch

import run
from conftest import small_cell


@pytest.mark.card
@pytest.mark.parametrize("cell,size", [("nyx512.bfp.roundtrip", 256),
                                       ("mdr384.zlib.progressive", 192)])
def test_control_fails_and_program_passes(card, tmp_path, cell, size):
    spec, name, roots = small_cell(tmp_path, cell, size)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        sound, _ = run.run_cell(spec, name, 2**31 + 21, 2.0, False, card,
                                roots=roots)
        control, _ = run.run_cell(spec, name, 2**31 + 21, 2.0, False, card,
                                  roots=roots, tf32=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32[0]
        torch.set_float32_matmul_precision(tf32[1])
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
