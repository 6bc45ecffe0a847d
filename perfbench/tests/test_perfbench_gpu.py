"""On the card: each cell's control comes out not correct, at the cell's
own size, on three seeds, and the program's timed path comes out correct
on the same seeds.

The control is the reference put in the program's place and computed in
the next precision down from the configuration's float32 with TF32 off:
TF32 products (``perfbench.tests.readings``). It has to fail at least
one of the cell's limits on every seed.

    python -m pytest perfbench/tests -q -m gpu
"""
from __future__ import annotations

import pytest

from perfbench.tests.readings import readings

SEEDS = (101, 2**31 + 3, 987654321)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["flagship-serve-b8", "tts-train-b16"])
def test_control_fails_and_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for r in readings(cell, SEEDS):
        lim = r["limits"]
        assert all(r["program"][k] <= lim[k] for k in lim), r
        assert any(r["control"][k] > lim[k] for k in lim), r
