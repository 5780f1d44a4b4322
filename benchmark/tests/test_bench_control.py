"""The control on the card, at the cells' own size and load: the program's
own int8 path must come out not correct, and the program as the
configuration states it (bf16) correct, on three seeds each (the click
cell: every round of a session of each canvas size; the NoC cells: a
chunk's rounds). Runs only on the card:

    python3 -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_control.py
"""
from __future__ import annotations

import pytest
import torch

from benchmark import control


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell,seconds", [("vitb448_click", 4.0),
                                          ("vith448_noc_b8", 1.0),
                                          ("vitb448_noc_b16", 1.0)])
def test_control_fails_and_program_passes(cell, seconds):
    dev = _card()
    for seed in (101, 102, 103):
        assert control.readings(cell, seed, seconds, "program",
                                dev)["correct"]
        assert not control.readings(cell, seed, seconds, "int8",
                                    dev)["correct"]
