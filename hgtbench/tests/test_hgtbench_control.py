"""The control (the reference with K1's scores saturating at 127, an
8-bit lane) must come out as not correct against the exact reference:
at a tiny size on the CPU here, at the cells' own sizes on the card
(python3 -m hgtbench.control)."""

import pytest
import torch

from hgtbench import check, control, registry


@pytest.mark.parametrize("cell_name", ["tiny.kmer", "tiny.direct"])
def test_control_fails_the_check(tiny_bench, tmp_path, cell_name):
    spec, d = tiny_bench
    cell = registry.Cell(spec, cell_name, d)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        nums = control.control_numbers(cell.config, cell.traffic, 2**31 + 9,
                                       torch.device("cpu"),
                                       str(tmp_path / "w"))
    finally:
        torch.set_num_threads(n)
    assert nums["alignments"] > check.LIMIT, nums
