"""The control (the reference with its graphs solved in float32) fails
the cell's limits: at a size a test run holds, 150 frames on one
seed. On the card machine it runs at the cell's size
(python3 -m gslam_bench.control, PERF.md)."""
import pytest
import torch

from gslam_bench import compare, control


@pytest.mark.parametrize("cell", ["beams11.office"])
def test_control_fails(cell):
    torch.set_num_threads(2)
    nums = control.control_numbers(cell, 2147483659, 150)
    limits = compare.load_cell_file(cell)["limits"]
    assert not compare.judge(nums, limits), nums


def test_reference_agrees_with_itself():
    """The reference twice in float64 compares equal: the control's gap
    is the precision's, not the replay's."""
    torch.set_num_threads(2)
    from gslam_bench import generator, run
    from gslam_bench.reference import replay
    import tempfile

    _, cell, cfg, tr = run.load_cell("beams11.office")
    d = tempfile.mkdtemp()
    run.write_dataset(d, "office", cfg, generator.make_traffic(tr, 8))
    a = replay(d, "office", [100], cleanup=False)[100]
    b = replay(d, "office", [100], cleanup=False)[100]
    assert all(v == 0.0 for v in compare.compare(a, b).values())
