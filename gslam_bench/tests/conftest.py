"""Shared by the harness's CPU tests."""
import copy

import pytest

from gslam_bench import run


@pytest.fixture
def one_lap(monkeypatch):
    """Runs of the harness on the CPU replay the cell's log over one lap
    of its tour instead of all of them: a window holds whole sessions,
    and a session of the whole log takes minutes on the CPU."""
    load = run.load_cell

    def load_one_lap(name):
        bench, cell, config, traffic = load(name)
        traffic = copy.deepcopy(traffic)
        traffic["sim"]["laps"] = 1
        return bench, cell, config, traffic

    monkeypatch.setattr(run, "load_cell", load_one_lap)
