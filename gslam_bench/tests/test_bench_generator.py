"""The generator's copy writes the committed sim logs byte for byte."""
import filecmp
import os

import pytest

from gslam_bench import generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.parametrize("traffic,seed,dataset", [
    ("office", 2, "sim-office"),
    ("loops", 5, "sim-loops"),
    ("corridor", 9, "sim-corridor"),
])
def test_committed_logs(tmp_path, traffic, seed, dataset):
    sim = generator.make_traffic(generator.load_json("traffic", traffic),
                                 seed)
    out = tmp_path / f"{dataset}.log"
    generator.write_carmen_log(str(out), sim)
    assert filecmp.cmp(out, os.path.join(ROOT, "datasets", dataset,
                                         f"{dataset}.log"), shallow=False)


def test_seed_of_any_size():
    """Seeds beyond 32 and 64 bits and below 0 give logs; the same seed
    the same log, another seed another."""
    t = generator.load_json("traffic", "corridor")
    a = generator.make_traffic(t, 2 ** 31 + 11)
    b = generator.make_traffic(t, 2 ** 31 + 11)
    c = generator.make_traffic(t, 2 ** 70 + 3)
    d = generator.make_traffic(t, -5)
    assert (a["odom"] == b["odom"]).all() and (a["scans"] == b["scans"]).all()
    assert not (a["odom"] == c["odom"]).all()
    assert len(a["times"]) == len(c["times"]) == len(d["times"]) == 608
