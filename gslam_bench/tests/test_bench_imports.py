"""No run and no reference loads jax, jaxlib, flax or the JAX package
(compared by whole top-level names); the reference loads nothing of the
port either."""
import os
import subprocess
import sys
import types

from gslam_bench import run
from gslam_bench.compare import CHECKS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_whole_name_check():
    assert run.forbidden_modules(["sparse_gslam_tpu_torch",
                                  "sparse_gslam_tpu_torch.ops.grid",
                                  "jax_like", "numpy"]) == []
    assert run.forbidden_modules(["sparse_gslam_tpu.ops", "jax.numpy",
                                  "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "sparse_gslam_tpu"]


def _child(code: str) -> str:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["OMP_NUM_THREADS"] = "2"
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.strip().splitlines()[-1]


def test_reference_loads_no_program():
    """The reference's replay of a short log, alone in a process."""
    last = _child(
        "import sys, tempfile\n"
        "from gslam_bench import generator, run\n"
        "from gslam_bench.reference import replay\n"
        "_, cell, cfg, tr = run.load_cell('beams11.office')\n"
        "d = tempfile.mkdtemp()\n"
        "run.write_dataset(d, 'office', cfg, generator.make_traffic(tr, 3))\n"
        "out = replay(d, 'office', [60], cleanup=False)\n"
        "assert len(out[60]['kf']) > 0\n"
        "names = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print(sorted(names & {'jax', 'jaxlib', 'flax', 'sparse_gslam_tpu',"
        " 'sparse_gslam_tpu_torch'}))\n")
    assert last == "[]"


def test_run_loads_no_jax():
    """A whole run on the CPU (the card check skipped; one lap of the
    tour, as the `one_lap` fixture cuts it), alone in a process: its own
    check finds nothing, and neither does this one."""
    last = _child(
        "import sys\n"
        "from gslam_bench import run\n"
        "load = run.load_cell\n"
        "def one_lap(name):\n"
        "    b, c, cfg, tr = load(name)\n"
        "    tr['sim']['laps'] = 1\n"
        "    return b, c, cfg, tr\n"
        "run.load_cell = one_lap\n"
        "assert run.main(['--workload', 'beams11.office', '--seed', '4',"
        " '--seconds', '1', '--trace', '0'], device='cpu') == 0\n"
        "print(run.forbidden_modules())\n")
    assert last == "[]"


def test_result_withheld_where_a_forbidden_module_loads(capsys, monkeypatch):
    """A module that no run may load, loaded after the window (where the
    reference or a metric reader would load it), stops the run before
    its result line."""
    def check_that_loads(*a, **k):
        monkeypatch.setitem(sys.modules, "sparse_gslam_tpu",
                            types.ModuleType("sparse_gslam_tpu"))
        return {k: 0.0 for k in CHECKS}, True, 0

    monkeypatch.setattr(run, "setup", lambda *a: (None, None, []))
    monkeypatch.setattr(run, "window", lambda *a: ([], 0, 1.0))
    monkeypatch.setattr(run, "check", check_that_loads)
    rc = run.main(["--workload", "beams11.office", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], device="cpu")
    out, err = capsys.readouterr()
    assert rc == 3
    assert out.strip() == ""
    assert "sparse_gslam_tpu" in err
