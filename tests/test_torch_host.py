"""The port's host modules against their JAX-package originals on the
same seeded inputs: config reading, se2, odometry propagation, the
multicloud window, line extraction, range stores, the CARMEN parser,
.result writing and the relations ATE. The port keeps its own copies of
these numpy modules, so the expected result is equality."""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
import yaml

from sparse_gslam_tpu.eval import relations as jrel
from sparse_gslam_tpu.io import providers as jprov
from sparse_gslam_tpu.io import result_writer as jrw
from sparse_gslam_tpu.models import range_data as jrd
from sparse_gslam_tpu.models.slam import SlamSystem as JSlamSystem
from sparse_gslam_tpu.ops import lines as jlines
from sparse_gslam_tpu.ops import multicloud as jmc
from sparse_gslam_tpu.utils import chi2 as jchi2
from sparse_gslam_tpu.utils import config as jcfg
from sparse_gslam_tpu.utils import se2 as jse2
from sparse_gslam_tpu_torch.eval import relations as trel
from sparse_gslam_tpu_torch.io import providers as tprov
from sparse_gslam_tpu_torch.io import result_writer as trw
from sparse_gslam_tpu_torch.models import range_data as trd
from sparse_gslam_tpu_torch.models.slam import SlamSystem as TSlamSystem
from sparse_gslam_tpu_torch.ops import lines as tlines
from sparse_gslam_tpu_torch.ops import multicloud as tmc
from sparse_gslam_tpu_torch.utils import chi2 as tchi2
from sparse_gslam_tpu_torch.utils import config as tcfg
from sparse_gslam_tpu_torch.utils import se2 as tse2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "datasets", "sim-*", "*.yaml")))
OFFICE = os.path.join(ROOT, "datasets", "sim-office")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs in several worker processes at once; one torch
    thread per worker keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("path", YAMLS, ids=[
    os.path.relpath(p, ROOT) for p in YAMLS])
def test_flat_yaml_matches_pyyaml(path):
    ref = yaml.safe_load(open(path))
    got = tcfg.load_flat_yaml(path)
    assert got == ref
    assert {k: type(v) for k, v in got.items()} == {
        k: type(v) for k, v in ref.items()}


@pytest.mark.parametrize("text", [
    "a:\n  b: 1\n", "- 1\n", "a: [1, 2]\n", "a: 0x1f\n", "a: 1\na: 2\n",
])
def test_flat_yaml_refuses_what_it_cannot_read(text):
    with pytest.raises(ValueError):
        tcfg.parse_flat_yaml(text)


def test_flat_yaml_scalars():
    text = ("i: -3\nf: 1.5\ne: 1e-5\ns: 'a b'\nb: off\nn: ~\n"
            "c: 7  # comment\n# whole line\n\n")
    assert tcfg.parse_flat_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("world", ["sim-office", "sim-killian"])
def test_load_dataset_config_matches_jax(world):
    d = os.path.join(ROOT, "datasets", world)
    ts, tl = tcfg.load_dataset_config(d)
    js, jl = jcfg.load_dataset_config(d)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)


SE2_FNS = ["compose", "relative", "inverse", "apply", "wrap_angle",
           "rotation_matrix"]


@pytest.mark.parametrize("fn", SE2_FNS)
def test_se2_numpy_and_torch(fn):
    r = np.random.default_rng(0)
    a = r.uniform(-5, 5, (64, 3))
    b = r.uniform(-5, 5, (64, 3))
    pts = r.uniform(-5, 5, (64, 2))
    args = {"compose": (a, b), "relative": (a, b), "inverse": (a,),
            "apply": (a, pts), "wrap_angle": (a[:, 2] * 3,),
            "rotation_matrix": (a[:, 2],)}[fn]
    ref = getattr(jse2, fn)(*args)
    np.testing.assert_array_equal(getattr(tse2, fn)(*args), ref)
    on_torch = getattr(tse2, fn)(*(torch.from_numpy(x) for x in args))
    assert isinstance(on_torch, torch.Tensor)
    np.testing.assert_allclose(on_torch.numpy(), ref, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("model", ["reference", "additive"])
def test_odometry_propagation(model):
    r = np.random.default_rng(1)
    deltas = r.normal(0, 0.1, (15, 3))
    var = np.array([0.04, 1.0, 1.0])
    for a, b in zip(tmc.propagate_suffixes(deltas, var, model),
                    jmc.propagate_suffixes(deltas, var, model)):
        np.testing.assert_array_equal(a, b)
    tp = tmc.OdomErrorPropagator(0.2, 1.0, 1.0, model)
    jp = jmc.OdomErrorPropagator(0.2, 1.0, 1.0, model)
    for d in deltas:
        tp.step(d)
        jp.step(d)
    np.testing.assert_array_equal(tp.pose, jp.pose)
    np.testing.assert_array_equal(tp.cov, jp.cov)


def host_pipeline(mod_slam, mod_mc, mod_lines, mod_prov, mod_cfg, n):
    """Subsampling, multicloud window and SMC extraction over the first
    n frames of sim-office; returns every emitted array."""
    cfg, ls = mod_cfg.load_dataset_config(OFFICE)
    slam = mod_slam.__new__(mod_slam)
    slam.config = cfg
    mc = mod_mc.MulticloudConverter(cfg)
    prov = mod_prov.CarmenLogDataProvider(
        os.path.join(OFFICE, "sim-office.log"),
        **({"use_native": False} if mod_prov is jprov else {}))
    out, deltas, last, zero = [], [], None, np.zeros(3)
    for k, fr in enumerate(prov.frames()):
        if k == n:
            break
        if last is not None:
            d = jse2.relative(last, fr.pose)
            zero = jse2.compose(zero, d)
            deltas.append(d)
        last = fr.pose
        ranges, table = slam._subsample(np.asarray(fr.ranges))
        out += [ranges, table]
        mc.set_table(table)
        res = mc.update(ranges, deltas, zero)
        if res is not None:
            seg = mod_lines.extract_lines_any(res.points, res.covs, ls)
            out += [res.points, res.covs, seg.rhotheta, seg.cov, seg.start,
                    seg.end]
    return out


def test_multicloud_and_lines_on_sim_office():
    port = host_pipeline(TSlamSystem, tmc, tlines, tprov, tcfg, 80)
    ref = host_pipeline(JSlamSystem, jmc, jlines, jprov, jcfg, 80)
    assert len(port) == len(ref) > 100
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a, b)


def make_store(mod):
    r = np.random.default_rng(2)
    ang = np.linspace(-1.5, 1.5, 9)
    table = np.stack([np.cos(ang), np.sin(ang)], 1)
    rd = mod.RangeData2D()
    for i in range(6):
        rng_ = r.uniform(0.5, 12.0, 9)
        rng_[i] = np.inf
        rd.insert_scan(rng_, table, 10.0,
                       pose=None if i == 0 else r.normal(0, 1, 3))
    return rd


def test_range_data():
    t, j = make_store(trd), make_store(jrd)
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.returns(), j.returns())
    pose = np.array([1.0, -2.0, 0.3])
    to, jo = trd.RangeData2D(), jrd.RangeData2D()
    t.transform_into(pose, to)
    j.transform_into(pose, jo)
    np.testing.assert_array_equal(to.points, jo.points)
    for (a, b, c), (d, e, f) in zip(to.meta, jo.meta):
        assert (a, b) == (d, e)
        np.testing.assert_array_equal(c, f)
    est = np.random.default_rng(3).normal(0, 1, (2, 3))
    np.testing.assert_array_equal(
        trd.construct_multicloud([t, t], est, 0, 1, 2, returns_only=True),
        jrd.construct_multicloud([j, j], est, 0, 1, 2, returns_only=True))


def test_carmen_parser_matches_jax():
    log = os.path.join(OFFICE, "sim-office.log")
    port = list(tprov.create_data_provider("carmen", log).frames())
    ref = list(jprov.CarmenLogDataProvider(log, use_native=False).frames())
    assert len(port) == len(ref) == 663
    for a, b in zip(port, ref):
        assert a.time == b.time
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.ranges, b.ranges)


# the values the port refused before it ported them: (slam.yaml key,
# value) pairs, SlamSystem built on the CPU
FORMERLY_REFUSED = {
    "final_joint": ("final_joint", True),
    "chain_info_marginal": ("chain_info_mode", "marginal"),
    "smf": ("algorithm", "smf"),
    "hough": ("algorithm", "hough"),
    "stanford": ("data_provider", "stanford"),
    "fr079": ("data_provider", "fr079"),
    "usc": ("data_provider", "usc"),
    "drone_bag": ("data_provider", "drone_bag"),
    "oregon": ("data_provider", "oregon"),
}


@pytest.mark.parametrize("case", list(FORMERLY_REFUSED))
def test_formerly_refused_values_run(tmp_path, case):
    """Each value the port once refused builds a SlamSystem (backend on)
    on the CPU that takes frames: the options on sim-office's first 60
    frames, then final_cleanup; each provider on a log of its format
    written here (tests/test_torch_providers.py's generators)."""
    from test_torch_providers import TEXT_LOGS, drone_bag

    key, value = FORMERLY_REFUSED[case]
    slam, ls = tcfg.load_dataset_config(OFFICE)
    if key == "algorithm":
        ls = dataclasses.replace(ls, algorithm=value)
    else:
        slam = dataclasses.replace(slam, **{key: value})
    log = os.path.join(OFFICE, "sim-office.log")
    n_frames = 60
    if key == "data_provider":
        log = str(tmp_path / f"{value}.log")
        if value == "drone_bag":
            drone_bag(log, np.random.default_rng(1), "bz2")
            slam = dataclasses.replace(slam, scan_size=4)
        else:
            with open(log, "w") as fh:
                fh.write("\n".join(TEXT_LOGS[value](
                    np.random.default_rng(1))) + "\n")
        n_frames = None
    ts = TSlamSystem(slam, ls, device="cpu")
    frames = list(tprov.create_data_provider(slam.data_provider,
                                             log).frames())[:n_frames]
    for fr in frames:
        ts.process_frame(fr)
    assert ts.frame_idx == len(frames) > 0
    if key != "data_provider":
        assert len(ts.frontend.keyframes) > 5
        ts.final_cleanup()
        assert ts.backend.pose_count == len(ts.frontend.keyframes)


def test_result_writer_and_relations(tmp_path):
    r = np.random.default_rng(4)
    est = r.normal(0, 2, (7, 3))
    lm_est = est + r.normal(0, 0.01, est.shape)
    odom = [([10.0 * i + 0.5 * k for k in range(3)],
             [r.normal(0, 1, 3) for _ in range(3)]) for i in range(7)]
    for last_opt in (7, 4):
        trw.write_trajectory(tmp_path / "t.result", est, odom, last_opt,
                             lm_est)
        jrw.write_trajectory(tmp_path / "j.result", est, odom, last_opt,
                             lm_est)
        assert (tmp_path / "t.result").read_bytes() == (
            tmp_path / "j.result").read_bytes()
    ref_result = os.path.join(ROOT, "sparse_gslam_tpu_torch", "data",
                              "sim-office-nobackend.result")
    rel = os.path.join(OFFICE, "sim-office.relations")
    a = trel.evaluate_files(ref_result, rel)
    b = jrel.evaluate_files(ref_result, rel)
    assert str(a) == str(b)
    assert str(a).startswith("ATE trans 0.2020 +- 0.2765 m, rot 1.740")
    np.testing.assert_array_equal(a.trans_errors, b.trans_errors)


@pytest.mark.parametrize("dof", [1, 3, 57, 745])
def test_chi2_quantile(dof):
    assert tchi2.chi2_quantile(0.99, dof) == jchi2.chi2_quantile(0.99, dof)
