"""Checkpoints between the two packages: the port's utils/checkpoint.py
writes and reads the JAX package's npz layout.

A small world (the JAX package's SimConfig(n_beams=60, seed=4) world and
its test configuration, tests/test_checkpoint_and_system.py) runs half
way through the JAX package's SlamSystem with the backend on, which
saves. Then:

- the port loads that file, and so does the JAX package: every array of
  the two loaded states (what save_checkpoint writes, and the submap
  grids that load_checkpoint rebuilds) is equal;
- both continue 60 frames with the runner's fields set by hand, as the
  JAX test does: keyframe estimates within 1e-6 (that test's
  tolerance; the largest difference seen is printed);
- the port saves after the same first half, and both packages load that
  file into equal states;
- the port's own save and load resume identically (1e-6, as the JAX
  test);
- the committed JAX checkpoint of sim-office at frame 330 continues in
  the port as in the JAX package (chip_smoke.py's `resume` phase, here
  on the CPU)."""
import numpy as np
import pytest
import torch

from sparse_gslam_tpu.io.providers import create_data_provider
from sparse_gslam_tpu.models.slam import SlamSystem as JSlamSystem
from sparse_gslam_tpu.utils import checkpoint as jck
from sparse_gslam_tpu.utils.config import ExtractorConfig as JExtractor
from sparse_gslam_tpu.utils.config import SlamConfig as JSlam
from sparse_gslam_tpu_torch.eval.simulate import SimConfig, generate_dataset
from sparse_gslam_tpu_torch.models.slam import SlamSystem
from sparse_gslam_tpu_torch.utils import checkpoint as tck
from sparse_gslam_tpu_torch.utils.config import ExtractorConfig, SlamConfig

CONFIG = dict(
    std_r=0.05, range_max=10.0, scan_size=11, multicloud_size=88,
    landmark_max_gap=0.5, match_interval=20, dcs_phi=10.0,
    max_match_distance=10.0, submap_trajectory_length=6.0,
)
EXTRACTOR = dict(min_line_points=8, cluster_threshold=100.0)
CONTINUE = 60
ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_system():
    return JSlamSystem(JSlam(**CONFIG), JExtractor(**EXTRACTOR),
                       enable_backend=True)


def port_system():
    return SlamSystem(SlamConfig(**CONFIG), ExtractorConfig(**EXTRACTOR),
                      enable_backend=True, device="cpu")


def carry_runner_fields(dst, src):
    """The runner state save_checkpoint leaves out, set by hand as the
    JAX package's own test does."""
    dst.frame_idx = src.frame_idx
    dst.deltas = list(src.deltas)
    dst.zero_pose = src.zero_pose.copy()
    dst.last_pose = src.last_pose.copy()
    dst.mc._cloud_odom = src.mc._cloud_odom.copy()


def state(system, save, path):
    """Every array of a system's state: what `save` writes, and each
    submap's grids, origins and keyframe range."""
    save(str(path), system)
    with np.load(str(path)) as z:
        out = {k: z[k] for k in z.files}
    for k, sm in enumerate(system.backend.submaps):
        for name in ("score_grid", "pooled_grid", "probs", "origin",
                     "high_res", "high_origin"):
            out[f"submap{k}_{name}"] = np.asarray(getattr(sm, name))
        out[f"submap{k}_range"] = np.array([sm.anchor_idx, sm.start_idx,
                                            sm.end_idx])
    return out


def assert_same_state(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    """The world, its frames, and the JAX system after the first half,
    saved."""
    d = tmp_path_factory.mktemp("ckpt")
    generate_dataset(str(d), SimConfig(n_beams=60, seed=4), name="t")
    frames = list(create_data_provider("carmen", str(d / "t.log")).frames())
    cut = len(frames) // 2
    js = jax_system()
    for fr in frames[:cut]:
        js.process_frame(fr)
    jck.save_checkpoint(str(d / "jax.npz"), js)
    return d, frames, cut, js


@pytest.fixture(scope="module")
def loaded(jax_saved):
    """The JAX checkpoint loaded into each package."""
    d, frames, cut, js = jax_saved
    jl = jax_system()
    jck.load_checkpoint(str(d / "jax.npz"), jl)
    tl = port_system()
    tck.load_checkpoint(str(d / "jax.npz"), tl)
    return jl, tl


def test_jax_checkpoint_loads_into_port(jax_saved, loaded, tmp_path):
    _, _, _, js = jax_saved
    jl, tl = loaded
    assert len(tl.backend.submaps) >= 2 and tl.backend.closures
    assert len(tl.frontend.keyframes) == len(js.frontend.keyframes)
    assert_same_state(state(tl, tck.save_checkpoint, tmp_path / "t.npz"),
                      state(jl, jck.save_checkpoint, tmp_path / "j.npz"))


def test_continuations_agree(jax_saved, loaded):
    _, frames, cut, js = jax_saved
    jl, tl = loaded
    for s in (jl, tl):
        carry_runner_fields(s, js)
    for fr in frames[cut:cut + CONTINUE]:
        jl.process_frame(fr)
        tl.process_frame(fr)
    ej, et = jl.frontend.estimates(), tl.frontend.estimates()
    assert len(et) == len(ej) > len(js.frontend.keyframes)
    diff = float(np.abs(et - ej).max())
    print(f"continuation: largest keyframe estimate difference {diff:.3e}")
    np.testing.assert_allclose(et, ej, rtol=0, atol=ATOL)
    assert tl.backend.closure_count == jl.backend.closure_count
    np.testing.assert_allclose(tl.backend.pose_estimates(),
                               jl.backend.pose_estimates(), rtol=0,
                               atol=ATOL)


@pytest.fixture(scope="module")
def port_half(jax_saved):
    """The port's system after the first half."""
    _, frames, cut, _ = jax_saved
    ts = port_system()
    for fr in frames[:cut]:
        ts.process_frame(fr)
    return ts


def test_port_checkpoint_loads_into_jax(jax_saved, port_half, tmp_path):
    """The port saves (after the first half, run by the port), and both
    packages load that file into equal states. (Loading adds submaps
    and chain edges beyond those saved, as the JAX package does:
    ROADMAP.md, section 3.)"""
    _, _, _, js = jax_saved
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, port_half)
    jl = jax_system()
    jck.load_checkpoint(path, jl)
    tl = port_system()
    tck.load_checkpoint(path, tl)
    assert len(jl.frontend.keyframes) == len(js.frontend.keyframes)
    assert_same_state(state(jl, jck.save_checkpoint, tmp_path / "j.npz"),
                      state(tl, tck.save_checkpoint, tmp_path / "t.npz"))


def test_port_roundtrip_resumes_identically(jax_saved, port_half,
                                            tmp_path):
    """The JAX package's test_checkpoint_roundtrip_resumes_identically on
    the port alone."""
    _, frames, cut, _ = jax_saved
    a = port_half
    tck.save_checkpoint(str(tmp_path / "a.npz"), a)
    b = port_system()
    tck.load_checkpoint(str(tmp_path / "a.npz"), b)
    carry_runner_fields(b, a)
    for fr in frames[cut:cut + CONTINUE]:
        a.process_frame(fr)
        b.process_frame(fr)
    ea, eb = a.frontend.estimates(), b.frontend.estimates()
    assert len(ea) == len(eb)
    np.testing.assert_allclose(ea, eb, atol=ATOL)


def test_committed_office_checkpoint_continues_as_jax(tmp_path):
    """The committed JAX checkpoint of sim-office at frame 330 and its
    continuations (scripts/make_office_checkpoint.py), which
    chip_smoke.py's `resume` phase holds on the card, on the CPU:
    both continuations within 1e-6 of the JAX package's, the same
    counts."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    reading = chip_smoke.resume_continuations("cpu", str(tmp_path / "p.npz"))
    print(reading)
    assert chip_smoke.resume_problems(reading) == []
    assert reading["second_pg_max_abs_diff"] > 0  # the added chain edge
