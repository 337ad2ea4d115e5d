"""The port's host tools against the JAX package's, on the same inputs:

- the world generator (eval/simulate.py): generate_dataset writes the
  same .log and .relations bytes for three seeds; ray_cast, the
  closed-loop simulate_controlled and the wall follower
  (models/wall_follower.py) give equal arrays;
- the timing tables (eval/timing.py): analyze() gives equal stats on
  timing files the port's TimingWriter wrote (it writes no
  .fflag/.bflag, so the steady columns equal the raw ones) and on
  files with compile flags set beside them;
- the metricEvaluator replacement (eval/cli.py) writes the same
  _trans_error.log and _rot_error.log bytes;
- the Crazyflie frame source and command client (io/crazyflie.py): the
  same Frames from the same pushed telemetry streams and the same
  setpoint sequences; the bridge refuses to start without cflib in
  both.
All comparisons are exact."""
import dataclasses
import math
import os

import numpy as np
import pytest

from sparse_gslam_tpu.eval import cli as jcli
from sparse_gslam_tpu.eval import simulate as jsim
from sparse_gslam_tpu.eval import timing as jtiming
from sparse_gslam_tpu.io import crazyflie as jcf
from sparse_gslam_tpu.models import wall_follower as jwf
from sparse_gslam_tpu_torch.eval import cli as tcli
from sparse_gslam_tpu_torch.eval import simulate as tsim
from sparse_gslam_tpu_torch.eval import timing as ttiming
from sparse_gslam_tpu_torch.io import crazyflie as tcf
from sparse_gslam_tpu_torch.io.result_writer import TimingWriter
from sparse_gslam_tpu_torch.models import wall_follower as twf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_dataset_writes_the_same_bytes(tmp_path, seed):
    kw = dict(n_beams=11, seed=seed, laps=1 + seed % 2)
    tsim.generate_dataset(str(tmp_path / "t"), tsim.SimConfig(**kw), "w")
    jsim.generate_dataset(str(tmp_path / "j"), jsim.SimConfig(**kw), "w")
    for ext in ("log", "relations"):
        a = (tmp_path / "t" / f"w.{ext}").read_bytes()
        b = (tmp_path / "j" / f"w.{ext}").read_bytes()
        assert len(a) > 1000 and a == b, ext


def test_ray_cast_equal():
    """Both packages' worlds and ray_cast from seeded poses."""
    rng = np.random.default_rng(0)
    angles = np.linspace(-np.pi, np.pi, 90)
    for world, hi in (("killian_world", (84, 54)),
                      ("rect_room_world", (24, 16))):
        tw, jw = getattr(tsim, world)(), getattr(jsim, world)()
        np.testing.assert_array_equal(tw, jw)
        for _ in range(20):
            pose = np.array([rng.uniform(0, hi[0]), rng.uniform(0, hi[1]),
                             rng.uniform(-np.pi, np.pi)])
            np.testing.assert_array_equal(
                tsim.ray_cast(pose, angles, tw, 10.0),
                jsim.ray_cast(pose, angles, jw, 10.0))


def test_wall_follower_steps_equal():
    rng = np.random.default_rng(1)
    for side in ("right", "left"):
        t = twf.WallFollower(twf.WallFollowerConfig(side=side))
        j = jwf.WallFollower(jwf.WallFollowerConfig(side=side))
        for _ in range(500):
            r = rng.uniform(0.1, 4.0, 4)
            dt = float(rng.uniform(0.05, 0.2))
            assert t.step(*r, dt=dt) == j.step(*r, dt=dt)
            assert t.state == j.state


def test_simulate_controlled_equal():
    kw = dict(n_beams=11, seed=3, odom_trans_noise=0.03,
              odom_rot_noise=0.02)
    wkw = dict(side="right", max_speed=0.9, target_dist=0.6)
    t = tsim.simulate_controlled(
        twf.WallFollower(twf.WallFollowerConfig(**wkw)),
        tsim.SimConfig(**kw), n_steps=300)
    j = jsim.simulate_controlled(
        jwf.WallFollower(jwf.WallFollowerConfig(**wkw)),
        jsim.SimConfig(**kw), n_steps=300)
    for key in ("times", "gt", "odom", "scans", "angles", "walls"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert dataclasses.asdict(t["cfg"]) == dataclasses.asdict(j["cfg"])


def write_timing(prefix, flags):
    """Seeded .ftime/.btime/.dtime through the port's TimingWriter; with
    `flags`, .fflag/.bflag beside them marking some ticks as compile
    ticks, as the JAX runner writes them."""
    rng = np.random.default_rng(7)
    w = TimingWriter(prefix)
    for k in range(300):
        w.dataset(0.2 * k)
        w.frontend(float(rng.uniform(0.01, 0.05)))
        if k % 25 == 0:
            w.backend(float(rng.uniform(0.1, 0.9)))
    w.close()
    if flags:
        for ext, every in ((".fflag", 40), (".bflag", 5)):
            n = len(np.loadtxt(prefix + ext[:2] + "time", ndmin=1))
            np.savetxt(prefix + ext, (np.arange(n) % every == 0)
                       .astype(int), fmt="%d")


@pytest.mark.parametrize("flags", [False, True])
def test_timing_analyze_equal(tmp_path, flags):
    prefix = str(tmp_path / "w")
    write_timing(prefix, flags)
    t, j = ttiming.analyze(prefix), jtiming.analyze(prefix)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert str(t) == str(j)
    if not flags:
        # the port's runs have no compile ticks, and no sidecars
        assert not os.path.exists(prefix + ".fflag")
        assert not os.path.exists(prefix + ".bflag")
        assert t.n_compile_ticks == 0
        assert t.steady_mean_frontend == t.mean_frontend
        assert t.steady_max_backend == t.max_backend
    else:
        assert t.n_compile_ticks > 0


def test_cli_writes_the_same_error_logs(tmp_path):
    d = tmp_path / "d"
    tsim.generate_dataset(str(d), tsim.SimConfig(n_beams=11, seed=5), "w")
    sim = tsim.simulate(tsim.SimConfig(n_beams=11, seed=5))
    with open(d / "w.result", "w") as fh:  # odometry as the trajectory
        for t, o in zip(sim["times"], sim["odom"]):
            fh.write(f"FLASER 0 {o[0]:.6f} {o[1]:.6f} {o[2]:.6f} "
                     f"{o[0]:.6f} {o[1]:.6f} {o[2]:.6f} {t:.6f} h {t:.6f}\n")
    assert tcli.main([str(d), "w", "port"]) == 0
    assert jcli.main([str(d), "w", "jax"]) == 0
    for kind in ("trans", "rot"):
        a = (d / f"w-port_{kind}_error.log").read_bytes()
        b = (d / f"w-jax_{kind}_error.log").read_bytes()
        assert a.startswith(b"mean, std") and a == b


def push_streams(src, seed):
    """Seeded, jittered telemetry: 10 Hz state and ranger samples with
    occasional gaps and out-of-tolerance stamps."""
    rng = np.random.default_rng(seed)
    for k in range(200):
        t = 0.1 * k
        if rng.uniform() > 0.1:
            src.push_state(t + rng.normal(0, 0.01),
                           *rng.uniform(-5, 5, 2).tolist())
        if rng.uniform() > 0.1:
            yaw = rng.uniform(-np.pi, np.pi)
            q = (0.0, 0.0, math.sin(yaw / 2), math.cos(yaw / 2))
            src.push_ranger(t + rng.normal(0, 0.03),
                            rng.uniform(0.1, 4.0, 4).tolist(), q)


def test_live_frame_source_equal():
    for seed in range(3):
        t, j = tcf.LiveFrameSource(), jcf.LiveFrameSource()
        push_streams(t, seed)
        push_streams(j, seed)
        ft, fj = list(t.frames()), list(j.frames())
        assert len(ft) == len(fj) > 50
        for a, b in zip(ft, fj):
            assert a.time == b.time
            np.testing.assert_array_equal(a.pose, b.pose)
            np.testing.assert_array_equal(a.ranges, b.ranges)


class Recorder:
    def __init__(self):
        self.calls = []

    def send_hover_setpoint(self, vx, vy, yawrate, z):
        self.calls.append(("hover", vx, vy, yawrate, z))

    def send_stop_setpoint(self):
        self.calls.append(("stop",))


def drive(pkg):
    """One flight through every mode of a CommandClient."""
    link = Recorder()
    cc = pkg.CommandClient(link, hover_height=0.5, takeoff_time=1.0)
    rng = np.random.default_rng(2)
    cc.step(dt=0.1)
    cc.takeoff()
    for _ in range(12):
        cc.step(dt=0.1)
    cc.set_velocity(0.3, -0.1, 0.5)
    cc.step(dt=0.1)
    cc.toggle_wall_following(True)
    for _ in range(50):
        cc.step(ranges4=rng.uniform(0.2, 4.0, 4), dt=0.1)
    cc.toggle_wall_following(False)
    cc.step(dt=0.1)
    cc.land()
    for _ in range(15):
        cc.step(dt=0.1)
    return link.calls, cc.mode


def test_command_client_setpoints_equal():
    t, j = drive(tcf), drive(jcf)
    assert t == j
    assert t[1] == "IDLE" and t[0][-1] == ("stop",)


def test_bridge_needs_cflib():
    for pkg in (tcf, jcf):
        with pytest.raises(RuntimeError, match="cflib is not installed"):
            pkg.CrazyflieBridge("radio://0/80/2M")
