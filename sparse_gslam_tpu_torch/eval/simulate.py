"""Synthetic 2D world simulator: generates CARMEN-format logs with
ground-truth `.relations` files.

The reference's headline datasets (aces, intel-lab, mit-killian) are
fetched by datasets/download.sh and are not redistributable in-repo;
this simulator provides closed-loop quantitative ATE testing in their
place: a polygonal world, a waypoint trajectory with loop closures,
noisy odometry (the same noise model the engine assumes,
odom_error_propagator.h:38-46), and ray-cast laser scans with range
noise -- emitted as FLASER lines (data_provider.cpp:24-42 format) plus
Burgard-style relations over multiple time separations. Host numpy;
port of sparse_gslam_tpu/eval/simulate.py, which writes the same bytes
for the same SimConfig.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import se2


@dataclasses.dataclass
class SimConfig:
    n_beams: int = 180
    fov: tuple = (-np.pi / 2, np.pi / 2)
    range_max: float = 10.0
    range_noise: float = 0.01
    odom_trans_noise: float = 0.006  # per-step fractional drift
    odom_rot_noise: float = 0.004
    laps: int = 1  # times the waypoint tour is repeated
    dt: float = 0.2
    speed: float = 0.35  # m per step
    turn_rate: float = 0.12  # rad per step max
    seed: int = 0


def rect_room_world():
    """A multi-room office-like world (walls as segment list)."""
    w = []

    def box(x0, y0, x1, y1):
        w.extend(
            [
                ((x0, y0), (x1, y0)),
                ((x1, y0), (x1, y1)),
                ((x1, y1), (x0, y1)),
                ((x0, y1), (x0, y0)),
            ]
        )

    box(0, 0, 24, 16)  # outer shell
    # inner walls with door gaps
    w.append(((8, 0), (8, 6)))
    w.append(((8, 8), (8, 12)))
    w.append(((16, 4), (16, 10)))
    w.append(((16, 12), (16, 16)))
    w.append(((0, 10), (5, 10)))
    w.append(((12, 6), (12, 11)))
    w.append(((4, 4), (6, 4)))
    w.append(((18, 2), (22, 2)))
    w.append(((18, 13), (21, 13)))
    return np.array(w, dtype=np.float64)  # (W, 2, 2)


def loop_waypoints():
    """A loopy trajectory visiting all rooms and re-entering the start
    area twice (guarantees loop-closure opportunities)."""
    return np.array(
        [
            (3, 2), (6, 2), (10, 2), (14, 2), (14, 8), (14, 13),
            (10, 13), (6, 13), (3, 13), (2, 7), (3, 2.5),
            (10, 2.5), (14, 2.6), (18, 6), (21, 6), (21, 10),
            (18, 10.5), (14, 8.5), (14, 3), (6, 2.2), (3, 2.2),
        ],
        dtype=np.float64,
    )


def killian_world():
    """A long-corridor network in the spirit of mit-killian: a 5 m
    ring corridor around an 84x54 m block with a transverse corridor
    splitting it into two loops (figure-eight revisits). Exercises the
    large-pose-graph regime (config 3 of BASELINE.json): ~2k keyframes
    over ~800 m of travel with long closure-free stretches."""
    w = []

    def box(x0, y0, x1, y1):
        w.extend(
            [
                ((x0, y0), (x1, y0)),
                ((x1, y0), (x1, y1)),
                ((x1, y1), (x0, y1)),
                ((x0, y1), (x0, y0)),
            ]
        )

    box(0, 0, 84, 54)  # outer shell
    # inner block with gaps at the transverse corridor (x in [40, 44])
    w.append(((10, 10), (40, 10)))
    w.append(((44, 10), (74, 10)))
    w.append(((10, 44), (40, 44)))
    w.append(((44, 44), (74, 44)))
    w.append(((10, 10), (10, 44)))
    w.append(((74, 10), (74, 44)))
    # transverse corridor walls
    w.append(((40, 10), (40, 44)))
    w.append(((44, 10), (44, 44)))
    # a few alcoves/features so corridors aren't featureless
    w.append(((20, 0), (20, 3)))
    w.append(((60, 54), (60, 51)))
    w.append(((84, 20), (81, 20)))
    w.append(((0, 34), (3, 34)))
    return np.array(w, dtype=np.float64)


def killian_waypoints():
    """Figure-eight + full-ring tour: both loops traversed and the
    start corridor revisited multiple times per lap."""
    return np.array(
        [
            (5, 5), (22, 5), (42, 5), (60, 5), (79, 5),
            (79, 27), (79, 49), (60, 49), (42, 49),
            (42, 27), (42, 12), (42, 5),
            (22, 5), (5, 5), (5, 27), (5, 49),
            (22, 49), (42, 49), (42, 27), (42, 5),
            (60, 5), (79, 5),
        ],
        dtype=np.float64,
    )


def ray_cast(pose, angles, walls, range_max):
    """Batch ray-segment intersection. pose (3,), angles (B,) body-frame
    beam angles, walls (W,2,2). Returns ranges (B,)."""
    th = pose[2] + angles
    d = np.stack([np.cos(th), np.sin(th)], axis=1)  # (B,2)
    o = pose[:2]
    a = walls[:, 0]  # (W,2)
    b = walls[:, 1]
    v = b - a  # (W,2)
    # solve o + t d = a + s v ; t = cross(a-o, v)/cross(d, v)
    ao = a[None, :, :] - o[None, None, :]  # (1,W,2)
    denom = d[:, None, 0] * v[None, :, 1] - d[:, None, 1] * v[None, :, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ao[..., 0] * v[None, :, 1] - ao[..., 1] * v[None, :, 0]) / denom
        # s = cross(ao, d) / cross(d, v): crossing t*d - s*v = ao with
        # d gives -s*cross(v, d) = cross(ao, d). (A sign error here
        # once mirrored every wall's valid span about its first vertex,
        # leaving whole corridor stretches blind -- all beams at
        # range_max -- and starving the landmark frontend; see
        # tests/test_simulator_raycast.py.)
        s = (
            ao[..., 0] * d[:, None, 1] - ao[..., 1] * d[:, None, 0]
        ) / denom
    valid = (np.abs(denom) > 1e-12) & (t > 1e-6) & (s >= 0.0) & (s <= 1.0)
    t = np.where(valid, t, np.inf)
    return np.minimum(t.min(axis=1), range_max)


def simulate(cfg: SimConfig = SimConfig(), walls=None, waypoints=None):
    """Run the simulation. Returns dict with times, gt_poses, odom_poses,
    scans (N, B)."""
    rng = np.random.default_rng(cfg.seed)
    if walls is None:
        walls = rect_room_world()
    if waypoints is None:
        waypoints = loop_waypoints()
    if cfg.laps > 1:
        waypoints = np.concatenate([waypoints] * cfg.laps)
    angles = np.linspace(cfg.fov[0], cfg.fov[1], cfg.n_beams)

    gt = [np.array([waypoints[0][0], waypoints[0][1], 0.0])]
    wp_i = 1
    while wp_i < len(waypoints):
        pose = gt[-1]
        target = waypoints[wp_i]
        to = target - pose[:2]
        dist = np.linalg.norm(to)
        if dist < 0.3:
            wp_i += 1
            continue
        bearing = np.arctan2(to[1], to[0])
        dth = np.clip(
            se2.wrap_angle(bearing - pose[2]), -cfg.turn_rate, cfg.turn_rate
        )
        step = cfg.speed * max(0.15, np.cos(se2.wrap_angle(bearing - pose[2])))
        new = np.array(
            [
                pose[0] + np.cos(pose[2] + dth) * step,
                pose[1] + np.sin(pose[2] + dth) * step,
                se2.wrap_angle(pose[2] + dth),
            ]
        )
        gt.append(new)
        if len(gt) > 20000:
            raise RuntimeError("simulation did not terminate")
    gt = np.stack(gt)
    return _observe(gt, cfg, walls, angles, rng)


def _observe(gt, cfg: SimConfig, walls, angles, rng):
    """Shared sensor emission: noisy odometry integrated from gt
    deltas + ray-cast scans with range noise."""
    n = len(gt)
    times = np.arange(n) * cfg.dt

    odom = [gt[0].copy()]
    for i in range(1, n):
        d = se2.relative(gt[i - 1], gt[i])
        d_noisy = d + np.array(
            [
                rng.normal(0, cfg.odom_trans_noise * (abs(d[0]) + 0.01)),
                rng.normal(0, cfg.odom_trans_noise * (abs(d[0]) + 0.01)),
                rng.normal(
                    0, cfg.odom_rot_noise * (abs(d[2]) + abs(d[0]) + 0.01)
                ),
            ]
        )
        odom.append(se2.compose(odom[-1], d_noisy))
    odom = np.stack(odom)

    scans = np.stack(
        [ray_cast(gt[i], angles, walls, cfg.range_max) for i in range(n)]
    )
    scans = np.where(
        scans < cfg.range_max,
        np.maximum(scans + rng.normal(0, cfg.range_noise, scans.shape), 0.05),
        cfg.range_max,
    )
    return {
        "times": times,
        "gt": gt,
        "odom": odom,
        "scans": scans,
        "angles": angles,
        "walls": walls,
        "cfg": cfg,
    }


# body-frame beam directions of the Crazyflie multiranger layout the
# wall follower consumes (front, left, back, right -- converter.cpp's
# 4-beam stream order)
MULTIRANGER_ANGLES = np.array([0.0, np.pi / 2, np.pi, -np.pi / 2])


def simulate_controlled(
    controller,
    cfg: SimConfig = SimConfig(),
    walls=None,
    n_steps: int = 2000,
    start=None,
    sensor_range: float = 4.0,
):
    """Closed-loop simulation driven by an onboard controller
    (models/wall_follower.WallFollower equivalent of the reference's
    wallfollowing_multirange_onboard.h:10-15 exploration interface).

    Each step ray-casts the 4-beam multiranger, asks the controller
    for (v, omega), and integrates a unicycle model with a hard
    collision clamp (never step into a wall closer than the commanded
    advance). Returns the same dict as simulate(), so the standard
    CARMEN-log + SLAM + eval flow runs unchanged on autonomously
    explored trajectories."""
    rng = np.random.default_rng(cfg.seed)
    if walls is None:
        walls = rect_room_world()
    if start is None:
        start = np.array([2.0, 2.0, 0.0])
    angles = np.linspace(cfg.fov[0], cfg.fov[1], cfg.n_beams)

    gt = [np.asarray(start, np.float64).copy()]
    for _ in range(n_steps):
        pose = gt[-1]
        r4 = ray_cast(pose, MULTIRANGER_ANGLES, walls, sensor_range)
        v, omega = controller.step(
            float(r4[0]), float(r4[1]), float(r4[2]), float(r4[3]),
            dt=cfg.dt,
        )
        dth = float(np.clip(omega * cfg.dt, -3 * cfg.turn_rate,
                            3 * cfg.turn_rate))
        step = float(np.clip(v * cfg.dt, 0.0, cfg.speed))
        # collision clamp: cannot advance past the wall ahead
        heading = se2.wrap_angle(pose[2] + dth)
        ahead = ray_cast(
            np.array([pose[0], pose[1], heading]),
            np.zeros(1), walls, sensor_range,
        )[0]
        step = min(step, max(0.0, ahead - 0.15))
        gt.append(
            np.array(
                [
                    pose[0] + np.cos(heading) * step,
                    pose[1] + np.sin(heading) * step,
                    heading,
                ]
            )
        )
    gt = np.stack(gt)
    return _observe(gt, cfg, walls, angles, rng)


def write_carmen_log(path: str, sim: dict):
    """FLASER lines matching CarmenLogDataProvider's parse
    (data_provider.cpp:24-42)."""
    scans = sim["scans"]
    odom = sim["odom"]
    times = sim["times"]
    with open(path, "w") as f:
        for i in range(len(times)):
            r = " ".join(f"{v:.4f}" for v in scans[i])
            o = odom[i]
            f.write(
                f"FLASER {scans.shape[1]} {r} {o[0]:.6f} {o[1]:.6f} "
                f"{o[2]:.6f} {o[0]:.6f} {o[1]:.6f} {o[2]:.6f} "
                f"{times[i]:.6f} sim {times[i]:.6f}\n"
            )


def make_relations(
    sim: dict, seps=(1.0, 5.0, 15.0, 40.0), stride=5, warmup: float = 20.0
):
    """Ground-truth relative motions over several time separations,
    like the Freiburg .relations files.

    Relations starting before `warmup` seconds are skipped: the SLAM
    system (reference and ours alike) emits its first trajectory line
    only once the multiscan window fills, so earlier relations would
    compare against the wrong pose."""
    times, gt = sim["times"], sim["gt"]
    t1, t2, rel = [], [], []
    for sep in seps:
        k = max(1, int(round(sep / sim["cfg"].dt)))
        for i in range(0, len(times) - k, stride):
            if times[i] < warmup:
                continue
            t1.append(times[i])
            t2.append(times[i + k])
            rel.append(se2.relative(gt[i], gt[i + k]))
    return np.asarray(t1), np.asarray(t2), np.stack(rel)


def generate_dataset(out_dir: str, cfg: SimConfig = SimConfig(), name="sim"):
    """Write <out>/<name>.log + <out>/<name>.relations, return sim."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    sim = simulate(cfg)
    write_carmen_log(os.path.join(out_dir, f"{name}.log"), sim)
    from .relations import save_relations

    t1, t2, rel = make_relations(sim)
    save_relations(os.path.join(out_dir, f"{name}.relations"), t1, t2, rel)
    return sim
