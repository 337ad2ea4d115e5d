"""The benchmark's traffic: a sensor log made from a world and a seed.

A frozen copy of sparse_gslam_tpu_torch/eval/simulate.py (simulate,
_observe, ray_cast, write_carmen_log; numpy only) and of the SE(2)
helpers it uses. A traffic file (traffic/<name>.json) names a world
file (worlds/<name>.json: walls and waypoints) and SimConfig's fields
as scripts/gen_sim_datasets.py sets them for that world; the run's
--seed takes the place of `seed`. With the committed seeds the copy
writes datasets/sim-*/<name>.log byte for byte.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


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


def wrap_angle(theta):
    return theta - 2.0 * np.pi * np.floor((theta + np.pi) / (2.0 * np.pi))


def compose(a, b):
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return np.stack([x, y, t], axis=-1)


def inverse(a):
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return np.stack([x, y, -a[..., 2]], axis=-1)


def relative(a, b):
    return compose(inverse(a), b)


def ray_cast(pose, angles, walls, range_max):
    """Batch ray-segment intersection. pose (3,), angles (B,) body-frame
    beam angles, walls (W,2,2). Returns ranges (B,)."""
    th = pose[2] + angles
    d = np.stack([np.cos(th), np.sin(th)], axis=1)
    o = pose[:2]
    a = walls[:, 0]
    b = walls[:, 1]
    v = b - a
    ao = a[None, :, :] - o[None, None, :]
    denom = d[:, None, 0] * v[None, :, 1] - d[:, None, 1] * v[None, :, 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ao[..., 0] * v[None, :, 1] - ao[..., 1] * v[None, :, 0]) / denom
        s = (
            ao[..., 0] * d[:, None, 1] - ao[..., 1] * d[:, None, 0]
        ) / denom
    valid = (np.abs(denom) > 1e-12) & (t > 1e-6) & (s >= 0.0) & (s <= 1.0)
    t = np.where(valid, t, np.inf)
    return np.minimum(t.min(axis=1), range_max)


def simulate(cfg: SimConfig, walls, waypoints):
    """The waypoint tour (repeated cfg.laps times) driven at cfg.speed,
    observed with noisy odometry and ray-cast scans. Returns a dict with
    times, gt, odom, scans, angles, walls, cfg."""
    rng = np.random.default_rng(cfg.seed)
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
            wrap_angle(bearing - pose[2]), -cfg.turn_rate, cfg.turn_rate
        )
        step = cfg.speed * max(0.15, np.cos(wrap_angle(bearing - pose[2])))
        new = np.array(
            [
                pose[0] + np.cos(pose[2] + dth) * step,
                pose[1] + np.sin(pose[2] + dth) * step,
                wrap_angle(pose[2] + dth),
            ]
        )
        gt.append(new)
        if len(gt) > 20000:
            raise RuntimeError("simulation did not terminate")
    gt = np.stack(gt)
    return _observe(gt, cfg, walls, angles, rng)


def _observe(gt, cfg: SimConfig, walls, angles, rng):
    """Noisy odometry integrated from gt deltas + ray-cast scans with
    range noise."""
    n = len(gt)
    times = np.arange(n) * cfg.dt

    odom = [gt[0].copy()]
    for i in range(1, n):
        d = relative(gt[i - 1], gt[i])
        d_noisy = d + np.array(
            [
                rng.normal(0, cfg.odom_trans_noise * (abs(d[0]) + 0.01)),
                rng.normal(0, cfg.odom_trans_noise * (abs(d[0]) + 0.01)),
                rng.normal(
                    0, cfg.odom_rot_noise * (abs(d[2]) + abs(d[0]) + 0.01)
                ),
            ]
        )
        odom.append(compose(odom[-1], d_noisy))
    odom = np.stack(odom)

    scans = np.stack(
        [ray_cast(gt[i], angles, walls, cfg.range_max) for i in range(n)]
    )
    scans = np.where(
        scans < cfg.range_max,
        np.maximum(scans + rng.normal(0, cfg.range_noise, scans.shape), 0.05),
        cfg.range_max,
    )
    return {"times": times, "gt": gt, "odom": odom, "scans": scans,
            "angles": angles, "walls": walls, "cfg": cfg}


def write_carmen_log(path: str, sim: dict):
    """FLASER lines as CarmenLogDataProvider parses them."""
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


def load_json(kind: str, name: str) -> dict:
    """<kind>/<name>.json beside this file (kind: traffic, worlds)."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def rng_seed(seed: int) -> int:
    """The run's --seed as numpy's generator takes it (a whole number of
    any size or sign; 0 <= seed < 2**64 unchanged)."""
    return int(seed) % (1 << 64)


def make_traffic(traffic: dict, seed: int) -> dict:
    """simulate() of the traffic's world under its SimConfig fields, with
    `seed` for the noise."""
    world = load_json("worlds", traffic["world"])
    cfg = SimConfig(**traffic["sim"], seed=rng_seed(seed))
    return simulate(cfg, np.asarray(world["walls"], np.float64),
                    np.asarray(world["waypoints"], np.float64))
