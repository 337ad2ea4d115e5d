"""Autonomous wall-following exploration controller.

The reference declares this interface for onboard exploration
(include/wallfollowing_multirange_onboard.h:10-15) but ships no
implementation (simulator.cpp absent, CMakeLists.txt:281-282); this is
a complete equivalent of the declared behavior for the 4-beam
multiranger layout (front/left/back/right): follow the wall on the
chosen side at a target distance, turning into gaps and away from
frontal obstacles. Pure function of the latest ranges -> (v, omega)
command, so it composes with the live Crazyflie bridge or the
simulator. Port of sparse_gslam_tpu/models/wall_follower.py.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class WallFollowerConfig:
    side: str = "right"  # wall side to keep
    target_dist: float = 0.5  # m
    max_speed: float = 0.3  # m/s
    max_turn: float = 1.2  # rad/s
    front_stop: float = 0.6  # start turning away below this
    kp: float = 2.0
    kd: float = 4.0


class WallFollower:
    """state machine: FORWARD (track wall) / TURN (frontal obstacle) /
    FIND (no wall in range)."""

    def __init__(self, config: WallFollowerConfig = WallFollowerConfig()):
        self.config = config
        self.prev_err = 0.0
        self.state = "FIND"

    def step(self, front: float, left: float, back: float,
             right: float, dt: float = 0.1):
        """ranges in meters (inf/large = no return). Returns
        (v, omega) with omega > 0 turning left."""
        cfg = self.config
        side_r = right if cfg.side == "right" else left
        sign = -1.0 if cfg.side == "right" else 1.0

        if front < cfg.front_stop:
            self.state = "TURN"
        elif side_r < 3.0 * cfg.target_dist:
            self.state = "FORWARD"
        else:
            self.state = "FIND"

        if self.state == "TURN":
            # rotate away from the wall side until the front clears
            return 0.05, -sign * cfg.max_turn
        if self.state == "FIND":
            # arc toward the wall side until something appears
            return cfg.max_speed * 0.7, sign * 0.4 * cfg.max_turn
        err = side_r - cfg.target_dist
        derr = (err - self.prev_err) / max(dt, 1e-3)
        self.prev_err = err
        omega = sign * max(
            -cfg.max_turn,
            min(cfg.max_turn, cfg.kp * err + cfg.kd * derr),
        )
        v = cfg.max_speed * max(0.3, 1.0 - abs(omega) / cfg.max_turn)
        return v, omega
