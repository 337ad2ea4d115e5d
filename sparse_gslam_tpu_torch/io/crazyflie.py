"""Live Crazyflie telemetry bridge (the controller.py + converter.cpp
path of the reference).

Re-implements the maintained parts of the reference's live-robot flow
(scripts/controller.py:1-245: cflib log blocks -> RawData streams;
src/converter.cpp RawDataConverter: sync state_xyzv with
state_ranger_qxyzw into odometry + 4-beam frames) without ROS: a
LiveFrameSource accepts the two telemetry streams (from cflib when
available, or any asyncio/callback producer), approximate-time-syncs
them exactly like the rosbag provider, and yields io.providers.Frame
objects that feed SlamSystem.process_frame directly.

cflib is not bundled in this environment; CrazyflieBridge raises at
construction unless cflib is importable. The synchronization and
decoding logic (the part that matters for parity) is fully testable
without hardware via push(). Host code; port of
sparse_gslam_tpu/io/crazyflie.py. Like the JAX one, the bridge is a
live link, not a data_provider value.
"""
from __future__ import annotations

import collections
import math
import threading

import numpy as np

from .providers import Frame

STATE_VARS = ("stateEstimate.x", "stateEstimate.y", "stateEstimate.z")
RANGER_VARS = (
    "range.front", "range.left", "range.back", "range.right",
)


class LiveFrameSource:
    """Pairs the two telemetry streams by nearest timestamp (the
    message_filters ApproximateTime role, data_provider.cpp:263-264)
    and emits 4-beam frames."""

    def __init__(self, tolerance: float = 0.05, maxlen: int = 64):
        self.tolerance = tolerance
        self._state = collections.deque(maxlen=maxlen)
        self._ranger = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._out = collections.deque()

    def push_state(self, stamp: float, x: float, y: float):
        with self._lock:
            self._state.append((stamp, np.array([x, y])))
            self._try_match()

    def push_ranger(self, stamp: float, ranges, quat_xyzw):
        """ranges: 4 values in meters; quat: (qx, qy, qz, qw)."""
        qx, qy, qz, qw = quat_xyzw
        yaw = math.atan2(
            2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz)
        )
        with self._lock:
            self._ranger.append(
                (stamp, np.asarray(ranges, dtype=np.float64), yaw)
            )
            self._try_match()

    def _try_match(self):
        while self._state and self._ranger:
            ts, xy = self._state[0]
            # closest ranger sample
            best = min(
                range(len(self._ranger)),
                key=lambda i: abs(self._ranger[i][0] - ts),
            )
            tr, ranges, yaw = self._ranger[best]
            if abs(tr - ts) > self.tolerance:
                if tr < ts:
                    self._ranger.popleft()
                    continue
                break
            self._state.popleft()
            for _ in range(best + 1):
                self._ranger.popleft()
            pose = np.array([xy[0], xy[1], yaw])
            self._out.append(Frame(ts, pose, ranges))

    def frames(self):
        while True:
            with self._lock:
                if not self._out:
                    break
                yield self._out.popleft()


class CommandClient:
    """The command side of the reference's live-robot flow: the
    takeoff service client (scripts/takeoff.py:1-14) and the
    teleop / wall-following-autonomy toggle of controller.py
    (scripts/controller.py: joystick passthrough + the service that
    flips the onboard wall follower on and off).

    `link` is anything with send_hover_setpoint(vx, vy, yawrate_deg,
    z) and send_stop_setpoint() -- the cflib Commander satisfies it,
    and tests use a recording mock. Call step(ranges4, dt) at the
    telemetry rate; it emits exactly one setpoint per call from the
    active mode:

    - IDLE: nothing
    - TAKEOFF: ramp z from 0 to hover_height over takeoff_time
    - TELEOP: pass through the last set_velocity() command
    - WALL_FOLLOW: models.wall_follower output (the autonomous
      exploration the reference declares in
      wallfollowing_multirange_onboard.h:10-15)
    - LAND: ramp z to 0, then stop
    """

    def __init__(self, link, hover_height: float = 0.5,
                 takeoff_time: float = 2.0, wall_follower=None):
        self.link = link
        self.hover_height = hover_height
        self.takeoff_time = takeoff_time
        self.mode = "IDLE"
        self._z = 0.0
        self._t_mode = 0.0
        self._teleop = (0.0, 0.0, 0.0)  # vx, vy, yawrate (rad/s)
        if wall_follower is None:
            from ..models.wall_follower import WallFollower

            wall_follower = WallFollower()
        self.wall_follower = wall_follower

    # -- service entry points (takeoff.py / controller.py toggles) ----
    def takeoff(self):
        self.mode = "TAKEOFF"
        self._t_mode = 0.0

    def land(self):
        self.mode = "LAND"
        self._t_mode = 0.0

    def set_velocity(self, vx: float, vy: float, yawrate: float):
        """Teleop passthrough (controller.py joystick path)."""
        self.mode = "TELEOP"
        self._teleop = (vx, vy, yawrate)

    def toggle_wall_following(self, on: bool):
        """The autonomy service: True hands control to the wall
        follower, False returns to teleop hover."""
        if on:
            self.mode = "WALL_FOLLOW"
        elif self.mode == "WALL_FOLLOW":
            self.mode = "TELEOP"
            self._teleop = (0.0, 0.0, 0.0)

    # -- telemetry-rate pump ------------------------------------------
    def step(self, ranges4=None, dt: float = 0.1):
        """ranges4 = (front, left, back, right) meters; required in
        WALL_FOLLOW mode."""
        self._t_mode += dt
        if self.mode == "IDLE":
            return
        if self.mode == "TAKEOFF":
            a = min(self._t_mode / self.takeoff_time, 1.0)
            self._z = a * self.hover_height
            self.link.send_hover_setpoint(0.0, 0.0, 0.0, self._z)
            if a >= 1.0:
                self.mode = "TELEOP"
                self._teleop = (0.0, 0.0, 0.0)
            return
        if self.mode == "LAND":
            self._z = max(self._z - dt * self.hover_height
                          / self.takeoff_time, 0.0)
            if self._z <= 0.0:
                self.link.send_stop_setpoint()
                self.mode = "IDLE"
            else:
                self.link.send_hover_setpoint(0.0, 0.0, 0.0, self._z)
            return
        if self.mode == "WALL_FOLLOW":
            if ranges4 is None:
                raise ValueError("WALL_FOLLOW mode needs ranges4")
            v, omega = self.wall_follower.step(
                float(ranges4[0]), float(ranges4[1]),
                float(ranges4[2]), float(ranges4[3]), dt=dt,
            )
            self.link.send_hover_setpoint(
                v, 0.0, math.degrees(omega), self._z
            )
            return
        vx, vy, yawrate = self._teleop
        self.link.send_hover_setpoint(
            vx, vy, math.degrees(yawrate), self._z
        )


class CrazyflieBridge:
    """cflib log-block subscription feeding a LiveFrameSource
    (controller.py:40-120 semantics: two 10 Hz log configs)."""

    def __init__(self, uri: str, source: LiveFrameSource | None = None):
        try:
            import cflib.crtp  # noqa: F401
            from cflib.crazyflie import Crazyflie  # noqa: F401
        except ImportError as e:  # pragma: no cover
            raise RuntimeError(
                "cflib is not installed; live Crazyflie operation "
                "requires it (the log-replay paths do not)"
            ) from e
        self.uri = uri
        self.source = source or LiveFrameSource()

    def start(self):  # pragma: no cover - hardware path
        import time

        import cflib.crtp
        from cflib.crazyflie import Crazyflie
        from cflib.crazyflie.log import LogConfig

        cflib.crtp.init_drivers()
        cf = Crazyflie()
        cf.open_link(self.uri)

        state_cfg = LogConfig(name="state", period_in_ms=100)
        for v in STATE_VARS[:2]:
            state_cfg.add_variable(v, "float")
        ranger_cfg = LogConfig(name="ranger", period_in_ms=100)
        for v in RANGER_VARS:
            ranger_cfg.add_variable(v, "uint16_t")
        for v in ("stateEstimate.qx", "stateEstimate.qy",
                  "stateEstimate.qz", "stateEstimate.qw"):
            ranger_cfg.add_variable(v, "float")

        def on_state(ts, data, _):
            self.source.push_state(
                ts / 1000.0,
                data["stateEstimate.x"], data["stateEstimate.y"],
            )

        def on_ranger(ts, data, _):
            self.source.push_ranger(
                ts / 1000.0,
                [data[v] / 1000.0 for v in RANGER_VARS],
                (
                    data["stateEstimate.qx"], data["stateEstimate.qy"],
                    data["stateEstimate.qz"], data["stateEstimate.qw"],
                ),
            )

        cf.log.add_config(state_cfg)
        cf.log.add_config(ranger_cfg)
        state_cfg.data_received_cb.add_callback(on_state)
        ranger_cfg.data_received_cb.add_callback(on_ranger)
        state_cfg.start()
        ranger_cfg.start()
        self._cf = cf
        time.sleep(0.5)
