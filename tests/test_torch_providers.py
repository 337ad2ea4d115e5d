"""The port's log providers (sparse_gslam_tpu_torch/io/providers.py and
io/rosbag.py) against the JAX package's, on logs written inside the
test from a seed: CARMEN, fr079, stanford, oregon and USC text logs,
and Crazyflie telemetry bags (rosbag v2) with uncompressed and bz2
chunks. Both packages parse on the host, so every frame's time,
odometry and ranges are equal.
"""
import bz2
import struct

import numpy as np
import pytest

from sparse_gslam_tpu.io.providers import create_data_provider as j_create
from sparse_gslam_tpu_torch.io import providers as tprov
from sparse_gslam_tpu_torch.io import rosbag as trosbag


def fmt(v):
    return f"{v:.6f}"


def carmen_log(r, n_frames=12, beams=11):
    lines = ["# CARMEN log", "PARAM robot_name test"]
    for k in range(n_frames):
        ranges = r.uniform(0.2, 9.0, beams)
        pose = r.normal(0, 2, 3)
        t = 3.0 + 0.2 * ((k * 7) % n_frames)  # out of time order
        lines.append(" ".join(
            ["FLASER", str(beams), *map(fmt, ranges), *map(fmt, pose),
             *map(fmt, pose), fmt(t), "host", fmt(t)]))
    return lines


def fr079_log(r, n_frames=10, beams=9):
    lines = []
    t = 100.0
    for k in range(n_frames):
        for _ in range(2):
            t += 0.05
            x, y, th = r.normal(0, 1, 3)
            tv, rv = r.uniform(0, 0.5), r.uniform(-1e-3, 1e-3)
            lines.append(" ".join(["ODOM", *map(fmt, (x, y, th, tv, rv)),
                                   "0.0", fmt(t), "host", fmt(t)]))
        t += 0.02
        ranges = r.uniform(0.2, 9.0, beams)
        pose = r.normal(0, 1, 3)
        lines.append(" ".join(
            ["FLASER", str(beams), *map(fmt, ranges), *map(fmt, pose),
             *map(fmt, pose), fmt(t), "host", fmt(t)]))
    # a scan before any odometry is skipped by both
    return [lines[2]] + lines


def stanford_log(r, extra_cols, laser_start, n_frames=8):
    lines = ["# stanford-gates"]
    for k in range(n_frames):
        pose = r.normal(0, 3, 3)
        lines.append(" ".join(["0", "0", "0", "position", "0", "0",
                               *map(fmt, pose), "0.1", "0.2"]))
        vals = []
        for rng in r.uniform(0.1, 8.0, 181):
            vals += [fmt(rng)] + ["1"] * extra_cols
        head = ["0", "0", "0", "laser", "0", fmt(10.0 + k)]
        head += ["0"] * (laser_start - len(head))
        lines.append(" ".join(head + vals))
        if k % 3 == 2:  # a second scan without a new position: skipped
            lines.append(" ".join(head + vals))
    return lines


def usc_log(r, n_frames=8):
    lines = []
    for k in range(n_frames):
        if k % 2 == 0:
            lines.append(" ".join(["position", "0", "0",
                                   *map(fmt, r.normal(0, 3, 3))]))
        vals = []
        for rng in r.uniform(0.1, 8.0, 181):
            vals += [fmt(rng), "0", "0"]
        lines.append(" ".join(["laser", "0", fmt(20.0 + k), *vals]))
    return lines


TEXT_LOGS = {
    "carmen": lambda r: carmen_log(r),
    "fr079": lambda r: fr079_log(r),
    "stanford": lambda r: stanford_log(r, extra_cols=1, laser_start=10),
    "oregon": lambda r: stanford_log(r, extra_cols=2, laser_start=6),
    "usc": lambda r: usc_log(r),
}


def _record(fields, data):
    head = b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode()
                    + b"=" + v for k, v in fields.items())
    return (struct.pack("<I", len(head)) + head
            + struct.pack("<I", len(data)) + data)


def _rawdata(seq, stamp, raw):
    secs = int(stamp)
    nsecs = int(round((stamp - secs) * 1e9))
    frame = b"cf"
    return (struct.pack("<III", seq, secs, nsecs)
            + struct.pack("<I", len(frame)) + frame
            + struct.pack("<I", len(raw))
            + np.asarray(raw, "<f4").tobytes())


def drone_bag(path, r, compression, n_state=14, n_ranger=11):
    """A rosbag v2 with the two Crazyflie telemetry topics: state raw
    (x, y, z, vx, vy, vz) at one rate and ranger raw (4 ranges, z, qx,
    qy, qz, qw) at another, stamps interleaved, in one chunk."""
    topics = {0: trosbag.TOPIC_STATE, 1: trosbag.TOPIC_RANGER,
              2: "/other"}
    conns = b"".join(
        _record({"op": b"\x07", "conn": struct.pack("<I", c),
                 "topic": t.encode()}, b"type=sparse_gslam/RawData")
        for c, t in topics.items())
    msgs = []
    for k in range(n_state):
        t = 5.0 + 0.1 * k + r.uniform(0, 0.01)
        msgs.append((t, 0, r.normal(0, 2, 6)))
    for k in range(n_ranger):
        t = 5.0 + 0.13 * k + r.uniform(0, 0.01)
        q = r.normal(0, 1, 4)
        q /= np.linalg.norm(q)
        msgs.append((t, 1, np.concatenate([r.uniform(0.1, 4, 4),
                                           [1.0], q])))
    msgs.append((5.5, 2, np.zeros(3)))
    r.shuffle(msgs)
    body = b"".join(
        _record({"op": b"\x02", "conn": struct.pack("<I", c),
                 "time": struct.pack("<II", int(t), 0)},
                _rawdata(k, t, raw))
        for k, (t, c, raw) in enumerate(msgs))
    chunk = conns + body
    data = bz2.compress(chunk) if compression == "bz2" else chunk
    with open(path, "wb") as fh:
        fh.write(b"#ROSBAG V2.0\n")
        fh.write(_record({"op": b"\x03", "conn_count": struct.pack("<I", 3)},
                         b" " * 16))
        fh.write(_record({"op": b"\x05", "compression": compression.encode(),
                          "size": struct.pack("<I", len(chunk))}, data))


def assert_same_frames(port, ref):
    got, want = list(port.frames()), list(ref.frames())
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.time == b.time
        np.testing.assert_array_equal(a.pose, b.pose)
        np.testing.assert_array_equal(a.ranges, b.ranges)
    return got


@pytest.mark.parametrize("name", list(TEXT_LOGS))
def test_text_provider_equals_jax(tmp_path, name):
    path = tmp_path / f"{name}.log"
    path.write_text("\n".join(TEXT_LOGS[name](np.random.default_rng(5)))
                    + "\n")
    frames = assert_same_frames(tprov.create_data_provider(name, str(path)),
                                j_create(name, str(path)))
    beams = {"carmen": 11, "fr079": 9}.get(name, 181)
    assert all(len(f.ranges) == beams for f in frames)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_drone_bag_provider_equals_jax(tmp_path, compression):
    path = tmp_path / "flight.log"
    drone_bag(path, np.random.default_rng(6), compression)
    frames = assert_same_frames(
        tprov.create_data_provider("drone_bag", str(path)),
        j_create("drone_bag", str(path)))
    assert len(frames) == 14  # one per state message
    assert all(len(f.ranges) == 4 for f in frames)
    times = [f.time for f in frames]
    assert times == sorted(times)


def test_bag_reader_refuses_other_files(tmp_path):
    path = tmp_path / "not_a_bag.log"
    path.write_bytes(b"#ROSBAG V1.2\n")
    with pytest.raises(ValueError, match="not a rosbag v2.0"):
        list(trosbag.read_bag_messages(str(path)))


def test_unknown_provider_raises():
    with pytest.raises(ValueError, match="unknown data provider"):
        tprov.create_data_provider("kitti", "unused.log")
