"""Minimal pure-python rosbag v2.0 reader for the Crazyflie telemetry
bags shipped with the reference (olsson-demo, olsson-3loop, rice).

Replaces the reference's rosbag/message_filters dependency
(data_provider.cpp:250-317): reads uncompressed v2 bags, decodes the
custom sparse_gslam/RawData message (std_msgs/Header + float32[] raw,
msg/RawData.msg), approximate-time-syncs the two telemetry topics and
emits (time, SE2 pose, 4 ranges) tuples like ROSBagDataProvider.
Reads bz2-compressed chunks too. A copy of sparse_gslam_tpu/io/rosbag.py.
"""
from __future__ import annotations

import math
import struct

import numpy as np

TOPIC_STATE = "/crazyflie2/state_xyzv"
TOPIC_RANGER = "/crazyflie2/state_ranger_qxyzw"


def _parse_header(buf: bytes) -> dict:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1 :]
    return fields


def _records(buf: bytes, off: int = 0):
    """Iterate (header_fields, data_bytes) records in a buffer."""
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


def _decode_rawdata(data: bytes):
    """Decode sparse_gslam/RawData: Header{seq, stamp, frame_id} +
    float32[] raw. Returns (stamp_seconds, raw float array)."""
    off = 0
    (_seq,) = struct.unpack_from("<I", data, off)
    off += 4
    secs, nsecs = struct.unpack_from("<II", data, off)
    off += 8
    (slen,) = struct.unpack_from("<I", data, off)
    off += 4 + slen
    (alen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = np.frombuffer(data, dtype="<f4", count=alen, offset=off)
    return secs + nsecs * 1e-9, raw


def read_bag_messages(path: str):
    """Yield (topic, stamp, raw_array) for every RawData message."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#ROSBAG V2.0"):
            raise ValueError(f"{path}: not a rosbag v2.0 file")
        buf = f.read()
    conn_topics: dict[int, str] = {}
    for header, data in _records(buf):
        op = header.get("op", b"\x00")[0]
        if op == 0x07:  # connection
            (cid,) = struct.unpack("<I", header["conn"])
            conn_topics[cid] = header["topic"].decode()
        elif op == 0x05:  # chunk
            compression = header.get("compression", b"none").decode()
            if compression == "bz2":
                import bz2

                chunk = bz2.decompress(data)
            elif compression == "lz4":
                raise ValueError("lz4 rosbag chunks not supported")
            else:
                chunk = data
            for h2, d2 in _records(chunk):
                op2 = h2.get("op", b"\x00")[0]
                if op2 == 0x07:
                    (cid,) = struct.unpack("<I", h2["conn"])
                    conn_topics[cid] = h2["topic"].decode()
                elif op2 == 0x02:
                    (cid,) = struct.unpack("<I", h2["conn"])
                    stamp, raw = _decode_rawdata(d2)
                    yield conn_topics.get(cid, ""), stamp, raw


def _quat_to_yaw(qx, qy, qz, qw) -> float:
    return math.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))


def approximate_time_sync(s0, s1):
    """Greedy nearest-stamp pairing of two (stamp, payload) streams,
    emulating message_filters ApproximateTime (data_provider.cpp:263-264).

    Each message from the denser stream is matched at most once; pairs
    are emitted in time order keyed on stream-0 stamps.
    """
    pairs = []
    j = 0
    for t0, p0 in s0:
        # advance j to the closest stamp in s1
        while j + 1 < len(s1) and abs(s1[j + 1][0] - t0) <= abs(s1[j][0] - t0):
            j += 1
        if j < len(s1):
            pairs.append((t0, p0, s1[j][1]))
    return pairs


def read_rawdata_bag(path: str):
    """Full drone_bag decoding (data_provider.cpp:278-316).

    Returns a list of (time, pose[3], ranges[4]): pose xy from
    state_xyzv raw[0:2], yaw from state_ranger quaternion raw[5:9],
    ranges from state_ranger raw[0:4].
    """
    state, ranger = [], []
    for topic, stamp, raw in read_bag_messages(path):
        if topic == TOPIC_STATE:
            state.append((stamp, raw))
        elif topic == TOPIC_RANGER:
            ranger.append((stamp, raw))
    state.sort(key=lambda x: x[0])
    ranger.sort(key=lambda x: x[0])
    out = []
    for t, s_raw, r_raw in approximate_time_sync(state, ranger):
        yaw = _quat_to_yaw(r_raw[5], r_raw[6], r_raw[7], r_raw[8])
        pose = np.array([s_raw[0], s_raw[1], yaw], dtype=np.float64)
        ranges = np.asarray(r_raw[0:4], dtype=np.float64).copy()
        out.append((t, pose, ranges))
    return out
