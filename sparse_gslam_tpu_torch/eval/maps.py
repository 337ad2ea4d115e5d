"""Global occupancy-map rendering from keyframe range data.

Replaces the reference's rviz Visualizer occupancy-grid topics
(src/visualizer.cpp:93-137 RangeDataInserter::rayTrace + :197-208
map publishing): re-ray-traces every keyframe's RangeData2D at the
current trajectory estimates into one grid and writes a PNG. Uses the
same insertion as submap construction. Port of
sparse_gslam_tpu/eval/maps.py; the PNG is written with zlib and struct
from the standard library (one pixel per grid cell).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..models.range_data import RangeData2D
from ..ops.grid import GridSpec, build_submap_grid


def map_range_data(keyframes, estimates, resolution: float = 0.1,
                   max_size: int = 2048):
    """All keyframes' scans in the world frame at `estimates`, and the
    spec of the square grid that holds them: a side that is a multiple
    of 64 cells, at most `max_size`. Returns (RangeData2D, GridSpec),
    the spec None when there are no points."""
    est = np.asarray(estimates)
    n = min(len(keyframes), len(est))
    world = RangeData2D()
    for i in range(n):
        keyframes[i].data.transform_into(est[i], world)
    if len(world.points) == 0:
        return world, None
    lo = world.points.min(0)
    hi = world.points.max(0)
    extent = float(max(hi[0] - lo[0], hi[1] - lo[1])) + 4.0
    size = int(np.ceil(extent / resolution / 64.0) * 64)
    size = min(size, max_size)
    return world, GridSpec(size=size, resolution=extent / size)


def render_map(
    keyframes,
    estimates,
    resolution: float = 0.1,
    hit_p: float = 0.7,
    miss_p: float = 0.4,
    max_size: int = 2048,
    device="cuda",
):
    """Build a global occupancy grid from all keyframes at `estimates`,
    inserting on `device`.

    Returns (probs (G,G) numpy float32, origin (2,), resolution).
    """
    world, spec = map_range_data(keyframes, estimates, resolution, max_size)
    if spec is None:
        return np.zeros((64, 64), np.float32), np.zeros(2), resolution
    sm = build_submap_grid(world, spec, hit_p, miss_p, device=device)
    return sm.probs.cpu().numpy(), sm.origin.cpu().numpy(), spec.resolution


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in rgb)

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", crc
        )

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _draw_line(img, a, b, color):
    """Colour the cells of img (indexed [x, y]) on the segment from cell
    coordinates a to b."""
    n = int(np.ceil(np.abs(b - a).max())) + 1
    ts = np.linspace(0.0, 1.0, n)[:, None]
    c = np.floor(a + (b - a) * ts).astype(np.int64)
    keep = ((c >= 0) & (c < np.array(img.shape[:2]))).all(axis=1)
    img[c[keep, 0], c[keep, 1]] = color


def map_image(probs, estimates=None, origin=None, resolution=None,
              segments=None, seg_color=(31, 119, 180)):
    """(H, W, 3) uint8 picture of a grid: free white, occupied black,
    unknown grey, x to the right and y up, with the trajectory drawn in
    red over it and `segments` ((a, b) world-frame point pairs) in
    seg_color."""
    arr = np.asarray(probs, dtype=np.float64)
    gray = np.where(arr > 0, 1.0 - arr, 0.5)
    img = np.repeat(np.round(gray * 255.0)[:, :, None], 3, axis=2)
    img = img.astype(np.uint8)  # indexed [x, y]
    if origin is not None and resolution:
        o = np.asarray(origin, np.float64)

        def cell(p):
            return (np.asarray(p, np.float64)[..., :2] - o) / resolution

        if estimates is not None:
            cells = cell(estimates)
            for a, b in zip(cells[:-1], cells[1:]):
                _draw_line(img, a, b, (255, 0, 0))
        for a, b in segments or ():
            _draw_line(img, cell(a), cell(b), seg_color)
    return img.transpose(1, 0, 2)[::-1]  # rows = y, top row = max y


def save_map_png(path, probs, estimates=None, origin=None,
                 resolution=None, segments=None, seg_color=(31, 119, 180)):
    """PNG dump with optional trajectory and segment overlays."""
    write_png(path, map_image(probs, estimates, origin, resolution,
                              segments, seg_color))
