"""Refinement kernel at the padded sizes only 60 beams reaches
(ops/refine_cuda.py -> csrc/refine_pose.cu, N >= 512): its roofline
share, in %, over the window's launches at those N, computed by
refine_pose_roofline's reader (the least time of each launch from its
points and the GN steps each stage ran, over the kernel's time summed
from CUDA events). None without such a launch, or on a card the peak
table lacks."""
from gslam_bench.metrics import refine_pose_roofline

MIN_N = 512


def read(ctx):
    wide = [r for r in ctx["launches"]["refine_pose"] if r[0][0] >= MIN_N]
    return refine_pose_roofline.read(
        {**ctx, "launches": {**ctx["launches"], "refine_pose": wide}})
