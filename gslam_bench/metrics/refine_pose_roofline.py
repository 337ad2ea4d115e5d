"""Refinement kernel (ops/refine_cuda.py -> csrc/refine_pose.cu): its
roofline share over the window, in %: the least time of each launch
(roofline.refine_work from the launch's points and the GN steps each
stage ran, over the card's peaks) summed, over the kernel's time on the
card, summed from CUDA events recorded on its stream around each
launch. None without a launch, or on a card the peak table lacks."""
from gslam_bench import roofline


def read(ctx):
    peak = roofline.peaks(ctx["device_kind"])
    recs = ctx["launches"]["refine_pose"]
    if peak is None or not recs:
        return None
    least = 0.0
    for (n, steps, want_cov), _, _ in recs:
        for row in steps.cpu().tolist():
            least += roofline.bound_s(*roofline.refine_work(n, row, want_cov),
                                      peak)
    spent = sum(a.elapsed_time(b) for _, a, b in recs) * 1e-3
    return 100.0 * least / spent
