"""Insertion kernel (ops/grid.py -> grid_cuda -> csrc/insert_rays.cu):
its roofline share over the window, in %: the least time of each launch
(roofline.insertion_work over the card's peaks) summed, over the
kernel's time on the card, summed from CUDA events recorded on its
stream around each launch. None without a launch, or on a card the
peak table lacks."""
from gslam_bench import roofline


def read(ctx):
    peak = roofline.peaks(ctx["device_kind"])
    recs = ctx["launches"]["insert_rays"]
    if peak is None or not recs:
        return None
    least = sum(roofline.bound_s(*roofline.insertion_work(args), peak)
                for args, _, _ in recs)
    spent = sum(a.elapsed_time(b) for _, a, b in recs) * 1e-3
    return 100.0 * least / spent
