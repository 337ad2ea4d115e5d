"""Device: the share of the traced slice's wall time in which no
operation ran on the card, in %: 1 - the union of the device
operations' intervals over the slice's seconds."""
from gslam_bench.trace import busy_intervals


def read(ctx):
    tr = ctx["trace"]
    if not tr["device"] or tr["wall_s"] <= 0:
        return None
    busy = sum(t - s for s, t in busy_intervals(tr["device"])) * 1e-9
    return 100.0 * (1.0 - busy / tr["wall_s"])
