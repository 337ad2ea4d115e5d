"""Frontend tick (models/slam.py: extraction plus Frontend.tick, ending
in a host read): the 95th percentile, in ms, of every frontend tick of
the window (SlamSystem.frontend_times). Kept as a per-layer number: it
spreads too widely from run to run for a bound (PERF.md, section 2)."""
import numpy as np


def read(ctx):
    t = ctx["frontend_times"]
    return float(np.percentile(t, 95)) * 1e3 if t else None
