"""Backend tick (models/backend.py precompute + match, every
match_interval frames): the mean ms of every backend tick of the window
(SlamSystem.backend_times). Kept as a per-layer number: it spreads too
widely from seed to seed for a bound (PERF.md, section 2)."""


def read(ctx):
    t = ctx["backend_times"]
    return sum(t) / len(t) * 1e3 if t else None
