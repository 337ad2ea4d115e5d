"""Backend closure apply (models/backend.py `_match_apply`): ms of
SubmapLoopCloser.prof["match_apply"] (the chain extended, the closure
edge added and the pose graph solved, ending in the solve's host read)
per backend tick, over the window's ticks (final cleanups left out).
None where no closure was applied in the window."""


def read(ctx):
    v = ctx["prof"].get("match_apply", 0.0)
    n = ctx["backend_ticks"]
    return v / n * 1e3 if v > 0 and n else None
