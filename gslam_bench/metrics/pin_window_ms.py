"""Backend pins (models/backend.py `_pin_match_grid`): ms of
SubmapLoopCloser.prof["pin_window"] (the span slam.backend.pin_window:
the host numpy window correlation of each pin that passed its pooled
bound) per backend tick, over the window's ticks (final cleanups left
out). Host code only. None where the program has no such span or the
phase took no time in the window."""


def read(ctx):
    v = ctx["prof"].get("pin_window", 0.0)
    n = ctx["backend_ticks"]
    return v / n * 1e3 if v > 0 and n else None
