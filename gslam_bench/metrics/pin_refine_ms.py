"""Backend pins (models/backend.py `_pin_accept`): ms of
SubmapLoopCloser.prof["pin_refine"] (the span slam.backend.pin_refine:
each pin's refinement launch on the high-res grid and the host read it
ends in, so the kernel's time is inside) per backend tick, over the
window's ticks (final cleanups left out). None where the program has no
such span or the phase took no time in the window."""


def read(ctx):
    v = ctx["prof"].get("pin_refine", 0.0)
    n = ctx["backend_ticks"]
    return v / n * 1e3 if v > 0 and n else None
