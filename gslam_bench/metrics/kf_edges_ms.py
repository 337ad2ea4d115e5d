"""Backend pins and chain (`_keyframe_edges`): ms of
SubmapLoopCloser.prof["kf_edges"] (the per-keyframe pins) per backend tick, over the window's ticks (final cleanups left
out). A host clock with no synchronise: each phase ends in a host read.
None where the phase took no time in the window."""


def read(ctx):
    v = ctx["prof"].get("kf_edges", 0.0)
    n = ctx["backend_ticks"]
    return v / n * 1e3 if v > 0 and n else None
