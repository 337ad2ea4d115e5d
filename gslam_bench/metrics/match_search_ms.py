"""Backend matcher (models/backend.py `match` -> ops/matching): ms of
SubmapLoopCloser.prof["match_search"] (the candidate search and its
refinement) per backend tick, over the window's ticks (final cleanups left
out). A host clock with no synchronise: each phase ends in a host read.
None where the phase took no time in the window."""


def read(ctx):
    v = ctx["prof"].get("match_search", 0.0)
    n = ctx["backend_ticks"]
    return v / n * 1e3 if v > 0 and n else None
