"""Frontend LM (models/frontend.py -> ops/solvers.optimize_landmark_graph):
mean ms of one LM solve over the window, synchronised on the card before
and after (the benchmark's span frontend.lm)."""


def read(ctx):
    t = ctx["spans"].get("frontend.lm", [])
    return sum(t) / len(t) * 1e3 if t else None
