"""Host front end (ops/multicloud.py, ops/lines.py): mean ms of one
line extraction (extract_lines_any, the benchmark's span host.extract)
over the window."""


def read(ctx):
    t = ctx["spans"].get("host.extract", [])
    return sum(t) / len(t) * 1e3 if t else None
