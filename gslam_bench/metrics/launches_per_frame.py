"""Device: kernel launches (device operations that are not copies or
fills) in the traced slice, over the frames the slice holds."""


def read(ctx):
    n = sum(1 for *_, kernel in ctx["trace"]["device"] if kernel)
    f = ctx["slice_frames"]
    return n / f if n and f > 0 else None
