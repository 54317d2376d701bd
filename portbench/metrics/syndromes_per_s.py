"""syndromes_per_s: syndromes decoded over the window's whole time (host clock)."""


def read(ctx):
    return ctx["shots"] / ctx["window_s"]
