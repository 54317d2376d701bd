"""shots_per_s: detector records decoded over the window's whole time (host clock)."""


def read(ctx):
    return ctx["shots"] / ctx["window_s"]
