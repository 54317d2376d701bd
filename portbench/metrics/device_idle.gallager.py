"""device_idle.gallager: the share of the traced window in which no device operation
runs (the union of the profiler's kernel, copy and set intervals), in %."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
