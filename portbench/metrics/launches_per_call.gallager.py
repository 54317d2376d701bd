"""launches_per_call.gallager: device kernel launches in the traced window
(the profiler's count) over the decode calls traced."""


def read(ctx):
    t = ctx["trace"]
    if not t or not t["calls"] or not t["launches"]:
        return None
    return t["launches"] / t["calls"]
