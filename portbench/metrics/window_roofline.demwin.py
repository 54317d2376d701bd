"""window_roofline.demwin: the least time the card needs for the min-sum work
the traced shots needed in each window, over the device's busy time inside the
traced calls, in %.

The work is counted by the program per window ``k``: ``stage0_lane_iters.w<k>``
(each shot's own stage-0 iterations in that window) at the stated stage-0
dtype and ``member_lane_iters.w<k>`` (each real member lane's own iterations
in that window's deep ensemble and relay legs) at the stated deep dtype, each
times the least time of one damped lane-iteration (portbench/work.py) on that
window's own model: its edges, columns and rows from the configuration's
``sizes.windows[k]``.  The time is every device operation inside the calls,
matched by no name.  Nothing is read from a program without those counters.
"""

from portbench.program import record, totals
from portbench.work import minsum_lane_iteration

_BYTES = {"float32": 4, "bfloat16": 2}


def read(ctx):
    t = ctx["trace"]
    rec = record(ctx)
    if rec is None or t["busy_in_calls_s"] <= 0:
        return None
    c = totals(rec)
    s, wins = ctx["config"]["stated"], ctx["config"]["sizes"]["windows"]
    if f"stage0_lane_iters.w{len(wins) - 1}" not in c:
        return None
    work = 0.0
    for k, w in enumerate(wins):
        for counter, dtype in (("stage0_lane_iters", s["dtype"]),
                               ("member_lane_iters", s["deep_dtype"])):
            _, _, least = minsum_lane_iteration(w["edges"], w["cols"], w["rows"],
                                                _BYTES[dtype], damped=True)
            work += c.get(f"{counter}.w{k}", 0) * least
    return 100.0 * work / t["busy_in_calls_s"]
