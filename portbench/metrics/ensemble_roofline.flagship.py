"""ensemble_roofline.flagship: the least time the card needs for the min-sum work
the traced shots needed, over the device's busy time inside the traced calls,
in %.

The work is counted by the program: ``stage0_lane_iters`` (each shot's own
stage-0 iterations) at the stated stage-0 dtype, and ``member_lane_iters``
(each real member lane's own iterations in the deep ensemble and the relay
legs, bucket padding left out) at the stated deep dtype, each times the
least time of one damped lane-iteration on the code at that dtype
(portbench/work.py).  The time is every device operation inside the calls,
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
    if "stage0_lane_iters" not in c:
        return None
    s, code = ctx["config"]["stated"], ctx["code"]
    work = 0.0
    for counter, dtype in (("stage0_lane_iters", s["dtype"]), ("member_lane_iters",
                                                               s["deep_dtype"])):
        _, _, least = minsum_lane_iteration(code["edges"], code["n"], code["m"], _BYTES[dtype],
                                            damped=True)
        work += c.get(counter, 0) * least
    return 100.0 * work / t["busy_in_calls_s"]
