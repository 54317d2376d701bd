"""minsum_roofline.dem: the least time the card needs for the min-sum work the
traced shots needed, over the device's busy time inside the traced calls, in %.

The work is each shot's reported iterations (stage 0 plus deep) times the
least time of one lane-iteration of min-sum on the code at the stated
dtype (portbench/work.py: bytes of the state carried between iterations
over 3.35 TB/s, or operations over 67 TFLOP/s, whichever is larger).  The
time is every device operation inside the calls, matched by no name.
"""

from portbench.work import minsum_lane_iteration

_BYTES = {"float32": 4, "bfloat16": 2}


def read(ctx):
    t = ctx["trace"]
    if not t or not t["lane_iters"] or t["busy_in_calls_s"] <= 0:
        return None
    s, c = ctx["config"]["stated"], ctx["code"]
    damped = bool(s.get("gammas", [s.get("damping", 0.0)])[0])
    _, _, least = minsum_lane_iteration(c["edges"], c["n"], c["m"], _BYTES[s["dtype"]], damped)
    return 100.0 * t["lane_iters"] * least / t["busy_in_calls_s"]
