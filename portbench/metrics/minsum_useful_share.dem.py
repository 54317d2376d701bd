"""minsum_useful_share.dem: the lane-iterations the traced shots needed (each
shot's reported iterations, stage 0 plus deep) over those the min-sum loop
launched (the program's ``minsum_lane_iters_launched``: lanes launched, tile
padding and ensemble members included, times the iterations each decode
ran), in %.  Times the kernels' efficiency on launched work it makes
``minsum_roofline.dem``."""

from portbench.program import record, totals


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    launched = totals(rec).get("minsum_lane_iters_launched", 0)
    if not launched:
        return None
    return 100.0 * ctx["trace"]["lane_iters"] / launched
