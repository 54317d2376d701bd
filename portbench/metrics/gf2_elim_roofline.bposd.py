"""gf2_elim_roofline.bposd: the least time the card needs to eliminate the
traced calls' failing lanes, over the device time of the OSD elimination
kernels, in %.

The lanes are the program's ``osd_dev_lanes`` counter (the real failing
lanes: a bucket's padding lanes count as waste); a lane's least time is
``portbench/work_osd.py``'s at the code's ``W = ceil(n / 32)`` words and
``m`` rows: the larger of its bytes (the packed system read once and
written once, its syndrome in and out, its pivots out, over 3.35 TB/s) and
its operations (the schoolbook elimination's trips and row XORs counted on
the cell's lanes, over 16.75e12 a second).  The kernel time is the trace
breakdown's device operations whose names hold ``gf2_``; that list is the
trace's ten largest, so nothing is read where no such kernel is among them
or no lane went to the device OSD.
"""

from portbench.program import record, totals
from portbench.work_osd import gf2_elim_lane


def read(ctx):
    t = ctx["trace"]
    rec = record(ctx)
    if rec is None:
        return None
    lanes = totals(rec).get("osd_dev_lanes", 0)
    kernel_s = sum(s for name, s in t.get("breakdown", {}).get("device_ops", [])
                   if "gf2_" in name)
    if not lanes or kernel_s <= 0:
        return None
    c = ctx["code"]
    _, _, least = gf2_elim_lane(-(-c["n"] // 32), c["m"])
    return 100.0 * lanes * least / kernel_s
