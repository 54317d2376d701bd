"""osd_ms_per_lane.dem: milliseconds of the traced calls inside the staged
decoder's host OSD span (``ldpc.staged.osd``) over the lanes sent to it
(the program's ``osd_lanes`` counter); nothing where no lane went."""

from portbench.program import record, seconds, totals


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    lanes = totals(rec).get("osd_lanes", 0)
    if not lanes:
        return None
    return 1e3 * seconds(rec, "ldpc.staged.osd") / lanes
