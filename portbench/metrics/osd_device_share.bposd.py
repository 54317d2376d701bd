"""osd_device_share.bposd: seconds of the traced calls inside BP+OSD's device
OSD span (``ldpc.bposd.osd``: the failing lanes' gather, ``sort_and_pack``,
the elimination, the sweep, the unsort and the splice, closed where the
spliced answers are ready on the device) over the traced window, in %;
nothing where the program records no such span."""

from portbench.program import record, seconds


def read(ctx):
    rec = record(ctx)
    if rec is None or not any(sp.name == "ldpc.bposd.osd" for c in rec.calls for sp in c.spans):
        return None
    return 100.0 * seconds(rec, "ldpc.bposd.osd") / ctx["trace"]["window_s"]
