"""window_glue_share.demwin: seconds of the traced calls inside the windowed
decoder's commit span (``ldpc.window.commit``, one a window: the committed
columns spliced into the answer and, after an open window, the committed
mechanisms XORed out of the later rounds' record, closed where the device has
done them) over the traced window, in %; nothing where the program records
no such span."""

from portbench.program import record, seconds


def read(ctx):
    rec = record(ctx)
    if rec is None or not any(sp.name == "ldpc.window.commit" for c in rec.calls
                              for sp in c.spans):
        return None
    return 100.0 * seconds(rec, "ldpc.window.commit") / ctx["trace"]["window_s"]
