"""deep_share.dem: seconds of the traced calls inside the staged decoder's
stage-1 spans (``ldpc.staged.deep``, one a straggler bucket: its index build,
decode, reads and splicing; ``ldpc.staged.relay``, one a relay leg) over the
traced window, in %."""

from portbench.program import record, seconds


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    return 100.0 * seconds(rec, "ldpc.staged.deep", "ldpc.staged.relay") / ctx["trace"]["window_s"]
