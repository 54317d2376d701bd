"""relay_share.flagship: seconds of the traced calls inside the staged decoder's
relay legs (``ldpc.staged.relay``, one a leg: its memory strengths' upload, the
K-member decode of the leg's bucket, the pick and its reads) over the traced
window, in %."""

from portbench.program import record, seconds


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    return 100.0 * seconds(rec, "ldpc.staged.relay") / ctx["trace"]["window_s"]
