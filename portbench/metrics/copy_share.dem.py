"""copy_share.dem: seconds of the traced calls inside the program's copy spans
(``ldpc.to_device``: the syndromes to the device and the staged decoder's
results back onto it; ``ldpc.to_host``: the decoder contract's outputs to
numpy) over the traced window, in %."""

from portbench.program import record, seconds


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    return 100.0 * seconds(rec, "ldpc.to_device", "ldpc.to_host") / ctx["trace"]["window_s"]
