"""host_reads_per_call.dem: the program's device-to-host reads (its
``host_reads`` counter: the min-sum loop's all-converged flag at each check,
the staged decoder's reads of stage-0, deep and OSD inputs, the decoder
contract's outputs) over the traced calls."""

from portbench.program import record, totals


def read(ctx):
    rec = record(ctx)
    if rec is None:
        return None
    return totals(rec).get("host_reads", 0) / ctx["trace"]["calls"]
