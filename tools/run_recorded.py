#!/usr/bin/env python3
"""One run of a benchmark cell with the decoder's recording on throughout.

    python3 tools/run_recorded.py --workload <cell> --seed <n> --seconds <s> --trace 0

``portbench/run.py``'s run, with arguments and result line alike, inside
``ldpcdecoders_tpu_torch.utils.profiling.recording()``: every span and
counter of the window's calls is recorded (no profiler runs, so no span
is a profiler range).  Against ``portbench/run.py`` on the same seed it
gives the cost of recording on, in ``shots_per_s``; the record's size goes
to standard error.
"""

import time

_T0 = time.perf_counter()  # the start of set-up, as portbench/run.py's

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from ldpcdecoders_tpu_torch.utils import profiling  # noqa: E402
from portbench import harness  # noqa: E402

if __name__ == "__main__":
    with profiling.recording() as rec:
        rc = harness.main(t_start=_T0)
    print(f"recorded {len(rec.calls)} calls, {len(rec.spans)} spans", file=sys.stderr)
    sys.exit(rc)
