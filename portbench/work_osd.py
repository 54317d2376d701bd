"""The yardstick of the OSD elimination's roofline: the least time one lane's
Gauss-Jordan elimination needs, the larger of its bytes' time and its
operations' time.

A lane is the packed system of ``m`` rows of ``W`` 32-bit words (its
columns ordered by reliability), with its syndrome.  Eliminating it reads
the system once and writes the reduced system once, reads the syndrome and
writes the transformed one, and writes one pivot column a row: ``2 W m``
words and ``3 m`` words, 4 bytes each (6,846,336 B at the bb144 R = 6 DEM,
W = 989 and m = 864: 2.044 us at 3.35 TB/s).

Its operations depend on its data: the schoolbook algorithm's column trips
(two operations a row each: the column's bit and the pivot test) and its
row XORs, each the words from the pivot's word on, at 16.75e12 32-bit
integer operations a second.  ``OPS_PER_LANE`` holds the mean a lane
counted on a cell's own failing lanes (``tools/osd_elim_work.py``); a shape
it does not hold is bounded by its bytes alone.  The count is a yardstick,
not a floor of every kernel: a blocked kernel XORs fewer words.
"""

from __future__ import annotations

from portbench.work import PEAK_BYTES_PER_S

__all__ = ["gf2_elim_lane", "OPS_PER_LANE", "PEAK_I32_OPS_PER_S"]

PEAK_I32_OPS_PER_S = 16.75e12

#: ``(W, m)`` -> operations a lane.  The bb144 R = 6 DEM: the mean of 64
#: failing lanes of ``bb144_r6_bposd.p003`` (76.5e6-90.4e6 each; every lane
#: makes all 31,648 trips, since the DEM's rank, 858, is below its 864 rows),
#: 4.73 us at 16.75e12/s against its bytes' 2.04 us
OPS_PER_LANE = {(989, 864): 79_236_155}


def gf2_elim_lane(W: int, m: int):
    """``(bytes, operations, least seconds)`` of one lane's elimination."""
    nbytes = (2 * W * m + 3 * m) * 4
    ops = OPS_PER_LANE.get((W, m), 0)
    return nbytes, ops, max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_I32_OPS_PER_S)
