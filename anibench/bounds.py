"""The H100's peaks and the least time the L2 stage and K5 need for the
work that the traced job's inputs gave them: frozen copies of the kernel
table's arithmetic (``chip_smoke.py``: ``bound``, ``WALK_OPS_PER_EVENT``,
``EVENTS_*``), applied to the live units, their index entries and their
sketch hashes as the map step's own buffers held them (``trace.L2Work``).

Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM and 67 TFLOP/s in
float32 outside the tensor cores (no INT32 rate is published; the kernels
are integer code).
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12

# E1's integer operations an entry besides its two binary searches, E2's
# an event, K5's an event (the kernel table's counts)
EVENTS_OPS_PER_ENTRY = 24
EVENTS_SCAN_OPS_PER_EVENT = 30
WALK_OPS_PER_EVENT = 30
# bytes K5 reads an event: the six int32 rows of its input; and a unit:
# its sketch size and event count read, its best count and two
# positions written
WALK_BYTES_PER_EVENT = 24
WALK_BYTES_PER_UNIT = 20
# an index entry as the index tables hold it: int64 hash, int32 contig
# and position; a sketch hash, 32 bits; a unit's best count and
# position, written once
ENTRY_BYTES = 16
SKETCH_BYTES = 4
UNIT_OUT_BYTES = 12


def bound_s(nbytes: float, nops: float) -> float:
    return max(nbytes / PEAK_BYTES, nops / PEAK_OPS)


def events(entries: float) -> float:
    """The events a unit's walk needs for ``entries`` index entries in its
    window: one enter an entry, one leave an entry but the first, and
    one scoring event."""
    return 2 * entries


def walk_need_s(work: dict) -> float:
    """K5's least time for ``work`` (``trace.L2Work.result``): every live
    unit's events read once, 24 bytes and 30 operations each, and its 20
    bytes a unit."""
    ev = events(work["entries"])
    return bound_s(ev * WALK_BYTES_PER_EVENT
                   + work["units"] * WALK_BYTES_PER_UNIT,
                   ev * WALK_OPS_PER_EVENT)


def l2_need_s(work: dict) -> float:
    """The L2 stage's least time for ``work``, whichever kernels do it:
    each live unit reads its index entries and its sketch row once and
    writes its best count and position once; its operations are E1's an
    entry and E2's and K5's on its events."""
    ev = events(work["entries"])
    return bound_s(work["entries"] * ENTRY_BYTES
                   + work["sketch"] * SKETCH_BYTES
                   + work["units"] * UNIT_OUT_BYTES,
                   work["entries"] * EVENTS_OPS_PER_ENTRY
                   + ev * (EVENTS_SCAN_OPS_PER_EVENT + WALK_OPS_PER_EVENT))
