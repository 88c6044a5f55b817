"""``device_idle_pct``: the share of the traced job's window in which no
operation ran on the card: 1 - (the union of the intervals of its
kernels, copies and sets) / (the window)."""

LAYER = "device"
MOVES = "pairs_per_s"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
