"""Exact mapping of fragments that overflowed a capacity cap (counterpart
of ``fastani_tpu/models/glue.py::map_fallback_batch``).

The fixed-width map step leaves out every fragment over one of its caps
(``jitmap.map_step_packed``'s ``fallback_mask``).  ``map_fallback_batch``
maps such fragments again on the index's device with caps grown to what
the step's counters observed (``Mapper.with_caps``), until none
overflows; the JAX package runs its numpy kernels at data-sized caps
instead.  A fragment that needs a cap past a kernel's width limit stays
over it at the limit, and only such fragments go to the scalar oracle
(``utils/refmodel.py``), one by one, on the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fastani_tpu_torch.models import jitmap, l2walk
from fastani_tpu_torch.ops import sort
from fastani_tpu_torch.ops.stats import identities_for
from fastani_tpu_torch.utils import refmodel


class CapOverflowError(RuntimeError):
    """A fragment needs a cap past a kernel's width limit.  ``caps`` holds
    the growth that the kernels do take: every cap grown to its need, the
    ones past their limit to the limit."""

    def __init__(self, msg: str, caps: Dict[str, int]):
        super().__init__(msg)
        self.caps = caps


# cap -> (the counter that sizes it, rounding step, largest width the
# kernels take or None, what sets that limit).  The L2 event records hold
# ranks in 10 bits; K3 sorts rows of up to sort.MAX_KEYS hit keys
_CAPS = {
    "sketch_cap": ("max_s", 64, l2walk.MAX_SCAP, "the L2 event record"),
    "hits_cap": ("max_hits", 1024, sort.MAX_KEYS, "the K3 row sort"),
    "cand_cap": ("max_groups", 64, None, None),
    "l2_entry_cap": ("max_span", 128, l2walk.MAX_NCAP,
                     "the L2 event record"),
    "unit_cap": ("n_units", 1024, None, None),
}


def _grown_caps(cfg, c: Dict[str, int]) -> Dict[str, int]:
    """Caps that hold what the counters ``c`` of an overflowing batch
    observed, each rounded up to its step.  Raises ``CapOverflowError``
    (with the growth clamped to the limits) where a fragment needs more
    than a kernel's width limit."""
    caps, past = {}, []
    for cap, (counter, step, limit, holder) in _CAPS.items():
        cur, need = getattr(cfg, cap), c[counter]
        if cap == "sketch_cap" and c["sk_overflow"] and need <= cur:
            # the unique count fits: the emit row (>= 4 x sketch_cap wide,
            # mapping.sketch_fragments) overflowed, so widen both
            need = 2 * cur
        if need <= cur:
            continue
        if limit is not None and need > limit:
            past.append(f"{cap}: a fragment needs {need} ({counter} "
                        f"{c[counter]}), past the limit of {limit} of "
                        f"{holder}")
            need = limit
        grown = -(-need // step) * step
        if limit is not None:
            grown = min(grown, limit)
        if grown > cur:
            caps[cap] = grown
    if past:
        raise CapOverflowError("; ".join(past), caps)
    return caps


def map_fallback_batch(frags: torch.Tensor, mapper: "jitmap.Mapper", params,
                       stats: Optional[dict] = None):
    """Exact, gated mapping rows of the fragments ``frags`` (n, frag_len)
    on the index's device.  The batch is mapped with ``mapper``, then
    again with caps grown to the counters while a fragment overflows; once
    the caps reach the kernels' limits, the rows of the fragments that fit
    are kept and each fragment still over a cap is mapped by
    ``refmodel.map_fragment`` (counted in ``stats["oracle_frags"]``).

    Returns (rows, mapper): rows is a dict of host arrays ``frag`` (row in
    ``frags``), ``sid``, ``shared``, ``sketch``, ``mean_pos`` (int64) and
    ``ident`` (float32), the rows whose identity upper bound passes the
    cutoff (computeMap.hpp:375-403); mapper is the one whose caps held the
    batch."""
    while True:
        # eager: a fallback batch's height and caps are one-offs, which
        # graphs would capture for no replay
        out = jitmap.map_step_packed(mapper.cfg, frags, mapper.tables)
        c = dict(zip(jitmap.COUNT_NAMES, out["counts"].tolist()))
        if not jitmap.overflowed(c):
            break
        try:
            caps = _grown_caps(mapper.cfg, c)
        except CapOverflowError as e:
            caps = e.caps
        if not caps:
            break
        mapper = mapper.with_caps(**caps)
    # packed rows (frag, qno, qsid, sid, shared, sketch, mean_pos), valid
    # first; fragments still over a cap are left out of them
    packed = out["packed"][:, :c["n_valid"]].cpu().numpy().astype(np.int64)
    cols = [packed[i] for i in (0, 3, 4, 5, 6)]
    over = np.zeros(0, np.int64)
    if jitmap.overflowed(c):
        over = np.nonzero(out["fallback_mask"].cpu().numpy())[0]
    if len(over):
        host = mapper.index.host_view()
        rows = frags[torch.as_tensor(over, device=frags.device)].cpu().numpy()
        extra = [(f, m.ref_seq_id, m.conserved, m.sketch_size,
                  m.ref_start_pos)
                 for f, row in zip(over.tolist(), rows)
                 for m in refmodel.map_fragment(row, host, params, 0)]
        if extra:
            cols = [np.concatenate([a, b])
                    for a, b in zip(cols, np.array(extra, np.int64).T)]
    frag, sid, shared, sketch, pos = cols
    if stats is not None:
        stats["oracle_frags"] = stats.get("oracle_frags", 0) + len(over)
    ident, upper = identities_for(shared, sketch, params.kmer_size)
    keep = upper >= np.float32(params.percentage_identity)
    return dict(frag=frag[keep], sid=sid[keep], shared=shared[keep],
                sketch=sketch[keep], mean_pos=pos[keep],
                ident=ident[keep]), mapper
