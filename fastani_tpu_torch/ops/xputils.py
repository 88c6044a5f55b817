"""Small tensor primitives (counterpart of ``fastani_tpu/ops/xputils.py``).

The JAX package built these from static shifts because scans and gathers
compiled slowly on the TPU; PyTorch has ``cummax`` and ``gather``
(``take_along`` is ``torch.gather``).  The bucket-LUT searchsorted of the
JAX package (``build_prefix_lut`` / ``lut_searchsorted``) is
``torch.searchsorted`` here.
"""

from __future__ import annotations

import torch

UMAX = 0xFFFFFFFF            # u32 pad value (carried in int64)
PINF = 2 ** 30               # position infinity (room for +C arithmetic)


def u32_as_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 values carried in int64 -> int32 words with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def last_event_value(event: torch.Tensor, val: torch.Tensor, seed: int):
    """out[..., i] = val[..., j] for the largest j <= i with event[..., j];
    ``seed`` if there is none.  Returns (out, has)."""
    n = event.shape[-1]
    ar = torch.arange(n, device=event.device).expand_as(event)
    idx = torch.where(event, ar, -1).cummax(dim=-1).values
    has = idx >= 0
    out = torch.where(has, torch.gather(val, -1, idx.clamp(min=0)),
                      torch.full_like(val, seed))
    return out, has


def shift_right(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x shifted right by s along the last axis, the first s slots ``fill``."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def shift_left(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x shifted left by s along the last axis, the last s slots ``fill``."""
    if s == 0:
        return x
    pad = torch.full(x.shape[:-1] + (s,), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[..., s:], pad], dim=-1)
