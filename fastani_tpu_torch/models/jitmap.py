"""The mapping step (counterpart of ``fastani_tpu/models/jitmap.py``).

One fragment batch against the device-resident index: sketch, L1, unit
compaction to ``unit_cap``, L2 over chunks of ``unit_chunk`` units (on a
card one full wave of K5 blocks, ``chunk_width``), the
identity gate, and the packed valid-first block the device CGI folds.
The step runs as three stages over one dict of buffers: ``stage_pre``
(everything before L2), ``stage_chunk`` (one L2 chunk at a device-held
offset) and ``stage_post`` (gate, fallback mask, pack, counts).
``map_step_packed`` runs them eagerly; on a card ``Mapper`` captures them
as CUDA graphs (``StepGraphs``), the counterpart of the JAX package's
``jax.jit`` of the step.  ``Mapper.dispatch`` / ``collect`` /
``collect_device`` are the JAX package's batch contract: every batch is
padded to the mapper's height and passes ``row_valid``, so one captured
key serves every batch of a run, and the readout is left to the caller.
Between the stages the host reads one scalar a batch, the live unit
count, to replay the chunk up to the last chunk with a valid unit (the
JAX package's device-side ``while_loop`` bound: torch's ``CUDAGraph``
has no conditional node).

Spans (``utils/spans.py``) of a dispatched batch: ``batch.upload`` (with
``batch.upload_wait``, the wait for a pinned input set's last copy),
``batch.capture`` (the first batch on a card) and ``batch.n_live_read``;
counter ``l1.key_bits`` (32 or 64: the L1 hit keys' width, set where a
``Mapper`` makes its config);
counter ``l2.chunks`` (the L2 chunks run) and gauge ``l2.chunk_units``
(their width, ``chunk_width``);
counter ``l2.event_slots`` (each chunk's units times its event row
width, 2 x l2_entry_cap + 1), and, while tracing, ``l2.window_entries``
(``window_entries``, under span ``l2.window_count``: the traced job's
only device work that an untraced job does not run).
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import Dict, Optional

import numpy as np
import torch

from fastani_tpu_torch.models import l2walk, mapping
from fastani_tpu_torch.ops import compact, cuda, stats
from fastani_tpu_torch.ops.xputils import PINF, UMAX
from fastani_tpu_torch.utils import spans

# the 11 entries of map_step_packed's counts vector, in order
COUNT_NAMES = ("n_valid", "sk_overflow", "l1_overflow", "l2_overflow",
               "unit_overflow", "max_hits", "max_groups", "max_s",
               "max_span", "n_units", "sum_hits")


def overflowed(counts: dict) -> bool:
    """Whether a batch's counts (named by COUNT_NAMES) say a fragment
    overflowed a cap: the sketch, L1, L2 or unit flag."""
    return any(counts[key] for key in COUNT_NAMES[1:5])


@functools.lru_cache(maxsize=None)
def gate_lut_np(k: int, perc_identity: float, s_max: int) -> np.ndarray:
    """min_c[s] = smallest shared count whose CI upper bound passes the
    identity cutoff (computeMap.hpp:384); s_max+1 for s = 0."""
    _, upper = stats.identity_tables(k, s_max)
    out = np.full(s_max + 1, s_max + 1, dtype=np.int32)
    for s in range(1, s_max + 1):
        ok = np.nonzero(upper[s, : s + 1] >= np.float32(perc_identity))[0]
        out[s] = int(ok[0]) if len(ok) else s + 1
    return out


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    kmer_size: int
    window_size: int
    frag_len: int
    sketch_cap: int
    hits_cap: int
    cand_cap: int
    l2_entry_cap: int
    unit_cap: int        # max L2 work units per fragment batch
    unit_chunk: int      # units per L2 chunk
    freq_threshold: int
    # (seqId << wpos_bits | wpos) packing width of 32-bit L1 hit keys;
    # None when the index does not fit (64-bit keys, mapping.hit_key_layout)
    wpos_bits: Optional[int]

    @classmethod
    def from_params(cls, params, freq_threshold: int, unit_factor: int = 4,
                    unit_chunk: int = 16, index=None,
                    height: Optional[int] = None) -> "MapperConfig":
        if params.sketch_cap > l2walk.MAX_SCAP:
            raise ValueError(f"sketch_cap={params.sketch_cap} exceeds the L2 "
                             f"event record limit of {l2walk.MAX_SCAP}")
        if params.l2_entry_cap > l2walk.MAX_NCAP:
            raise ValueError(f"l2_entry_cap={params.l2_entry_cap} exceeds "
                             f"the L2 event record limit of {l2walk.MAX_NCAP}")
        wpos_bits = None
        if index is not None and len(index.metadata):
            max_len = max(c.length for c in index.metadata)
            n_seqs = len(index.metadata)
            # headroom for position + span queries so keys never saturate
            bits = max(int(max_len + 2 * params.frag_len).bit_length(), 1)
            if ((n_seqs - 1) << bits) + ((1 << bits) - 1) < 0xFFFFFFFF:
                wpos_bits = bits
        return cls(
            kmer_size=params.kmer_size, window_size=params.window_size,
            frag_len=params.frag_len, sketch_cap=params.sketch_cap,
            hits_cap=params.hits_cap, cand_cap=params.cand_cap,
            l2_entry_cap=params.l2_entry_cap,
            unit_cap=unit_cap_for(params, unit_factor, height),
            unit_chunk=unit_chunk, freq_threshold=freq_threshold,
            wpos_bits=wpos_bits)


def unit_cap_for(params, unit_factor: int,
                 height: Optional[int] = None) -> int:
    """The L2 work units a batch of ``height`` fragments (default
    ``params.frag_batch``) holds at ``unit_factor`` units a fragment,
    never more than the candidate grid (F x cand_cap) itself."""
    F = params.frag_batch if height is None else height
    return F * min(unit_factor, params.cand_cap)


def chunk_width(dev: torch.device, unit_cap: int, sketch_cap: int,
                narrow: int) -> int:
    """The units of one L2 chunk, and so of one K5 launch.  On a card, one
    full wave of K5 blocks: the SMs times the blocks an SM holds at K5's
    shared memory for ``sketch_cap``, times the 32 units of a block, at
    most ``unit_cap``.  K5's time is set by the longest event chain of its
    units, not by their number, so a narrower launch takes as long and
    leaves SMs idle.  On the CPU ``narrow``, the JAX package's chunk."""
    if dev.type != "cuda":
        return narrow
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * l2walk.walk_blocks_per_sm(sketch_cap)
    return min(blocks * l2walk.WALK_BLOCK_UNITS, unit_cap)


def job_mapper(params, index, n_genomes: int, height: int) -> "Mapper":
    """The map step of a job's shard (the whole index on one device) of
    ``n_genomes`` reference genomes for batches of ``height`` rows, at the
    caps ``config.scale_caps`` set: L2 units for ~1.7 candidate regions
    per fragment and genome (``unit_factor`` int(1.7 G) + 8, the JAX
    package's), ``unit_cap_for`` the height, in chunks of one full wave of
    K5 blocks on a card (``chunk_width``), of up to 512 units on the
    CPU."""
    uf = int(1.7 * n_genomes) + 8
    chunk = chunk_width(index.device, unit_cap_for(params, uf, height),
                        params.sketch_cap, min(512, height))
    return Mapper(params, index, unit_factor=uf, unit_chunk=chunk,
                  height=height)


@dataclasses.dataclass
class IndexTables:
    """The device tables one mapping step reads (padded to a common M)."""
    occ_hash: torch.Tensor      # (M,) int64 lookup-order hashes
    occ_keys: torch.Tensor      # (M,) L1 hit keys (mapping.hit_keys)
    mi_hash: torch.Tensor       # (M,) int64 build-order hashes
    mi_sid: torch.Tensor        # (M,) int32
    mi_wpos: torch.Tensor       # (M,) int32
    mi_prev: torch.Tensor       # (M,) int64 prev same-(hash, seqId) entry
    mi_nxt: torch.Tensor        # (M,) int64 next same-(hash, seqId) entry
    n_occ: int                  # true entry count
    min_hits: torch.Tensor      # (s_max+1,) int64 min-hits LUT
    gate: torch.Tensor          # (s_max+1,) int64 identity-gate LUT


def locate_units(cfg: MapperConfig, frags: torch.Tensor,
                 t: IndexTables) -> dict:
    """Sketch, L1, valid-unit compaction to ``unit_cap`` and each unit's
    entry window: everything of one batch before its L2 chunks.  The live
    unit count ``n_live`` and ``unit_overflow`` stay on the device (0-d
    tensors): nothing here reads the device from the host."""
    F = frags.shape[0]
    dev = frags.device
    k, w, l = cfg.kmer_size, cfg.window_size, cfg.frag_len
    qh, s, sk_over = mapping.sketch_fragments(frags, k, w, cfg.sketch_cap)
    l1 = mapping.l1_candidates(qh, s, t.occ_hash, t.occ_keys, t.n_occ,
                               t.min_hits, cfg.freq_threshold, l,
                               cfg.hits_cap, cfg.cand_cap, cfg.wpos_bits)

    # flatten the candidate grid and compact valid units to the front
    # (K2, stable: fragment-major order kept)
    u_frag = torch.arange(F, dtype=torch.int32, device=dev)[:, None].expand(
        F, cfg.cand_cap).reshape(1, -1)
    n_valid_units = l1.valid.sum()
    u_sid, u_start, u_end, u_frag = (a[0] for a in compact.compact_rows(
        l1.valid.reshape(1, -1),
        [(l1.sid.reshape(1, -1), 0), (l1.start.reshape(1, -1), 0),
         (l1.end.reshape(1, -1), 0), (u_frag, 0)], width=cfg.unit_cap))
    U = cfg.unit_cap
    u_valid = torch.arange(U, device=dev) < n_valid_units
    # exact per-fragment attribution of dropped units: fragment f's units
    # occupy [cum_excl[f], cum[f]) and any past unit_cap are dropped
    nvf = l1.valid.sum(dim=-1)

    # window location: first entry at/after the range start, end of the
    # last window (lower bounds over (seqId, wpos), winSketch.hpp:259-270)
    sid_m = torch.where(u_valid, u_sid, 0).to(torch.int64)
    b0 = mapping._searchsorted_pairs(t.mi_sid, t.mi_wpos, sid_m,
                                     u_start.to(torch.int64))
    eL = mapping._searchsorted_pairs(t.mi_sid, t.mi_wpos, sid_m,
                                     u_end.to(torch.int64) + l)
    return dict(qh=qh, s=s, sk_over=sk_over, l1=l1, u_frag=u_frag,
                u_sid=u_sid, u_valid=u_valid, b0=b0, eL=eL, nvf=nvf,
                # L2 runs only over chunks holding a valid unit (valid
                # units come first)
                n_live=n_valid_units.clamp(max=U),
                unit_overflow=n_valid_units > U,
                unit_drop_frag=(torch.cumsum(nvf, 0) > U) & (nvf > 0))


def l2_chunk_args(cfg: MapperConfig, t: IndexTables, u: dict, sl) -> tuple:
    """The ``l2walk.build_events`` / ``l2_walk_units`` arguments of the
    units ``sl`` (a slice, or a tensor of unit numbers) of
    ``locate_units``' result ``u``."""
    return (u["qh"], u["s"], u["u_frag"][sl].long(), u["u_sid"][sl],
            u["u_valid"][sl], u["b0"][sl], u["eL"][sl], t.mi_hash, t.mi_sid,
            t.mi_wpos, t.mi_prev, t.mi_nxt, cfg.frag_len, cfg.kmer_size,
            cfg.window_size, cfg.l2_entry_cap)


# The map step in three stages over one dict of buffers (the counterpart
# of the JAX package's jitted ``map_step_packed`` and its device-side L2
# ``while_loop``): the inputs (INPUTS, None where not given), then what
# each stage writes.  Eagerly the dict is made anew a batch; under CUDA
# graphs (``StepGraphs``) its tensors are the graphs' static buffers.
INPUTS = ("frags", "qno_row", "qsid_row", "row_valid")
OUTPUTS = ("packed", "counts", "fallback_mask")
_L2_OUT = ("shared", "mean_pos", "l2_valid", "l2_over")


def n_chunks(cfg: MapperConfig, n_live: torch.Tensor) -> int:
    """The L2 chunks holding the live units, ceil(n_live / unit_chunk): the
    one read of the device in the middle of a batch."""
    return -(-int(n_live) // cfg.unit_chunk)


def window_entries(cfg: MapperConfig, bufs: dict) -> torch.Tensor:
    """The index entries the live units' windows need, on the device: each
    live unit's ``eL - b0``, at most ``l2_entry_cap``, summed."""
    U = cfg.unit_cap
    ent = (bufs["eL"][:U] - bufs["b0"][:U]).clamp(0, cfg.l2_entry_cap)
    return torch.where(bufs["u_valid"][:U], ent, 0).sum()


def live_chunks(cfg: MapperConfig, bufs: dict) -> int:
    """``n_chunks`` of a batch whose ``stage_pre`` has run, the read of
    ``n_live`` as span ``batch.n_live_read``, with the batch's L2 counters
    (``l2.chunks``, ``l2.chunk_units``, ``l2.event_slots``, and
    ``l2.window_entries`` summed on the device while tracing)."""
    if spans.tracing():
        with spans.span("l2.window_count"):
            spans.add_device("l2.window_entries", window_entries(cfg, bufs))
    with spans.span("batch.n_live_read"):
        n_live = int(bufs["n_live"])
    n = n_chunks(cfg, n_live)
    spans.count("l2.chunks", n)
    spans.gauge("l2.chunk_units", cfg.unit_chunk)
    spans.count("l2.event_slots",
                n * cfg.unit_chunk * (2 * cfg.l2_entry_cap + 1))
    return n


def stage_pre(cfg: MapperConfig, t: IndexTables, bufs: dict) -> None:
    """Stage 1: ``locate_units`` on ``bufs["frags"]``, its unit arrays
    padded with invalid units to whole chunks (the JAX ``pad_to``), and the
    L2 outputs zeroed and the chunk offset ``off`` set to 0 for
    ``stage_chunk``."""
    u = locate_units(cfg, bufs["frags"], t)
    pad = -cfg.unit_cap % cfg.unit_chunk
    for name in ("u_frag", "u_sid", "u_valid", "b0", "eL"):
        if pad:
            u[name] = torch.cat([u[name], u[name].new_zeros(pad)])
    dev = bufs["frags"].device
    Up = cfg.unit_cap + pad
    bufs.update(u, off=torch.zeros((), dtype=torch.int64, device=dev),
                **{name: torch.zeros(Up, dtype=dt, device=dev)
                   for name, dt in zip(_L2_OUT, (torch.int32, torch.int32,
                                                 torch.bool, torch.bool))})


def stage_chunk(cfg: MapperConfig, t: IndexTables, bufs: dict) -> None:
    """Stage 2: one L2 chunk, the ``unit_chunk`` units at the device offset
    ``bufs["off"]``: ``build_events``, K4 and K5, the results scattered
    back at the offset, which then advances by ``unit_chunk``.  A unit's
    L2 does not depend on the other units of its chunk, so ``n_chunks``
    calls give what slicing the units chunk by chunk gives, bit for bit."""
    idx = bufs["off"] + torch.arange(cfg.unit_chunk, device=bufs["off"].device)
    res = l2walk.l2_walk_units(*l2_chunk_args(cfg, t, bufs, idx))
    for name, r in zip(_L2_OUT, res):
        bufs[name].index_copy_(0, idx, r)
    bufs["off"] += cfg.unit_chunk


def stage_post(cfg: MapperConfig, t: IndexTables, bufs: dict) -> None:
    """Stage 3: the identity gate, the per-fragment fallback mask, the
    (7, unit_cap) int32 block sorted valid-first, rows (frag, qno, qsid,
    sid, shared, sketch, mean_pos), and the (11,) ``counts`` vector named
    by COUNT_NAMES, into ``bufs`` (OUTPUTS)."""
    U = cfg.unit_cap
    F = bufs["frags"].shape[0]
    u_frag, sid, u_valid, b0, eL, shared, mean_pos, l2_valid, l2_over = (
        bufs[name][:U] for name in ("u_frag", "u_sid", "u_valid", "b0", "eL")
        + _L2_OUT)
    s, l1, sk_over = bufs["s"], bufs["l1"], bufs["sk_over"]
    qno_row, qsid_row, row_valid = (bufs.get(name) for name in INPUTS[1:])
    frag = u_frag.long()
    # identity gate: shared >= gate[s]
    s_u = s[frag]
    gated = l2_valid & (shared >= t.gate[s_u.clamp(0, t.gate.shape[0] - 1)])
    max_span = torch.where(u_valid, eL - b0, 0).max()
    fc = frag.clamp(0, F - 1)
    fb_l2 = torch.zeros(F, dtype=torch.int32, device=frag.device)
    fb_l2.index_add_(0, fc, l2_over.to(torch.int32))
    fallback_mask = (sk_over | l1.overflow | (fb_l2 > 0)
                     | bufs["unit_drop_frag"])
    if row_valid is not None:
        fallback_mask = fallback_mask & row_valid
    keep = gated & ~l2_over & ~fallback_mask[fc]
    if row_valid is not None:
        keep = keep & row_valid[fc]
    corder = torch.argsort((~keep).to(torch.int32), stable=True)
    qno = torch.zeros_like(u_frag) if qno_row is None else qno_row[frag]
    qsid = u_frag if qsid_row is None else qsid_row[frag]
    packed = torch.stack([
        u_frag, qno.to(torch.int32), qsid.to(torch.int32), sid, shared,
        s_u.to(torch.int32), mean_pos])[:, corder]
    counts = torch.stack([
        keep.sum(), sk_over.any(), l1.overflow.any(), l2_over.any(),
        bufs["unit_overflow"], l1.n_hits.max(), l1.n_groups.max(), s.max(),
        max_span, bufs["nvf"].sum(), l1.n_hits.sum()]).to(torch.int64)
    bufs.update(packed=packed, counts=counts, fallback_mask=fallback_mask)


def map_step_packed(cfg: MapperConfig, frags: torch.Tensor, t: IndexTables,
                    qno_row: Optional[torch.Tensor] = None,
                    qsid_row: Optional[torch.Tensor] = None,
                    row_valid: Optional[torch.Tensor] = None) -> dict:
    """One fragment batch against one index, eagerly: ``stage_pre``,
    ``stage_chunk`` ``n_chunks`` times, ``stage_post``.  Returns OUTPUTS:
    ``packed`` (7, unit_cap) int32, ``counts`` (11,) int64 and
    ``fallback_mask`` (F,) bool."""
    bufs = dict(zip(INPUTS, (frags, qno_row, qsid_row, row_valid)))
    stage_pre(cfg, t, bufs)
    for _ in range(live_chunks(cfg, bufs)):
        stage_chunk(cfg, t, bufs)
    stage_post(cfg, t, bufs)
    return {name: bufs[name] for name in OUTPUTS}


class StepGraphs:
    """The three stages of one mapper's batches (its ``MapperConfig`` and
    height, every input given) captured as CUDA graphs over static
    buffers, in one memory pool: they always replay in the order pre,
    chunk ..., post.  ``run`` copies a batch into the static inputs,
    replays pre, reads ``n_live``, replays chunk ``n_chunks`` times, then
    post, and copies the outputs into the next of two slots, which it
    returns: the static outputs are overwritten by the next replay, a slot
    by the replay after next.  A capture that reads the device from the
    host raises.  ``launches`` holds each graph's kernel launches (the
    wrappers' counts during its capture); each replay adds them to
    ``cuda.LAUNCHES``."""

    STAGES = (("pre", stage_pre), ("chunk", stage_chunk),
              ("post", stage_post))

    def __init__(self, cfg: MapperConfig, t: IndexTables, inputs: dict):
        """Capture on the current stream, which must not be the default
        stream (``Mapper.dispatch`` captures on its side stream)."""
        self.cfg = cfg
        self.bufs = {name: torch.empty_like(x) for name, x in inputs.items()}
        self.graphs, self.launches = {}, {}
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        pool = None
        for name, stage in self.STAGES:
            g = torch.cuda.CUDAGraph()
            with cuda.captured_launches() as launches:
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    stage(cfg, t, self.bufs)
                finally:
                    g.capture_end()
            if pool is None:
                pool = g.pool()
            self.graphs[name], self.launches[name] = g, launches
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.slots = [{name: torch.empty_like(self.bufs[name])
                       for name in OUTPUTS} for _ in range(2)]
        self._turn = 0

    def _replay(self, name: str) -> None:
        self.graphs[name].replay()
        cuda.add_launches(self.launches[name])

    def replay_chunks(self, n: int) -> None:
        for _ in range(n):
            self._replay("chunk")

    def run(self, inputs: dict) -> dict:
        for name, x in inputs.items():
            self.bufs[name].copy_(x)
        self._replay("pre")
        self.replay_chunks(live_chunks(self.cfg, self.bufs))
        self._replay("post")
        slot = self.slots[self._turn]
        self._turn ^= 1
        for name in OUTPUTS:
            slot[name].copy_(self.bufs[name])
        return dict(slot)


class HostInputs:
    """A batch's four input arrays (INPUTS) padded to ``height`` rows and
    sent to the device.  On a card they are staged in two sets of pinned
    host buffers used in turn and copied with ``non_blocking``: the host
    does not wait for the device, and a set is refilled only after the
    event of the copy that read it.  On the CPU they are new arrays."""

    def __init__(self, height: int, frag_len: int, dev: torch.device):
        self.height, self.frag_len, self.dev = height, frag_len, dev
        self._sets = ([self._pinned() for _ in range(2)]
                      if dev.type == "cuda" else [])
        self._events, self._turn = [None, None], 0

    def _arrays(self) -> dict:
        """One set of zeroed host arrays, by INPUTS name."""
        H, L = self.height, self.frag_len
        return dict(zip(INPUTS, (np.zeros((H, L), np.uint8),
                                 np.zeros(H, np.int32), np.zeros(H, np.int32),
                                 np.zeros(H, bool))))

    def _pinned(self) -> tuple:
        """One set of pinned tensors and the numpy views the host fills."""
        pinned = {name: torch.from_numpy(a).pin_memory()
                  for name, a in self._arrays().items()}
        return pinned, {name: t.numpy() for name, t in pinned.items()}

    def upload(self, frags: np.ndarray, qno_row: np.ndarray,
               qsid_row: np.ndarray, n_used: int) -> Dict[str, torch.Tensor]:
        n = len(frags)
        if not 0 <= n_used <= n <= self.height:
            raise ValueError(f"a batch of {n} rows, {n_used} used, for a "
                             f"mapper of {self.height} rows")
        on_card = self.dev.type == "cuda"
        if on_card:
            i = self._turn
            self._turn ^= 1
            if self._events[i] is not None:
                with spans.span("batch.upload_wait"):
                    self._events[i].synchronize()
            pinned, host = self._sets[i]
        else:
            host = self._arrays()
        for name, a in zip(INPUTS, (frags, qno_row, qsid_row)):
            host[name][:n] = a
            host[name][n:] = 0
        host["row_valid"][:] = np.arange(self.height) < n_used
        if not on_card:
            return {name: torch.from_numpy(a) for name, a in host.items()}
        out = {name: x.to(self.dev, non_blocking=True)
               for name, x in pinned.items()}
        self._events[i] = torch.cuda.Event()
        self._events[i].record()
        return out


@dataclasses.dataclass
class BatchHandle:
    """One dispatched batch: the map step's OUTPUTS (with graphs, a slot
    of ``StepGraphs``, good until the mapper's second dispatch after this
    one) and, when dispatched ``to_host``, the outputs on the host (on a
    card their copies in pinned memory, and the event recorded on the
    stream after the copies)."""
    packed: torch.Tensor            # (7, unit_cap) int32, valid rows first
    counts: torch.Tensor            # (11,) int64, named by COUNT_NAMES
    fallback_mask: torch.Tensor     # (height,) bool, real rows only
    host: Optional[Dict[str, torch.Tensor]] = None
    host_ready: Optional["torch.cuda.Event"] = None


class Mapper:
    """The mapping step bound to one index resident on the device (the
    work of ``JitMapper.__init__``): LUTs, index arrays padded with a
    sentinel margin, packed lookup keys and prev/next links.

    Batches go through the JAX package's two-phase interface: ``dispatch``
    pads a batch to the mapper's ``height`` (default
    ``params.frag_batch``), always passes ``row_valid`` and enqueues the
    step; ``collect`` reads a batch's rows to the host (the exact path),
    ``collect_device`` leaves them on the device (the fast path).  Every
    batch of a run thus has one shape.  ``graphs`` (default: on for an
    index on a card, always off on the CPU) runs the step as CUDA graphs,
    the counterpart of the JAX package's jit: the mapper's first batch
    warms each stage up once eagerly, captures the three stages
    (``StepGraphs``) and replays them, and every later batch replays them,
    a run's padded tail included; a capture that fails raises.
    ``graphs=False`` runs every batch eagerly."""

    def __init__(self, params, index, unit_factor: int = 4,
                 unit_chunk: int = 128, graphs: Optional[bool] = None,
                 height: Optional[int] = None):
        self.params = params
        self.index = index
        on_card = index.device.type == "cuda"
        self.graphs = on_card if graphs is None else bool(graphs) and on_card
        self.height = int(params.frag_batch if height is None else height)
        self._reset_batches()
        self._side = None               # the captures' stream
        self.cfg = MapperConfig.from_params(params, index.freq_threshold,
                                            unit_factor, unit_chunk,
                                            index=index, height=self.height)
        spans.gauge("l1.key_bits", 64 if self.cfg.wpos_bits is None else 32)
        dev = index.device
        M = index.n_entries
        # device builds arrive padded with >= 2048 sentinels past the true
        # count; unpadded arrays get the JAX package's padding (>= one L2
        # entry window of sentinels, so entry windows are plain slices)
        Mp = len(index.occ_hash)
        if Mp == M:
            Mp = max(128, 1 << max(M + params.l2_entry_cap - 1, 1).bit_length())

        def pad(a, fill):
            if len(a) == Mp:
                return a
            out = torch.full((Mp,), fill, dtype=a.dtype, device=dev)
            out[: len(a)] = a
            return out

        occ_hash = pad(index.occ_hash, UMAX)
        mi_hash = pad(index.mi_hash, UMAX)
        mi_sid = pad(index.mi_seqid, PINF)
        mi_wpos = pad(index.mi_wpos, PINF)
        occ_keys = mapping.hit_keys(pad(index.occ_seqid, PINF),
                                    pad(index.occ_wpos, PINF), M,
                                    self.cfg.wpos_bits)
        order = index.occ_order
        if order is None or len(order) != Mp:
            order = torch.sort(mi_hash, stable=True).indices
        prev, nxt = l2walk.prev_next_global(mi_hash, mi_sid, order)
        self.tables = IndexTables(
            occ_hash=occ_hash, occ_keys=occ_keys, mi_hash=mi_hash,
            mi_sid=mi_sid, mi_wpos=mi_wpos, mi_prev=prev, mi_nxt=nxt,
            n_occ=M, **self._luts(params.sketch_cap))

    def _reset_batches(self) -> None:
        """No batch dispatched yet: no graphs, no staging buffers, no
        counts."""
        self._step: Optional[StepGraphs] = None
        self._inputs: Optional[HostInputs] = None
        self.eager_batches = self.replays = 0
        self.t_warmup = 0.0
        self.warmup_launches: Dict[str, int] = {}

    def _luts(self, sketch_cap: int) -> dict:
        """The min-hits and identity-gate LUTs over sketch sizes 0..cap."""
        k, pct = self.params.kmer_size, self.params.percentage_identity
        s_max = max(sketch_cap, 1)
        lut = lambda a: torch.as_tensor(a.astype(np.int64),
                                        device=self.index.device)
        return dict(min_hits=lut(stats.min_hits_lut(k, pct, s_max)),
                    gate=lut(gate_lut_np(k, pct, s_max)))

    def with_caps(self, **caps) -> "Mapper":
        """This mapper over the same index tables with other capacity caps
        (``MapperConfig`` fields: sketch_cap, hits_cap, cand_cap,
        l2_entry_cap, unit_cap); the LUTs follow sketch_cap.  The copy
        starts with no batch dispatched: no graphs of its own."""
        other = copy.copy(self)
        other.cfg = dataclasses.replace(self.cfg, **caps)
        other._reset_batches()
        if other.cfg.sketch_cap != self.cfg.sketch_cap:
            other.tables = dataclasses.replace(
                self.tables, **self._luts(other.cfg.sketch_cap))
        return other

    def dispatch(self, frags: np.ndarray, qno_row: np.ndarray,
                 qsid_row: np.ndarray, n_used: int,
                 to_host: bool = False) -> BatchHandle:
        """Enqueue the map step of one batch of at most ``height`` host
        rows, of which the first ``n_used`` are real: the rows are padded
        to ``height`` with zeros (``HostInputs``) and ``row_valid`` is
        ``arange(height) < n_used``, so the fallback mask holds real rows
        only.  With graphs the only read of the device is ``n_live``
        (``n_chunks``).  ``to_host`` (for ``collect``) also enqueues the
        outputs' copies into pinned host memory right behind the step, on
        its stream: a copy enqueued later would wait for the batches
        dispatched in between.  Returns the batch's ``BatchHandle``."""
        dev = self.index.device
        if self._inputs is None:
            self._inputs = HostInputs(self.height, self.cfg.frag_len, dev)
        with spans.span("batch.upload"):
            inputs = self._inputs.upload(frags, qno_row, qsid_row, n_used)
        if self.graphs:
            if self._step is None:
                with spans.span("batch.capture"):
                    self._step = self._capture(inputs)
            out = self._step.run(inputs)
            self.replays += 1
        else:
            out = map_step_packed(self.cfg, inputs["frags"], self.tables,
                                  *(inputs[name] for name in INPUTS[1:]))
            self.eager_batches += 1
        h = BatchHandle(**out)
        if to_host and dev.type == "cuda":
            h.host = {name: torch.empty(x.shape, dtype=x.dtype,
                                        pin_memory=True).copy_(
                                            x, non_blocking=True)
                      for name, x in out.items()}
            h.host_ready = torch.cuda.Event()
            h.host_ready.record()
        elif to_host:
            h.host = out
        return h

    def collect_device(self, h: BatchHandle) -> dict:
        """A dispatched batch's OUTPUTS, left on the device (the fast
        path: the device CGI folds ``packed`` on the stream)."""
        return {name: getattr(h, name) for name in OUTPUTS}

    def collect(self, h: BatchHandle) -> dict:
        """Read a dispatched batch to the host (the exact path): its
        ``counts`` (a dict named by COUNT_NAMES), the ``n_valid`` packed
        ``rows`` (7, n_valid) int32 (frag, qno, qsid, sid, shared, sketch,
        mean_pos) and its ``fallback`` rows (the fallback mask's, used
        only when a counter says a fragment overflowed).  The batch must
        have been dispatched ``to_host``: only its copies' event is waited
        for."""
        if h.host is None:
            raise ValueError("collect reads a batch dispatched to_host")
        if h.host_ready is not None:
            h.host_ready.synchronize()
        out = h.host
        counts = dict(zip(COUNT_NAMES, out["counts"].tolist()))
        rows = out["packed"][:, :counts["n_valid"]].numpy().copy()
        fallback = (np.nonzero(out["fallback_mask"].numpy())[0]
                    if overflowed(counts) else np.zeros(0, np.int64))
        return {"counts": counts, "rows": rows, "fallback": fallback}

    def _capture(self, inputs: dict) -> StepGraphs:
        """The mapper's first batch: each stage once eagerly on its inputs
        (``stage_pre``, one ``stage_chunk``, ``stage_post``: every kernel
        loaded and its attributes set outside a capture; their launches
        count, and are kept in ``warmup_launches``), then the capture of
        the stages on the side stream, as ``torch.cuda.graph`` captures,
        without its synchronise and garbage collection, and with its cache
        flush only when the allocator's unused cache exceeds the device's
        free memory."""
        dev = inputs["frags"].device
        before = dict(cuda.LAUNCHES)
        t0 = time.perf_counter()
        bufs = dict(inputs)
        for _, stage in StepGraphs.STAGES:
            stage(self.cfg, self.tables, bufs)
        del bufs
        self.t_warmup = time.perf_counter() - t0
        self.warmup_launches = {name: cuda.LAUNCHES[name] - n
                                for name, n in before.items()
                                if cuda.LAUNCHES[name] != n}
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        if cached > torch.cuda.mem_get_info(dev)[0]:
            # a capture cannot free the allocator's cache, which keeps the
            # pools of earlier jobs' freed graphs until it is emptied, as
            # an allocation outside a capture would on running out
            torch.cuda.empty_cache()
        main = torch.cuda.current_stream(dev)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            step = StepGraphs(self.cfg, self.tables, inputs)
        main.wait_stream(self._side)
        return step

    def graph_stats(self) -> dict:
        """The mapper's graphs and batches: the graphs' count, the seconds
        of their capture and of the warm-up before it, the device bytes
        their pool reserved, the batches run eagerly and replayed, and
        the warm-up's kernel launches."""
        st = self._step
        return {"graphs": len(StepGraphs.STAGES) if st else 0,
                "t_capture": st.capture_s if st else 0,
                "t_warmup": self.t_warmup,
                "graph_pool_bytes": st.pool_bytes if st else 0,
                "eager_batches": self.eager_batches,
                "replays": self.replays,
                "warmup_launches": dict(self.warmup_launches)}

    def probe_hits(self, frags: torch.Tensor) -> torch.Tensor:
        """The L1 hit totals of one batch without the map step (the JAX
        package's ``JitMapper.probe_fn``): the sketch (K1, K2, K3) and the
        hash probes only.  Returns an int64 (2,) tensor [max per-fragment
        hit total, batch hit sum]; hashes at or above the frequency
        threshold count 0, as in L1."""
        cfg, t = self.cfg, self.tables
        qh, s, _ = mapping.sketch_fragments(frags, cfg.kmer_size,
                                            cfg.window_size, cfg.sketch_cap)
        _, cnt = mapping.l1_ranges(qh, s, t.occ_hash, t.n_occ,
                                   cfg.freq_threshold)
        tot = cnt.sum(dim=-1)
        return torch.stack([tot.max(), tot.sum()])
