"""Run configuration (counterpart of ``fastani_tpu/config.py``).

Mirrors the reference parameter record and its CLI defaults
(reference: src/map/include/map_parameters.hpp:22-41 and
src/map/include/parseCmdArgs.hpp:117-130), plus the capacity caps of the
fixed-width device buffers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Parameters:
    """Sketching and mapping parameters.

    Defaults match the reference CLI (parseCmdArgs.hpp:117-130): k=16,
    fragment length 3000, minFraction 0.2, identity cutoff 80, p-value 1e-3,
    assumed reference size 5e6.
    """

    kmer_size: int = 16
    # derived from the p-value model at startup unless given explicitly
    # (parseCmdArgs.hpp:225-228); 24 for the defaults
    window_size: Optional[int] = None
    frag_len: int = 3000                 # reference: minReadLength
    min_fraction: float = 0.2
    alphabet_size: int = 4
    reference_size: int = 5_000_000
    percentage_identity: float = 80.0
    p_value: float = 1e-3
    ref_sequences: List[str] = dataclasses.field(default_factory=list)
    query_sequences: List[str] = dataclasses.field(default_factory=list)
    out_file_name: str = ""
    visualize: bool = False
    matrix_output: bool = False
    max_ratio_diff: float = 100.0
    sanity_check: bool = False
    # index persistence (the JAX package's .npz format, version 1)
    save_index: str = ""                 # write the built index here
    load_index: str = ""                 # skip the build, restore from here
    # write a torch.profiler Chrome trace of the mapping phase here
    profile_dir: str = ""

    # capacity caps of the fixed-width buffers; a query genome that owns a
    # fragment over one is redone exactly with caps sized to its data
    frag_batch: int = 2048               # fragments mapped per batch
    sketch_cap: Optional[int] = None     # max unique minimizers per fragment
    hits_cap: int = 4096                 # max L1 seed hits per fragment
    cand_cap: int = 64                   # max L1 candidate regions per fragment
    l2_entry_cap: Optional[int] = None   # max ref index entries per L2 unit

    def resolved_window_size(self) -> int:
        if self.window_size is not None:
            return self.window_size
        from fastani_tpu_torch.ops import stats

        return stats.recommended_window_size(
            self.p_value,
            self.kmer_size,
            self.alphabet_size,
            self.percentage_identity,
            self.frag_len,
            self.reference_size,
        )

    def finalize(self) -> "Parameters":
        """Fill in derived fields; returns self for chaining."""
        if self.window_size is None:
            self.window_size = self.resolved_window_size()
        w = self.window_size

        def _round128(x: int) -> int:
            return max(128, -(-x // 128) * 128)

        if self.sketch_cap is None:
            # expected unique minimizers per fragment ~ 2L/(w+1); 1.6x margin
            self.sketch_cap = _round128(int(3.2 * self.frag_len / (w + 1)))
        if self.l2_entry_cap is None:
            # a clean mapping spans ~2 fragment lengths of index entries
            self.l2_entry_cap = _round128(int(6.4 * self.frag_len / (w + 1)))
        return self


def scale_caps(n_genomes: int, params: "Parameters") -> None:
    """Grow the L1 capacity caps with the reference-genome count: in
    many-to-many runs every fragment hits ~every related genome, so hits
    scale with s_avg * G and candidate regions with G (same formula as
    the JAX package, so both run at the same widths)."""
    if n_genomes > 64:
        params.cand_cap = 256
    elif n_genomes > 24:
        params.cand_cap = 128
    want = max(int(240 * n_genomes), 1024)
    # a multiple of 1024; the row sort pads to a power of two internally
    params.hits_cap = min(-(-want // 1024) * 1024, 32768)
    if n_genomes > 24:
        params.l2_entry_cap = 1016
    params.sketch_cap = 320
