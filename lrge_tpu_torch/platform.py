"""Sequencing platform enum and overlap-engine parameter presets.

The reference selects a minimap2 preset from the platform
(`liblrge/src/twoset.rs:591-594`, `liblrge/src/ava.rs:373-376`):

* ``Platform.NANOPORE`` -> ``ava-ont`` (``-k15 -Xw5 -e0 -m100 -r2k``,
  `liblrge/src/minimap2/preset.rs:26-27`)
* ``Platform.PACBIO``   -> ``ava-pb``  (``-Hk19 -Xw5 -e0 -m100``,
  `liblrge/src/minimap2/preset.rs:24-25`)

Instead of shelling into a C library, our engine is parameterised by
:class:`OverlapParams`, the TPU engine's equivalent of minimap2's
``mm_idxopt_t`` + ``mm_mapopt_t`` pair.  Only the options actually
exercised by the reference's presets are modelled.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace

from .errors import InvalidPlatformError


class Platform(enum.Enum):
    """Sequencing platform (reference: `liblrge/src/lib.rs:163-180`)."""

    PACBIO = "pacbio"
    NANOPORE = "nanopore"

    @classmethod
    def from_str(cls, s: str) -> "Platform":
        """Parse a platform string.

        Accepts ``pacbio|pb|nanopore|ont`` case-insensitively, mirroring
        `liblrge/src/lib.rs:170-180`.
        """
        low = s.lower()
        if low in ("pacbio", "pb"):
            return cls.PACBIO
        if low in ("nanopore", "ont"):
            return cls.NANOPORE
        raise InvalidPlatformError(f"Invalid platform: {s}")


@dataclass(frozen=True)
class OverlapParams:
    """Parameters of the TPU overlap engine.

    Field semantics follow minimap2 2.30's option structs because the
    reference's numbers (overlap counts, and therefore the final genome
    size estimate) are defined in terms of them.  See SURVEY.md C15 for
    the exercised subset.
    """

    # ---- sketch/index options (mm_idxopt_t equivalents) ----
    k: int = 15  # k-mer size
    w: int = 5  # minimizer window
    hpc: bool = False  # homopolymer compression (-H)

    # ---- mapping options (mm_mapopt_t equivalents) ----
    bw: int = 500  # chaining bandwidth (-r)
    max_gap: int = 10000  # max gap between anchors in a chain (-g); both
    # ava preset blocks override the 5000 default with max_gap = 10000
    min_chain_score: int = 100  # min chain score to output (-m); this is
    # also the estimator's overlap threshold (twoset.rs:213, ava.rs:174)
    min_cnt: int = 3  # min number of minimizers on a chain (-n)
    max_chain_iter: int = 5000  # max predecessors scanned per anchor
    max_chain_skip: int = 25  # mm_chain_dp early-break: scanning
    # predecessors descending, count js that are (a) the stored
    # predecessor of an already-examined anchor in this scan and (b) do
    # not improve the running max; the count decrements (floor 0) on
    # improving js and the scan stops when it exceeds max_chain_skip
    chain_gap_scale: float = 0.8
    chain_skip_scale: float = 0.0
    mid_occ_frac: float = 2e-4  # -f: top fraction of repetitive minimizers
    min_mid_occ: int = 10
    max_mid_occ: int = 1_000_000
    occ_dist: int = 0  # -e0 in both ava presets: drop (not sample)
    # minimizers above the occurrence cutoff
    q_occ_frac: float = 0.01  # mm_seed_mz_flt: drop query minimizers
    # occurring > mid_occ times within the query itself AND more than
    # q_occ_frac of the query's minimizer count (no-op unless the query
    # has > mid_occ minimizers)

    # ---- pair-level masks ----
    no_dual: bool = True  # MM_F_NO_DUAL (0x002): skip pairs where the
    # query name is lexicographically greater than the target name
    # (`aligner.rs:89-103`).  Both ava presets set it; two-set clears it.
    no_diag: bool = True  # skip exact self-diagonal seed hits (-X)
    ava: bool = True  # MM_F_AVA: keep all chains (no primary/secondary
    # subsetting), matching minimap2's read-overlap mode

    # ---- engine shape knobs (TPU-specific; no reference analogue) ----
    max_anchors: int = 4096  # static per-query anchor capacity
    chain_window: int = 64  # static DP predecessor window

    def chn_pen_gap(self) -> float:
        """Gap penalty coefficient used by the chain scoring function."""
        return 0.01 * self.chain_gap_scale * float(self.k)

    def chn_pen_skip(self) -> float:
        return 0.01 * self.chain_skip_scale * float(self.k)


# `ava-ont` (preset.rs:26-27): minimap2 options.c sets k15 w5,
# ALL_CHAINS|NO_DIAG|NO_DUAL|NO_LJOIN, m100, pri_ratio 0, g10000,
# max_chain_skip 25, occ_dist 0, bw = bw_long = 2000 (-r2k)
AVA_ONT = OverlapParams(k=15, w=5, hpc=False, bw=2000, min_chain_score=100)

# `ava-pb` (preset.rs:24-25): as above plus HPC k19, default bw 500
AVA_PB = OverlapParams(k=19, w=5, hpc=True, bw=500, min_chain_score=100)


def preset_for(platform: Platform, *, dual: bool) -> OverlapParams:
    """Return engine params for a platform.

    ``dual=True`` clears the no-dual mask, as the reference does for the
    two-set strategy (`twoset.rs:598,602` passes ``dual=true``); the
    all-vs-all strategy passes ``dual=false`` (`ava.rs:378`).
    """
    base = AVA_PB if platform is Platform.PACBIO else AVA_ONT
    return replace(base, no_dual=not dual)
