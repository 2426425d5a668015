"""The overlap parameters of a configuration file."""

from __future__ import annotations

from dataclasses import dataclass, fields


@dataclass(frozen=True)
class Params:
    k: int
    w: int
    hpc: bool
    bw: int
    max_gap: int
    min_chain_score: int
    min_cnt: int
    max_chain_iter: int
    max_chain_skip: int
    chain_gap_scale: float
    chain_skip_scale: float
    mid_occ_frac: float
    min_mid_occ: int
    max_mid_occ: int
    q_occ_frac: float
    dual: bool
    no_diag: bool

    @classmethod
    def from_config(cls, cfg: dict) -> "Params":
        return cls(**{f.name: cfg[f.name] for f in fields(cls)})

    def chn_pen_gap(self) -> float:
        return 0.01 * self.chain_gap_scale * float(self.k)

    def chn_pen_skip(self) -> float:
        return 0.01 * self.chain_skip_scale * float(self.k)
