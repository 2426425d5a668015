"""PAF record model and serialization.

Matches the reference's `liblrge/src/minimap2/mapping.rs` exactly:
12 standard columns plus ``tp:A``, ``cm:i``, ``s1:i``, ``dv:f`` (4
decimal places, bare ``0`` below f32 epsilon) and ``rl:i`` tags, and the
``is_internal`` overhang test used by ``-F/--filter-contained``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_F32_EPSILON = float(np.finfo(np.float32).eps)


@dataclass
class PafRecord:
    query_name: bytes
    query_len: int
    query_start: int
    query_end: int
    strand: str  # '+' or '-'
    target_name: bytes
    target_len: int
    target_start: int
    target_end: int
    match_len: int
    block_len: int
    mapq: int
    tp: str  # P/S/I/i
    cm: int
    s1: int
    dv: float
    rl: int

    def is_internal(self, max_overhang_ratio: float) -> bool:
        """Overhang test (`mapping.rs:59-77`).

        ``overhang`` is the strand-dependent min-sum of unaligned flanks;
        a mapping is internal iff ``overhang / maplen < ratio``.
        """
        if self.strand == "+":
            overhang = min(self.query_start, self.target_start) + min(
                self.query_len - self.query_end, self.target_len - self.target_end
            )
        else:
            overhang = min(self.query_start, self.target_len - self.target_end) + min(
                self.query_len - self.query_end, self.target_start
            )
        maplen = max(
            self.query_end - self.query_start, self.target_end - self.target_start
        )
        return overhang / np.float32(maplen) < max_overhang_ratio

    def to_line(self) -> str:
        """Serialize as one (newline-free) PAF line, byte-identical to the
        reference's csv serialization (`mapping.rs:109-191`)."""
        dv32 = float(np.float32(self.dv))
        dv_str = "0" if dv32 < _F32_EPSILON else f"{dv32:.4f}"
        qn = self.query_name.rstrip(b"\x00").decode("utf-8", "replace")
        tn = self.target_name.rstrip(b"\x00").decode("utf-8", "replace")
        return "\t".join(
            [
                qn,
                str(self.query_len),
                str(self.query_start),
                str(self.query_end),
                self.strand,
                tn,
                str(self.target_len),
                str(self.target_start),
                str(self.target_end),
                str(self.match_len),
                str(self.block_len),
                str(self.mapq),
                f"tp:A:{self.tp}",
                f"cm:i:{self.cm}",
                f"s1:i:{self.s1}",
                f"dv:f:{dv_str}",
                f"rl:i:{self.rl}",
            ]
        )

    @classmethod
    def from_line(cls, line: str) -> "PafRecord":
        fields = line.rstrip("\n").split("\t")
        tags = {}
        for t in fields[12:]:
            name, _typ, val = t.split(":", 2)
            tags[name] = val
        return cls(
            query_name=fields[0].encode(),
            query_len=int(fields[1]),
            query_start=int(fields[2]),
            query_end=int(fields[3]),
            strand=fields[4],
            target_name=fields[5].encode(),
            target_len=int(fields[6]),
            target_start=int(fields[7]),
            target_end=int(fields[8]),
            match_len=int(fields[9]),
            block_len=int(fields[10]),
            mapq=int(fields[11]),
            tp=tags.get("tp", "P"),
            cm=int(tags.get("cm", 0)),
            s1=int(tags.get("s1", 0)),
            dv=float(tags.get("dv", 0.0)),
            rl=int(tags.get("rl", 0)),
        )
