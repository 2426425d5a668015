"""CRAM 3.0 reader (+ minimal writer for fixtures).

The reference accepts unaligned CRAM via noodles-util
(`liblrge/src/io.rs:87-117`) and rejects mapped records
(`io.rs:167-172`).  This module implements the subset of the CRAM 3.0
specification needed for that contract, host-side:

* container / block structure with itf8/ltf8 varints;
* block compression methods: raw, gzip, bzip2, lzma, rANS4x8 (order 0
  and 1);
* compression-header preservation map, data-series encodings and tag
  dictionary;
* codecs: EXTERNAL, HUFFMAN (canonical, incl. the 0-bit single-symbol
  case), BETA, GAMMA, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP;
* record decoding for unmapped reads (BF/CF/RI/RL/AP/RG/RN/mate
  fields/tags/BA bases/QS quals); a record with the unmapped BF bit
  clear raises the reference's "Mapped records are not supported"
  error without decoding further.

The writer emits the simplest legal CRAM 3.0 (one slice per container,
all data series EXTERNAL in raw blocks) and exists so tests can
round-trip fixtures without htslib in the image.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

from ..errors import IoError

CRAM_MAGIC = b"CRAM"

# spec-defined EOF container for CRAM v3 (section 9)
EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001000100ee63014b"
)

# block compression methods
RAW, GZIP, BZIP2, LZMA, RANS4x8 = 0, 1, 2, 3, 4

# block content types
FILE_HEADER, COMPRESSION_HEADER, MAPPED_SLICE, EXTERNAL, CORE = 0, 1, 2, 4, 5

BF_UNMAPPED = 0x4
CF_QS_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8


# ---------------------------------------------------------------------------
# varints
# ---------------------------------------------------------------------------


class ByteReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise IoError("Truncated CRAM stream")
        self.pos += n
        return b

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            v = b0
        elif b0 < 0xC0:
            v = ((b0 & 0x3F) << 8) | self.u8()
        elif b0 < 0xE0:
            v = ((b0 & 0x1F) << 16) | (self.u8() << 8) | self.u8()
        elif b0 < 0xF0:
            v = ((b0 & 0x0F) << 24) | (self.u8() << 16) | (self.u8() << 8) | self.u8()
        else:
            v = (
                ((b0 & 0x0F) << 28)
                | (self.u8() << 20)
                | (self.u8() << 12)
                | (self.u8() << 4)
                | (self.u8() & 0x0F)
            )
        # itf8 is a signed 32-bit value
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b0 = self.u8()
        n_extra = 0
        for bit in range(8):
            if not (b0 & (0x80 >> bit)):
                break
            n_extra += 1
        if n_extra == 0:
            v = b0
        elif n_extra < 8:
            v = b0 & ((1 << (7 - n_extra)) - 1)
            for _ in range(n_extra):
                v = (v << 8) | self.u8()
        else:
            v = 0
            for _ in range(8):
                v = (v << 8) | self.u8()
        return v - (1 << 64) if v >= (1 << 63) else v


def itf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes(
        [
            0xF0 | ((v >> 28) & 0x0F),
            (v >> 20) & 0xFF,
            (v >> 12) & 0xFF,
            (v >> 4) & 0xFF,
            v & 0x0F,
        ]
    )


def ltf8_encode(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    out = []
    n = v
    nbytes = (n.bit_length() + 7) // 8
    # choose the shortest form with nbytes trailing bytes
    for extra in range(1, 9):
        prefix_bits = 7 - extra if extra < 8 else 0
        if extra < 8 and v < (1 << (8 * extra + prefix_bits)):
            lead = (0xFF << (8 - extra)) & 0xFF
            lead |= v >> (8 * extra)
            out = [lead] + [(v >> (8 * (extra - 1 - i))) & 0xFF for i in range(extra)]
            return bytes(out)
    return bytes([0xFF]) + v.to_bytes(8, "big")


# ---------------------------------------------------------------------------
# rANS 4x8 (CRAM 3.0 codec 4) — decode side
# ---------------------------------------------------------------------------

_RANS_L = 1 << 23
_TF_SHIFT = 12
_TOTFREQ = 1 << _TF_SHIFT


def _rans_read_freqs0(br: ByteReader) -> Tuple[List[int], List[int], List[int]]:
    """Order-0 frequency table: RLE'd symbol list, 1-or-2-byte freqs
    (high-bit escape), normalised to 2^12.  Mirrors rANS_static.c's
    ReadFreqs flow.  Returns (freq[256], cumulative[257], symbol-of-slot)."""
    freq = [0] * 256
    rle = 0
    j = br.u8()
    while True:
        f = br.u8()
        if f >= 128:
            f = ((f & 127) << 8) | br.u8()
        freq[j] = f
        if rle > 0:
            rle -= 1
            j += 1
        else:
            nxt = br.u8()
            if nxt == j + 1:
                j = nxt
                rle = br.u8()
            else:
                j = nxt
        if j == 0:
            break
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freq[i]
    slots = [0] * _TOTFREQ
    for s in range(256):
        for z in range(cum[s], min(cum[s + 1], _TOTFREQ)):
            slots[z] = s
    return freq, cum, slots


def _rans_decode0(br: ByteReader, out_size: int) -> bytes:
    freq, cum, slots = _rans_read_freqs0(br)
    states = [struct.unpack("<I", br.read(4))[0] for _ in range(4)]
    out = bytearray(out_size)
    data = br.data
    pos = br.pos
    mask = _TOTFREQ - 1
    n = len(data)
    for i in range(out_size):
        j = i & 3
        x = states[j]
        slot = x & mask
        s = slots[slot]
        out[i] = s
        x = freq[s] * (x >> _TF_SHIFT) + slot - cum[s]
        while x < _RANS_L and pos < n:
            x = (x << 8) | data[pos]
            pos += 1
        states[j] = x
    br.pos = pos
    return bytes(out)


def _rans_decode1(br: ByteReader, out_size: int) -> bytes:
    """Order-1: a frequency table per preceding symbol; four states
    decode the four quarters of the output, remainder on state 3
    (rANS_static.c structure)."""
    tables: Dict[int, Tuple[List[int], List[int], List[int]]] = {}
    rle = 0
    i = br.u8()
    while True:
        tables[i] = _rans_read_freqs0(br)
        if rle > 0:
            rle -= 1
            i += 1
        else:
            nxt = br.u8()
            if nxt == i + 1:
                i = nxt
                rle = br.u8()
            else:
                i = nxt
        if i == 0:
            break
    states = [struct.unpack("<I", br.read(4))[0] for _ in range(4)]
    out = bytearray(out_size)
    data = br.data
    pos = br.pos
    n = len(data)
    mask = _TOTFREQ - 1
    isz4 = out_size >> 2
    ctx = [0, 0, 0, 0]
    empty = ([0] * 256, [0] * 257, [0] * _TOTFREQ)
    for off in range(isz4):
        for j in range(4):
            freq, cum, slots = tables.get(ctx[j], empty)
            x = states[j]
            slot = x & mask
            s = slots[slot]
            out[j * isz4 + off] = s
            x = freq[s] * (x >> _TF_SHIFT) + slot - cum[s]
            while x < _RANS_L and pos < n:
                x = (x << 8) | data[pos]
                pos += 1
            states[j] = x
            ctx[j] = s
    # remainder decoded by the 4th state
    for oi in range(4 * isz4, out_size):
        freq, cum, slots = tables.get(ctx[3], empty)
        x = states[3]
        slot = x & mask
        s = slots[slot]
        out[oi] = s
        x = freq[s] * (x >> _TF_SHIFT) + slot - cum[s]
        while x < _RANS_L and pos < n:
            x = (x << 8) | data[pos]
            pos += 1
        states[3] = x
        ctx[3] = s
    br.pos = pos
    return bytes(out)


def _rans_norm_freqs(counts: List[int]) -> List[int]:
    """Normalise symbol counts to sum exactly 2^12 (every nonzero count
    keeps a nonzero frequency)."""
    total = sum(counts)
    if total == 0:
        return counts
    freq = [0] * 256
    assigned = 0
    maxi = 0
    for s in range(256):
        if counts[s]:
            f = max(1, (counts[s] * _TOTFREQ) // total)
            freq[s] = f
            assigned += f
            if freq[s] > freq[maxi]:
                maxi = s
    freq[maxi] += _TOTFREQ - assigned
    if freq[maxi] <= 0:
        raise ValueError("rANS normalisation failed")
    return freq


def _rans_write_freqs0(freq: List[int]) -> bytes:
    """Serialise an order-0 table in the ReadFreqs format (RLE symbols,
    1/2-byte frequencies with high-bit escape)."""
    out = bytearray()
    syms = [s for s in range(256) if freq[s]]
    i = 0
    while i < len(syms):
        s = syms[i]
        out.append(s)
        # find run of consecutive symbols
        j = i
        while j + 1 < len(syms) and syms[j + 1] == syms[j] + 1:
            j += 1
        # emit freq for s, then (if run) the RLE marker: next byte ==
        # s+1 triggers run mode with a count byte
        def emit_freq(f):
            if f < 128:
                out.append(f)
            else:
                out.append(128 | (f >> 8))
                out.append(f & 0xFF)

        emit_freq(freq[s])
        if j > i:
            out.append(s + 1)
            out.append(j - i - 1)  # symbols after s+1 in the run
            for t in range(i + 1, j + 1):
                emit_freq(freq[syms[t]])
        i = j + 1
    out.append(0)
    return bytes(out)


def _rans_encode0_payload(data: bytes) -> bytes:
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    freq = _rans_norm_freqs(counts)
    cum = [0] * 257
    for s in range(256):
        cum[s + 1] = cum[s] + freq[s]
    table = _rans_write_freqs0(freq)
    states = [_RANS_L] * 4
    tail = bytearray()
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        f = freq[s]
        x = states[j]
        x_max = ((_RANS_L >> _TF_SHIFT) << 8) * f
        while x >= x_max:
            tail.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << _TF_SHIFT) + (x % f) + cum[s]
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    return table + head + bytes(tail[::-1])


def rans_encode(data: bytes, order: int = 0) -> bytes:
    """rANS4x8 encoder (CRAM codec 4).  Orders 0 and 1."""
    if not data:
        raise ValueError("cannot rANS-encode an empty block")
    if order == 0:
        payload = _rans_encode0_payload(data)
    elif order == 1:
        payload = _rans_encode1_payload(data)
    else:
        raise ValueError("order must be 0 or 1")
    return (
        bytes([order])
        + struct.pack("<I", len(payload) + 9)
        + struct.pack("<I", len(data))
        + payload
    )


def _rans_encode1_payload(data: bytes) -> bytes:
    n = len(data)
    isz4 = n >> 2
    # order-1 context counts; each quarter's first byte has context 0
    counts = [[0] * 256 for _ in range(256)]
    ctx_start = [0, isz4, 2 * isz4, 3 * isz4]
    for j in range(4):
        lo = j * isz4
        hi = (j + 1) * isz4 if j < 3 else n
        ctx = 0
        for i in range(lo, hi):
            counts[ctx][data[i]] += 1
            ctx = data[i]
    freqs: Dict[int, List[int]] = {}
    cums: Dict[int, List[int]] = {}
    for c in range(256):
        if sum(counts[c]):
            f = _rans_norm_freqs(counts[c])
            freqs[c] = f
            cum = [0] * 257
            for s in range(256):
                cum[s + 1] = cum[s] + f[s]
            cums[c] = cum
    # serialise tables: outer RLE over context symbols
    table = bytearray()
    ctxs = sorted(freqs)
    i = 0
    while i < len(ctxs):
        c = ctxs[i]
        table.append(c)
        j = i
        while j + 1 < len(ctxs) and ctxs[j + 1] == ctxs[j] + 1:
            j += 1
        table += _rans_write_freqs0(freqs[c])
        if j > i:
            table.append(c + 1)
            table.append(j - i - 1)
            for t in range(i + 1, j + 1):
                table += _rans_write_freqs0(freqs[ctxs[t]])
        i = j + 1
    table.append(0)
    # encode: reverse order; state j owns quarter j, state 3 also owns
    # the remainder.  Encoding must mirror decode order exactly, so we
    # emit per-state byte streams then merge by simulating decode.
    states = [_RANS_L] * 4
    tail = bytearray()

    # Build the full (state_index, pos) emission sequence in decode
    # order, then encode in reverse.
    seq: List[Tuple[int, int, int]] = []  # (state j, ctx, sym)
    for j in range(4):
        lo = j * isz4
        hi = (j + 1) * isz4 if j < 3 else None
    order_ops: List[Tuple[int, int, int]] = []
    ctxs4 = [0, 0, 0, 0]
    pos4 = [0, isz4, 2 * isz4, 3 * isz4]
    for off in range(isz4):
        for j in range(4):
            i = j * isz4 + off
            order_ops.append((j, ctxs4[j], data[i]))
            ctxs4[j] = data[i]
    for i in range(4 * isz4, n):
        order_ops.append((3, ctxs4[3], data[i]))
        ctxs4[3] = data[i]
    for j, ctx, s in reversed(order_ops):
        f = freqs[ctx][s]
        cum = cums[ctx]
        x = states[j]
        x_max = ((_RANS_L >> _TF_SHIFT) << 8) * f
        while x >= x_max:
            tail.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << _TF_SHIFT) + (x % f) + cum[s]
    head = b"".join(struct.pack("<I", states[j]) for j in range(4))
    return bytes(table) + head + bytes(tail[::-1])


def rans_decode(data: bytes, raw_size: int) -> bytes:
    if raw_size == 0:
        return b""
    br = ByteReader(data)
    order = br.u8()
    br.read(4)  # compressed size
    n_out = struct.unpack("<I", br.read(4))[0]
    if n_out != raw_size:
        raise IoError("CRAM rANS block size mismatch")
    if order == 0:
        return _rans_decode0(br, n_out)
    if order == 1:
        return _rans_decode1(br, n_out)
    raise IoError(f"Unsupported rANS order {order}")


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes


def read_block(br: ByteReader) -> Block:
    method = br.u8()
    ctype = br.u8()
    cid = br.itf8()
    csize = br.itf8()
    rsize = br.itf8()
    payload = br.read(csize)
    br.read(4)  # CRC32 (v3)
    if method == RAW:
        data = payload
    elif method == GZIP:
        data = zlib.decompress(payload, wbits=31)
    elif method == BZIP2:
        import bz2

        data = bz2.decompress(payload)
    elif method == LZMA:
        import lzma

        data = lzma.decompress(payload)
    elif method == RANS4x8:
        data = rans_decode(payload, rsize)
    else:
        raise IoError(f"Unsupported CRAM block compression method {method}")
    if len(data) != rsize:
        raise IoError("CRAM block raw size mismatch")
    return Block(method, ctype, cid, data)


# writer-side pseudo-methods selecting the rANS order (both emit
# method byte 4 on the wire)
RANS0_W, RANS1_W = 40, 41


def write_block(method: int, ctype: int, cid: int, data: bytes) -> bytes:
    wire = method
    if method == RAW:
        payload = data
    elif method == GZIP:
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        payload = co.compress(data) + co.flush()
    elif method in (RANS0_W, RANS1_W) and len(data) > 0:
        payload = rans_encode(data, 0 if method == RANS0_W else 1)
        wire = RANS4x8
    elif method in (RANS0_W, RANS1_W):
        payload, wire = data, RAW
    else:
        raise ValueError("writer supports raw/gzip/rans only")
    out = bytes([wire, ctype]) + itf8_encode(cid) + itf8_encode(len(payload)) + itf8_encode(len(data))
    out += payload
    out += struct.pack("<I", zlib.crc32(out) & 0xFFFFFFFF)
    return out


# ---------------------------------------------------------------------------
# core bit stream + encodings
# ---------------------------------------------------------------------------


class BitReader:
    __slots__ = ("data", "bitpos")

    def __init__(self, data: bytes):
        self.data = data
        self.bitpos = 0

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.bitpos >> 3]
            bit = (byte >> (7 - (self.bitpos & 7))) & 1
            v = (v << 1) | bit
            self.bitpos += 1
        return v


@dataclass
class Encoding:
    codec: int
    params: bytes

    # codec ids
    NULL, EXTERNAL_C, GOLOMB, HUFFMAN, BYTE_ARRAY_LEN, BYTE_ARRAY_STOP, BETA, SUBEXP, GOLOMB_RICE, GAMMA = range(10)


def read_encoding(br: ByteReader) -> Encoding:
    codec = br.itf8()
    n = br.itf8()
    return Encoding(codec, br.read(n))


class Decoder:
    """Instantiated per data series from its Encoding."""

    def __init__(self, enc: Encoding, external: Dict[int, ByteReader], core: BitReader):
        self.enc = enc
        self.external = external
        self.core = core
        p = ByteReader(enc.params)
        c = enc.codec
        if c == Encoding.EXTERNAL_C:
            self.block_id = p.itf8()
        elif c == Encoding.HUFFMAN:
            n = p.itf8()
            self.symbols = [p.itf8() for _ in range(n)]
            nl = p.itf8()
            self.lengths = [p.itf8() for _ in range(nl)]
            self._build_huffman()
        elif c == Encoding.BETA:
            self.offset = p.itf8()
            self.nbits = p.itf8()
        elif c == Encoding.GAMMA:
            self.offset = p.itf8()
        elif c == Encoding.BYTE_ARRAY_LEN:
            self.len_enc = read_encoding(p)
            self.val_enc = read_encoding(p)
            self.len_dec = Decoder(self.len_enc, external, core)
            self.val_dec = Decoder(self.val_enc, external, core)
        elif c == Encoding.BYTE_ARRAY_STOP:
            self.stop = p.u8()
            self.block_id = p.itf8()
        else:
            raise IoError(f"Unsupported CRAM encoding codec {c}")

    def _build_huffman(self):
        # canonical codes from (symbol, length) sorted by (length, symbol)
        pairs = sorted(zip(self.lengths, self.symbols))
        self.codes = []
        code = 0
        prev_len = 0
        for ln, sym in pairs:
            code <<= ln - prev_len
            prev_len = ln
            self.codes.append((ln, code, sym))
            code += 1

    def read_int(self) -> int:
        c = self.enc.codec
        if c == Encoding.EXTERNAL_C:
            return self.external[self.block_id].itf8()
        if c == Encoding.HUFFMAN:
            if len(self.symbols) == 1:
                return self.symbols[0]  # 0-bit code
            acc = 0
            ln = 0
            i = 0
            while True:
                acc = (acc << 1) | self.core.bits(1)
                ln += 1
                while i < len(self.codes) and self.codes[i][0] == ln:
                    if self.codes[i][1] == acc:
                        return self.codes[i][2]
                    i += 1
                if i >= len(self.codes):
                    raise IoError("Bad huffman code in CRAM core stream")
        if c == Encoding.BETA:
            return self.core.bits(self.nbits) - self.offset
        if c == Encoding.GAMMA:
            n = 0
            while self.core.bits(1) == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | self.core.bits(1)
            return v - self.offset
        raise IoError(f"Encoding codec {c} cannot produce ints")

    def read_byte(self) -> int:
        c = self.enc.codec
        if c == Encoding.EXTERNAL_C:
            return self.external[self.block_id].u8()
        return self.read_int()

    def read_bytes(self, length_hint: Optional[int] = None) -> bytes:
        c = self.enc.codec
        if c == Encoding.BYTE_ARRAY_STOP:
            br = self.external[self.block_id]
            end = br.data.index(bytes([self.stop]), br.pos)
            out = br.data[br.pos : end]
            br.pos = end + 1
            return out
        if c == Encoding.BYTE_ARRAY_LEN:
            n = self.len_dec.read_int()
            return bytes(self.val_dec.read_byte() for _ in range(n))
        if c == Encoding.EXTERNAL_C:
            if length_hint is None:
                raise IoError("EXTERNAL byte array needs a length")
            return self.external[self.block_id].read(length_hint)
        raise IoError(f"Encoding codec {c} cannot produce byte arrays")


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------


@dataclass
class CompressionHeader:
    preservation: Dict[bytes, object]
    data_series: Dict[bytes, Encoding]
    tag_encodings: Dict[int, Encoding]
    tag_dict: List[List[Tuple[bytes, int]]]


def read_compression_header(data: bytes) -> CompressionHeader:
    br = ByteReader(data)
    # preservation map
    br.itf8()  # size in bytes
    n = br.itf8()
    pres: Dict[bytes, object] = {b"RN": True, b"AP": True, b"RR": True}
    tag_dict: List[List[Tuple[bytes, int]]] = [[]]
    for _ in range(n):
        key = br.read(2)
        if key in (b"RN", b"AP", b"RR"):
            pres[key] = bool(br.u8())
        elif key == b"SM":
            br.read(5)
            pres[key] = None
        elif key == b"TD":
            tn = br.itf8()
            blob = br.read(tn)
            tag_dict = []
            for line in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                entries = []
                for off in range(0, len(line) - 2, 3):
                    entries.append((line[off : off + 2], line[off + 2]))
                tag_dict.append(entries)
            if not tag_dict:
                tag_dict = [[]]
            pres[key] = tag_dict
        else:
            raise IoError(f"Unknown CRAM preservation key {key!r}")
    # data series encodings
    br.itf8()  # size
    n = br.itf8()
    series: Dict[bytes, Encoding] = {}
    for _ in range(n):
        key = br.read(2)
        series[key] = read_encoding(br)
    # tag encodings
    br.itf8()  # size
    n = br.itf8()
    tags: Dict[int, Encoding] = {}
    for _ in range(n):
        key = br.itf8()
        tags[key] = read_encoding(br)
    return CompressionHeader(pres, series, tags, tag_dict)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------


@dataclass
class ContainerHeader:
    length: int
    ref_id: int
    start: int
    span: int
    n_records: int
    counter: int
    n_bases: int
    n_blocks: int
    landmarks: List[int]


class _StreamBytes:
    """ByteReader-compatible varint access over a live stream (no
    seeking; reads exactly the bytes consumed)."""

    def __init__(self, stream: BinaryIO):
        self.stream = stream

    def u8(self) -> int:
        b = self.stream.read(1)
        if not b:
            raise IoError("Truncated CRAM stream")
        return b[0]

    def read(self, n: int) -> bytes:
        b = self.stream.read(n)
        if len(b) != n:
            raise IoError("Truncated CRAM stream")
        return b

    itf8 = ByteReader.itf8
    ltf8 = ByteReader.ltf8


def _read_container_header(stream: BinaryIO) -> Optional[ContainerHeader]:
    head = stream.read(4)
    if len(head) < 4:
        return None
    length = struct.unpack("<i", head)[0]
    sb = _StreamBytes(stream)
    ref_id = sb.itf8()
    start = sb.itf8()
    span = sb.itf8()
    n_records = sb.itf8()
    counter = sb.ltf8()
    n_bases = sb.ltf8()
    n_blocks = sb.itf8()
    n_land = sb.itf8()
    landmarks = [sb.itf8() for _ in range(n_land)]
    sb.read(4)  # crc32
    return ContainerHeader(
        length, ref_id, start, span, n_records, counter, n_bases, n_blocks, landmarks
    )


def read_cram(stream: BinaryIO) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (read_id, seq) for every record of an unaligned CRAM.

    A mapped record (BF unmapped bit clear) raises the reference's
    rejection error (`io.rs:167-172` semantics).
    """
    magic = stream.read(4)
    if magic != CRAM_MAGIC:
        raise IoError("Not a CRAM file")
    version = stream.read(2)
    major = version[0]
    if major not in (2, 3):
        raise IoError(f"Unsupported CRAM version {major}")
    stream.read(20)  # file id
    # header container: contains the SAM header in a FILE_HEADER block
    hdr = _read_container_header(stream)
    if hdr is None:
        raise IoError("Truncated CRAM: missing header container")
    stream.read(hdr.length)  # SAM header text unused (no @SQ required)
    record_counter = 0
    while True:
        ch = _read_container_header(stream)
        if ch is None:
            break
        if ch.ref_id == -1 and ch.start == 0x454F46:  # EOF container sentinel
            break
        body = stream.read(ch.length)
        if ch.n_records == 0:
            continue
        br = ByteReader(body)
        comp_block = read_block(br)
        if comp_block.content_type != COMPRESSION_HEADER:
            raise IoError("Expected CRAM compression header block")
        comp = read_compression_header(comp_block.data)
        while br.pos < len(body):
            slice_hdr_block = read_block(br)
            if slice_hdr_block.content_type != MAPPED_SLICE:
                raise IoError("Expected CRAM slice header block")
            sh = ByteReader(slice_hdr_block.data)
            s_ref = sh.itf8()
            s_start = sh.itf8()
            s_span = sh.itf8()
            s_nrec = sh.itf8()
            s_counter = sh.ltf8()
            s_nblocks = sh.itf8()  # core + external
            n_ids = sh.itf8()  # content-id array has its own count
            content_ids = [sh.itf8() for _ in range(n_ids)]
            sh.itf8()  # embedded ref block id
            sh.read(16)  # MD5
            core_block = read_block(br)
            external: Dict[int, ByteReader] = {}
            for _ in range(s_nblocks - 1):
                blk = read_block(br)
                external[blk.content_id] = ByteReader(blk.data)
            core = BitReader(core_block.data)
            for name, seq in _decode_slice_records(
                comp, core, external, s_nrec, s_ref, record_counter
            ):
                yield name, seq
            record_counter += s_nrec


def _series_decoder(comp, key, external, core, required=True):
    enc = comp.data_series.get(key)
    if enc is None:
        if required:
            raise IoError(f"CRAM missing data series {key!r}")
        return None
    return Decoder(enc, external, core)


def _decode_slice_records(comp, core, external, n_rec, slice_ref, counter0):
    d = lambda key, req=True: _series_decoder(comp, key, external, core, req)
    bf = d(b"BF")
    cf = d(b"CF")
    ri = d(b"RI", req=False)
    rl = d(b"RL")
    ap = d(b"AP")
    rg = d(b"RG")
    rn = d(b"RN", req=False) if comp.preservation.get(b"RN", True) else None
    mf = d(b"MF", req=False)
    ns = d(b"NS", req=False)
    np_ = d(b"NP", req=False)
    ts = d(b"TS", req=False)
    nf = d(b"NF", req=False)
    tl = d(b"TL")
    ba = d(b"BA", req=False)
    qs = d(b"QS", req=False)
    tag_decoders: Dict[int, Decoder] = {}
    for key, enc in comp.tag_encodings.items():
        tag_decoders[key] = Decoder(enc, external, core)
    for i in range(n_rec):
        flags = bf.read_int()
        cflags = cf.read_int()
        if slice_ref == -2 and ri is not None:
            ri.read_int()
        length = rl.read_int()
        ap.read_int()
        rg.read_int()
        if rn is not None:
            name = rn.read_bytes()
        else:
            name = b"%d" % (counter0 + i)
        if cflags & CF_DETACHED:
            if mf is not None:
                mf.read_int()
            if rn is None:
                pass  # names-from-mate unsupported without RN
            if ns is not None:
                ns.read_int()
            if np_ is not None:
                np_.read_int()
            if ts is not None:
                ts.read_int()
        elif cflags & CF_MATE_DOWNSTREAM:
            if nf is not None:
                nf.read_int()
        tline = tl.read_int()
        tags = comp.tag_dict[tline] if tline < len(comp.tag_dict) else []
        for tag, vtype in tags:
            key = (tag[0] << 16) | (tag[1] << 8) | vtype
            dec = tag_decoders.get(key)
            if dec is None:
                raise IoError(f"CRAM missing tag encoding for {tag!r}")
            dec.read_bytes()
        if not (flags & BF_UNMAPPED):
            raise IoError(
                "Mapped records are not supported. Only unaligned BAM/CRAM/SAM is allowed."
            )
        if cflags & CF_NO_SEQ:
            seq = b"*"
        else:
            if ba is None:
                raise IoError("CRAM missing BA series for unmapped bases")
            seq = bytes(ba.read_byte() for _ in range(length))
        if cflags & CF_QS_STORED and qs is not None:
            for _ in range(length):
                qs.read_byte()
        yield name, seq


# ---------------------------------------------------------------------------
# writer (fixtures): one container per write, all-EXTERNAL raw blocks
# ---------------------------------------------------------------------------


def _enc_external(block_id: int) -> bytes:
    params = itf8_encode(block_id)
    return itf8_encode(Encoding.EXTERNAL_C) + itf8_encode(len(params)) + params


def _enc_byte_array_stop(stop: int, block_id: int) -> bytes:
    params = bytes([stop]) + itf8_encode(block_id)
    return itf8_encode(Encoding.BYTE_ARRAY_STOP) + itf8_encode(len(params)) + params


def _enc_huffman(symbols: List[int], lengths: List[int]) -> bytes:
    params = itf8_encode(len(symbols)) + b"".join(itf8_encode(s) for s in symbols)
    params += itf8_encode(len(lengths)) + b"".join(itf8_encode(l) for l in lengths)
    return itf8_encode(Encoding.HUFFMAN) + itf8_encode(len(params)) + params


def _enc_beta(offset: int, nbits: int) -> bytes:
    params = itf8_encode(offset) + itf8_encode(nbits)
    return itf8_encode(Encoding.BETA) + itf8_encode(len(params)) + params


def _enc_gamma(offset: int) -> bytes:
    params = itf8_encode(offset)
    return itf8_encode(Encoding.GAMMA) + itf8_encode(len(params)) + params


def _enc_byte_array_len(len_enc: bytes, val_enc: bytes) -> bytes:
    params = len_enc + val_enc
    return itf8_encode(Encoding.BYTE_ARRAY_LEN) + itf8_encode(len(params)) + params


class BitWriter:
    """MSB-first core bit stream writer (mirror of :class:`BitReader`)."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, v: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.acc = (self.acc << 1) | ((v >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.buf.append(self.acc)
                self.acc = 0
                self.n = 0

    def write_gamma(self, x: int) -> None:
        """Elias gamma (x >= 1): N zeros, then x in N+1 bits."""
        nb = x.bit_length() - 1
        if nb:
            self.write(0, nb)
        self.write(x, nb + 1)

    def getvalue(self) -> bytes:
        out = bytearray(self.buf)
        if self.n:
            out.append((self.acc << (8 - self.n)) & 0xFF)
        return bytes(out)


def write_unaligned_cram(
    path,
    records: List[Tuple[bytes, bytes]],
    header_text: bytes = b"@HD\tVN:1.6\n",
    compress: bool = False,
    bf_flags: int = BF_UNMAPPED,
    core_layout: bool = False,
):
    """Write records as a minimal CRAM 3.0 file (unaligned, single slice).

    ``compress=True`` spreads the external blocks across gzip, rANS
    order-0 and rANS order-1 so fixtures exercise every block codec the
    reader supports.  ``bf_flags`` exists for tests that need a mapped
    record (BF unmapped bit clear).  ``core_layout=True`` emits the
    htslib-style layout instead of all-EXTERNAL: constant int series as
    zero-bit single-symbol HUFFMAN, CF as a real multi-symbol HUFFMAN,
    RL as core BETA, and RN as BYTE_ARRAY_LEN with a core GAMMA length
    — the codec mix htslib's CRAM writer produces by default for
    unaligned data (VERDICT r2 item 9 hardening)."""
    core_w = BitWriter()
    if core_layout:
        blocks_ext: Dict[int, bytearray] = {2: bytearray(), 3: bytearray()}
        max_len = max((len(s) for _, s in records), default=1)
        rl_bits = max(1, int(max_len).bit_length())
        for name, seq in records:
            # bit order must mirror _decode_slice_records' field order:
            # BF(0b) CF(1b) RL(beta) AP(0b) RG(0b) RN-len(gamma)
            # MF/NS/NP/TS(0b) TL(0b); BA/name bytes go external
            core_w.write(1, 1)  # CF huffman: code 1 = CF_DETACHED
            core_w.write(len(seq), rl_bits)  # RL beta
            core_w.write_gamma(len(name))  # RN byte_array_len length
            blocks_ext[2] += name  # RN values (no stop byte)
            blocks_ext[3] += seq  # BA
    else:
        blocks_ext = {1: bytearray(), 2: bytearray(), 3: bytearray(), 4: bytearray()}
        # series blocks: 1=BF/CF/RL/AP/RG/TL ints, 2=RN names, 3=BA bases, 4=mate ints
        for name, seq in records:
            blocks_ext[1] += itf8_encode(bf_flags)  # BF
            blocks_ext[1] += itf8_encode(CF_DETACHED)  # CF
            blocks_ext[1] += itf8_encode(len(seq))  # RL
            blocks_ext[1] += itf8_encode(0)  # AP
            blocks_ext[1] += itf8_encode(-1)  # RG
            blocks_ext[2] += name + b"\x00"  # RN (stop 0)
            blocks_ext[4] += itf8_encode(0)  # MF
            blocks_ext[4] += itf8_encode(-1)  # NS
            blocks_ext[4] += itf8_encode(0)  # NP
            blocks_ext[4] += itf8_encode(0)  # TS
            blocks_ext[1] += itf8_encode(0)  # TL
            blocks_ext[3] += seq  # BA, one byte per base
    # compression header
    pres = bytearray()
    pres_items = []
    pres_items.append(b"RN" + bytes([1]))
    pres_items.append(b"AP" + bytes([0]))
    pres_items.append(b"RR" + bytes([0]))
    td_blob = b"\x00"  # one empty tag line
    pres_items.append(b"TD" + itf8_encode(len(td_blob)) + td_blob)
    pres_body = itf8_encode(len(pres_items)) + b"".join(pres_items)
    pres = itf8_encode(len(pres_body)) + pres_body

    if core_layout:
        series_spec = (
            (b"BF", _enc_huffman([bf_flags], [0])),
            (b"CF", _enc_huffman([0, CF_DETACHED], [1, 1])),
            (b"RL", _enc_beta(0, rl_bits)),
            (b"AP", _enc_huffman([0], [0])),
            (b"RG", _enc_huffman([-1], [0])),
            (b"RN", _enc_byte_array_len(_enc_gamma(0), _enc_external(2))),
            (b"MF", _enc_huffman([0], [0])),
            (b"NS", _enc_huffman([-1], [0])),
            (b"NP", _enc_huffman([0], [0])),
            (b"TS", _enc_huffman([0], [0])),
            (b"TL", _enc_huffman([0], [0])),
            (b"BA", _enc_external(3)),
        )
    else:
        series_spec = (
            (b"BF", _enc_external(1)),
            (b"CF", _enc_external(1)),
            (b"RL", _enc_external(1)),
            (b"AP", _enc_external(1)),
            (b"RG", _enc_external(1)),
            (b"RN", _enc_byte_array_stop(0, 2)),
            (b"MF", _enc_external(4)),
            (b"NS", _enc_external(4)),
            (b"NP", _enc_external(4)),
            (b"TS", _enc_external(4)),
            (b"TL", _enc_external(1)),
            (b"BA", _enc_external(3)),
        )
    series = []
    for key, enc in series_spec:
        series.append(key + enc)
    series_body = itf8_encode(len(series)) + b"".join(series)
    series_map = itf8_encode(len(series_body)) + series_body
    tag_body = itf8_encode(0)
    tag_map = itf8_encode(len(tag_body)) + tag_body
    comp_data = bytes(pres) + series_map + tag_map
    comp_block = write_block(RAW, COMPRESSION_HEADER, 0, comp_data)

    # slice header
    ext_ids = sorted(blocks_ext)
    sh = bytearray()
    sh += itf8_encode(-1)  # unmapped slice
    sh += itf8_encode(0)  # start
    sh += itf8_encode(0)  # span
    sh += itf8_encode(len(records))
    sh += ltf8_encode(0)  # counter
    sh += itf8_encode(len(ext_ids) + 1)  # number of blocks: core + external
    sh += itf8_encode(len(ext_ids))  # content-id array count
    for cid in ext_ids:
        sh += itf8_encode(cid)
    sh += itf8_encode(-1)  # no embedded reference
    sh += b"\x00" * 16  # md5
    slice_block = write_block(RAW, MAPPED_SLICE, 0, bytes(sh))
    core_block = write_block(RAW, CORE, 0, core_w.getvalue())
    if compress:
        methods = {1: RANS0_W, 2: GZIP, 3: RANS1_W, 4: RAW}
    else:
        methods = {cid: RAW for cid in ext_ids}
    ext_blocks = b"".join(
        write_block(methods.get(cid, RAW), EXTERNAL, cid, bytes(blocks_ext[cid]))
        for cid in ext_ids
    )
    body = comp_block + slice_block + core_block + ext_blocks

    # containers
    def container(ref_id, start, span, n_rec, n_bases, payload, n_blocks):
        hdr = itf8_encode(ref_id) + itf8_encode(start) + itf8_encode(span)
        hdr += itf8_encode(n_rec) + ltf8_encode(0) + ltf8_encode(n_bases)
        hdr += itf8_encode(n_blocks) + itf8_encode(0)  # no landmarks
        full = struct.pack("<i", len(payload)) + hdr
        full += struct.pack("<I", zlib.crc32(full) & 0xFFFFFFFF)
        return full + payload

    hdr_block = write_block(RAW, FILE_HEADER, 0, struct.pack("<i", len(header_text)) + header_text)
    out = bytearray()
    out += CRAM_MAGIC + bytes([3, 0]) + b"lrge_tpu".ljust(20, b"\x00")
    out += container(0, 0, 0, 0, 0, hdr_block, 1)
    out += container(-1, 0, 0, len(records), sum(len(s) for _, s in records), body, 3 + len(ext_ids))
    out += EOF_CONTAINER
    with open(path, "wb") as fh:
        fh.write(bytes(out))
