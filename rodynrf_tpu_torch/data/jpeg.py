"""JPEG decoding: the marker parser, the plain versions of the decoder's
stages, and `decode_jpegs`, which runs the stages as hand-written kernels on
the card.

The JAX package reads its frames through PIL (rodynrf_tpu/data/
video_dataset.py:28-39), so a frame decodes to libjpeg-turbo's default
output; DAVIS ships its frames as JPEG. The card's machine has no image
library, so the port decodes JPEG itself, bit for bit as
`np.asarray(Image.open(p).convert("RGB"))`:

1. entropy decode: Huffman DC (with its predictor, reset at each restart
   marker) and AC symbols into int16 blocks in natural order
   (jdhuff.c decode_mcu); a progressive frame's scans one after another
   into the same blocks (jdphuff.c: DC first and refinement, AC first with
   its end-of-band runs, AC refinement with its correction bits);
2. dequantise, `JDCT_ISLOW` inverse DCT (jidctint.c: CONST_BITS 13,
   PASS1_BITS 2, its range limit), level shift and clamp, into uint8
   component planes;
3. `do_fancy_upsampling` (jdsample.c: the h2v1, h1v2 and h2v2 triangle
   filters with their biases, context rows and edge replication; the box
   filter for h2 components 2 or fewer samples wide) and jdcolor.c's
   fixed-point YCbCr -> RGB (SCALEBITS 16); gray is repeated into three
   channels, Adobe RGB passes through.

Taken: SOF0/SOF1 frames of one scan and SOF2 (progressive) frames of any
number of scans, Huffman-coded, 8-bit samples, 1 or 3 components, sampling
factors up to 2×2, 8-bit quantisation tables, restart intervals; a
progressive frame's scans may redefine the Huffman tables and the restart
interval between them. Refused with a ValueError that names the file and
the marker: lossless, hierarchical and arithmetic-coded frames, 12-bit
samples, 16-bit quantisation tables, four components, a baseline frame of
more than one scan, a progressive script that leaves any coefficient short
of full precision (libjpeg-turbo would smooth such blocks,
jdcoefct.c decompress_smooth_data), and truncated or corrupt data.

Each stage has a plain version here (the Huffman decodes a Python loop over
one entropy-coded segment at a time, the others vectorised torch integer
ops); `rodynrf_tpu_torch/ops/jpeg.py` holds the kernels' wrappers, which take
the plain versions only for tensors on the CPU.
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..device import check_device

# zig-zag position -> natural (row-major) index (jutils.c jpeg_natural_order)
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# one Huffman table as the entropy kernel reads it: a 9-bit lookahead
# (length << 8 | symbol, 0 for longer codes), maxcode[0..17], valoffset[0..17]
# and the 256 symbols (jdhuff.c jpeg_make_d_derived_tbl)
LOOKAHEAD = 9
HUFF_WORDS = (1 << LOOKAHEAD) + 18 + 18 + 256
SCAN_WORDS = 2 + 5 * 3  # n scan components, MCUs per row, 3 × (plane, h, v, dc, ac)
# a progressive scan: frame, scan components, units per row, Ss, Se, Ah, Al,
# then 3 × (plane, h, v)
PSCAN_WORDS = 7 + 3 * 3
COLOR_GRAY, COLOR_YCC, COLOR_RGB = 0, 1, 2

# status word of one entropy-coded segment
STATUS_OK, STATUS_BAD_CODE, STATUS_BAD_AC, STATUS_SHORT, STATUS_BAD_BAND = 0, 1, 2, 3, 4
STATUS_TEXT = {STATUS_BAD_CODE: "a Huffman code that is in no table",
               STATUS_BAD_AC: "an AC run past the 64th coefficient",
               STATUS_SHORT: "the segment ends before its last MCU",
               STATUS_BAD_BAND: "a coefficient run or refinement past the scan's band"}

_MARKER_NAMES = {0xC0 + i: f"SOF{i}" for i in range(16) if i not in (4, 8, 12)}
_MARKER_NAMES.update({0xC4: "DHT", 0xC8: "JPG", 0xCC: "DAC", 0xD8: "SOI", 0xD9: "EOI",
                      0xDA: "SOS", 0xDB: "DQT", 0xDC: "DNL", 0xDD: "DRI", 0xFE: "COM"})
_MARKER_NAMES.update({0xD0 + i: f"RST{i}" for i in range(8)})
_MARKER_NAMES.update({0xE0 + i: f"APP{i}" for i in range(16)})
_REFUSED = {
    **{0xC0 + i: "lossless" for i in (3, 7, 11, 15)},
    0xC5: "hierarchical (differential sequential)",
    0xC6: "hierarchical (differential progressive)",
    0xC9: "arithmetic-coded", 0xCA: "progressive arithmetic-coded",
    0xCD: "hierarchical arithmetic-coded", 0xCE: "hierarchical progressive arithmetic-coded",
    0xCC: "arithmetic-coded", 0xC8: "reserved (JPG)",
    0xDC: "DNL (height defined after the scan)",
}
_TAKEN = "(Huffman-coded SOF0/SOF1/SOF2 only)"


def _name(marker: int) -> str:
    return _MARKER_NAMES.get(marker, f"0xFF{marker:02X}")


@dataclass
class Component:
    cid: int
    h: int
    v: int
    tq: int
    cw: int = 0  # samples per row and rows of the component (downsampled size)
    ch: int = 0
    bw: int = 0  # blocks per row and rows of its coefficient plane
    bh: int = 0
    dc: int = 0  # Huffman table ids of the scan
    ac: int = 0


@dataclass
class Scan:
    """One scan of a progressive frame: its components (indices into the
    frame's), spectral band Ss..Se and successive approximation Ah/Al, the
    Huffman table each scan component reads (a snapshot taken at its SOS:
    progressive files redefine tables between scans; none for a DC
    refinement), the restart interval in force, its units (MCUs when
    interleaved, else the component's blocks) and its segments."""

    comps: List[int]
    ss: int
    se: int
    ah: int
    al: int
    huff: np.ndarray  # [3, HUFF_WORDS] int32, one table per scan component
    luts: list  # per scan component: the plain decoder's lookup, or None
    restart: int
    units_x: int
    n_units: int
    segments: List[bytes] = field(default_factory=list)


@dataclass
class JpegFrame:
    """One parsed frame: geometry, tables and its entropy-coded segments
    (0xFF00 unstuffed, split at the restart markers); a progressive frame
    keeps them per scan in `scans`."""

    path: str
    H: int
    W: int
    comps: List[Component]
    color: int
    quant: np.ndarray  # [n comps, 64] int32, natural order
    huff: np.ndarray  # [8, HUFF_WORDS] int32: DC tables 0-3, AC tables 4-7
    luts: Dict[int, list]  # slot -> 16-bit lookup (the plain decoder)
    interleaved: bool
    mcus_x: int
    n_mcu: int
    restart: int
    segments: List[bytes] = field(default_factory=list)
    progressive: bool = False
    scans: List[Scan] = field(default_factory=list)

    @property
    def hmax(self):
        return max(c.h for c in self.comps)

    @property
    def vmax(self):
        return max(c.v for c in self.comps)


# ---------------------------------------------------------------------------
# Huffman tables
# ---------------------------------------------------------------------------

def _huff_codes(bits: Sequence[int]):
    """(sizes, codes) of a DHT table's symbols in order (jdhuff.c
    jpeg_make_d_derived_tbl); raises on an over-subscribed table."""
    sizes = [l for l in range(1, 17) for _ in range(bits[l - 1])]
    codes, code, si, p = [], 0, sizes[0] if sizes else 1, 0
    while p < len(sizes):
        while p < len(sizes) and sizes[p] == si:
            codes.append(code)
            code += 1
            p += 1
        if code >= (1 << si):
            raise ValueError("DHT: over-subscribed Huffman table")
        code <<= 1
        si += 1
    return sizes, codes


@functools.lru_cache(maxsize=64)
def _derived(bits: bytes, vals: bytes):
    """The kernel's packed table and the plain decoder's 16-bit lookup (a
    list: its loop indexes it per symbol), made once per distinct table."""
    sizes, codes = _huff_codes(bits)
    look = np.zeros(1 << LOOKAHEAD, np.int32)
    maxcode = np.full(18, -1, np.int64)
    valoff = np.zeros(18, np.int64)
    lut = np.zeros(1 << 16, np.int32)
    p = 0
    for l in range(1, 17):
        n = bits[l - 1]
        if n:
            valoff[l] = p - codes[p]
            p += n
            maxcode[l] = codes[p - 1]
    maxcode[17] = 0xFFFFF
    for size, code, sym in zip(sizes, codes, vals):
        lut[code << (16 - size):(code + 1) << (16 - size)] = (size << 8) | sym
        if size <= LOOKAHEAD:
            look[code << (LOOKAHEAD - size):(code + 1) << (LOOKAHEAD - size)] = (size << 8) | sym
    packed = np.zeros(HUFF_WORDS, np.int32)
    o = 1 << LOOKAHEAD
    packed[:o] = look
    packed[o:o + 18] = maxcode
    packed[o + 18:o + 36] = valoff
    packed[o + 36:o + 36 + len(vals)] = list(vals)
    return packed, lut.tolist()


# ---------------------------------------------------------------------------
# the marker parser
# ---------------------------------------------------------------------------

def _entropy_end(arr: np.ndarray, start: int, path: str):
    """Split the entropy-coded data that starts at `start` at its restart
    markers. Returns (segments as unstuffed bytes, the position of the
    marker that ends the scan)."""
    tail = arr[start:]
    ffs = np.flatnonzero(tail[:-1] == 0xFF)
    nxt = tail[ffs + 1]
    ends = ffs[(nxt != 0x00) & (nxt != 0xFF) & ((nxt < 0xD0) | (nxt > 0xD7))]
    if len(ends) == 0:
        raise ValueError(f"{path}: SOS: truncated entropy-coded data (no marker ends the scan)")
    end = int(ends[0])
    ffs, nxt = ffs[ffs < end], nxt[ffs < end]
    segments, seg0, expect = [], 0, 0
    for i in np.flatnonzero((nxt >= 0xD0) & (nxt <= 0xD7)):
        pos, n = int(ffs[i]), int(nxt[i]) - 0xD0
        if n != expect:
            raise ValueError(f"{path}: {_name(0xD0 + n)}: restart marker out of order "
                             f"(expected RST{expect})")
        expect = (expect + 1) % 8
        segments.append((seg0, pos))
        seg0 = pos + 2
    segments.append((seg0, end))
    out = []
    for a, b in segments:
        s = tail[a:b]
        f = np.flatnonzero(s[:-1] == 0xFF)
        drop = f[s[f + 1] == 0x00] + 1  # the stuffed zero after a data 0xFF
        fill = f[s[f + 1] == 0xFF]  # fill bytes before a marker
        keep = np.ones(len(s), bool)
        keep[drop] = False
        keep[fill] = False
        if len(s) and s[-1] == 0xFF:
            keep[-1] = False
        out.append(s[keep].tobytes())
    return out, start + end


def parse_jpeg(data: bytes, path: str = "<bytes>") -> JpegFrame:
    """Parse a baseline or progressive JPEG file; raises ValueError (naming
    `path` and the marker) on what the decoder does not take or on
    truncated data."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI)")
    arr = np.frombuffer(data, np.uint8)
    pos, n = 2, len(data)
    qt: Dict[int, np.ndarray] = {}
    dht: Dict[int, tuple] = {}
    comps: List[Component] = []
    H = W = restart = 0
    jfif = adobe = progressive = False
    transform = 1
    frame = None
    coef_bits = None  # progressive: [components, 64], jdcoefct.c coef_bits
    while True:
        while pos < n and data[pos] != 0xFF:  # libjpeg skips garbage before a marker
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{path}: truncated: the file ends before EOI")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:  # EOI
            if frame is None or (progressive and not frame.scans):
                raise ValueError(f"{path}: EOI before any scan")
            if progressive:
                _check_complete(coef_bits, path)
            return frame
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise ValueError(f"{path}: {_name(marker)}: truncated marker segment")
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        if length < 2 or pos + length > n:
            raise ValueError(f"{path}: {_name(marker)}: truncated marker segment")
        pos += length
        name = _name(marker)
        if marker in _REFUSED:
            raise ValueError(f"{path}: {name}: {_REFUSED[marker]} JPEG is not supported "
                             f"{_TAKEN}")
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe, transform = True, body[11]
        elif marker == 0xDB:  # DQT
            p = 0
            while p < len(body):
                pq, tq = body[p] >> 4, body[p] & 15
                if pq != 0:
                    raise ValueError(f"{path}: DQT: 16-bit quantisation table {tq} is not "
                                     f"supported (8-bit tables only)")
                if p + 65 > len(body) or tq > 3:
                    raise ValueError(f"{path}: DQT: malformed table")
                q = np.zeros(64, np.int32)
                q[NATURAL] = np.frombuffer(body[p + 1:p + 65], np.uint8)
                qt[tq] = q
                p += 65
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(body):
                tc, th = body[p] >> 4, body[p] & 15
                if p + 17 > len(body) or tc > 1 or th > 3:
                    raise ValueError(f"{path}: DHT: malformed table")
                bits = bytes(body[p + 1:p + 17])
                nv = sum(bits)
                vals = bytes(body[p + 17:p + 17 + nv])
                if len(vals) != nv or nv > 256:
                    raise ValueError(f"{path}: DHT: malformed table")
                if tc == 0 and any(v > 15 for v in vals):
                    raise ValueError(f"{path}: DHT: DC symbol above 15")
                try:
                    dht[tc * 4 + th] = _derived(bits, vals)
                except ValueError as e:
                    raise ValueError(f"{path}: {e}") from None
                p += 17 + nv
        elif marker in (0xC0, 0xC1, 0xC2):  # SOF0 / SOF1 / SOF2
            if comps:
                raise ValueError(f"{path}: {name}: a second frame header")
            if len(body) < 6:
                raise ValueError(f"{path}: {name}: truncated marker segment")
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise ValueError(f"{path}: {name}: {prec}-bit samples are not supported "
                                 f"(8-bit only)")
            if nc not in (1, 3):
                raise ValueError(f"{path}: {name}: {nc} components are not supported "
                                 f"(1 or 3; CMYK/YCCK are not)")
            if H == 0 or W == 0:
                raise ValueError(f"{path}: {name}: empty image or DNL height")
            if len(body) < 6 + 3 * nc:
                raise ValueError(f"{path}: {name}: truncated marker segment")
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 2 and 1 <= v <= 2) or tq > 3:
                    raise ValueError(f"{path}: {name}: sampling {h}x{v} is not supported "
                                     f"(factors 1 or 2)")
                comps.append(Component(cid, h, v, tq))
            progressive = marker == 0xC2
            coef_bits = np.full((nc, 64), -1, np.int64)
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:  # SOS
            if not comps:
                raise ValueError(f"{path}: SOS before SOF")
            if progressive:
                if frame is None:
                    frame = _frame(path, H, W, comps, {}, {}, restart, jfif, adobe, transform)
                    frame.progressive = True
                scan = _progressive_scan(frame, body, qt, dht, restart, coef_bits, path)
                scan.segments, pos = _entropy_end(arr, pos, path)
                want = -(-scan.n_units // restart) if restart else 1
                if len(scan.segments) != want:
                    raise ValueError(f"{path}: SOS: scan {len(frame.scans)}: "
                                     f"{len(scan.segments)} entropy-coded segments, {want} "
                                     f"expected (truncated or corrupt restart markers)")
                frame.scans.append(scan)
                continue
            if frame is not None:
                raise ValueError(f"{path}: SOS: more than one scan is not supported")
            ns = body[0]
            if ns != len(comps) or len(body) < 1 + 2 * ns + 3:
                raise ValueError(f"{path}: SOS: a scan of {ns} of {len(comps)} components "
                                 f"(more than one scan) is not supported")
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError(f"{path}: SOS: spectral selection {ss}-{se}, approximation "
                                 f"{a} is not sequential")
            by_id = {c.cid: c for c in comps}
            for i in range(ns):
                cid, t = body[1 + 2 * i:3 + 2 * i]
                c = by_id.get(cid)
                if c is None:
                    raise ValueError(f"{path}: SOS: unknown component {cid}")
                c.dc, c.ac = t >> 4, t & 15
                for slot in (c.dc, 4 + c.ac):
                    if slot not in dht:
                        raise ValueError(f"{path}: SOS: Huffman table {slot & 3} "
                                         f"({'AC' if slot > 3 else 'DC'}) is not defined")
            for c in comps:
                if c.tq not in qt:
                    raise ValueError(f"{path}: SOS: quantisation table {c.tq} is not defined")
            frame = _frame(path, H, W, comps, qt, dht, restart, jfif, adobe, transform)
            frame.segments, pos = _entropy_end(arr, pos, path)
            want = -(-frame.n_mcu // restart) if restart else 1
            if len(frame.segments) != want:
                raise ValueError(f"{path}: SOS: {len(frame.segments)} entropy-coded segments, "
                                 f"{want} expected (truncated or corrupt restart markers)")
        # APPn other than JFIF/Adobe, COM and other markers are skipped


def _progressive_scan(frame: JpegFrame, body: bytes, qt, dht, restart, coef_bits,
                      path) -> Scan:
    """A progressive SOS header checked as jdphuff.c start_pass_phuff_decoder
    checks it, its tables snapshotted, coef_bits advanced (jdphuff.c) and the
    quantisation table of each component latched at its first scan
    (jdinput.c latch_quant_tables)."""
    k = len(frame.scans)
    ns = body[0] if body else 0
    if not 1 <= ns <= len(frame.comps) or len(body) < 1 + 2 * ns + 3:
        raise ValueError(f"{path}: SOS: scan {k}: malformed header ({ns} components)")
    ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
    ah, al = a >> 4, a & 15
    dc = ss == 0
    bad = (se != 0) if dc else (ss > se or se > 63 or ns != 1)
    if bad or (ah != 0 and al != ah - 1) or al > 13:
        raise ValueError(f"{path}: SOS: scan {k}: invalid progression Ss={ss} Se={se} Ah={ah} "
                         f"Al={al} (jdphuff.c start_pass_phuff_decoder)")
    index = {c.cid: i for i, c in enumerate(frame.comps)}
    idx, huff, luts = [], np.zeros((3, HUFF_WORDS), np.int32), []
    for j in range(ns):
        cid, t = body[1 + 2 * j:3 + 2 * j]
        ci = index.get(cid)
        if ci is None or ci in idx:
            raise ValueError(f"{path}: SOS: scan {k}: unknown or repeated component {cid}")
        idx.append(ci)
        slot = None if (dc and ah) else ((t >> 4) if dc else 4 + (t & 15))
        if slot is None:
            luts.append(None)  # a DC refinement reads raw bits
        elif slot not in dht:
            raise ValueError(f"{path}: SOS: scan {k}: Huffman table {slot & 3} "
                             f"({'AC' if slot > 3 else 'DC'}) is not defined")
        else:
            huff[j], lut = dht[slot]
            luts.append(lut)
        c = frame.comps[ci]
        if (coef_bits[ci] < 0).all():  # the component's first scan
            if c.tq not in qt:
                raise ValueError(f"{path}: SOS: quantisation table {c.tq} is not defined")
            frame.quant[ci] = qt[c.tq]
        coef_bits[ci, ss:se + 1] = al
    if ns > 1:
        units_x, n_units = frame.mcus_x, frame.n_mcu
    else:
        c = frame.comps[idx[0]]
        units_x = -(-c.cw // 8)
        n_units = units_x * -(-c.ch // 8)
    return Scan(idx, ss, se, ah, al, huff, luts, restart, units_x, n_units)


def _check_complete(coef_bits: np.ndarray, path: str) -> None:
    """Refuse a progressive frame whose scans leave a coefficient short of
    full precision (coef_bits != 0): libjpeg-turbo then smooths its blocks
    (jdcoefct.c smoothing_ok, decompress_smooth_data), which the port does
    not do. Names the first such band."""
    bad = np.argwhere(coef_bits != 0)
    if not len(bad):
        return
    ci, k0 = (int(x) for x in bad[0])
    v = int(coef_bits[ci, k0])
    k1 = k0
    while k1 < 63 and coef_bits[ci, k1 + 1] == v:
        k1 += 1
    what = "never sent" if v < 0 else f"left {v} bits short (never refined to Al=0)"
    raise ValueError(f"{path}: EOI: an incomplete progressive script: component {ci} "
                     f"coefficients {k0}-{k1} {what}; block smoothing is not supported "
                     f"(complete scripts only)")


def _frame(path, H, W, comps, qt, dht, restart, jfif, adobe, transform) -> JpegFrame:
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    interleaved = len(comps) > 1
    mcus_x, mcus_y = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for c in comps:
        c.cw, c.ch = -(-W * c.h // hmax), -(-H * c.v // vmax)
        if interleaved:
            c.bw, c.bh = mcus_x * c.h, mcus_y * c.v
        else:
            c.bw, c.bh = -(-c.cw // 8), -(-c.ch // 8)
    if not interleaved:
        mcus_x, mcus_y = comps[0].bw, comps[0].bh
    if len(comps) == 1:
        color = COLOR_GRAY
    elif jfif:
        color = COLOR_YCC
    elif adobe:
        color = COLOR_RGB if transform == 0 else COLOR_YCC
    else:  # jdapimin.c default_decompress_parms: guess from the component ids
        color = COLOR_RGB if [c.cid for c in comps] == [82, 71, 66] else COLOR_YCC
    huff = np.zeros((8, HUFF_WORDS), np.int32)
    luts = {}
    for slot, (packed, lut) in dht.items():
        huff[slot] = packed
        luts[slot] = lut
    quant = np.stack([qt.get(c.tq, np.zeros(64, np.int32)) for c in comps])
    return JpegFrame(path, H, W, comps, color, quant, huff, luts, interleaved, mcus_x,
                     mcus_x * mcus_y, restart)


def read_jpeg(path: str) -> JpegFrame:
    with open(path, "rb") as f:
        return parse_jpeg(f.read(), path)


def jpeg_size(path: str):
    """(width, height) from the SOF header, without reading the rest."""
    with open(path, "rb") as f:
        data = f.read(2)
        if data != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG file (no SOI)")
        while True:
            b = f.read(1)
            while b and b != b"\xff":
                b = f.read(1)
            while b == b"\xff":
                b = f.read(1)
            if not b:
                raise ValueError(f"{path}: truncated: no SOF header")
            marker = b[0]
            if 0xD0 <= marker <= 0xD9 or marker == 0x01:
                continue
            head = f.read(2)
            if len(head) < 2:
                raise ValueError(f"{path}: {_name(marker)}: truncated marker segment")
            (length,) = struct.unpack(">H", head)
            if marker in _REFUSED:
                raise ValueError(f"{path}: {_name(marker)}: {_REFUSED[marker]} JPEG is not "
                                 f"supported {_TAKEN}")
            if marker in (0xC0, 0xC1, 0xC2):
                body = f.read(5)
                if len(body) < 5:
                    raise ValueError(f"{path}: {_name(marker)}: truncated marker segment")
                _, H, W = struct.unpack(">BHH", body)
                return W, H
            if marker == 0xDA:
                raise ValueError(f"{path}: SOS before SOF")
            f.seek(length - 2, 1)


# ---------------------------------------------------------------------------
# a batch of frames as flat tensors
# ---------------------------------------------------------------------------

@dataclass
class JpegBatch:
    """Frames packed for the stages (host tensors until `.to`).

    data  uint8 [bytes]: every segment's unstuffed bytes, back to back;
    seg   int32 [S, 5]: the baseline frames' segments: byte offset, byte
          length, frame, first MCU, MCUs;
    scan  int32 [F, SCAN_WORDS]: scan components, MCUs per row, then per
          scan component its plane, h, v (1, 1 when not interleaved), DC
          and AC table slot (zeros for a progressive frame);
    huff  int32 [F, 8, HUFF_WORDS];
    pseg  int32 [Sp, 5]: the progressive frames' segments, round after
          round: byte offset, byte length, progressive scan, first unit
          (MCU when the scan is interleaved, else block), units;
    pscan int32 [Np, PSCAN_WORDS]: frame, scan components, units per row,
          Ss, Se, Ah, Al, then per scan component its plane, h, v (1, 1
          when not interleaved);
    phuff int32 [Np, 3, HUFF_WORDS]: each scan component's table;
    rounds [(first segment, segments)]: round k holds scan k of every
          progressive frame that has one, launched after round k - 1;
    plane_block0 int64 [P + 1]: each component plane's first block;
    plane int32 [P, 8]: blocks per row, block rows, samples per row, rows,
          horizontal and vertical upsampling factor, fancy flag, frame;
    plane_pix0 int64 [P]: first byte of the plane's samples;
    quant int32 [P, 64];
    frame int32 [F, 5]: H, W, colour, components, first plane;
    frame_pix0 int64 [F + 1]: first output pixel of each frame.
    """

    data: torch.Tensor
    seg: torch.Tensor
    scan: torch.Tensor
    huff: torch.Tensor
    pseg: torch.Tensor
    pscan: torch.Tensor
    phuff: torch.Tensor
    plane_block0: torch.Tensor
    plane: torch.Tensor
    plane_pix0: torch.Tensor
    quant: torch.Tensor
    frame: torch.Tensor
    frame_pix0: torch.Tensor
    n_blocks: int
    n_plane_bytes: int
    n_pixels: int
    frames: List[JpegFrame]
    rounds: List[tuple] = field(default_factory=list)
    scans: List[Scan] = field(default_factory=list)  # row i of pscan

    _TENSORS = ("data", "seg", "scan", "huff", "pseg", "pscan", "phuff", "plane_block0",
                "plane", "plane_pix0", "quant", "frame", "frame_pix0")

    def to(self, device) -> "JpegBatch":
        kw = {k: getattr(self, k).to(device) for k in self._TENSORS}
        return JpegBatch(**kw, n_blocks=self.n_blocks, n_plane_bytes=self.n_plane_bytes,
                         n_pixels=self.n_pixels, frames=self.frames, rounds=self.rounds,
                         scans=self.scans)


def pack(frames: Sequence[JpegFrame]) -> JpegBatch:
    """Lay parsed frames out as one batch (`JpegBatch`): segments, tables,
    component planes and output pixels back to back, frame after frame; the
    progressive frames' segments grouped into rounds of scans."""
    data, seg, scan, planes, plane_block0, plane_pix0, quant, fr, pix0 = ([] for _ in range(9))
    nbytes = nblocks = npix = nplane = 0
    by_round: Dict[int, list] = {}  # round -> [(segment bytes, scan row, first unit, units)]
    pscan, phuff, scans = [], [], []
    for f_i, f in enumerate(frames):
        p0 = len(planes)
        sc = [len(f.comps), f.mcus_x]
        for c_i, c in enumerate(f.comps):
            rh, rv = f.hmax // c.h, f.vmax // c.v
            fancy = int(rh == 1 or c.cw > 2)  # jdsample.c: h2 fancy needs > 2 samples
            planes.append([c.bw, c.bh, c.cw, c.ch, rh, rv, fancy, f_i])
            plane_block0.append(nblocks)
            plane_pix0.append(nplane)
            quant.append(f.quant[c_i])
            nblocks += c.bw * c.bh
            nplane += c.bw * c.bh * 64
            h, v = (c.h, c.v) if f.interleaved else (1, 1)
            sc += [p0 + c_i, h, v, c.dc, 4 + c.ac]
        scan.append([0] * SCAN_WORDS if f.progressive else sc + [0] * (SCAN_WORDS - len(sc)))
        fr.append([f.H, f.W, f.color, len(f.comps), p0])
        pix0.append(npix)
        npix += f.H * f.W
        per = f.restart or f.n_mcu
        for s_i, s in enumerate(f.segments):
            m0 = s_i * per
            seg.append([nbytes, len(s), f_i, m0, min(per, f.n_mcu - m0)])
            data.append(s)
            nbytes += len(s)
        for k, ps in enumerate(f.scans):
            row = [f_i, len(ps.comps), ps.units_x, ps.ss, ps.se, ps.ah, ps.al]
            for ci in ps.comps:
                c = f.comps[ci]
                row += [p0 + ci, c.h, c.v] if len(ps.comps) > 1 else [p0 + ci, 1, 1]
            pscan.append(row + [0] * (PSCAN_WORDS - len(row)))
            phuff.append(ps.huff)
            scans.append(ps)
            per = ps.restart or ps.n_units
            for s_i, s in enumerate(ps.segments):
                m0 = s_i * per
                by_round.setdefault(k, []).append((s, len(pscan) - 1, m0,
                                                   min(per, ps.n_units - m0)))
    pseg, rounds = [], []
    for k in sorted(by_round):
        rounds.append((len(pseg), len(by_round[k])))
        for s, row, m0, nu in by_round[k]:
            pseg.append([nbytes, len(s), row, m0, nu])
            data.append(s)
            nbytes += len(s)
    if nbytes >= 2 ** 31:  # the segment offsets are int32
        raise ValueError("batch too large: split the frames into several batches")
    plane_block0.append(nblocks)
    pix0.append(npix)
    raw = b"".join(data) or bytes(1)  # torch.frombuffer refuses an empty buffer
    return JpegBatch(
        data=torch.frombuffer(bytearray(raw), dtype=torch.uint8),
        seg=torch.tensor(seg, dtype=torch.int32).reshape(-1, 5),
        scan=torch.tensor(scan, dtype=torch.int32).reshape(-1, SCAN_WORDS),
        huff=torch.from_numpy(np.stack([f.huff for f in frames])),
        pseg=torch.tensor(pseg, dtype=torch.int32).reshape(-1, 5),
        pscan=torch.tensor(pscan, dtype=torch.int32).reshape(-1, PSCAN_WORDS),
        phuff=torch.from_numpy(np.stack(phuff) if phuff
                               else np.zeros((0, 3, HUFF_WORDS), np.int32)),
        plane_block0=torch.tensor(plane_block0, dtype=torch.int64),
        plane=torch.tensor(planes, dtype=torch.int32).reshape(-1, 8),
        plane_pix0=torch.tensor(plane_pix0, dtype=torch.int64),
        quant=torch.from_numpy(np.stack(quant).astype(np.int32)),
        frame=torch.tensor(fr, dtype=torch.int32).reshape(-1, 5),
        frame_pix0=torch.tensor(pix0, dtype=torch.int64),
        n_blocks=nblocks, n_plane_bytes=nplane, n_pixels=npix, frames=list(frames),
        rounds=rounds, scans=scans)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _decode_segment(seg: bytes, comps, coef: np.ndarray, m0: int, nmcu: int,
                    mcus_x: int) -> int:
    """Huffman-decode one entropy-coded segment into coef [blocks, 64]
    (natural order); returns its status word. comps: per scan component
    (first block, blocks per row, h, v, DC lookup, AC lookup)."""
    nbits = 8 * len(seg)
    raw = np.frombuffer(seg + bytes(2), np.uint8).astype(np.int64)
    # w24[i]: the 24 bits from byte i; bytes past the segment read as 0 (as in
    # the kernel), enough of them for one MCU of 12 blocks of 64 symbols
    w24 = ((raw[:-2] << 16) | (raw[1:-1] << 8) | raw[2:]).tolist() + [0] * 4096
    limit = len(w24) * 8 - 32
    nat = NATURAL.tolist()
    pred = [0] * len(comps)
    p = 0
    for m in range(m0, m0 + nmcu):
        my, mx = divmod(m, mcus_x)
        for ci, (b0, bw, h, v, dlut, alut) in enumerate(comps):
            for yy in range(v):
                for xx in range(h):
                    row = coef[b0 + (my * v + yy) * bw + mx * h + xx]
                    e = dlut[(w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                    if not e:
                        return STATUS_BAD_CODE
                    p += e >> 8
                    s = e & 255
                    x = 0
                    if s:
                        x = ((w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                        p += s
                        if x < (1 << (s - 1)):
                            x += (-1 << s) + 1
                    pred[ci] += x
                    row[0] = ((pred[ci] + 32768) & 0xFFFF) - 32768
                    k = 1
                    while k < 64:
                        e = alut[(w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                        if not e:
                            return STATUS_BAD_CODE
                        p += e >> 8
                        rs = e & 255
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            if k > 63:
                                return STATUS_BAD_AC
                            x = ((w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - s)
                            p += s
                            if x < (1 << (s - 1)):
                                x += (-1 << s) + 1
                            row[nat[k]] = x
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            break
        if p > nbits or p > limit:
            return STATUS_SHORT
    return STATUS_OK


def entropy_decode_plain(batch: JpegBatch):
    """(coef int16 [n_blocks, 64] natural order, status int32 [S]): the
    Python loop, one segment at a time."""
    coef = np.zeros((batch.n_blocks, 64), np.int16)
    data = batch.data.numpy().tobytes()
    seg = batch.seg.numpy()
    scan = batch.scan.numpy()
    plane = batch.plane.numpy()
    b0 = batch.plane_block0.numpy()
    status = np.zeros(len(seg), np.int32)
    for s_i, (off, n, f_i, m0, nmcu) in enumerate(seg.tolist()):
        sc = scan[f_i]
        comps = []
        for j in range(int(sc[0])):
            pl, h, v, dc, ac = (int(x) for x in sc[2 + 5 * j:7 + 5 * j])
            luts = batch.frames[f_i].luts
            comps.append((int(b0[pl]), int(plane[pl, 0]), h, v, luts[dc], luts[ac]))
        status[s_i] = _decode_segment(data[off:off + n], comps, coef, m0, nmcu, int(sc[1]))
    return torch.from_numpy(coef), torch.from_numpy(status)


def _wrap16(x: int) -> int:
    """x as a JCOEF (int16) stores it."""
    return ((x + 32768) & 0xFFFF) - 32768


def _decode_progressive_segment(seg: bytes, comps, coef: np.ndarray, m0: int, nu: int,
                                units_x: int, ss: int, se: int, ah: int, al: int) -> int:
    """Decode one entropy-coded segment of a progressive scan into coef
    [blocks, 64] (natural order; earlier scans' values in place), as
    jdphuff.c's decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine;
    returns its status word. comps: per scan component (first block, blocks
    per row, h, v, lookup or None); units: MCUs of an interleaved scan,
    blocks of the one component otherwise (h = v = 1). The DC predictors
    and the end-of-band run start at 0 in every segment."""
    nbits = 8 * len(seg)
    raw = np.frombuffer(seg + bytes(2), np.uint8).astype(np.int64)
    w24 = ((raw[:-2] << 16) | (raw[1:-1] << 8) | raw[2:]).tolist() + [0] * 4096
    limit = len(w24) * 8 - 32
    nat = NATURAL.tolist()
    p1, m1 = 1 << al, -1 << al
    pred = [0] * len(comps)
    eobrun = 0
    p = 0

    def bit():
        nonlocal p
        b = (w24[p >> 3] >> (23 - (p & 7))) & 1
        p += 1
        return b

    def bits(n):
        nonlocal p
        x = ((w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF) >> (16 - n)
        p += n
        return x

    for m in range(m0, m0 + nu):
        my, mx = divmod(m, units_x)
        for ci, (b0, bw, h, v, lut) in enumerate(comps):
            for yy in range(v):
                for xx in range(h):
                    row = coef[b0 + (my * v + yy) * bw + mx * h + xx]
                    if ss == 0 and ah == 0:  # DC first
                        e = lut[(w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                        if not e:
                            return STATUS_BAD_CODE
                        p += e >> 8
                        t = e & 255
                        x = 0
                        if t:
                            x = bits(t)
                            if x < (1 << (t - 1)):
                                x += (-1 << t) + 1
                        pred[ci] += x
                        row[0] = _wrap16(pred[ci] << al)
                    elif ss == 0:  # DC refinement: one raw bit
                        if bit():
                            row[0] |= p1
                    elif ah == 0:  # AC first
                        if eobrun:
                            eobrun -= 1
                            continue
                        k = ss
                        while k <= se:
                            e = lut[(w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                            if not e:
                                return STATUS_BAD_CODE
                            p += e >> 8
                            r, t = (e & 255) >> 4, e & 15
                            if t:
                                k += r
                                if k > se:
                                    return STATUS_BAD_BAND
                                x = bits(t)
                                if x < (1 << (t - 1)):
                                    x += (-1 << t) + 1
                                row[nat[k]] = _wrap16(x << al)
                            elif r == 15:
                                k += 15
                            else:
                                eobrun = (1 << r) + (bits(r) if r else 0) - 1
                                break
                            k += 1
                    else:  # AC refinement
                        k = ss
                        if eobrun == 0:
                            while k <= se:
                                e = lut[(w24[p >> 3] >> (8 - (p & 7))) & 0xFFFF]
                                if not e:
                                    return STATUS_BAD_CODE
                                p += e >> 8
                                r, t = (e & 255) >> 4, e & 15
                                val = 0
                                if t:  # a newly nonzero coefficient, its sign bit
                                    val = p1 if bit() else m1
                                elif r != 15:
                                    eobrun = (1 << r) + (bits(r) if r else 0)
                                    break
                                # correction bits for nonzero coefficients; the
                                # run counts zero-history coefficients only
                                while k <= se:
                                    z = nat[k]
                                    c = int(row[z])
                                    if c:
                                        if bit() and not c & p1:
                                            row[z] = _wrap16(c + (p1 if c >= 0 else m1))
                                    else:
                                        r -= 1
                                        if r < 0:
                                            break
                                    k += 1
                                if val:
                                    if k > se:
                                        return STATUS_BAD_BAND
                                    row[nat[k]] = val
                                k += 1
                        if eobrun:  # the rest of the band: correction bits only
                            while k <= se:
                                z = nat[k]
                                c = int(row[z])
                                if c and bit() and not c & p1:
                                    row[z] = _wrap16(c + (p1 if c >= 0 else m1))
                                k += 1
                            eobrun -= 1
        if p > nbits or p > limit:
            return STATUS_SHORT
    return STATUS_OK


def progressive_decode_plain(coef: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """Decode every progressive segment of the batch into coef int16
    [n_blocks, 64] in place, round after round (the Python loop, one
    segment at a time); returns the status words int32 [progressive
    segments]."""
    out = coef.numpy()
    data = batch.data.numpy().tobytes()
    pseg = batch.pseg.numpy()
    pscan = batch.pscan.numpy()
    plane = batch.plane.numpy()
    b0 = batch.plane_block0.numpy()
    status = np.zeros(len(pseg), np.int32)
    for s_i, (off, n, row, m0, nu) in enumerate(pseg.tolist()):
        f_i, ns, units_x, ss, se, ah, al = (int(x) for x in pscan[row, :7])
        comps = []
        for j in range(ns):
            pl, h, v = (int(x) for x in pscan[row, 7 + 3 * j:10 + 3 * j])
            comps.append((int(b0[pl]), int(plane[pl, 0]), h, v, batch.scans[row].luts[j]))
        status[s_i] = _decode_progressive_segment(data[off:off + n], comps, out, m0, nu,
                                                  units_x, ss, se, ah, al)
    return torch.from_numpy(status)


_FIX = dict(c0_298631336=2446, c0_390180644=3196, c0_541196100=4433, c0_765366865=6270,
            c0_899976223=7373, c1_175875602=9633, c1_501321110=12299, c1_847759065=15137,
            c1_961570560=16069, c2_053119869=16819, c2_562915447=20995, c3_072711026=25172)


def _islow_1d(x: torch.Tensor, shift: int):
    """One pass of jidctint.c jpeg_idct_islow along the last axis of int64
    x [..., 8]: returns the 8 outputs DESCALEd by `shift`, unrounded by the
    caller."""
    F = _FIX
    z2, z3 = x[..., 2], x[..., 6]
    z1 = (z2 + z3) * F["c0_541196100"]
    tmp2 = z1 + z3 * (-F["c1_847759065"])
    tmp3 = z1 + z2 * F["c0_765366865"]
    tmp0 = (x[..., 0] + x[..., 4]) << 13
    tmp1 = (x[..., 0] - x[..., 4]) << 13
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7], x[..., 5], x[..., 3], x[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * F["c1_175875602"]
    t0 = t0 * F["c0_298631336"]
    t1 = t1 * F["c2_053119869"]
    t2 = t2 * F["c3_072711026"]
    t3 = t3 * F["c1_501321110"]
    z1 = z1 * (-F["c0_899976223"])
    z2 = z2 * (-F["c2_562915447"])
    z3 = z3 * (-F["c1_961570560"]) + z5
    z4 = z4 * (-F["c0_390180644"]) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    r = 1 << (shift - 1)
    return torch.stack([(o + r) >> shift for o in out], -1)


def idct_plain(coef: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """Dequantise, islow IDCT, level shift and clamp every block: uint8
    [n_plane_bytes], each plane [block rows·8, blocks per row·8]."""
    b0 = batch.plane_block0
    counts = (b0[1:] - b0[:-1])
    q = torch.repeat_interleave(batch.quant.to(torch.int64), counts, 0)  # [N, 64]
    x = (coef.to(torch.int64) * q).view(-1, 8, 8)
    ws = _islow_1d(x.transpose(1, 2), 11)  # columns: [N, col, row]
    ws = ws.to(torch.int32).to(torch.int64)  # the workspace holds ints
    pix = _islow_1d(ws.transpose(1, 2), 18)  # rows: [N, row, col]
    v = ((pix & 1023) ^ 512) - 512  # RANGE_MASK, as a signed 10-bit value
    pix = torch.clamp(v + 128, 0, 255).to(torch.uint8)
    out = torch.empty(batch.n_plane_bytes, dtype=torch.uint8)
    plane = batch.plane.tolist()
    for p_i, (bw, bh, *_rest) in enumerate(plane):
        blocks = pix[int(b0[p_i]):int(b0[p_i + 1])].view(bh, bw, 8, 8)
        o = int(batch.plane_pix0[p_i])
        out[o:o + bw * bh * 64] = blocks.permute(0, 2, 1, 3).reshape(-1)
    return out


def _upsample(P: torch.Tensor, rh: int, rv: int, fancy: int) -> torch.Tensor:
    """jdsample.c's upsampling of one component's samples P [ch, cw] int32."""
    ch, cw = P.shape
    up = torch.cat([P[:1], P[:-1]], 0)  # the row above, replicated at the top
    dn = torch.cat([P[1:], P[-1:]], 0)
    if rv == 2 and rh == 1:  # h1v2: (3·near + far + 1 or 2) >> 2
        return torch.stack([(3 * P + up + 1) >> 2, (3 * P + dn + 2) >> 2], 1).view(2 * ch, cw)
    if rh == 2 and not fancy:  # box filter
        return P.repeat_interleave(rv, 0).repeat_interleave(2, 1)
    if rv == 2:  # h2v2: column sums 3·near + far rows, then (3·this + other + 8 or 7) >> 4
        C = torch.stack([3 * P + up, 3 * P + dn], 1).view(2 * ch, cw)
        lft = torch.cat([C[:, :1], C[:, :-1]], 1)
        rgt = torch.cat([C[:, 1:], C[:, -1:]], 1)
        return torch.stack([(3 * C + lft + 8) >> 4, (3 * C + rgt + 7) >> 4], 2).view(2 * ch,
                                                                                   2 * cw)
    if rh == 2:  # h2v1: (3·near + far + 1 or 2) >> 2
        lft = torch.cat([P[:, :1], P[:, :-1]], 1)
        rgt = torch.cat([P[:, 1:], P[:, -1:]], 1)
        return torch.stack([(3 * P + lft + 1) >> 2, (3 * P + rgt + 2) >> 2], 2).view(ch, 2 * cw)
    return P


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """jdcolor.c ycc_rgb_convert on int32 samples -> [..., 3] int32."""
    cb, cr = cb - 128, cr - 128
    r = y + ((91881 * cr + 32768) >> 16)
    g = y + ((-22554 * cb + 32768 - 46802 * cr) >> 16)
    b = y + ((116130 * cb + 32768) >> 16)
    return torch.clamp(torch.stack([r, g, b], -1), 0, 255)


def color_plain(planes: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """Upsample and convert every frame: uint8 [n_pixels · 3]."""
    out = torch.empty(batch.n_pixels * 3, dtype=torch.uint8)
    plane = batch.plane.tolist()
    for f_i, (H, W, color, nc, p0) in enumerate(batch.frame.tolist()):
        chans = []
        for p_i in range(p0, p0 + nc):
            bw, bh, cw, ch, rh, rv, fancy, _ = plane[p_i]
            o = int(batch.plane_pix0[p_i])
            P = planes[o:o + bw * bh * 64].view(bh * 8, bw * 8)[:ch, :cw].to(torch.int32)
            chans.append(_upsample(P, rh, rv, fancy)[:H, :W])
        if color == COLOR_GRAY:
            rgb = chans[0][..., None].expand(H, W, 3)
        elif color == COLOR_YCC:
            rgb = ycc_to_rgb(*chans)
        else:
            rgb = torch.stack(chans, -1)
        o = int(batch.frame_pix0[f_i]) * 3
        out[o:o + H * W * 3] = rgb.reshape(-1).to(torch.uint8)
    return out


def check_status(status: torch.Tensor, batch: JpegBatch, progressive: bool = False) -> None:
    """Raise a ValueError naming the file for the first segment whose
    status word is not 0 (`batch` on the host: one copy of the words); the
    baseline segments' words, or with `progressive` the progressive ones'."""
    status = status.cpu()
    bad = torch.nonzero(status).flatten().tolist()
    if not bad:
        return
    s = bad[0]
    code = int(status[s])
    what = STATUS_TEXT.get(code, f"status {code}")
    if progressive:
        row = int(batch.pseg[s, 2])
        f_i = int(batch.pscan[row, 0])
        k = row - int((batch.pscan[:, 0] == f_i).nonzero()[0])
        first = min(i for i in range(len(batch.pseg)) if int(batch.pseg[i, 2]) == row)
        raise ValueError(f"{batch.frames[f_i].path}: SOS: corrupt entropy-coded data in "
                         f"scan {k}, segment {s - first}: {what}")
    f_i = int(batch.seg[s, 2])
    first = int((batch.seg[:, 2] == f_i).nonzero()[0])
    raise ValueError(f"{batch.frames[f_i].path}: SOS: corrupt entropy-coded data in "
                     f"segment {s - first}: {what}")


def decode_jpegs(paths: Sequence[str], device="cuda") -> List[torch.Tensor]:
    """Decode baseline and progressive JPEG files as one batch: a list of
    [H, W, 3] uint8 tensors on `device`, equal bit for bit to PIL's
    `Image.open(p).convert("RGB")`. On the card the stages run as the
    kernels of ops/jpeg.py: the baseline entropy decode, the progressive
    scans round after round into the same blocks, then the IDCT and the
    colour pass over every frame; the status words are read once.
    `device="cpu"` runs their plain versions. Raises RuntimeError when the
    card is asked for and there is none, ValueError (naming the file and the
    marker) on what the decoder does not take."""
    from ..ops import jpeg as kernels

    device = check_device(device)
    if not paths:
        return []
    host = pack([read_jpeg(p) for p in paths])
    batch = host.to(device)
    coef, status = kernels.jpeg_entropy(batch)
    pstatus = kernels.jpeg_progressive(coef, batch)
    rgb = kernels.jpeg_color(kernels.jpeg_idct(coef, batch), batch)
    check_status(status, host)
    check_status(pstatus, host, progressive=True)
    out = []
    for f_i, f in enumerate(host.frames):
        o = int(host.frame_pix0[f_i]) * 3
        out.append(rgb[o:o + f.H * f.W * 3].view(f.H, f.W, 3))
    return out
