"""Baseline JFIF (JPEG) entropy decoder: quantised DCT coefficients.

Counterpart of ``exsr/jpeg/jfif.py``, in numpy on the host.  It parses a
baseline sequential JPEG (SOI, DQT, SOF0/1, DHT, optional DRI, SOS) and
Huffman-decodes the quantised coefficient planes and their quantisation
tables, which :meth:`exsr_torch.apps.jpeg_session.JPEGEditSession.
open_coefficients` takes.

Only what cameras and PIL emit for baseline JPEGs is read: 8-bit
precision, Huffman coding, one interleaved scan over every component,
optional restart markers.  Progressive and arithmetic-coded files, a
non-interleaved scan, a DHT of more than 256 symbols and bad codes raise
:class:`UnsupportedJPEGError`.

The scan's bit-serial loop runs either in the port's own C++ copy
(:mod:`exsr_torch.native.jfif_native`, built with ``g++`` at first use) or
in the Python reader below; both give the same coefficients.
``decode_jfif(data, native=None)`` picks the C++ scan when it builds and
the Python reader otherwise; ``native=True`` raises when the C++ scan
cannot be built, ``native=False`` runs the Python reader.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from exsr_torch.native import jfif_native

# natural (row-major) position of each zigzag-ordered coefficient,
# ITU T.81 figure A.6 — ZIGZAG[k] = natural index of the k-th zigzag coeff
ZIGZAG = np.array([
    0,  1,  8, 16,  9,  2,  3, 10,
    17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
# natural position of each zigzag-ordered coefficient
UNZIGZAG = np.argsort(ZIGZAG)


class UnsupportedJPEGError(ValueError):
    pass


@dataclasses.dataclass
class ComponentPlane:
    """One color component's decoded data."""
    coeffs: np.ndarray       # [blocks_h, blocks_w, 64] int32, natural order
    q_table: np.ndarray      # [8, 8] uint16, natural order
    sampling: tuple[int, int]  # (h, v) sampling factors


class _BitReader:
    """MSB-first bit reader over the entropy-coded segment with 0xFF00
    byte unstuffing and RSTn awareness."""

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self.bits = 0
        self.nbits = 0

    def _fill(self):
        d = self.data
        while self.nbits <= 24:
            if self.pos >= len(d):
                self.bits = (self.bits << 8) & 0xFFFFFFFF
                self.nbits += 8
                continue
            b = d[self.pos]
            if b == 0xFF:
                nxt = d[self.pos + 1] if self.pos + 1 < len(d) else 0
                if nxt == 0x00:
                    self.pos += 2
                elif 0xD0 <= nxt <= 0xD7:  # RSTn handled by caller
                    self.bits = (self.bits << 8) & 0xFFFFFFFF
                    self.nbits += 8
                    continue
                else:  # EOI or next segment: pad with zeros
                    self.bits = (self.bits << 8) & 0xFFFFFFFF
                    self.nbits += 8
                    continue
            else:
                self.pos += 1
            self.bits = ((self.bits << 8) | b) & 0xFFFFFFFF
            self.nbits += 8

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self._fill()
        v = (self.bits >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        return v

    def align_restart(self):
        """Skip to just after the next RSTn marker."""
        self.bits = 0
        self.nbits = 0
        d = self.data
        while self.pos < len(d) - 1:
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1
        raise UnsupportedJPEGError('expected restart marker')


class _Huffman:
    """Canonical Huffman table (T.81 annex C) with incremental decode."""

    def __init__(self, counts, symbols):
        self.counts = counts       # raw table, for the native decoder
        self.maxcode = {}
        self.mincode = {}
        self.valptr = {}
        self.symbols = symbols
        code = 0
        k = 0
        for length in range(1, 17):
            n = counts[length - 1]
            if n:
                self.valptr[length] = k
                self.mincode[length] = code
                code += n
                k += n
                self.maxcode[length] = code - 1
            else:
                self.maxcode[length] = -1
            code <<= 1

    def decode(self, br: _BitReader) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | br.take(1)
            mx = self.maxcode.get(length, -1)
            if mx != -1 and code <= mx:
                return self.symbols[self.valptr[length]
                                    + code - self.mincode[length]]
        raise UnsupportedJPEGError('bad Huffman code')


def _extend(v: int, t: int) -> int:
    """DIFF/coefficient magnitude decoding (T.81 F.2.2.1)."""
    if t == 0:
        return 0
    return v if v >= (1 << (t - 1)) else v - (1 << t) + 1


def decode_jfif(data: bytes, native: bool | None = None) -> dict:
    """Decode a baseline JPEG byte string (``native``: see the module's
    docstring).

    Returns ``{'width', 'height', 'components': [ComponentPlane, ...]}``
    with components in file order (typically Y, Cb, Cr).
    """
    if data[:2] != b'\xff\xd8':
        raise UnsupportedJPEGError('not a JPEG (missing SOI)')
    pos = 2
    q_tables: dict[int, np.ndarray] = {}
    huff_dc: dict[int, _Huffman] = {}
    huff_ac: dict[int, _Huffman] = {}
    frame = None
    restart_interval = 0

    while pos < len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        marker = data[pos + 1]
        pos += 2
        if marker == 0xFF:  # T.81 B.1.1.2: optional fill bytes
            pos -= 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            continue
        if marker == 0xD9:  # EOI
            break
        seg_len = int.from_bytes(data[pos:pos + 2], 'big')
        seg = data[pos + 2:pos + seg_len]
        if marker == 0xDB:  # DQT
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 0xF
                p += 1
                if pq != 0:
                    raise UnsupportedJPEGError('16-bit Q tables')
                flat = np.frombuffer(seg[p:p + 64], np.uint8)
                tbl = np.zeros(64, np.uint16)
                tbl[ZIGZAG] = flat  # file stores zigzag order
                q_tables[tq] = tbl.reshape(8, 8)
                p += 64
        elif marker in (0xC0, 0xC1):  # SOF0/1 baseline
            prec = seg[0]
            if prec != 8:
                raise UnsupportedJPEGError(f'{prec}-bit precision')
            h = int.from_bytes(seg[1:3], 'big')
            w = int.from_bytes(seg[3:5], 'big')
            ncomp = seg[5]
            if not 1 <= ncomp <= 4:
                # T.81 limits interleaved scans to Ns <= 4, and this
                # decoder requires one interleaved scan over every frame
                # component; the bound also keeps a crafted component
                # count from indexing past the native decoder's
                # fixed-size per-component tables
                raise UnsupportedJPEGError(f'{ncomp} components')
            comps = []
            for c in range(ncomp):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                comps.append({'id': cid, 'h': hv >> 4, 'v': hv & 0xF,
                              'tq': tq})
            frame = {'w': w, 'h': h, 'comps': comps}
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA,
                        0xCB, 0xCD, 0xCE, 0xCF):
            raise UnsupportedJPEGError(
                f'non-baseline SOF marker 0xFF{marker:02X} '
                '(progressive/arithmetic)')
        elif marker == 0xC4:  # DHT
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 0xF
                counts = list(seg[p + 1:p + 17])
                n = sum(counts)
                if n > 256:
                    # T.81 B.2.4.2: at most 256 symbols per table — a
                    # crafted count vector would otherwise index past the
                    # decoders' fixed 256-entry symbol buffers
                    raise UnsupportedJPEGError(
                        f'DHT declares {n} symbols (> 256)')
                symbols = list(seg[p + 17:p + 17 + n])
                table = _Huffman(counts, symbols)
                (huff_dc if tc == 0 else huff_ac)[th] = table
                p += 17 + n
        elif marker == 0xDD:  # DRI
            restart_interval = int.from_bytes(seg[0:2], 'big')
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise UnsupportedJPEGError('SOS before SOF')
            ns = seg[0]
            if ns != len(frame['comps']):
                # this decoder implements only a single interleaved scan
                # covering every frame component (T.81 baseline subset);
                # a non-interleaved multi-scan file would otherwise be
                # silently decoded with interleaved-MCU geometry
                raise UnsupportedJPEGError(
                    f'non-interleaved scan ({ns} of '
                    f"{len(frame['comps'])} components)")
            scan = []
            for c in range(ns):
                cs, tdta = seg[1 + 2 * c:3 + 2 * c]
                comp = next(cc for cc in frame['comps'] if cc['id'] == cs)
                scan.append({'comp': comp, 'dc': tdta >> 4,
                             'ac': tdta & 0xF})
            return _decode_scan(data, pos + seg_len, frame, scan,
                                q_tables, huff_dc, huff_ac,
                                restart_interval, native)
        pos += seg_len
    raise UnsupportedJPEGError('no scan found')


def _decode_scan(data, pos, frame, scan, q_tables, huff_dc, huff_ac,
                 restart_interval, native=None):
    hmax = max(c['h'] for c in frame['comps'])
    vmax = max(c['v'] for c in frame['comps'])
    mcus_x = -(-frame['w'] // (8 * hmax))
    mcus_y = -(-frame['h'] // (8 * vmax))

    planes = []
    for s in scan:
        c = s['comp']
        bw, bh = mcus_x * c['h'], mcus_y * c['v']
        planes.append(np.zeros((bh, bw, 64), np.int32))

    def assemble():
        comps = []
        for ci, s in enumerate(scan):
            c = s['comp']
            comps.append(ComponentPlane(
                coeffs=planes[ci],
                q_table=q_tables[c['tq']],
                sampling=(c['h'], c['v'])))
        return {'width': frame['w'], 'height': frame['h'],
                'components': comps}

    if native is None:
        native = jfif_native.available()
    if native:
        # the same algorithm as the Python loop below, byte for byte
        rc = jfif_native.decode_scan(
            data, pos,
            [s['comp']['h'] for s in scan],
            [s['comp']['v'] for s in scan],
            [(huff_dc[s['dc']].counts, huff_dc[s['dc']].symbols)
             for s in scan],
            [(huff_ac[s['ac']].counts, huff_ac[s['ac']].symbols)
             for s in scan],
            mcus_x, mcus_y, restart_interval, planes)
        if rc == 0:
            return assemble()
        raise UnsupportedJPEGError(
            {1: 'bad Huffman code', 2: 'AC overrun',
             3: 'expected restart marker'}.get(
                rc, f'native decode error {rc}'))

    br = _BitReader(data, pos)
    preds = [0] * len(scan)
    mcu_index = 0
    for my in range(mcus_y):
        for mx in range(mcus_x):
            if restart_interval and mcu_index and \
                    mcu_index % restart_interval == 0:
                br.align_restart()
                preds = [0] * len(scan)
            mcu_index += 1
            for ci, s in enumerate(scan):
                c = s['comp']
                dc_t, ac_t = huff_dc[s['dc']], huff_ac[s['ac']]
                for by in range(c['v']):
                    for bx in range(c['h']):
                        blk = np.zeros(64, np.int32)
                        t = dc_t.decode(br)
                        if t > 16:  # DC category bound (T.81 F.1.2.1.2)
                            raise UnsupportedJPEGError('bad Huffman code')
                        preds[ci] += _extend(br.take(t), t)
                        blk[0] = preds[ci]
                        k = 1
                        while k < 64:
                            rs = ac_t.decode(br)
                            r, sz = rs >> 4, rs & 0xF
                            if sz == 0:
                                if r == 15:  # ZRL
                                    k += 16
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                raise UnsupportedJPEGError('AC overrun')
                            blk[k] = _extend(br.take(sz), sz)
                            k += 1
                        row = my * c['v'] + by
                        col = mx * c['h'] + bx
                        # zigzag -> natural row-major order
                        planes[ci][row, col][ZIGZAG] = blk

    return assemble()


def load_jpeg_coefficients(path: str, native: bool | None = None) -> dict:
    """File-path convenience wrapper around :func:`decode_jfif`."""
    with open(path, 'rb') as f:
        return decode_jfif(f.read(), native)
