"""JPEG decoding with the standard library and NumPy only.

Counterpart of the reference glTF loader's JPEG decode
(``scene/gltf.py::GltfDocument.read_image``), which opens the image with
PIL and converts it to RGBA. The port does not depend on PIL, so this
module decodes JPEG bytes to exactly what
``PIL.Image.open(...).convert("RGBA")`` gives: libjpeg-turbo's default
decompression (integer "islow" IDCT, fancy upsampling, RGB out).

- Markers: SOF0 and SOF1 (baseline and extended Huffman, 8-bit) and SOF2
  (progressive), DHT, DQT with 8- and 16-bit tables, DRI with RST0-7
  (each restart resets the DC predictors and the EOB run and realigns to
  a byte), APPn and COM skipped, ``FF 00`` stuffing and ``FF`` fill bytes.
- Entropy decoding, one Huffman symbol at a time in Python over the
  16-bit window at every bit position of the unstuffed scan; where a code
  and its value bits fit in the window, one lookup reads both. Sequential
  scans, and the progressive DC first / refine and AC first / refine
  scans with EOB runs. Every scan is absorbed before any output, as in
  libjpeg's non-buffered mode; its block smoothing then finds the first
  ten coefficients complete and does nothing. A progressive file that
  leaves one of them incomplete is refused.
- Everything after the entropy decode runs in NumPy over all blocks at
  once: dequantisation with each component's table as latched at its
  first scan; jidctint.c's ``jpeg_idct_islow`` (CONST_BITS 13, PASS1_BITS
  2) in int64 with both passes' rounding, saturated to [0, 255] as the
  SIMD form that PIL's libjpeg-turbo runs saturates (a file whose
  coefficients leave the range where that form is exact is refused);
  jdsample.c's upsampling (fancy h2v1 and h2v2 when the
  downsampled width exceeds 2, fancy h1v2, integer replication
  otherwise; the context rows beyond the plane repeat its first and last
  real rows); jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16).
- The colour space is guessed as jdapimin.c's
  ``default_decompress_parms`` does. One component is greyscale (PIL's
  L -> RGBA replicates it, alpha 255). Three components are YCbCr after
  a JFIF marker; else as an Adobe APP14 marker's transform says (0 is
  RGB); else RGB only for the component ids 'R', 'G', 'B'.

Arithmetic coding, lossless, hierarchical, sample precisions other than 8
bits and 4-component (CMYK / YCCK) files raise NotImplementedError naming
the form; malformed data raises ValueError. Nothing decodes approximately.
"""

from __future__ import annotations

import functools
import struct

import numpy as np

# zigzag position -> natural (row-major 8x8) position (jpeg_natural_order)
_NATURAL = (
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
)
# libjpeg's block smoothing reads the first SAVED_COEFS coefficients
_SAVED_COEFS = 10
_REFUSED = {
    0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
    0xDE: "hierarchical", 0xDF: "hierarchical", 0xC9: "arithmetic-coded",
    0xCA: "arithmetic-coded", 0xCB: "arithmetic-coded", 0xCC: "arithmetic-coded",
    0xCD: "arithmetic-coded", 0xCE: "arithmetic-coded", 0xCF: "arithmetic-coded",
}
# jidctint.c's FIX(x) at CONST_BITS 13
_F0_298, _F0_390, _F0_541, _F0_765 = 2446, 3196, 4433, 6270
_F0_899, _F1_175, _F1_501, _F1_847 = 7373, 9633, 12299, 15137
_F1_961, _F2_053, _F2_562, _F3_072 = 16069, 16819, 20995, 25172


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.td = self.ta = 0  # DC / AC Huffman table of the current scan
        self.quant = None  # [64] natural order, latched at the component's first scan
        self.coef = []  # flat [blocks_y * blocks_x * 64], natural order
        self.bits = [-1] * 64  # per coefficient, the Al of its last scan (coef_bits)


@functools.lru_cache(maxsize=16)  # files share the standard tables; read-only
def _huffman_lookup(counts: bytes, symbols: bytes, ac: bool) -> list:
    """[65536] per 16-bit window, the tuple the decoder unpacks for the
    code the window starts with: (bits to advance, run, value, slow).
    Where a code with ``s`` value bits fits in the window with them,
    value is the extended coefficient (never 0) and advance covers both;
    where it does not, value is 0, advance covers the code and slow is s.
    A code with no value bits (DC 0, EOB, ZRL, an EOB run) gives value 0
    and slow 0; a window that starts no code gives None."""
    length = np.zeros(65536, np.int64)
    sym = np.zeros(65536, np.int64)
    code = k = 0
    for ln in range(1, 17):  # canonical codes (JPEG Annex C)
        for _ in range(counts[ln - 1]):
            span = slice(code << (16 - ln), (code + 1) << (16 - ln))
            length[span], sym[span] = ln, symbols[k]
            k += 1
            code += 1
        if code > (1 << ln):
            raise ValueError("bad Huffman table")
        code <<= 1
    s = sym & 15 if ac else sym
    run = sym >> 4 if ac else np.zeros_like(sym)
    total = length + s
    fits = (total <= 16) & (s > 0)
    bits = (np.arange(65536) >> np.clip(16 - total, 0, 16)) & ((1 << s) - 1)
    value = np.where(bits < (1 << np.maximum(s - 1, 0)), bits - (1 << s) + 1, bits)
    adv, slow = np.where(fits, total, length), np.where(fits, 0, s)
    value = np.where(fits, value, 0)
    # one tuple per distinct entry, shared by every window that gives it
    uniq, inverse = np.unique(adv | run << 5 | slow << 10 | (value + 65536) << 15,
                              return_inverse=True)
    entries = [(k & 31, k >> 5 & 31, (k >> 15) - 65536, k >> 10 & 31) if k & 31 else None
               for k in uniq.tolist()]  # advance 0: no code
    return list(map(entries.__getitem__, inverse.tolist()))


def _entropy_data(data: bytes, pos: int, name: str):
    """The entropy-coded segment from ``pos`` -> (its unstuffed bytes, the
    byte offset where each restart interval starts, the position of the
    marker that ends it)."""
    parts, starts, size = [], [0], 0
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        m = j + 1
        while 0 < m < n and data[m] == 0xFF:  # fill bytes
            m += 1
        if j < 0 or m >= n:
            raise ValueError(f"{name}: entropy-coded data runs past the end of the file")
        parts.append(data[pos:j])
        size += j - pos
        pos = m + 1
        if data[m] == 0x00:  # a stuffed FF
            parts.append(b"\xff")
            size += 1
        elif 0xD0 <= data[m] <= 0xD7:  # RSTn
            starts.append(size)
        else:
            return b"".join(parts), starts, j


def _windows(buf: bytes) -> list:
    """The 24 bits from every byte of ``buf``, with zeros past its end
    (libjpeg reads zeros at a marker): the 16-bit window at bit p is
    ``w[p >> 3] >> (8 - (p & 7)) & 0xFFFF``, and its first n bits
    ``w[p >> 3] >> (24 - n - (p & 7)) & ((1 << n) - 1)``."""
    b = np.frombuffer(buf + bytes(4), np.uint8).astype(np.int64)
    return ((b[:-2] << 16) | (b[1:-1] << 8) | b[2:]).tolist()


def _block_order(comps: list, width: int, height: int, hmax: int, vmax: int,
                 mcux: int, mcuy: int):
    """The scan's blocks in decode order as (component's place in the
    scan, flat coefficient offset), and the blocks per MCU. One component
    is scanned over its own blocks only; several go MCU by MCU."""
    order = []
    if len(comps) == 1:
        c = comps[0]
        cols = _cdiv(_cdiv(width * c.h, hmax), 8)
        rows = _cdiv(_cdiv(height * c.v, vmax), 8)
        for by in range(rows):
            order.extend((0, (by * mcux * c.h + bx) * 64) for bx in range(cols))
        return order, 1
    for my in range(mcuy):
        for mx in range(mcux):
            for n, c in enumerate(comps):
                for i in range(c.v):
                    row = (my * c.v + i) * mcux * c.h + mx * c.h
                    order.extend((n, (row + j) * 64) for j in range(c.h))
    return order, sum(c.h * c.v for c in comps)


def _decode_scan(comps: list, kind: str, ss: int, se: int, al: int, w: list,
                 starts: list, per_interval: int, order: list, dc: list, ac: list) -> None:
    """Huffman-decode one scan's blocks into its components'
    coefficients. ``kind`` is "seq", "dc_first", "dc_refine", "ac_first"
    or "ac_refine" (jdhuff.c decode_mcu, jdphuff.c decode_mcu_*)."""
    nat = _NATURAL
    coefs = [c.coef for c in comps]
    pred = [0] * len(comps)
    eobrun = p = interval = 0
    p1, m1 = 1 << al, -1 << al
    for idx, (n, base) in enumerate(order):
        if per_interval and idx and idx % per_interval == 0:
            interval += 1
            p = starts[interval] * 8
            pred = [0] * len(comps)
            eobrun = 0
        coef = coefs[n]
        if kind in ("seq", "dc_first"):
            adv, _, v, slow = dc[n][w[p >> 3] >> (8 - (p & 7)) & 0xFFFF]
            p += adv
            if slow:
                v = w[p >> 3] >> (24 - slow - (p & 7)) & ((1 << slow) - 1)
                p += slow
                if v < 1 << (slow - 1):
                    v -= (1 << slow) - 1
            pred[n] += v
            coef[base] = pred[n] << al
            if kind == "dc_first":
                continue
            tab, k = ac[n], 1
            while k < 64:
                adv, r, v, slow = tab[w[p >> 3] >> (8 - (p & 7)) & 0xFFFF]
                p += adv
                if v:
                    k += r
                    coef[base + nat[k]] = v
                elif slow:
                    k += r
                    v = w[p >> 3] >> (24 - slow - (p & 7)) & ((1 << slow) - 1)
                    p += slow
                    if v < 1 << (slow - 1):
                        v -= (1 << slow) - 1
                    coef[base + nat[k]] = v
                elif r == 15:  # ZRL
                    k += 15
                else:  # EOB
                    break
                k += 1
        elif kind == "dc_refine":
            if w[p >> 3] >> (23 - (p & 7)) & 1:
                coef[base] |= p1
            p += 1
        elif kind == "ac_first":
            if eobrun:
                eobrun -= 1
                continue
            tab, k = ac[n], ss
            while k <= se:
                adv, r, v, slow = tab[w[p >> 3] >> (8 - (p & 7)) & 0xFFFF]
                p += adv
                if slow:
                    v = w[p >> 3] >> (24 - slow - (p & 7)) & ((1 << slow) - 1)
                    p += slow
                    if v < 1 << (slow - 1):
                        v -= (1 << slow) - 1
                if v:
                    k += r
                    coef[base + nat[k]] = v * p1
                elif r == 15:  # ZRL
                    k += 15
                else:  # EOBr: this block and 2^r + (r bits) - 1 more
                    eobrun = 1 << r
                    if r:
                        eobrun += w[p >> 3] >> (24 - r - (p & 7)) & ((1 << r) - 1)
                        p += r
                    eobrun -= 1
                    break
                k += 1
        else:  # ac_refine
            k = ss
            if not eobrun:
                tab = ac[n]
                while k <= se:
                    adv, r, v, slow = tab[w[p >> 3] >> (8 - (p & 7)) & 0xFFFF]
                    p += adv
                    if slow == 1:  # the sign bit past the window
                        v = 1 if w[p >> 3] >> (23 - (p & 7)) & 1 else -1
                        p += 1
                    if slow > 1 or v not in (0, 1, -1):
                        raise ValueError("a refinement coefficient of size above 1")
                    if not v and r != 15:  # EOBr
                        eobrun = 1 << r
                        if r:
                            eobrun += w[p >> 3] >> (24 - r - (p & 7)) & ((1 << r) - 1)
                            p += r
                        break
                    # correction bits for the nonzero coefficients passed
                    # over, up to the r-th zero one (the new coefficient's
                    # place, or the 16th after a ZRL)
                    while k <= se:
                        pos = base + nat[k]
                        c = coef[pos]
                        if c:
                            if w[p >> 3] >> (23 - (p & 7)) & 1 and not c & p1:
                                coef[pos] = c + p1 if c >= 0 else c + m1
                            p += 1
                        else:
                            r -= 1
                            if r < 0:
                                break
                        k += 1
                    if v:
                        coef[base + nat[k]] = p1 if v > 0 else m1
                    k += 1
            if eobrun:  # the rest of the band: correction bits only
                while k <= se:
                    pos = base + nat[k]
                    c = coef[pos]
                    if c:
                        if w[p >> 3] >> (23 - (p & 7)) & 1 and not c & p1:
                            coef[pos] = c + p1 if c >= 0 else c + m1
                        p += 1
                    k += 1
                eobrun -= 1


def _idct_1d(x: list) -> list:
    """One pass of jpeg_idct_islow over its 8 inputs (arrays) -> the 8
    outputs before descaling."""
    z1 = (x[2] + x[6]) * _F0_541
    tmp2 = z1 - x[6] * _F1_847
    tmp3 = z1 + x[2] * _F0_765
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1_175
    z1 = z1 * -_F0_899
    z2 = z2 * -_F2_562
    z3 = z3 * -_F1_961 + z5
    z4 = z4 * -_F0_390 + z5
    t0 = t0 * _F0_298 + z1 + z3
    t1 = t1 * _F2_053 + z2 + z4
    t2 = t2 * _F3_072 + z2 + z3
    t3 = t3 * _F1_501 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


# Within these magnitudes of the dequantised coefficients and of pass 1's
# output, the 16-bit lanes of libjpeg-turbo's SIMD islow (two-term 16-bit
# sums into pmaddwd, 32-bit sums of three such products) compute jidctint.c's
# arithmetic exactly. No encoder's output comes near them (a full-contrast
# checker at quality 1 reaches 765 and 4,260).
_IDCT_EXACT = 1 << 13


def _idct_islow(blocks: np.ndarray, name: str) -> np.ndarray:
    """[N, 64] dequantised coefficients (natural order, int64) -> [N, 8,
    8] uint8 samples, as jpeg_idct_islow computes them in the SIMD form
    PIL's libjpeg-turbo runs: the result saturated to [0, 255] (the C
    form's range_limit table wraps values beyond +-512 instead; no valid
    file reaches them). NotImplementedError past ``_IDCT_EXACT``."""
    def exact(a, where):
        if a.size and int(np.abs(a).max()) >= _IDCT_EXACT:
            raise NotImplementedError(
                f"{name}: JPEG whose {where} reach {int(np.abs(a).max())}, past what "
                f"libjpeg-turbo's 16-bit SIMD IDCT computes exactly ({_IDCT_EXACT})")

    exact(blocks, "dequantised coefficients")
    b = blocks.reshape(-1, 8, 8)
    # pass 1 down each column, DESCALE by CONST_BITS - PASS1_BITS
    ws = np.stack([(o + (1 << 10)) >> 11 for o in _idct_1d([b[:, k] for k in range(8)])], 1)
    exact(ws, "IDCT columns")
    # pass 2 along each row, DESCALE by CONST_BITS + PASS1_BITS + 3
    out = np.stack([(o + (1 << 17)) >> 18 for o in _idct_1d([ws[:, :, k] for k in range(8)])], 2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample(x: np.ndarray, hx: int, vx: int) -> np.ndarray:
    """jdsample.c's upsampling of a component's real [dh, dw] plane (int64)
    by (hx, vx)."""
    if (hx, vx) == (1, 1):
        return x
    dh, dw = x.shape
    # the context rows: the first and last real rows repeated
    up = np.concatenate([x[:1], x[:-1]])
    down = np.concatenate([x[1:], x[-1:]])
    if (hx, vx) == (1, 2):  # h1v2_fancy_upsample
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out
    if hx == 2 and vx in (1, 2) and dw > 2:  # h2v1 / h2v2_fancy_upsample
        sums = [(x, 2, 1, 2)] if vx == 1 else [(3 * x + up, 4, 8, 7), (3 * x + down, 4, 8, 7)]
        out = np.empty((vx * dh, 2 * dw), np.int64)
        for i, (cs, shift, b_left, b_right) in enumerate(sums):
            left = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            right = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[i::vx, 0::2] = (3 * cs + left + b_left) >> shift
            out[i::vx, 1::2] = (3 * cs + right + b_right) >> shift
        return out
    return np.repeat(np.repeat(x, vx, axis=0), hx, axis=1)  # int_upsample


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert (SCALEBITS 16) -> [H, W, 3] int64."""
    half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (int(1.40200 * 65536 + 0.5) * x + half) >> 16
    cb_b = (int(1.77200 * 65536 + 0.5) * x + half) >> 16
    cr_g = -int(0.71414 * 65536 + 0.5) * x
    cb_g = -int(0.34414 * 65536 + 0.5) * x + half
    rgb = [y + cr_r[cr], y + ((cb_g[cb] + cr_g[cr]) >> 16), y + cb_b[cb]]
    return np.clip(np.stack(rgb, axis=-1), 0, 255)


def _next_marker(data: bytes, pos: int, name: str):
    """The marker segment at or after ``pos`` (bytes before it skipped,
    as libjpeg's next_marker does) -> (code, body, position after it).
    Markers without a length are passed over; EOI gives an empty body."""
    n = len(data)
    while True:
        j = data.find(b"\xff", pos)
        while 0 <= j < n - 1 and data[j + 1] == 0xFF:  # fill bytes
            j += 1
        if j < 0 or j + 1 >= n:
            raise ValueError(f"{name}: JPEG ends before its EOI marker")
        code, pos = data[j + 1], j + 2
        if code == 0xD9:
            return code, b"", pos
        if code in (0x00, 0x01) or 0xD0 <= code <= 0xD8:
            continue  # stuffing, TEM, RSTn or SOI out of place
        if pos + 2 > n:
            raise ValueError(f"{name}: truncated JPEG marker segment")
        (length,) = struct.unpack(">H", data[pos : pos + 2])
        body = data[pos + 2 : pos + length]
        if length < 2 or len(body) != length - 2:
            raise ValueError(f"{name}: truncated JPEG marker segment")
        return code, body, pos + length


def _read_frame(body: bytes, progressive: bool, name: str) -> dict:
    if len(body) < 6 or len(body) < 6 + 3 * body[5]:
        raise ValueError(f"{name}: truncated JPEG frame header")
    precision, height, width, nc = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise NotImplementedError(f"{name}: {precision}-bit JPEG (only 8-bit samples decode)")
    if nc == 4:
        raise NotImplementedError(f"{name}: 4-component (CMYK / YCCK) JPEG")
    if nc not in (1, 3):
        raise NotImplementedError(f"{name}: {nc}-component JPEG")
    if height == 0 or width == 0:
        raise NotImplementedError(f"{name}: JPEG whose height a DNL marker sets")
    comps = []
    for k in range(nc):
        cid, hv, tq = body[6 + 3 * k : 9 + 3 * k]
        if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
            raise ValueError(f"{name}: bad JPEG sampling factors {hv >> 4}x{hv & 15}")
        comps.append(_Component(cid, hv >> 4, hv & 15, tq))
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    if any(hmax % c.h or vmax % c.v for c in comps):
        raise NotImplementedError(f"{name}: JPEG with fractional sampling factors")
    mcux, mcuy = _cdiv(width, 8 * hmax), _cdiv(height, 8 * vmax)
    for c in comps:
        c.coef = [0] * (mcux * c.h * mcuy * c.v * 64)
    return dict(width=width, height=height, progressive=progressive, comps=comps,
                hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy)


def _scan(data: bytes, pos: int, body: bytes, f: dict, quant: dict, tables: dict,
          restart: int, name: str) -> int:
    """Decode the scan whose SOS header is ``body`` and whose data starts
    at ``pos`` -> the position of the marker after it."""
    ns = body[0]
    comps = []
    for k in range(ns):
        cid, t = body[1 + 2 * k : 3 + 2 * k]
        match = [c for c in f["comps"] if c.id == cid]
        if not match:
            raise ValueError(f"{name}: scan names an unknown component {cid}")
        c = match[0]
        c.td, c.ta = t >> 4, t & 15
        if c.quant is None:  # latch_quant_tables
            if c.tq not in quant:
                raise ValueError(f"{name}: missing quantisation table {c.tq}")
            c.quant = quant[c.tq].copy()
        comps.append(c)
    ss, se, a = body[1 + 2 * ns : 4 + 2 * ns]
    ah, al = a >> 4, a & 15
    if not f["progressive"]:
        kind, ss, se, al = "seq", 0, 63, 0
    elif se > 63 or ss > se or (ss == 0) != (se == 0) or (ss and ns != 1) or al > 13:
        raise ValueError(f"{name}: bad progressive scan parameters")
    else:
        kind = ("ac_" if ss else "dc_") + ("refine" if ah else "first")
    for c in comps:
        c.bits[ss : se + 1] = [al] * (se + 1 - ss)
    need_dc = kind in ("seq", "dc_first")
    need_ac = kind in ("seq", "ac_first", "ac_refine")
    for key in [("dc", c.td) for c in comps if need_dc] + [("ac", c.ta) for c in comps if need_ac]:
        if key not in tables:
            raise ValueError(f"{name}: missing Huffman table {key}")
    buf, starts, end = _entropy_data(data, pos, name)
    order, per_mcu = _block_order(comps, f["width"], f["height"], f["hmax"], f["vmax"],
                                  f["mcux"], f["mcuy"])
    try:
        _decode_scan(comps, kind, ss, se, al, _windows(buf), starts, restart * per_mcu,
                     order, [tables.get(("dc", c.td)) for c in comps],
                     [tables.get(("ac", c.ta)) for c in comps])
    except (TypeError, IndexError, ValueError) as e:  # no code / past the data
        raise ValueError(f"{name}: corrupt entropy-coded data ({e})") from e
    return end


def decode_jpeg(data: bytes, name: str = "JPEG") -> np.ndarray:
    """JPEG bytes -> [H, W, 4] uint8, as PIL's convert("RGBA") gives it."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    quant, tables, f = {}, {}, None
    restart, jfif, adobe = 0, False, None
    pos = 2
    while True:
        code, body, pos = _next_marker(data, pos, name)
        if code == 0xD9:  # EOI
            break
        if code == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                raw = body[i + 1 : i + 65 + 64 * pq]
                if pq > 1 or tq > 3 or len(raw) != 64 + 64 * pq:
                    raise ValueError(f"{name}: bad DQT segment")
                table = np.zeros(64, np.int64)
                table[list(_NATURAL)] = struct.unpack(">64H" if pq else "64B", raw)
                quant[tq] = table
                i += 65 + 64 * pq
        elif code == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = body[i + 1 : i + 17]
                symbols = body[i + 17 : i + 17 + sum(counts)]
                if tc > 1 or th > 3 or len(counts) != 16 or len(symbols) != sum(counts):
                    raise ValueError(f"{name}: bad DHT segment")
                try:
                    tables[("ac" if tc else "dc", th)] = _huffman_lookup(counts, symbols, tc == 1)
                except ValueError as e:
                    raise ValueError(f"{name}: {e}") from e
                i += 17 + len(symbols)
        elif code == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif code == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif code == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif code in (0xC0, 0xC1, 0xC2):
            if f is not None:
                raise ValueError(f"{name}: more than one SOF marker")
            f = _read_frame(body, code == 0xC2, name)
        elif code in _REFUSED:
            raise NotImplementedError(f"{name}: {_REFUSED[code]} JPEG (marker FF{code:02X}): "
                                      "not decoded")
        elif code == 0xDA:  # SOS
            if f is None:
                raise ValueError(f"{name}: SOS before SOF")
            pos = _scan(data, pos, body, f, quant, tables, restart, name)
        # APPn, COM and the rest: skipped
    if f is None:
        raise ValueError(f"{name}: JPEG without a frame")
    comps, width, height = f["comps"], f["width"], f["height"]
    if f["progressive"]:
        for k, c in enumerate(comps):
            if any(b != 0 for b in c.bits[:_SAVED_COEFS]):
                raise NotImplementedError(
                    f"{name}: progressive JPEG whose scans leave component {k}'s first "
                    f"{_SAVED_COEFS} coefficients incomplete (libjpeg smooths those blocks)")
    planes = []
    for c in comps:
        by, bx = f["mcuy"] * c.v, f["mcux"] * c.h
        q = c.quant if c.quant is not None else np.zeros(64, np.int64)
        pix = _idct_islow(np.array(c.coef, np.int64).reshape(-1, 64) * q, name)
        pix = pix.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
        real = pix[: _cdiv(height * c.v, f["vmax"]), : _cdiv(width * c.h, f["hmax"])]
        planes.append(_upsample(real.astype(np.int64), f["hmax"] // c.h,
                                f["vmax"] // c.v)[:height, :width])
    if len(comps) == 1:
        rgb = np.stack(planes * 3, axis=-1)
    else:
        if jfif:
            is_rgb = False
        elif adobe is not None:
            is_rgb = adobe == 0
        else:
            is_rgb = tuple(c.id for c in comps) == (82, 71, 66)  # 'R', 'G', 'B'
        rgb = np.stack(planes, axis=-1) if is_rgb else _ycc_to_rgb(*planes)
    alpha = np.full((height, width, 1), 255, np.int64)
    return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
