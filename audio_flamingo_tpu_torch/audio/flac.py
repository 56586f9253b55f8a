"""Pure-Python FLAC decoder of the port: the decoder half of
``audio_flamingo_tpu/audio/flac_ref.py`` (the encoder stays in the JAX package).

It is the plain reference of the native decoder (audio/cpp/flac.cpp, bound in
audio/io.py): native-FLAC container, CONSTANT / VERBATIM / FIXED / LPC subframes, Rice
residual partitions, independent and left/right/mid-side stereo.
"""

from __future__ import annotations

import numpy as np

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


class _BitReader:
    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.bitpos = bitpos

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.bitpos >> 3
            off = 7 - (self.bitpos & 7)
            v = (v << 1) | ((self.data[byte] >> off) & 1)
            self.bitpos += 1
        return v

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        if v & (1 << (n - 1)):
            v -= 1 << n
        return v

    def unary(self) -> int:
        q = 0
        while True:
            byte = self.bitpos >> 3
            off = 7 - (self.bitpos & 7)
            self.bitpos += 1
            if (self.data[byte] >> off) & 1:
                return q
            q += 1

    def align(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7


def decode_flac_np(data: bytes) -> tuple[np.ndarray, int]:
    """Pure-Python native-FLAC decoder (mirror of audio/cpp/flac.cpp): mono float32 +
    sample rate. Channels averaged, samples scaled by 2^-(bps-1)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    br = _BitReader(data, 32)

    sr = channels = bps = 0
    total = 0
    last = False
    while not last:
        last = br.bits(1) == 1
        btype = br.bits(7)
        blen = br.bits(24)
        if btype == 0:
            br.bits(16); br.bits(16); br.bits(24); br.bits(24)
            sr = br.bits(20)
            channels = br.bits(3) + 1
            bps = br.bits(5) + 1
            total = br.bits(36)
            br.bitpos += (blen - 18) * 8  # 18 bytes of fields read; skip md5 etc.
        else:
            br.bitpos += blen * 8

    scale = 1.0 / (1 << (bps - 1))
    mono: list[float] = []

    def read_residual(blocksize, order):
        method = br.bits(2)
        pbits = 4 if method == 0 else 5
        escape = 15 if method == 0 else 31
        porder = br.bits(4)
        nparts = 1 << porder
        res = np.zeros(blocksize, np.int64)
        idx = order
        for p in range(nparts):
            count = blocksize // nparts - (order if p == 0 else 0)
            param = br.bits(pbits)
            if param == escape:
                raw = br.bits(5)
                for _ in range(count):
                    res[idx] = br.sbits(raw) if raw else 0
                    idx += 1
            else:
                for _ in range(count):
                    q = br.unary()
                    v = (q << param) | br.bits(param)
                    res[idx] = (v >> 1) ^ -(v & 1)
                    idx += 1
        return res

    def read_subframe(blocksize, sbps):
        if br.bits(1) != 0:
            raise ValueError("corrupt FLAC subframe header")
        stype = br.bits(6)
        wasted = 0
        if br.bits(1) == 1:
            wasted = 1 + br.unary()
        ebps = sbps - wasted
        if stype == 0:
            out = np.full(blocksize, br.sbits(ebps), np.int64)
        elif stype == 1:
            out = np.asarray([br.sbits(ebps) for _ in range(blocksize)], np.int64)
        elif 8 <= stype <= 12:
            order = stype - 8
            out = np.zeros(blocksize, np.int64)
            for i in range(order):
                out[i] = br.sbits(ebps)
            out += read_residual(blocksize, order)
            coefs = _FIXED_COEFS[order]
            for i in range(order, blocksize):
                out[i] += sum(c * out[i - 1 - j] for j, c in enumerate(coefs))
        elif stype >= 32:
            order = stype - 31
            out = np.zeros(blocksize, np.int64)
            for i in range(order):
                out[i] = br.sbits(ebps)
            precision = br.bits(4) + 1
            shift = br.sbits(5)
            coef = [br.sbits(precision) for _ in range(order)]
            out += read_residual(blocksize, order)
            for i in range(order, blocksize):
                out[i] += sum(c * out[i - 1 - j] for j, c in enumerate(coef)) >> shift
        else:
            raise ValueError(f"subframe type {stype}")
        return out << wasted if wasted else out

    while br.bitpos + 32 <= len(data) * 8 and (not total or len(mono) < total):
        if br.bits(14) != 0x3FFE:
            break
        br.bits(2)
        bs_code = br.bits(4)
        sr_code = br.bits(4)
        ch_code = br.bits(4)
        ss_code = br.bits(3)
        br.bits(1)
        b0 = br.bits(8)  # utf8 coded number
        extra = 0
        for mask, lead, e in ((0x80, 0x00, 0), (0xE0, 0xC0, 1), (0xF0, 0xE0, 2),
                              (0xF8, 0xF0, 3), (0xFC, 0xF8, 4), (0xFE, 0xFC, 5)):
            if (b0 & mask) == lead:
                extra = e
                break
        for _ in range(extra):
            br.bits(8)
        if bs_code == 1:
            bs = 192
        elif 2 <= bs_code <= 5:
            bs = 576 << (bs_code - 2)
        elif bs_code == 6:
            bs = br.bits(8) + 1
        elif bs_code == 7:
            bs = br.bits(16) + 1
        else:
            bs = 256 << (bs_code - 8)
        if sr_code == 12:
            br.bits(8)
        elif sr_code in (13, 14):
            br.bits(16)
        fbps = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[ss_code]
        br.bits(8)  # crc8

        if ch_code <= 7:
            nch, mode = ch_code + 1, 0
        else:
            nch, mode = 2, ch_code - 7   # 1 left/side, 2 right/side, 3 mid/side
        chans = []
        for c in range(nch):
            sbps = fbps
            if (mode == 1 and c == 1) or (mode == 2 and c == 0) or (mode == 3 and c == 1):
                sbps += 1
            chans.append(read_subframe(bs, sbps))
        br.align()
        br.bits(16)  # crc16

        if mode == 0:
            m = np.mean(np.stack(chans, 1), axis=1)
        elif mode == 1:
            left, side = chans
            m = 0.5 * (left + (left - side))
        elif mode == 2:
            side, right = chans
            m = 0.5 * ((right + side) + right)
        else:
            mid, side = chans
            l2 = ((mid << 1) | (side & 1)) + side
            r2 = ((mid << 1) | (side & 1)) - side
            m = 0.25 * (l2 + r2)
        mono.extend((m * scale).tolist())

    if total:
        mono = mono[:total]
    return np.asarray(mono, np.float32), sr
