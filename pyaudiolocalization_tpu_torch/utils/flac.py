"""Self-contained FLAC decode/encode (no soundfile in this environment).

Closes the non-WAV ingestion gap vs the reference's ``sf.read``-based
``read_audio_files`` (reference: utils.py:459-482): FLAC is the realistic
multichannel capture format.  Implemented from the public format spec
(https://xiph.org/flac/format.html) — no code taken from libFLAC.

Decoder: STREAMINFO parsing, frame sync + header (UTF-8-coded numbers,
CRC-8 verified), subframe types CONSTANT / VERBATIM / FIXED(0-4) / LPC,
wasted bits, Rice / Rice2 partitioned residuals (incl. escape codes), and
the left/side, right/side, mid/side stereo decorrelation modes.

Encoder (for fixtures and round-trips): independent channels, FIXED
predictors (best of order 0-2 per subframe) with single-partition Rice
residuals, or verbatim; correct CRC-8/CRC-16 so external decoders accept
the output.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

__all__ = ["read_flac", "write_flac"]


# ---------------------------------------------------------------------------
# CRCs (FLAC frame integrity): CRC-8 poly 0x07, CRC-16 poly 0x8005, init 0.
# ---------------------------------------------------------------------------

def _crc_table(poly: int, width: int) -> np.ndarray:
    table = np.zeros(256, np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
            crc &= mask
        table[i] = crc
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def _crc16_bytewise(data: bytes, crc: int = 0) -> int:
    for b in data:
        crc = int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return crc


def _crc16_slice_tables() -> List[np.ndarray]:
    """T[k][v] = CRC-16 of byte v followed by k zero bytes — the slicing-
    by-8 decomposition (CRC is GF(2)-linear, so the CRC of a chunk is the
    XOR of each byte's contribution shifted by its distance from the
    end)."""
    tables = [_CRC16_TABLE.astype(np.uint16)]
    for _ in range(7):
        prev = tables[-1]
        nxt = (_CRC16_TABLE[(prev >> 8) & 0xFF].astype(np.uint16)
               ^ ((prev << 8) & 0xFFFF).astype(np.uint16))
        tables.append(nxt)
    return tables


_CRC16_SLICE = _crc16_slice_tables()


_CRC16_SLICE_L = [t.tolist() for t in _CRC16_SLICE]


def _crc16(data: bytes, crc: int = 0) -> int:
    """Slicing-by-8 CRC-16 (poly 0x8005, init 0): ~8x the bytewise loop —
    frame CRCs walk every byte of the file and dominated decode time.
    Plain-int list lookups, not numpy scalar indexing (the latter costs
    ~100 ns per element access and would erase the slicing win)."""
    n8 = len(data) >> 3
    if n8 >= 4:
        t0, t1, t2, t3, t4, t5, t6, t7 = _CRC16_SLICE_L
        m = memoryview(data)
        for i in range(0, n8 * 8, 8):
            b = m[i:i + 8]
            crc = (t7[b[0] ^ (crc >> 8)] ^ t6[b[1] ^ (crc & 0xFF)]
                   ^ t5[b[2]] ^ t4[b[3]] ^ t3[b[4]]
                   ^ t2[b[5]] ^ t1[b[6]] ^ t0[b[7]])
        data = data[n8 * 8:]
    return _crc16_bytewise(data, crc)


# ---------------------------------------------------------------------------
# Bit I/O
# ---------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over a bytes object, tracking byte position so
    frame CRC-16 can be computed over the consumed span."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos          # byte position of the next unread byte
        self.acc = 0
        self.nbits = 0

    def read(self, n: int) -> int:
        while self.nbits < n:
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8
        self.nbits -= n
        val = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return val

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        count = 0
        while self.read(1) == 0:
            count += 1
        return count

    def align(self) -> None:
        self.nbits = 0
        self.acc = 0

    def bit_position(self) -> int:
        """Absolute bit offset of the next unread bit (for the vectorized
        bulk decoders, which bypass the per-bit accumulator)."""
        return self.pos * 8 - self.nbits

    def seek_bit(self, bitpos: int) -> None:
        self.pos = bitpos >> 3
        self.acc = 0
        self.nbits = 0
        rem = bitpos & 7
        if rem:
            self.read(rem)          # discard the already-consumed MSBs

    def read_utf8_number(self) -> int:
        """FLAC's UTF-8-style coded frame/sample number (up to 7 bytes)."""
        b0 = self.read(8)
        if b0 < 0x80:
            return b0
        nbytes = 0
        mask = 0x40
        while b0 & mask:
            nbytes += 1
            mask >>= 1
        val = b0 & (mask - 1)
        for _ in range(nbytes):
            cont = self.read(8)
            if cont & 0xC0 != 0x80:
                raise RuntimeError("Invalid UTF-8-coded number in FLAC frame")
            val = (val << 6) | (cont & 0x3F)
        return val


class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, val: int, n: int) -> None:
        self.acc = (self.acc << n) | (val & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def write_utf8_number(self, val: int) -> None:
        if val < 0x80:
            self.write(val, 8)
            return
        # Collect 6-bit continuation groups.
        groups = []
        v = val
        while v:
            groups.append(v & 0x3F)
            v >>= 6
        nbytes = len(groups)  # continuation bytes; header byte holds the rest
        # Header byte capacity shrinks with more continuations; bump if the
        # top group no longer fits.
        while groups[-1] >= (1 << (6 - nbytes)) if nbytes < 6 else False:
            groups.append(0)
            nbytes = len(groups)
        header = (0xFF << (7 - nbytes)) & 0xFF | groups[-1]
        self.write(header, 8)
        for g in reversed(groups[:-1]):
            self.write(0x80 | g, 8)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _window_bits(data: bytes, bitpos: int, nbits: int) -> np.ndarray:
    """Unpack ``data``'s bits over [bitpos, bitpos + nbits) (clipped to the
    stream end) as a 0/1 uint8 array starting exactly at ``bitpos``."""
    byte0 = bitpos >> 3
    byte1 = min(len(data), byte0 + ((nbits + 7) >> 3) + 1)
    bits = np.unpackbits(np.frombuffer(data, np.uint8, byte1 - byte0, byte0))
    return bits[bitpos - byte0 * 8:]


def _bits_to_ints(w: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Gather ``width``-bit big-endian unsigned ints at bit offsets
    ``starts`` of the 0/1 window ``w`` (vectorized)."""
    idx = starts[:, None] + np.arange(width)
    weights = (np.int64(1) << np.arange(width - 1, -1, -1, dtype=np.int64))
    return w[idx].astype(np.int64) @ weights


def _rice_partition(data: bytes, bitpos: int, count: int,
                    param: int) -> Tuple[np.ndarray, int]:
    """Vectorized Rice decode of one partition: returns (values (count,),
    bit position after the partition).

    Two passes over an unpacked bit window: (1) find the terminating
    1-bits — a greedy min-gap selection over the positions of ALL set bits
    (remainder fields may contain 1s, so a terminator is the first set bit
    at least param+1 past the previous one), computed with ONE vectorized
    searchsorted jump table + a cheap list-walk of its orbit; (2) gather
    all remainder fields / quotients / zigzag decode as array ops.  ~20x
    the per-bit _BitReader loop this replaces."""
    if count == 0:
        return np.zeros(0, np.int64), bitpos
    need = count * (param + 4) + 256
    while True:
        w = _window_bits(data, bitpos, need)
        ones = np.flatnonzero(w).astype(np.int64)
        n_ones = ones.size
        t = None
        if n_ones:
            # jump[k] = index of the first set bit more than param past
            # ones[k]; terminator i = jump^i(0).  The orbit is extracted
            # for ALL i at once by pointer doubling (binary decomposition
            # of i over precomposed jump^(2^p) tables) — no Python walk.
            jump = np.searchsorted(ones, ones + param + 1).astype(np.int64)
            jump = np.concatenate([jump, [np.int64(n_ones)]])  # sentinel
            jump = np.minimum(jump, n_ones)
            idx_vec = np.arange(count, dtype=np.int64)
            cur = np.zeros(count, np.int64)
            jp = jump
            for p in range(max(count - 1, 1).bit_length()):
                bit = (idx_vec >> p) & 1
                cur = np.where(bit == 1, jp[cur], cur)
                jp = jp[jp]
            if int(cur[-1]) < n_ones:
                t = ones[cur]
        if t is not None and int(t[-1]) + 1 + param <= w.size:
            break
        if (bitpos + w.size) >= len(data) * 8:
            raise RuntimeError("Truncated FLAC Rice partition")
        need *= 2
    prev_end = np.concatenate([[np.int64(0)], t[:-1] + 1 + param])
    q = t - prev_end
    if param:
        rem = _bits_to_ints(w, t + 1, param)
        zz = (q << param) | rem
    else:
        zz = q
    vals = (zz >> 1) ^ -(zz & 1)
    return vals, bitpos + int(t[-1]) + 1 + param


def _read_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise RuntimeError(f"Reserved residual coding method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    nparts = 1 << part_order
    if block_size % nparts or (nparts > 1 and (block_size >> part_order) <= order):
        raise RuntimeError("Invalid partition order")
    res = np.empty(block_size - order, np.int64)
    idx = 0
    for p in range(nparts):
        count = (block_size >> part_order) - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            bits = br.read(5)
            if bits:
                pos = br.bit_position()
                w = _window_bits(br.data, pos, count * bits)
                if w.size < count * bits:
                    raise RuntimeError("Truncated FLAC escape partition")
                starts = np.arange(count, dtype=np.int64) * bits
                vals = _bits_to_ints(w, starts, bits)
                sign = np.int64(1) << (bits - 1)
                res[idx:idx + count] = (vals ^ sign) - sign
                br.seek_bit(pos + count * bits)
            else:
                res[idx:idx + count] = 0
        else:
            vals, end = _rice_partition(br.data, br.bit_position(), count,
                                        param)
            res[idx:idx + count] = vals
            br.seek_bit(end)
        idx += count
    return res


def _read_verbatim(br: _BitReader, count: int, bits: int) -> np.ndarray:
    """Vectorized fixed-width signed reads (VERBATIM subframes)."""
    pos = br.bit_position()
    w = _window_bits(br.data, pos, count * bits)
    if w.size < count * bits:
        raise RuntimeError("Truncated FLAC verbatim subframe")
    vals = _bits_to_ints(w, np.arange(count, dtype=np.int64) * bits, bits)
    br.seek_bit(pos + count * bits)
    sign = np.int64(1) << (bits - 1)
    return (vals ^ sign) - sign


def _integrate_fixed(res: np.ndarray, warmup: List[int],
                     order: int) -> np.ndarray:
    """FIXED-predictor reconstruction as ``order`` cumulative sums: the
    residual is the order-th finite difference of the signal, so each
    integration pass adds back one difference level, seeded with the
    corresponding warmup difference (exact in int64; |cumsum| is bounded
    by block_size * 2^(bits+order) << 2^63)."""
    w = np.asarray(warmup, np.int64)
    x = res.astype(np.int64)
    for j in range(order - 1, -1, -1):
        init = np.diff(w, j)[-1] if j else w[-1]
        x = init + np.cumsum(x)
    return np.concatenate([w, x])


def _decode_subframe(br: _BitReader, block_size: int, bits: int) -> np.ndarray:
    if br.read(1):
        raise RuntimeError("Subframe padding bit set")
    sftype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bits -= wasted
    if sftype == 0:  # CONSTANT
        out = np.full(block_size, br.read_signed(bits), np.int64)
    elif sftype == 1:  # VERBATIM
        out = _read_verbatim(br, block_size, bits)
    elif 8 <= sftype <= 12:  # FIXED
        order = sftype - 8
        warmup = [br.read_signed(bits) for _ in range(order)]
        res = _read_residual(br, block_size, order)
        out = (_integrate_fixed(res, warmup, order) if order
               else res.copy())
    elif sftype >= 32:  # LPC
        order = sftype - 31
        warmup = [br.read_signed(bits) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise RuntimeError("Invalid LPC precision escape")
        shift = br.read_signed(5)
        coeffs = [br.read_signed(precision) for _ in range(order)]
        res = _read_residual(br, block_size, order)
        # The quantized predictor floors (>> shift) INSIDE the recursion,
        # so this is not an LTI filter and no cumsum/lfilter form is
        # exact — a plain-int Python loop (native ints are ~10x faster
        # than np.int64 scalars here) is the honest implementation.
        hist = list(map(int, warmup))
        rev = list(map(int, coeffs))
        sh = int(shift)
        res_l = res.tolist()
        for r in res_l:
            pred = 0
            h = len(hist)
            for k in range(order):
                pred += rev[k] * hist[h - 1 - k]
            hist.append(r + (pred >> sh))
        out = np.asarray(hist, np.int64)
    else:
        raise RuntimeError(f"Reserved subframe type {sftype}")
    if wasted:
        out <<= wasted
    return out


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file to ((frames, channels) float64 in [-1, 1), fs) —
    the same contract as ``read_wav``."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"fLaC":
        raise RuntimeError(f"Not a FLAC file: {path}")
    pos = 4
    fs = channels = bits = None
    total_samples = None
    while True:
        if pos + 4 > len(data):
            raise RuntimeError(f"Truncated FLAC metadata: {path}")
        header = data[pos]
        last = header & 0x80
        btype = header & 0x7F
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16); br.read(16)          # min/max block size
            br.read(24); br.read(24)          # min/max frame size
            fs = br.read(20)
            channels = br.read(3) + 1
            bits = br.read(5) + 1
            total_samples = br.read(36)
        pos += 4 + size
        if last:
            break
    if fs is None:
        raise RuntimeError(f"FLAC file without STREAMINFO: {path}")

    chans: List[np.ndarray] = []
    while pos < len(data):
        frame_start = pos
        br = _BitReader(data, pos)
        try:
            chans, pos = _read_frame(br, data, frame_start, path, bits,
                                     channels, chans)
        except IndexError:
            # A corrupted payload can derail Rice/LPC decoding into reading
            # past the end of the stream before the frame CRC is ever
            # reached — surface it under the same error contract as a CRC
            # mismatch, not as a raw IndexError.
            raise RuntimeError(
                f"Corrupted FLAC frame at byte {frame_start} in {path}: "
                "bitstream ended mid-frame") from None

    arrays = [np.concatenate(ch) if ch else np.zeros(0, np.int64)
              for ch in chans] or [np.zeros(0, np.int64)]
    frames = np.stack(arrays, axis=1).astype(np.float64) / float(1 << (bits - 1))
    if total_samples:
        frames = frames[:total_samples]
    return frames, int(fs)


def _read_frame(br, data, frame_start, path, bits, channels, chans):
    """Decode one frame (header + subframes + CRC-16); returns the updated
    per-channel sample lists and the next byte position."""
    sync = br.read(14)
    if sync != 0x3FFE:
        raise RuntimeError(f"Lost FLAC frame sync at byte {frame_start}")
    if br.read(1):
        raise RuntimeError("Reserved frame header bit set")
    br.read(1)                            # blocking strategy
    bs_code = br.read(4)
    sr_code = br.read(4)
    chan_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise RuntimeError("Reserved frame header bit set")
    br.read_utf8_number()
    if bs_code == 6:
        block_size = br.read(8) + 1
    elif bs_code == 7:
        block_size = br.read(16) + 1
    elif bs_code in _BLOCK_SIZES:
        block_size = _BLOCK_SIZES[bs_code]
    else:
        raise RuntimeError(f"Reserved block size code {bs_code}")
    if sr_code == 12:
        br.read(8)
    elif sr_code in (13, 14):
        br.read(16)
    elif sr_code == 15:
        raise RuntimeError("Invalid sample rate code")
    frame_bits = _SAMPLE_SIZES.get(ss_code, bits)
    header_crc = br.read(8)
    if _crc8(data[frame_start:br.pos - 1]) != header_crc:
        raise RuntimeError(f"FLAC frame header CRC mismatch in {path}")

    if chan_code < 8:
        nch = chan_code + 1
        subs = [_decode_subframe(br, block_size, frame_bits)
                for _ in range(nch)]
    elif chan_code in (8, 9, 10):
        nch = 2
        extra = (0, 1) if chan_code == 8 else \
                (1, 0) if chan_code == 9 else (0, 1)
        a = _decode_subframe(br, block_size, frame_bits + extra[0])
        b = _decode_subframe(br, block_size, frame_bits + extra[1])
        if chan_code == 8:      # left/side: right = left - side
            subs = [a, a - b]
        elif chan_code == 9:    # right/side: left = right + side
            subs = [a + b, b]
        else:                   # mid/side
            mid, side = a, b
            left = (((mid << 1) | (side & 1)) + side) >> 1
            subs = [left, left - side]
    else:
        raise RuntimeError(f"Reserved channel assignment {chan_code}")
    if nch != channels:
        raise RuntimeError("FLAC frame channel count != STREAMINFO")

    br.align()
    frame_crc = br.read(16)
    if _crc16(data[frame_start:br.pos - 2]) != frame_crc:
        raise RuntimeError(f"FLAC frame CRC-16 mismatch in {path}")
    if not chans:
        chans = [[] for _ in range(nch)]
    for ch, sub in zip(chans, subs):
        ch.append(sub)
    return chans, br.pos


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _best_rice_param(res: np.ndarray, plen: int) -> int:
    if res.size == 0:
        return 0
    zz = np.abs(res.astype(np.int64)) * 2
    mean = max(float(zz.mean()), 1.0)
    param = max(int(np.floor(np.log2(mean))), 0)
    return min(param, (1 << plen) - 2)


def _write_residual(bw: _BitWriter, res: np.ndarray) -> None:
    """Single-partition Rice coding (partition order 0) with the 4-bit
    parameter method, escaping to raw when Rice would blow up."""
    bw.write(0, 2)                  # method: rice, 4-bit params
    bw.write(0, 4)                  # partition order 0
    param = _best_rice_param(res, 4)
    # zigzag: n>=0 -> 2n, n<0 -> -2n-1
    zz = np.where(res >= 0, 2 * res.astype(np.int64),
                  -2 * res.astype(np.int64) - 1)
    worst_q = int((zz >> param).max()) if zz.size else 0
    if worst_q > 1 << 16:           # pathological: escape to raw
        bits = int(max(np.ceil(np.log2(np.abs(res).max() + 1)) + 1, 1)) \
            if res.size else 1
        bits = min(bits, 31)
        bw.write(0xF, 4)            # escape
        bw.write(bits, 5)
        for v in res:
            bw.write(int(v) & ((1 << bits) - 1), bits)
        return
    bw.write(param, 4)
    for v in zz:
        q = int(v) >> param
        bw.write_unary(q)
        if param:
            bw.write(int(v) & ((1 << param) - 1), param)


def _encode_subframe(bw: _BitWriter, samples: np.ndarray, bits: int,
                     method: str) -> None:
    s = samples.astype(np.int64)
    if method == "verbatim":
        bw.write(0, 1)
        bw.write(1, 6)
        bw.write(0, 1)
        for v in s:
            bw.write(int(v) & ((1 << bits) - 1), bits)
        return
    if np.all(s == s[0]):
        bw.write(0, 1); bw.write(0, 6); bw.write(0, 1)
        bw.write(int(s[0]) & ((1 << bits) - 1), bits)
        return
    # FIXED: pick the order 0-2 with the smallest residual magnitude sum.
    cands = {0: s}
    if len(s) > 1:
        cands[1] = np.diff(s)
    if len(s) > 2:
        cands[2] = np.diff(s, 2)
    order = min(cands, key=lambda o: np.abs(cands[o]).sum()
                + sum(abs(int(v)) for v in s[:o]))
    res = cands[order]
    bw.write(0, 1)
    bw.write(8 + order, 6)
    bw.write(0, 1)
    for v in s[:order]:
        bw.write(int(v) & ((1 << bits) - 1), bits)
    _write_residual(bw, res)


def write_flac(path: str, samples, fs: float, bits: int = 16,
               block_size: int = 4096, method: str = "fixed") -> None:
    """Encode (frames,) or (frames, channels) float samples in [-1, 1] as a
    FLAC file (independent channels; ``method`` 'fixed' or 'verbatim')."""
    if bits not in (8, 16, 24):
        raise ValueError("bits must be 8, 16 or 24")
    if method not in ("fixed", "verbatim"):
        raise ValueError("method must be 'fixed' or 'verbatim'")
    arr = np.asarray(samples, np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    frames, channels = arr.shape
    if not 1 <= channels <= 8:
        raise ValueError("1-8 channels supported")
    scale = float(1 << (bits - 1))
    quant = np.clip(np.round(arr * scale), -scale, scale - 1).astype(np.int64)

    # STREAMINFO
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    si.write(0, 24); si.write(0, 24)
    si.write(int(fs), 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(frames, 36)
    for _ in range(16):
        si.write(0, 8)              # MD5 unset (all zero) is legal
    streaminfo = bytes(si.bytes)

    out = bytearray(b"fLaC")
    out.append(0x80 | 0)            # last metadata block, STREAMINFO
    out += len(streaminfo).to_bytes(3, "big")
    out += streaminfo

    for fi, start in enumerate(range(0, frames, block_size)):
        block = quant[start:start + block_size]
        n = block.shape[0]
        bw = _BitWriter()
        bw.write(0x3FFE, 14)
        bw.write(0, 1)
        bw.write(0, 1)              # fixed block size strategy
        bw.write(7, 4)              # block size: 16-bit field below
        sr_code = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
                   22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
                   96000: 11}.get(int(fs), 0)
        bw.write(sr_code, 4)
        bw.write(channels - 1, 4)   # independent channels
        ss_code = {8: 1, 16: 4, 24: 6}[bits]
        bw.write(ss_code, 3)
        bw.write(0, 1)
        bw.write_utf8_number(fi)
        bw.write(n - 1, 16)
        header = bytes(bw.bytes)
        assert bw.nbits == 0
        bw.write(_crc8(header), 8)
        for ch in range(channels):
            _encode_subframe(bw, block[:, ch], bits, method)
        bw.align()
        body = bytes(bw.bytes)
        bw.write(_crc16(body), 16)
        out += bw.bytes

    with open(path, "wb") as f:
        f.write(out)
