"""Self-contained Ogg Vorbis decoder (host-side I/O, pure NumPy math).

Closes the remaining audio-format-breadth gap of ``read_audio_files``
(reference: utils.py:459-482 reads any soundfile-supported container;
this environment has no soundfile, so .ogg captures were previously
unreadable).  Implements Vorbis I per the public specification:

* Ogg page layer: capture-pattern scan, CRC-32 (poly 0x04C11DB7, LSB-free
  variant used by Ogg), lacing/continuation packet reassembly, granule
  tracking for end-trim.
* Vorbis setup: codebooks (ordered/sparse length lists, canonical Huffman
  codeword assignment, VQ lookup types 0/1/2), floor types 0 (LSP) and 1
  (piecewise-linear dB), residue types 0/1/2, mappings (square-polar
  channel coupling), modes (long/short windows).
* Audio decode: packet-mode dispatch, floor decode + curve synthesis
  (integer Bresenham render, vectorized), cascaded residue passes,
  inverse coupling, floor multiply, IMDCT (DCT-IV based, O(n log n) via
  scipy.fft when available, exact cosine matmul fallback), Vorbis window
  with block-switching slopes, overlap-add with granule truncation.

Decoding is tolerant of end-of-packet conditions per the spec (partial
floor/residue data stands; the rest of the frame is zeros).

Validated sample-exactly (±few int16 LSB) against an SDL_mixer/stb_vorbis
decode of a real encoder-produced stream in tests/test_vorbis.py, plus
analytic IMDCT / lapping / Huffman-assignment unit tests.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

try:  # pragma: no cover - exercised via _dct4 dispatch
    from scipy.fft import dct as _scipy_dct
except Exception:  # pragma: no cover
    _scipy_dct = None


class VorbisError(RuntimeError):
    pass


class _EndOfPacket(Exception):
    """Raised when a read crosses the packet end (spec 4.3: not an error
    inside audio packets — decode keeps what it has)."""


# ---------------------------------------------------------------------------
# Ogg container layer
# ---------------------------------------------------------------------------

def _ogg_crc_table() -> list:
    tab = []
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ 0x04C11DB7 if r & 0x80000000 else r << 1) \
                & 0xFFFFFFFF
        tab.append(r)
    return tab


_CRC_TAB = _ogg_crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    tab = _CRC_TAB
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ tab[(crc >> 24) ^ b]
    return crc


def _ogg_packets(data: bytes) -> Tuple[List[bytes], List[Tuple[int, int]],
                                       int]:
    """Parse Ogg pages into (packets, per-packet (page_index, granule),
    final granule).  Follows the first logical stream whose first packet is
    a Vorbis identification header; checks page CRCs."""
    packets: List[bytes] = []
    granules: List[Tuple[int, int]] = []
    serial: Optional[int] = None
    partial = b""
    final_granule = -1
    pos = 0
    page_index = 0
    n = len(data)
    while pos + 27 <= n:
        if data[pos:pos + 4] != b"OggS":
            nxt = data.find(b"OggS", pos + 1)
            if nxt < 0:
                break
            pos = nxt
            continue
        if data[pos + 4] != 0:
            raise VorbisError("unsupported Ogg stream structure version")
        htype = data[pos + 5]
        granule = struct.unpack("<q", data[pos + 6:pos + 14])[0]
        pserial = struct.unpack("<I", data[pos + 14:pos + 18])[0]
        crc_stored = struct.unpack("<I", data[pos + 22:pos + 26])[0]
        nseg = data[pos + 26]
        header_len = 27 + nseg
        if pos + header_len > n:
            break
        segs = data[pos + 27:pos + 27 + nseg]
        body_len = sum(segs)
        page_end = pos + header_len + body_len
        if page_end > n:
            break
        page = bytearray(data[pos:page_end])
        page[22:26] = b"\x00" * 4
        if _ogg_crc(bytes(page)) != crc_stored:
            raise VorbisError("Ogg page CRC mismatch")
        body = data[pos + header_len:page_end]
        if serial is None:
            # lock onto the stream that starts with a Vorbis ident header
            if (htype & 0x02) and body[:7] == b"\x01vorbis":
                serial = pserial
        if serial is not None and pserial == serial:
            if not (htype & 0x01):
                partial = b""  # fresh packet (no continuation)
            off = 0
            for i, s in enumerate(segs):
                partial += body[off:off + s]
                off += s
                if s < 255:
                    packets.append(partial)
                    granules.append((page_index, granule))
                    partial = b""
            if granule >= 0:
                final_granule = granule
        pos = page_end
        page_index += 1
    if serial is None:
        raise VorbisError("no Vorbis logical stream found")
    return packets, granules, final_granule


# ---------------------------------------------------------------------------
# Bit reader (LSB-first within bytes, per Vorbis spec section 2)
# ---------------------------------------------------------------------------

class _BitReader:
    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.nbits = len(data) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        if p + n > self.nbits:
            self.pos = self.nbits
            raise _EndOfPacket
        self.pos = p + n
        b0 = p >> 3
        b1 = (p + n + 7) >> 3
        val = int.from_bytes(self.data[b0:b1], "little") >> (p & 7)
        return val & ((1 << n) - 1)

    def peek_word(self) -> int:
        """Up to 32 bits at the cursor, zero-padded past packet end."""
        p = self.pos
        b0 = p >> 3
        chunk = self.data[b0:b0 + 5]
        return (int.from_bytes(chunk, "little") >> (p & 7)) & 0xFFFFFFFF

    def remaining(self) -> int:
        return self.nbits - self.pos


def _ilog(x: int) -> int:
    return max(x, 0).bit_length()


def _float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    exponent = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(mantissa) * 2.0 ** (exponent - 788)


def _lookup1_values(entries: int, dims: int) -> int:
    v = int(round(entries ** (1.0 / dims)))
    while (v + 1) ** dims <= entries:
        v += 1
    while v ** dims > entries:
        v -= 1
    return v


# ---------------------------------------------------------------------------
# Codebooks
# ---------------------------------------------------------------------------

_FAST_BITS = 12


class _Codebook:
    __slots__ = ("dims", "entries", "lengths", "vectors", "fast_entry",
                 "fast_len", "long_codes", "maxlen")

    def __init__(self, br: _BitReader):
        if br.read(24) != 0x564342:
            raise VorbisError("codebook sync lost")
        self.dims = br.read(16)
        self.entries = br.read(24)
        lengths = np.zeros(self.entries, np.int32)
        if br.read(1):  # ordered
            cur = br.read(5) + 1
            i = 0
            while i < self.entries:
                num = br.read(_ilog(self.entries - i))
                if i + num > self.entries:
                    raise VorbisError("ordered codebook overflow")
                lengths[i:i + num] = cur
                i += num
                cur += 1
        else:
            sparse = br.read(1)
            for i in range(self.entries):
                if sparse:
                    lengths[i] = br.read(5) + 1 if br.read(1) else 0
                else:
                    lengths[i] = br.read(5) + 1
        self.lengths = lengths
        self._assign_codewords()
        lt = br.read(4)
        if lt == 0:
            self.vectors = None
        elif lt in (1, 2):
            minv = _float32_unpack(br.read(32))
            delta = _float32_unpack(br.read(32))
            vbits = br.read(4) + 1
            seq = br.read(1)
            if lt == 1:
                lv = _lookup1_values(self.entries, self.dims)
            else:
                lv = self.entries * self.dims
            mults = np.array([br.read(vbits) for _ in range(lv)], np.float64)
            ent = np.arange(self.entries)[:, None]
            d = np.arange(self.dims)[None, :]
            if lt == 1:
                idx = (ent // (lv ** d)) % lv if lv > 0 else np.zeros(
                    (self.entries, self.dims), np.int64)
                vec = mults[idx] * delta + minv
            else:
                vec = mults.reshape(self.entries, self.dims) * delta + minv
            if seq:
                vec = np.cumsum(vec, axis=1)
            self.vectors = vec
        else:
            raise VorbisError(f"reserved codebook lookup type {lt}")

    def _assign_codewords(self) -> None:
        """Canonical Vorbis codeword assignment (spec 3.2.1): each used
        entry, in order, takes the lowest-valued free codeword of its
        length.  Builds an LSB-first fast table + long-code dict."""
        used = [(i, int(l)) for i, l in enumerate(self.lengths) if l > 0]
        self.fast_entry = np.full(1 << _FAST_BITS, -1, np.int32)
        self.fast_len = np.zeros(1 << _FAST_BITS, np.int8)
        self.long_codes = {}
        self.maxlen = 0
        if not used:
            return
        if len(used) == 1:
            # single-entry codebook: reads its stated length of zero bits
            i, l = used[0]
            self._install(i, l, 0)
            self.maxlen = l
            return
        # available[l] = sorted list of free prefixes of length l
        import heapq
        avail = [[] for _ in range(33)]
        heapq.heappush(avail[0], 0)
        for i, l in used:
            self.maxlen = max(self.maxlen, l)
            best_d, best_code = -1, None
            for d in range(l, -1, -1):
                if avail[d]:
                    cand = avail[d][0] << (l - d)
                    if best_code is None or cand < best_code:
                        best_code, best_d = cand, d
            if best_code is None:
                raise VorbisError("over-specified Huffman tree")
            prefix = heapq.heappop(avail[best_d])
            # re-add the untaken right branches along the zero-extension
            for d in range(best_d + 1, l + 1):
                heapq.heappush(avail[d], (prefix << (d - best_d)) | 1)
            self._install(i, l, best_code)

    def _install(self, entry: int, length: int, code: int) -> None:
        if length <= _FAST_BITS:
            rev = int(f"{code:0{length}b}"[::-1], 2) if length else 0
            step = 1 << length
            for k in range(rev, 1 << _FAST_BITS, step):
                self.fast_entry[k] = entry
                self.fast_len[k] = length
        else:
            self.long_codes[(length, code)] = entry

    def decode_scalar(self, br: _BitReader) -> int:
        avail = br.remaining()
        if avail <= 0:
            raise _EndOfPacket
        w = br.peek_word()
        e = int(self.fast_entry[w & ((1 << _FAST_BITS) - 1)])
        if e >= 0:
            l = int(self.fast_len[w & ((1 << _FAST_BITS) - 1)])
            if l > avail:
                raise _EndOfPacket
            br.pos += l
            return e
        cw = 0
        long_codes = self.long_codes
        for l in range(1, self.maxlen + 1):
            if l > avail:
                raise _EndOfPacket
            if l > 32:
                break
            cw = (cw << 1) | ((w >> (l - 1)) & 1)
            hit = long_codes.get((l, cw))
            if hit is not None:
                br.pos += l
                return hit
        raise VorbisError("invalid Huffman codeword")

    def decode_vector(self, br: _BitReader) -> np.ndarray:
        if self.vectors is None:
            raise VorbisError("scalar codebook used in VQ context")
        return self.vectors[self.decode_scalar(br)]


# ---------------------------------------------------------------------------
# Floors
# ---------------------------------------------------------------------------

def _make_inverse_db_table() -> np.ndarray:
    # The spec's floor1_inverse_dB_table is the geometric sequence
    # table[i] = 1.0649863e-07 * 1.0649863**i (~0.5466 dB per step,
    # ~-139 dB floor); validated against an stb_vorbis decode to within
    # 4 int16 LSB end to end (tests/test_vorbis.py).
    return 1.0649863e-07 * 1.0649863 ** np.arange(256)


_INV_DB = _make_inverse_db_table()

_FLOOR1_RANGES = (256, 128, 86, 64)


class _Floor1:
    def __init__(self, br: _BitReader):
        partitions = br.read(5)
        self.partition_class = [br.read(4) for _ in range(partitions)]
        maxclass = max(self.partition_class) if partitions else -1
        self.class_dims = []
        self.class_subclasses = []
        self.class_masterbooks = []
        self.subclass_books = []
        for _ in range(maxclass + 1):
            dims = br.read(3) + 1
            sub = br.read(2)
            master = br.read(8) if sub else -1
            books = [br.read(8) - 1 for _ in range(1 << sub)]
            self.class_dims.append(dims)
            self.class_subclasses.append(sub)
            self.class_masterbooks.append(master)
            self.subclass_books.append(books)
        self.multiplier = br.read(2) + 1
        rangebits = br.read(4)
        xs = [0, 1 << rangebits]
        for i in range(partitions):
            for _ in range(self.class_dims[self.partition_class[i]]):
                xs.append(br.read(rangebits))
        self.x_list = np.array(xs, np.int64)
        if len(set(xs)) != len(xs):
            raise VorbisError("floor1 X values not unique")
        self.values = len(xs)
        # neighbor tables (computed once: depend only on X layout)
        self.lo_nb = np.zeros(self.values, np.int64)
        self.hi_nb = np.zeros(self.values, np.int64)
        for i in range(2, self.values):
            below = [j for j in range(i) if xs[j] < xs[i]]
            above = [j for j in range(i) if xs[j] > xs[i]]
            self.lo_nb[i] = max(below, key=lambda j: xs[j])
            self.hi_nb[i] = min(above, key=lambda j: xs[j])
        self.sort_order = np.argsort(self.x_list, kind="stable")

    def decode(self, br: _BitReader, books: List[_Codebook]):
        """Returns (final_Y (range units), step2 flags) or None when the
        floor is unused.  Flags travel WITH the decoded data: floor
        configs are shared across channels, so per-channel state must not
        live on the instance (all channels decode before any curve is
        rendered — instance state would leave every channel with the
        last channel's flags)."""
        if not br.read(1):
            return None
        rng = _FLOOR1_RANGES[self.multiplier - 1]
        ybits = _ilog(rng - 1)
        y = np.zeros(self.values, np.int64)
        y[0] = br.read(ybits)
        y[1] = br.read(ybits)
        offset = 2
        for cls in self.partition_class:
            cdim = self.class_dims[cls]
            cbits = self.class_subclasses[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[self.class_masterbooks[cls]].decode_scalar(br)
            for _ in range(cdim):
                book = self.subclass_books[cls][cval & csub]
                cval >>= cbits
                y[offset] = books[book].decode_scalar(br) if book >= 0 else 0
                offset += 1
        return self._amplitude(y, rng)

    def _amplitude(self, y: np.ndarray, rng: int):
        final = np.zeros(self.values, np.int64)
        step2 = np.zeros(self.values, bool)
        final[0], final[1] = y[0], y[1]
        step2[0] = step2[1] = True
        for i in range(2, self.values):
            lo, hi = int(self.lo_nb[i]), int(self.hi_nb[i])
            pred = _render_point(int(self.x_list[lo]), int(final[lo]),
                                 int(self.x_list[hi]), int(final[hi]),
                                 int(self.x_list[i]))
            val = int(y[i])
            highroom = rng - pred
            lowroom = pred
            room = 2 * min(highroom, lowroom)
            if val:
                step2[lo] = step2[hi] = step2[i] = True
                if val >= room:
                    if highroom > lowroom:
                        final[i] = val - lowroom + pred
                    else:
                        final[i] = pred - (val - highroom) - 1
                else:
                    final[i] = pred - ((val + 1) >> 1) if (val & 1) \
                        else pred + (val >> 1)
            else:
                step2[i] = False
                final[i] = pred
            final[i] = min(max(int(final[i]), 0), rng - 1)
        return final, step2

    def curve(self, decoded, n2: int) -> np.ndarray:
        """Synthesize the floor curve over n2 spectral bins (linear
        amplitude via the inverse-dB table) from decode()'s
        (final_Y, step2) pair."""
        final_y, step2 = decoded
        out = np.zeros(n2, np.int64)
        order = self.sort_order
        flagged = [int(j) for j in order if step2[j]]
        lx, ly = 0, int(final_y[flagged[0]]) * self.multiplier
        for j in flagged[1:]:
            hx = int(self.x_list[j])
            hy = int(final_y[j]) * self.multiplier
            if hx >= n2:
                _render_line(lx, ly, n2, ly + (hy - ly) * (n2 - lx)
                             // max(hx - lx, 1) if hx > lx else ly, out, n2)
                lx, ly = n2, hy
                break
            _render_line(lx, ly, hx, hy, out, n2)
            lx, ly = hx, hy
        if lx < n2:
            out[lx:] = ly
        return _INV_DB[np.clip(out, 0, 255)]


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def _render_line(x0: int, y0: int, x1: int, y1: int, out: np.ndarray,
                 n2: int) -> None:
    """Integer Bresenham per the spec, closed-form vectorized:
    y(x0+t) = y0 + trunc(dy/adx)*t + sign(dy)*floor((|dy| mod adx)*t/adx)."""
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0 or x0 >= n2:
        return
    base = -((-dy) // adx) if dy < 0 else dy // adx  # C-style truncation
    ady = abs(dy) - abs(base) * adx
    hx = min(x1, n2)
    t = np.arange(hx - x0)
    sgn = 1 if dy >= 0 else -1
    out[x0:hx] = y0 + base * t + sgn * ((ady * t) // adx)


class _Floor0:
    """Floor type 0 (LSP); parsed and synthesized per spec 6.2.  Rare in
    practice (old encoders); kept for spec completeness."""

    def __init__(self, br: _BitReader):
        self.order = br.read(8)
        self.rate = br.read(16)
        self.bark_map_size = br.read(16)
        self.amplitude_bits = br.read(6)
        self.amplitude_offset = br.read(8)
        nbooks = br.read(4) + 1
        self.book_list = [br.read(8) for _ in range(nbooks)]
        if self.order == 0 or self.rate == 0 or self.bark_map_size == 0:
            raise VorbisError("invalid floor0 header")

    def decode(self, br: _BitReader, books: List[_Codebook]):
        amplitude = br.read(self.amplitude_bits)
        if amplitude <= 0:
            return None
        booknum = br.read(_ilog(len(self.book_list)))
        if booknum >= len(self.book_list):
            raise VorbisError("floor0 book number out of range")
        book = books[self.book_list[booknum]]
        coeffs: List[float] = []
        last = 0.0
        while len(coeffs) < self.order:
            vec = book.decode_vector(br)
            coeffs.extend((vec + last).tolist())
            last = float(coeffs[-1])
        return amplitude, np.array(coeffs[:self.order], np.float64)

    def curve(self, decoded, n2: int) -> np.ndarray:
        amplitude, lsp = decoded
        # bark map (spec: foobar(n) with linear interpolation of cos(w))
        def bark(f):
            return (13.1 * np.arctan(0.00074 * f) +
                    2.24 * np.arctan(1.85e-8 * f * f) + 1e-4 * f)
        i = np.arange(n2)
        mapv = np.minimum(
            (bark(self.rate * i / (2.0 * n2)) * self.bark_map_size
             / bark(0.5 * self.rate)).astype(np.int64),
            self.bark_map_size - 1)
        omega = np.pi * mapv / self.bark_map_size
        cos_o = np.cos(omega)
        two_cos_lsp = 2.0 * np.cos(lsp)
        p = np.ones(n2)
        q = np.ones(n2)
        if self.order % 2:
            for j in range(0, self.order - 1, 2):
                q *= (two_cos_lsp[j] / 2.0 - cos_o) ** 2 * 4.0
            for j in range(1, self.order - 1, 2):
                p *= (two_cos_lsp[j] / 2.0 - cos_o) ** 2 * 4.0
            p *= (1.0 - cos_o ** 2) * 4.0
            q *= 0.25
        else:
            for j in range(0, self.order, 2):
                p *= (two_cos_lsp[j] / 2.0 - cos_o) ** 2 * 4.0
            for j in range(1, self.order, 2):
                q *= (two_cos_lsp[j] / 2.0 - cos_o) ** 2 * 4.0
            p *= (1.0 - cos_o) * 2.0
            q *= (1.0 + cos_o) * 2.0
        linear = np.exp((amplitude * self.amplitude_offset /
                         ((2 ** self.amplitude_bits - 1)
                          * np.sqrt(p + q + 1e-300)) -
                         self.amplitude_offset) * 0.11512925)
        return linear


# ---------------------------------------------------------------------------
# Residues
# ---------------------------------------------------------------------------

class _Residue:
    def __init__(self, br: _BitReader, rtype: int):
        self.rtype = rtype
        self.begin = br.read(24)
        self.end = br.read(24)
        self.partition_size = br.read(24) + 1
        self.classifications = br.read(6) + 1
        self.classbook = br.read(8)
        cascade = []
        for _ in range(self.classifications):
            low = br.read(3)
            high = br.read(5) if br.read(1) else 0
            cascade.append((high << 3) | low)
        self.cascade = cascade
        self.books = []
        for c in cascade:
            row = []
            for j in range(8):
                row.append(br.read(8) if (c >> j) & 1 else -1)
            self.books.append(row)

    def decode(self, br: _BitReader, books: List[_Codebook],
               do_not_decode: List[bool], n2: int) -> np.ndarray:
        ch = len(do_not_decode)
        if self.rtype == 2:
            out = np.zeros((1, n2 * ch), np.float64)
            dnd = [all(do_not_decode)]
        else:
            out = np.zeros((ch, n2), np.float64)
            dnd = list(do_not_decode)
        actual = out.shape[1]
        limit_begin = min(self.begin, actual)
        limit_end = min(self.end, actual)
        to_read = limit_end - limit_begin
        if to_read <= 0:
            return self._deinterleave(out, ch, n2)
        psize = self.partition_size
        parts = to_read // psize
        classbook = books[self.classbook]
        cwords = classbook.dims
        nch = out.shape[0]
        classif = np.zeros((nch, parts + cwords), np.int64)
        max_pass = max((c.bit_length() for c in self.cascade), default=0)
        try:
            for pas in range(max_pass):
                pcount = 0
                while pcount < parts:
                    if pas == 0:
                        for j in range(nch):
                            if dnd[j]:
                                continue
                            temp = classbook.decode_scalar(br)
                            for k in range(cwords - 1, -1, -1):
                                classif[j, pcount + k] = \
                                    temp % self.classifications
                                temp //= self.classifications
                    for _ in range(cwords):
                        if pcount >= parts:
                            break
                        for j in range(nch):
                            if dnd[j]:
                                continue
                            vq = int(classif[j, pcount])
                            booknum = self.books[vq][pas]
                            if booknum < 0:
                                continue
                            book = books[booknum]
                            off = limit_begin + pcount * psize
                            self._partition(br, book, out[j], off, psize)
                        pcount += 1
        except _EndOfPacket:
            pass
        return self._deinterleave(out, ch, n2)

    def _partition(self, br: _BitReader, book: _Codebook, v: np.ndarray,
                   off: int, psize: int) -> None:
        dims = book.dims
        if self.rtype == 0:
            step = psize // dims
            for i in range(step):
                vec = book.decode_vector(br)
                v[off + i: off + i + dims * step: step] += vec
        else:  # types 1 and 2 share the sequential format
            i = 0
            while i < psize:
                vec = book.decode_vector(br)
                v[off + i: off + i + dims] += vec
                i += dims

    def _deinterleave(self, out: np.ndarray, ch: int, n2: int) -> np.ndarray:
        if self.rtype != 2:
            return out
        return out[0].reshape(n2, ch).T.copy()


# ---------------------------------------------------------------------------
# Mapping / mode
# ---------------------------------------------------------------------------

class _Mapping:
    def __init__(self, br: _BitReader, channels: int):
        self.submaps = br.read(4) + 1 if br.read(1) else 1
        self.coupling = []
        if br.read(1):
            steps = br.read(8) + 1
            bits = _ilog(channels - 1)
            for _ in range(steps):
                mag = br.read(bits)
                ang = br.read(bits)
                if mag == ang or mag >= channels or ang >= channels:
                    raise VorbisError("invalid coupling step")
                self.coupling.append((mag, ang))
        if br.read(2) != 0:
            raise VorbisError("mapping reserved bits nonzero")
        if self.submaps > 1:
            self.mux = [br.read(4) for _ in range(channels)]
        else:
            self.mux = [0] * channels
        self.submap_floor = []
        self.submap_residue = []
        for _ in range(self.submaps):
            br.read(8)  # unused time configuration placeholder
            self.submap_floor.append(br.read(8))
            self.submap_residue.append(br.read(8))


# ---------------------------------------------------------------------------
# IMDCT + window
# ---------------------------------------------------------------------------

def _dct4(x: np.ndarray) -> np.ndarray:
    """z[m] = sum_k x[k] cos(pi/N (m+0.5)(k+0.5)), N = len(x)."""
    if _scipy_dct is not None:
        return 0.5 * _scipy_dct(x, type=4)
    n = len(x)
    m = np.arange(n)
    mat = np.cos(np.pi / n * np.outer(m + 0.5, m + 0.5))
    return mat @ x


def imdct(spectrum: np.ndarray) -> np.ndarray:
    """Vorbis IMDCT: n/2 spectral coefficients -> n time samples,
    y[j] = sum_k X[k] cos(2 pi/n (j + 0.5 + n/4)(k + 0.5))."""
    n2 = len(spectrum)
    n4 = n2 // 2
    z = _dct4(np.asarray(spectrum, np.float64))
    y = np.empty(2 * n2, np.float64)
    y[:n4] = z[n4:]
    y[n4:n4 + n2] = -z[::-1]
    y[n4 + n2:] = -z[:n4]
    return y


def _window_slope(length: int) -> np.ndarray:
    i = np.arange(length) + 0.5
    return np.sin(0.5 * np.pi * np.sin(i / (2.0 * length) * np.pi) ** 2)


def frame_geometry(n: int, n0: int, blockflag: int, prev_flag: int,
                   next_flag: int) -> Tuple[int, int, int, int]:
    """Window slope boundaries (left_start, left_end, right_start,
    right_end) for a block of size n with block-switching flags
    (spec 4.3.8; n0 = short blocksize)."""
    if blockflag and not prev_flag:
        left_start, left_end = n // 4 - n0 // 4, n // 4 + n0 // 4
    else:
        left_start, left_end = 0, n // 2
    if blockflag and not next_flag:
        right_start, right_end = 3 * n // 4 - n0 // 4, 3 * n // 4 + n0 // 4
    else:
        right_start, right_end = n // 2, n
    return left_start, left_end, right_start, right_end


def frame_window(n: int, geometry: Tuple[int, int, int, int]) -> np.ndarray:
    """The Vorbis window for a block, zero outside the slope span."""
    ls, le, rs, re = geometry
    w = np.zeros(n)
    w[ls:le] = _window_slope(le - ls)
    w[le:rs] = 1.0
    w[rs:re] = _window_slope(re - rs)[::-1]
    return w


# ---------------------------------------------------------------------------
# Top-level decoder
# ---------------------------------------------------------------------------

class _VorbisSetup:
    def __init__(self, ident: bytes, setup: bytes):
        br = _BitReader(ident)
        if br.read(8) != 1 or bytes(br.read(8) for _ in range(6)) != b"vorbis":
            raise VorbisError("bad identification header")
        if br.read(32) != 0:
            raise VorbisError("unsupported Vorbis version")
        self.channels = br.read(8)
        self.rate = br.read(32)
        br.read(32), br.read(32), br.read(32)  # bitrate hints
        bs = br.read(4), br.read(4)
        self.blocksize0 = 1 << bs[0]
        self.blocksize1 = 1 << bs[1]
        if not (64 <= self.blocksize0 <= 8192 and
                self.blocksize0 <= self.blocksize1 <= 8192):
            raise VorbisError("invalid blocksizes")
        if not br.read(1):
            raise VorbisError("ident framing bit unset")
        if self.channels == 0 or self.rate == 0:
            raise VorbisError("invalid channel count or rate")

        br = _BitReader(setup)
        if br.read(8) != 5 or bytes(br.read(8) for _ in range(6)) != b"vorbis":
            raise VorbisError("bad setup header")
        self.books = [_Codebook(br) for _ in range(br.read(8) + 1)]
        for _ in range(br.read(6) + 1):  # time transforms (placeholder)
            if br.read(16) != 0:
                raise VorbisError("nonzero time transform")
        self.floors = []
        self.floor_types = []
        for _ in range(br.read(6) + 1):
            ftype = br.read(16)
            if ftype == 0:
                self.floors.append(_Floor0(br))
            elif ftype == 1:
                self.floors.append(_Floor1(br))
            else:
                raise VorbisError(f"unknown floor type {ftype}")
            self.floor_types.append(ftype)
        self.residues = []
        for _ in range(br.read(6) + 1):
            rtype = br.read(16)
            if rtype not in (0, 1, 2):
                raise VorbisError(f"unknown residue type {rtype}")
            self.residues.append(_Residue(br, rtype))
        self.mappings = []
        for _ in range(br.read(6) + 1):
            if br.read(16) != 0:
                raise VorbisError("unknown mapping type")
            self.mappings.append(_Mapping(br, self.channels))
        self.modes = []
        for _ in range(br.read(6) + 1):
            blockflag = br.read(1)
            if br.read(16) != 0 or br.read(16) != 0:
                raise VorbisError("nonzero window/transform type")
            mapping = br.read(8)
            if mapping >= len(self.mappings):
                raise VorbisError("mode mapping out of range")
            self.modes.append((blockflag, mapping))
        if not br.read(1):
            raise VorbisError("setup framing bit unset")


def _decode_frame(setup: _VorbisSetup, packet: bytes):
    """One audio packet -> (windowed time block, n, left_start, left_end,
    right_start, right_end) or None for non-audio packets."""
    br = _BitReader(packet)
    try:
        if br.read(1) != 0:
            return None
        mode_bits = _ilog(len(setup.modes) - 1)
        blockflag, mapping_idx = setup.modes[br.read(mode_bits)]
    except _EndOfPacket:
        return None
    n = setup.blocksize1 if blockflag else setup.blocksize0
    n0 = setup.blocksize0
    prev_flag = next_flag = 1
    if blockflag:
        try:
            prev_flag = br.read(1)
            next_flag = br.read(1)
        except _EndOfPacket:
            prev_flag = next_flag = 1
    mapping = setup.mappings[mapping_idx]
    ch = setup.channels
    n2 = n // 2

    floor_data = [None] * ch
    try:
        for c in range(ch):
            submap = mapping.mux[c]
            fidx = mapping.submap_floor[submap]
            floor_data[c] = setup.floors[fidx].decode(br, setup.books)
    except _EndOfPacket:
        pass
    nonzero = [fd is not None for fd in floor_data]
    for mag, ang in mapping.coupling:
        if nonzero[mag] or nonzero[ang]:
            nonzero[mag] = nonzero[ang] = True

    residue_vec = np.zeros((ch, n2), np.float64)
    for s in range(mapping.submaps):
        chlist = [c for c in range(ch) if mapping.mux[c] == s]
        if not chlist:
            continue
        dnd = [not nonzero[c] for c in chlist]
        res = setup.residues[mapping.submap_residue[s]]
        decoded = res.decode(br, setup.books, dnd, n2)
        for k, c in enumerate(chlist):
            residue_vec[c] = decoded[k]

    for mag, ang in reversed(mapping.coupling):
        m = residue_vec[mag]
        a = residue_vec[ang]
        new_m = np.where(m > 0, np.where(a > 0, m, m + a),
                         np.where(a > 0, m, m - a))
        new_a = np.where(m > 0, np.where(a > 0, m - a, m),
                         np.where(a > 0, m + a, m))
        residue_vec[mag] = new_m
        residue_vec[ang] = new_a

    pcm = np.zeros((ch, n), np.float64)
    for c in range(ch):
        if floor_data[c] is None:
            continue
        submap = mapping.mux[c]
        floor = setup.floors[mapping.submap_floor[submap]]
        curve = floor.curve(floor_data[c], n2)
        pcm[c] = imdct(curve * residue_vec[c])

    geom = frame_geometry(n, n0, blockflag, prev_flag, next_flag)
    w = frame_window(n, geom)
    return (pcm * w, n) + geom


def read_ogg(path: str) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Vorbis file to ((frames, channels) float64 in [-1, 1],
    sample rate).  Counterpart of soundfile's .ogg support used by the
    reference's read_audio_files (utils.py:469)."""
    with open(path, "rb") as f:
        data = f.read()
    packets, _granules, final_granule = _ogg_packets(data)
    if len(packets) < 3:
        raise VorbisError("missing Vorbis headers")
    if packets[1][:7] != b"\x03vorbis":
        raise VorbisError("missing comment header")
    setup = _VorbisSetup(packets[0], packets[2])
    out_chunks: List[np.ndarray] = []
    prev_tail: Optional[np.ndarray] = None
    total = 0
    for pkt in packets[3:]:
        if not pkt:
            continue
        frame = _decode_frame(setup, pkt)
        if frame is None:
            continue
        pcm, n, ls, le, rs, re = frame
        if prev_tail is not None:
            emit = pcm[:, ls:rs].copy()
            ov = min(prev_tail.shape[1], le - ls)
            emit[:, :ov] += prev_tail[:, :ov]
            out_chunks.append(emit)
            total += emit.shape[1]
        prev_tail = pcm[:, rs:re].copy()
    if not out_chunks:
        raise VorbisError("no audio frames decoded")
    pcm_all = np.concatenate(out_chunks, axis=1)
    if 0 <= final_granule < pcm_all.shape[1]:
        pcm_all = pcm_all[:, :final_granule]
    return pcm_all.T.copy(), setup.rate
