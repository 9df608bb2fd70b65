"""Audio file ingestion (counterpart of the JAX package's
utils/audio_io.py; reference: utils.py:459-482, which uses soundfile and
resampy).

The decoders and the writer are host-side numpy, copied verbatim from the
JAX package (``tests/test_torch_audio_io.py`` holds each copy to the
original): a RIFF/WAVE parser (PCM 8/16/24/32-bit, IEEE float 32/64,
mu-law, A-law, IMA and MS ADPCM), FLAC through utils/flac.py, Ogg Vorbis
through utils/vorbis.py and AIFF/AIFC through ``read_aiff``; soundfile,
where importable, for any other format.  ``read_audio_files`` moves each
mono downmix to the caller's device and resamples, normalizes and
compresses it there (ops/resample.py, ops/signal.py).
"""

from __future__ import annotations

import os
import struct
from typing import List, Tuple

import numpy as np
import torch

from ..ops import signal as sig_ops
from ..ops.resample import resample
from .device import resolve_device

try:  # pragma: no cover - optional dependency
    import soundfile as _soundfile
except Exception:  # pragma: no cover
    _soundfile = None


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a RIFF/WAVE file to (samples (frames, channels) float64, fs).

    Supports PCM 8 (unsigned) / 16 / 24 / 32-bit and IEEE float 32/64.
    Integer formats are scaled to [-1, 1) like soundfile's float output.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise RuntimeError(f"Not a RIFF/WAVE file: {path}")
    pos = 12
    fmt = None
    fmt_body = None
    payload = None
    fact_frames = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            payload = body
        elif chunk_id == b"fact" and size >= 4:
            fact_frames = struct.unpack("<I", body[:4])[0]
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise RuntimeError(f"Missing fmt/data chunk in WAV: {path}")
    audio_format, channels, fs, _, block_align, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # Resolve the real format from the SubFormat GUID's leading code
        # (bytes 24-25 of the fmt chunk): 1 = PCM, 3 = IEEE float.
        if fmt_body is not None and len(fmt_body) >= 26:
            audio_format = struct.unpack("<H", fmt_body[24:26])[0]
        else:
            raise RuntimeError(
                f"Extensible WAV without a SubFormat GUID: {path}")
    if audio_format == 1:  # PCM
        if bits == 8:
            raw = np.frombuffer(payload, np.uint8).astype(np.float64)
            samples = (raw - 128.0) / 128.0
        elif bits == 16:
            samples = np.frombuffer(payload, "<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            b = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) |
                    (b[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            samples = vals.astype(np.float64) / float(1 << 23)
        elif bits == 32:
            samples = np.frombuffer(payload, "<i4").astype(np.float64) / float(1 << 31)
        else:
            raise RuntimeError(f"Unsupported PCM bit depth {bits} in {path}")
    elif audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(payload, dt).astype(np.float64)
    elif audio_format == 6:  # G.711 A-law
        samples = _ALAW[np.frombuffer(payload, np.uint8)].astype(
            np.float64) / 32768.0
    elif audio_format == 7:  # G.711 mu-law
        samples = _MULAW[np.frombuffer(payload, np.uint8)].astype(
            np.float64) / 32768.0
    elif audio_format == 0x11:  # IMA/DVI ADPCM
        frames = _ima_adpcm_decode(payload, channels,
                                   block_align).astype(np.float64) / 32768.0
        if fact_frames is not None:
            frames = frames[:fact_frames]
        return frames, int(fs)
    elif audio_format == 2:  # Microsoft ADPCM
        coefs = _MS_COEFS
        if fmt_body is not None and len(fmt_body) >= 22:
            ncoef = struct.unpack("<H", fmt_body[20:22])[0]
            if ncoef and len(fmt_body) >= 22 + 4 * ncoef:
                coefs = np.frombuffer(fmt_body[22:22 + 4 * ncoef],
                                      "<i2").reshape(ncoef, 2).astype(
                                          np.int64)
        frames = _ms_adpcm_decode(payload, channels, block_align,
                                  coefs).astype(np.float64) / 32768.0
        if fact_frames is not None:
            frames = frames[:fact_frames]
        return frames, int(fs)
    else:
        raise RuntimeError(f"Unsupported WAV format code {audio_format} in {path}")
    frames = samples.reshape(-1, channels)
    return frames, int(fs)


def _mulaw_table() -> np.ndarray:
    """G.711 mu-law byte -> int16-scale PCM (segment/mantissa expansion)."""
    code = np.arange(256, dtype=np.int64) ^ 0xFF
    sign = code & 0x80
    exp = (code >> 4) & 7
    mant = code & 0xF
    mag = (((mant << 3) + 0x84) << exp) - 0x84
    return np.where(sign, -mag, mag).astype(np.int16)


def _alaw_table() -> np.ndarray:
    """G.711 A-law byte -> int16-scale PCM.  Note the sign convention is
    the OPPOSITE of mu-law's: after the 0x55 XOR, a SET 0x80 bit means
    positive (ITU G.711; matches audioop.alaw2lin, pinned in tests)."""
    code = np.arange(256, dtype=np.int64) ^ 0x55
    sign = code & 0x80
    exp = (code >> 4) & 7
    mant = code & 0xF
    mag = np.where(exp == 0, (mant << 4) + 8,
                   ((mant << 4) + 0x108) << np.maximum(exp - 1, 0))
    return np.where(sign, mag, -mag).astype(np.int16)


_MULAW = _mulaw_table()
_ALAW = _alaw_table()

_IMA_STEPS = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767], np.int64)
_IMA_INDEX = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int64)


def _ima_adpcm_decode(payload: bytes, channels: int,
                      block_align: int) -> np.ndarray:
    """IMA/DVI ADPCM (WAV format 0x11): per-block 4-byte channel headers
    (predictor, step index) + nibble groups of 4 bytes per channel.
    Vectorized across blocks; sequential only in the per-block sample
    recurrence."""
    nblocks = len(payload) // block_align
    raw = np.frombuffer(payload[:nblocks * block_align], np.uint8)
    raw = raw.reshape(nblocks, block_align)
    pred = raw[:, :4 * channels].copy().view("<i2").reshape(
        nblocks, channels, 2)[:, :, 0].astype(np.int64)
    index = raw[:, 2:4 * channels:4][:, :channels].astype(np.int64)
    index = np.clip(index, 0, 88)
    body = raw[:, 4 * channels:]
    groups_per_row = body.shape[1] // (4 * channels)
    body = body[:, :groups_per_row * 4 * channels].reshape(
        nblocks, groups_per_row, channels, 4)
    nibbles = np.stack([body & 0xF, body >> 4], axis=-1).reshape(
        nblocks, groups_per_row, channels, 8)
    # (blocks, channels, samples-per-channel-after-header)
    nib = np.transpose(nibbles, (0, 2, 1, 3)).reshape(
        nblocks, channels, groups_per_row * 8).astype(np.int64)
    nsamp = nib.shape[2]
    out = np.empty((nblocks, channels, nsamp + 1), np.int64)
    out[:, :, 0] = pred
    for t in range(nsamp):
        n = nib[:, :, t]
        step = _IMA_STEPS[index]
        diff = (step >> 3) + np.where(n & 1, step >> 2, 0) \
            + np.where(n & 2, step >> 1, 0) + np.where(n & 4, step, 0)
        pred = np.clip(np.where(n & 8, pred - diff, pred + diff),
                       -32768, 32767)
        index = np.clip(index + _IMA_INDEX[n & 7], 0, 88)
        out[:, :, t + 1] = pred
    return np.transpose(out, (0, 2, 1)).reshape(-1, channels)


_MS_ADAPT = np.array([230, 230, 230, 230, 307, 409, 512, 614,
                      768, 614, 512, 409, 307, 230, 230, 230], np.int64)
_MS_COEFS = np.array([[256, 0], [512, -256], [0, 0], [192, 64],
                      [240, 0], [460, -208], [392, -232]], np.int64)


def _ms_adpcm_decode(payload: bytes, channels: int, block_align: int,
                     coefs: np.ndarray) -> np.ndarray:
    """Microsoft ADPCM (WAV format 2).  Block header per channel:
    predictor index (uint8), initial delta (int16), sample1, sample2
    (int16, channel-interleaved); body nibbles are channel-interleaved
    high-nibble-first."""
    nblocks = len(payload) // block_align
    raw = np.frombuffer(payload[:nblocks * block_align], np.uint8)
    raw = raw.reshape(nblocks, block_align)
    ci = np.clip(raw[:, :channels].astype(np.int64), 0, len(coefs) - 1)
    c1 = coefs[ci, 0]
    c2 = coefs[ci, 1]
    hdr = raw[:, channels:7 * channels].copy().view("<i2").reshape(
        nblocks, 3, channels).astype(np.int64)
    delta, s1, s2 = hdr[:, 0], hdr[:, 1], hdr[:, 2]
    body = raw[:, 7 * channels:]
    nib = np.stack([body >> 4, body & 0xF], axis=-1).reshape(
        nblocks, -1).astype(np.int64)
    nsamp = nib.shape[1] // channels
    nib = nib[:, :nsamp * channels].reshape(nblocks, nsamp, channels)
    nib = np.transpose(nib, (0, 2, 1))  # (blocks, channels, samples)
    out = np.empty((nblocks, channels, nsamp + 2), np.int64)
    out[:, :, 0] = s2
    out[:, :, 1] = s1
    for t in range(nsamp):
        n = nib[:, :, t]
        signed = np.where(n >= 8, n - 16, n)
        # C-style truncation toward zero (the format's reference decoders
        # use integer division, not a floor shift — they differ by 1 on
        # negative predictions and the error feeds the recurrence)
        q = out[:, :, t + 1] * c1 + out[:, :, t] * c2
        predicted = np.where(q >= 0, q >> 8, -((-q) >> 8))
        sample = np.clip(predicted + signed * delta, -32768, 32767)
        out[:, :, t + 2] = sample
        delta = np.maximum((_MS_ADAPT[n] * delta) >> 8, 16)
    return np.transpose(out, (0, 2, 1)).reshape(-1, channels)


def _read_extended80(b: bytes) -> float:
    """Decode an 80-bit IEEE 754 extended float (AIFF COMM sample rate):
    1 sign bit, 15 exponent bits (bias 16383), 64-bit explicit-integer-bit
    mantissa."""
    sign_exp, mant = struct.unpack(">HQ", b[:10])
    sign = -1.0 if sign_exp & 0x8000 else 1.0
    exp = sign_exp & 0x7FFF
    if exp == 0 and mant == 0:
        return 0.0
    return sign * float(mant) * 2.0 ** (exp - 16383 - 63)


def read_aiff(path: str) -> Tuple[np.ndarray, int]:
    """Decode an AIFF / AIFF-C file to ((frames, channels) float64, fs).

    Big-endian IFF container: FORM/{AIFF,AIFC}, COMM (channels, numFrames,
    bits, 80-bit extended-float rate [+ compression id for AIFC]), SSND
    (offset, blockSize, payload).  Supports PCM 8/16/24/32 ('NONE'),
    'sowt' (little-endian 16-bit) and 'fl32'/'FL32'/'fl64' floats.
    Closes the reference's soundfile format surface (utils.py:465) for
    AIFF captures alongside WAV and FLAC.
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"FORM" or data[8:12] not in (b"AIFF",
                                                                   b"AIFC"):
        raise RuntimeError(f"Not an AIFF/AIFC file: {path}")
    is_aifc = data[8:12] == b"AIFC"
    pos = 12
    comm = None
    compression = b"NONE"
    ssnd = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        size = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if chunk_id == b"COMM":
            channels, num_frames, bits = struct.unpack(">HIH", body[:8])
            fs = _read_extended80(body[8:18])
            if is_aifc and len(body) >= 22:
                compression = body[18:22]
            comm = (channels, num_frames, bits, fs)
        elif chunk_id == b"SSND":
            offset, _block = struct.unpack(">II", body[:8])
            ssnd = body[8 + offset:]
        pos += 8 + size + (size & 1)
    if comm is None or ssnd is None:
        raise RuntimeError(f"Missing COMM/SSND chunk in AIFF: {path}")
    channels, num_frames, bits, fs = comm
    if compression in (b"NONE", b"sowt"):
        order = "<" if compression == b"sowt" else ">"
        if bits == 8:  # AIFF 8-bit PCM is SIGNED (unlike WAV)
            samples = np.frombuffer(ssnd, np.int8).astype(np.float64) / 128.0
        elif bits == 16:
            samples = np.frombuffer(ssnd, order + "i2").astype(
                np.float64) / 32768.0
        elif bits == 24:
            b3 = np.frombuffer(ssnd, np.uint8)
            b3 = b3[:len(b3) - len(b3) % 3].reshape(-1, 3)
            if compression == b"sowt":
                b3 = b3[:, ::-1]
            vals = ((b3[:, 0].astype(np.int32) << 16)
                    | (b3[:, 1].astype(np.int32) << 8)
                    | b3[:, 2].astype(np.int32))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            samples = vals.astype(np.float64) / float(1 << 23)
        elif bits == 32:
            samples = np.frombuffer(ssnd, order + "i4").astype(
                np.float64) / float(1 << 31)
        else:
            raise RuntimeError(f"Unsupported AIFF bit depth {bits} in {path}")
    elif compression in (b"fl32", b"FL32"):
        samples = np.frombuffer(ssnd, ">f4").astype(np.float64)
    elif compression in (b"fl64", b"FL64"):
        samples = np.frombuffer(ssnd, ">f8").astype(np.float64)
    elif compression in (b"ulaw", b"ULAW"):
        samples = _MULAW[np.frombuffer(ssnd, np.uint8)].astype(
            np.float64) / 32768.0
    elif compression in (b"alaw", b"ALAW"):
        samples = _ALAW[np.frombuffer(ssnd, np.uint8)].astype(
            np.float64) / 32768.0
    else:
        raise RuntimeError(
            f"Unsupported AIFC compression {compression!r} in {path}")
    samples = samples[:num_frames * channels]
    frames = samples.reshape(-1, channels)
    return frames, int(round(fs))


def read_audio_file(path: str) -> Tuple[np.ndarray, int]:
    """Read one audio file to (frames, channels) float64 + sample rate.
    WAV, FLAC (utils/flac.py) and AIFF/AIFC decode self-contained;
    anything else falls back to soundfile when importable."""
    lower = path.lower()
    if lower.endswith(".flac"):
        from .flac import read_flac
        return read_flac(path)
    if lower.endswith((".ogg", ".oga")):
        from .vorbis import read_ogg
        return read_ogg(path)
    if lower.endswith((".aiff", ".aif", ".aifc")):
        return read_aiff(path)
    if lower.endswith(".wav"):
        return read_wav(path)
    if _soundfile is None:
        if lower.endswith((".mp3", ".opus", ".m4a", ".aac", ".wma")):
            raise RuntimeError(
                f"{path}: {os.path.splitext(path)[1]} requires the optional "
                "soundfile package (not importable here); native decoders "
                "cover .wav/.flac/.ogg/.aiff")
        return read_wav(path)  # unknown extension: try RIFF, error cleanly
    data, fs = _soundfile.read(path, always_2d=True)  # pragma: no cover
    return np.asarray(data, np.float64), int(fs)

def read_audio_files(audio_files: List[str], expected_fs: float,
                     dtype=None, device=None) -> List[torch.Tensor]:
    """Read, mono-downmix (the channel mean, on the host in float64),
    move to ``device`` in ``dtype`` (default: torch's default dtype), then
    resample to ``expected_fs``, normalize and compress there, as
    utils.py:459-482 does, with its error contract: FileNotFoundError for
    a missing file, RuntimeError wrapping any other failure.  ``device``
    defaults to ``cuda`` (utils/device.resolve_device)."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else torch.get_default_dtype()
    signals = []
    for path in audio_files:
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Audio file not found: {path}")
        try:
            frames, fs = read_audio_file(path)
            mono = frames.mean(axis=1) if frames.shape[1] > 1 else frames[:, 0]
            sig = torch.as_tensor(mono, dtype=dt, device=dev)
            if fs != expected_fs:
                sig = resample(sig, fs, expected_fs)
            sig = sig_ops.dynamic_range_compression(
                sig_ops.normalize_signal(sig))
            signals.append(sig)
        except FileNotFoundError:
            raise
        except Exception as e:
            raise RuntimeError(
                f"Error reading audio file '{path}': {e}") from e
    return signals


def write_wav(path: str, samples, fs: float, bits: int = 16) -> None:
    """Write (frames,) or (frames, channels) samples in [-1, 1] as a RIFF
    WAV: 16-bit PCM (default) or 32-bit IEEE float.  Companion to
    ``read_wav`` (the reference has no writer — soundfile covers it there)."""
    arr = np.asarray(samples, np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    frames, channels = arr.shape
    if bits == 16:
        fmt_code, bytes_per = 1, 2
        payload = np.clip(np.round(arr * 32767.0), -32768, 32767).astype(
            "<i2").tobytes()
    elif bits == 32:
        fmt_code, bytes_per = 3, 4
        payload = arr.astype("<f4").tobytes()
    else:
        raise ValueError("bits must be 16 (PCM) or 32 (IEEE float)")
    byte_rate = int(fs) * channels * bytes_per
    block_align = channels * bytes_per
    fmt = struct.pack("<HHIIHH", fmt_code, channels, int(fs), byte_rate,
                      block_align, bits)
    chunks = (b"WAVE"
              + b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"data" + struct.pack("<I", len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(chunks)) + chunks)
