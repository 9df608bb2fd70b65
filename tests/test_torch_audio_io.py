"""Recorded audio in the port against the JAX package: the decoders (every
WAV format, AIFF, FLAC, Ogg Vorbis) equal on the same bytes and as source
text, the chunked Kaiser-sinc resampler within 1e-12 relative,
``read_audio_files`` on a mixed-format, mixed-rate set within 1e-12 with
its error contract, and ``localize_sound_source`` from files
(``use_simulation=False``) in physical mode (TDOAs within 1e-9 s, the
position within 1e-6 m) and in parity mode with the pre-sync (float64,
small sizes)."""

import copy
import inspect
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyaudiolocalization_tpu as jpkg
import pyaudiolocalization_tpu_torch as tpkg
from pyaudiolocalization_tpu.models.simulator import simulate_signals_fast
from pyaudiolocalization_tpu.ops import resample as jres
from pyaudiolocalization_tpu.utils import audio_io as jaio
from pyaudiolocalization_tpu.utils.flac import write_flac
from pyaudiolocalization_tpu_torch.ops import resample as tres
from pyaudiolocalization_tpu_torch.utils import audio_io as taio

DATA = os.path.join(os.path.dirname(__file__), "data")
RTOL = 1e-12


def _rel_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * float(np.max(np.abs(want))))


def _wav_bytes(fmt_code, channels, fs, bits, block_align, payload,
               fact=None, fmt_extra=b""):
    fmt = struct.pack("<HHIIHH", fmt_code, channels, fs,
                      fs * max(block_align, 1), block_align, bits) + fmt_extra
    chunks = b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
    if fact is not None:
        chunks += b"fact" + struct.pack("<II", 4, fact)
    chunks += b"data" + struct.pack("<I", len(payload)) + payload
    return b"RIFF" + struct.pack("<I", len(chunks)) + chunks


def _wav_cases():
    """(name, file bytes) of every format the decoder takes."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, (300, 2))
    codes = rng.integers(0, 256, 600, dtype=np.uint8)
    pcm24 = np.round(x * (1 << 23)).astype(np.int32).reshape(-1)
    b24 = np.stack([pcm24 & 0xFF, (pcm24 >> 8) & 0xFF, (pcm24 >> 16) & 0xFF],
                   -1).astype(np.uint8)
    ima_align = 4 + 8 * 2
    ms_align = 7 + 16
    ms = bytearray(rng.integers(0, 256, 2 * ms_align, dtype=np.uint8))
    ms[0] = ms[ms_align] = 0
    guid = struct.pack("<HHI", 22, 16, 0) + struct.pack("<H", 3) + bytes(14)
    return {
        "pcm8": _wav_bytes(1, 2, 8000, 8, 2, codes.tobytes()),
        "pcm16": _wav_bytes(1, 2, 16000, 16, 4, np.round(
            x * 32767).astype("<i2").tobytes()),
        "pcm24": _wav_bytes(1, 2, 22050, 24, 6, b24.tobytes()),
        "pcm32": _wav_bytes(1, 2, 44100, 32, 8, np.round(
            x * 2 ** 31).astype("<i4").tobytes()),
        "float32": _wav_bytes(3, 2, 48000, 32, 8, x.astype("<f4").tobytes()),
        "float64": _wav_bytes(3, 2, 48000, 64, 16, x.astype("<f8").tobytes()),
        "mulaw": _wav_bytes(7, 2, 8000, 8, 2, codes.tobytes()),
        "alaw": _wav_bytes(6, 2, 8000, 8, 2, codes.tobytes()),
        "ima_adpcm": _wav_bytes(0x11, 1, 8000, 4, ima_align, bytes(
            rng.integers(0, 256, 2 * ima_align, dtype=np.uint8)), fact=20),
        "ms_adpcm": _wav_bytes(2, 1, 8000, 4, ms_align, bytes(ms)),
        "extensible_float": _wav_bytes(0xFFFE, 2, 48000, 32, 8,
                                       x.astype("<f4").tobytes(),
                                       fmt_extra=guid),
    }


@pytest.mark.parametrize("name", sorted(_wav_cases()))
def test_read_wav_equals_jax(tmp_path, name):
    path = str(tmp_path / f"{name}.wav")
    with open(path, "wb") as f:
        f.write(_wav_cases()[name])
    want, want_fs = jaio.read_audio_file(path)
    got, got_fs = taio.read_audio_file(path)
    assert got_fs == want_fs and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _aiff(path, data, fs):
    """A 16-bit AIFF (big-endian IFF) of interleaved ``data``."""
    exp = int(np.floor(np.log2(fs)))
    rate = struct.pack(">HQ", exp + 16383, int(fs / 2.0 ** (exp - 63)))
    payload = np.round(data * 32767).astype(">i2").tobytes()
    comm = struct.pack(">HIH", 2, data.size // 2, 16) + rate
    ssnd = struct.pack(">II", 0, 0) + payload
    body = (b"AIFF" + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


def test_aiff_flac_and_vorbis_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.uniform(-0.9, 0.9, (400, 2))
    paths = [str(tmp_path / "a.aiff"), str(tmp_path / "a.flac"),
             os.path.join(DATA, "house_lo.ogg")]
    _aiff(paths[0], x.reshape(-1), 22050)
    write_flac(paths[1], x, 16000)
    for path in paths:
        want, want_fs = jaio.read_audio_file(path)
        got, got_fs = taio.read_audio_file(path)
        assert got_fs == want_fs
        np.testing.assert_array_equal(got, want)
    golden = np.load(os.path.join(DATA, "house_lo_golden.npz"))
    assert got.shape[0] == golden[golden.files[0]].shape[0]


@pytest.mark.parametrize("name", ["read_wav", "_mulaw_table", "_alaw_table",
                                  "_ima_adpcm_decode", "_ms_adpcm_decode",
                                  "_read_extended80", "read_aiff",
                                  "read_audio_file", "write_wav"])
def test_decoders_are_copies(name):
    assert inspect.getsource(getattr(taio, name)) == \
        inspect.getsource(getattr(jaio, name))
    for table in ("_IMA_STEPS", "_IMA_INDEX", "_MS_ADAPT", "_MS_COEFS"):
        np.testing.assert_array_equal(getattr(taio, table),
                                      getattr(jaio, table))


def test_write_wav_round_trips(tmp_path):
    x = np.random.default_rng(2).uniform(-1, 1, (200, 3))
    for bits in (16, 32):
        path = str(tmp_path / f"w{bits}.wav")
        taio.write_wav(path, x, 44100, bits=bits)
        frames, fs = taio.read_audio_file(path)
        assert fs == 44100
        # 16-bit: written as round(32767 x), read back over 32768.
        np.testing.assert_allclose(frames, x, atol=2 / 32767 if bits == 16
                                   else 1e-7)
    with pytest.raises(ValueError, match="bits"):
        taio.write_wav(str(tmp_path / "bad.wav"), x, 44100, bits=24)


@pytest.mark.parametrize("sr_orig,sr_new", [(48000.0, 44100.0),
                                            (44100.0, 16000.0),
                                            (16000.0, 48000.0)])
def test_resample_matches_jax(sr_orig, sr_new, monkeypatch):
    """Within 1e-12 relative, in one chunk and in chunks of 37 output
    samples (boundaries inside the row: the chunking changes no value);
    the output keeps the input's dtype and leading axes."""
    x = np.random.default_rng(3).standard_normal((2, 1500))
    want = np.asarray(jres.resample(jnp.asarray(x), sr_orig, sr_new))
    whole = tres.resample(torch.tensor(x), sr_orig, sr_new)
    assert whole.shape == want.shape and whole.dtype == torch.float64
    _rel_close(whole, want)
    taps = 2 * int(np.ceil(64 / min(1.0, sr_new / sr_orig))) + 1
    monkeypatch.setattr(tres, "CHUNK_BYTES",
                        37 * taps * (tres._WEIGHT_BYTES + 2 * 8 * 2))
    chunked = tres.resample(torch.tensor(x), sr_orig, sr_new)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    single = tres.resample(torch.tensor(x[0]).float(), sr_orig, sr_new)
    assert single.dtype == torch.float32
    # float32 samples and weights, float64 positions: within 1e-5.
    np.testing.assert_allclose(single.numpy(), want[0], rtol=0, atol=1e-5)
    same = torch.tensor(x)
    assert tres.resample(same, sr_orig, sr_orig) is same


@pytest.mark.parametrize("seconds", [1, 4])
def test_float32_resample_keeps_its_positions_exact(seconds):
    """A 1 -> 5 kHz chirp at 48 kHz resampled to 44.1 kHz in float32: the
    JAX package's float32 path (positions in float32) departs from its
    float64 answer by more than 1e-3 (1.6e-3 at 1 s, 6.6e-3 at 4 s: n *
    2^-24 samples of position error), the port's (float64 positions,
    float32 weights and sums) stays within 2e-5 of it."""
    fs = 48000
    t = np.arange(fs * seconds) / fs
    x = np.sin(2 * np.pi * (1000 * t + 2000 * t * t / seconds))
    exact = np.asarray(jres.resample(jnp.asarray(x), 48000.0, 44100.0))
    jax32 = np.asarray(jres.resample(jnp.asarray(x, jnp.float32), 48000.0,
                                     44100.0))
    port32 = tres.resample(torch.tensor(x, dtype=torch.float32), 48000.0,
                           44100.0)
    assert np.max(np.abs(jax32 - exact)) > 1e-3
    assert port32.dtype == torch.float32
    assert np.max(np.abs(port32.numpy() - exact)) < 2e-5


def _mixed_files(tmp_path, signals, rates):
    """One file a channel: 16-bit WAV, float WAV, FLAC, AIFF."""
    paths = []
    for k, (sig, fs) in enumerate(zip(signals, rates)):
        kind = ("pcm16.wav", "float.wav", "flac", "aiff")[k % 4]
        path = str(tmp_path / f"mic{k}.{kind.split('.')[-1]}")
        if kind == "pcm16.wav":
            jaio.write_wav(path, sig, fs)
        elif kind == "float.wav":
            jaio.write_wav(path, np.stack([sig, 0.5 * sig], -1), fs,
                           bits=32)
        elif kind == "flac":
            write_flac(path, sig, fs)
        else:
            _aiff(path, np.stack([sig, sig], -1).reshape(-1), fs)
        paths.append(path)
    return paths


def test_read_audio_files_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    rates = (48000, 44100, 16000, 22050)
    sigs = [0.8 * np.sin(2 * np.pi * 440 * np.arange(int(fs * 0.05)) / fs)
            + 0.05 * rng.standard_normal(int(fs * 0.05)) for fs in rates]
    paths = _mixed_files(tmp_path, sigs, rates)
    want = jaio.read_audio_files(paths, 16000.0)
    got = taio.read_audio_files(paths, 16000.0, device="cpu",
                                dtype=torch.float64)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and g.dtype == torch.float64
        _rel_close(g, w)
    assert taio.read_audio_files(paths[:1], 16000.0,
                                 device="cpu")[0].dtype == torch.float32
    with pytest.raises(FileNotFoundError):
        taio.read_audio_files([str(tmp_path / "missing.wav")], 16000.0,
                              device="cpu")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a riff file at all")
    with pytest.raises(RuntimeError, match="bad.wav"):
        taio.read_audio_files([str(bad)], 16000.0, device="cpu")
    with pytest.raises(RuntimeError, match="soundfile|mp3"):
        mp3 = tmp_path / "x.mp3"
        mp3.write_bytes(b"ID3")
        if taio._soundfile is not None:
            pytest.skip("soundfile is importable here")
        taio.read_audio_files([str(mp3)], 16000.0, device="cpu")


def _config(lag_mode):
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=[0.2, 0.6, 0.4],
               signal_type="chirp")
    cfg["localization"].update(
        lag_mode=lag_mode, max_reflections=1, num_bootstrap=64,
        visualize_correlation=False,
        sync_mode="none" if lag_mode == "physical" else "reference")
    return cfg


def _recorded(tmp_path, cfg, file_fs=16000):
    """The JAX package's off-centre scene rendered at ``file_fs``, one file
    a mic in mixed formats."""
    scene = jpkg.SceneConfig.from_dict(cfg)
    sigs = np.asarray(simulate_signals_fast(
        scene.source_position, scene.mic_positions, float(file_fs), 343.0,
        scene.duration, "noise", scene.freq, scene.plane_coeffs,
        scene.plane_material_ids, scene.materials.absorption,
        scene.materials.freq, 1, 0.01, key=jax.random.PRNGKey(3),
        dtype=jnp.float64))
    return _mixed_files(tmp_path, list(0.9 * sigs), [file_fs] * len(sigs))


@pytest.mark.parametrize("lag_mode", ["physical", "reference"])
def test_api_from_files_matches_jax(tmp_path, monkeypatch, lag_mode):
    """Physical mode: TDOAs within 1e-9 s and the position within 1e-6 m;
    parity mode (with the pre-sync): the TDOAs and the position of the
    same LM -> DE chain.  ``actual_position`` is None.  The scene is in the
    working directory's figure only for parity mode."""
    monkeypatch.chdir(tmp_path)
    cfg = _config(lag_mode)
    paths = _recorded(tmp_path, cfg)
    want = jpkg.localize_sound_source(cfg, audio_files=paths,
                                      use_simulation=False,
                                      dtype=jnp.float64)
    got = tpkg.localize_sound_source(cfg, audio_files=paths,
                                     use_simulation=False, device="cpu",
                                     dtype=torch.float64)
    assert got["actual_position"] is None and want["actual_position"] is None
    assert np.any(np.abs(want["tdoas"]) > 0)
    np.testing.assert_allclose(got["tdoas"], want["tdoas"], rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got["estimated_position"],
                               want["estimated_position"], rtol=0,
                               atol=1e-6)
    for pair, w in want["correlation_metrics"].items():
        g = got["correlation_metrics"][pair]
        np.testing.assert_allclose(g["snr"], w["snr"], rtol=1e-7)


def test_api_at_2_20_from_a_long_recording_matches_jax(tmp_path,
                                                      monkeypatch):
    """A 4-mic recording at 44.1 kHz (no resampling) of 12 s, whose GCC
    under ``DEFAULT_CONFIG`` (``max_expected_delay`` 0.05: the circular
    next_pow2(n)) transforms at 2^20, where K1's and K2's GCC go through
    the mic rows' spectra on the card: the full core without the bootstrap
    (float64, ``analyze_correlation`` off, so no fast path) and then the
    windowed fast path (float32), the port against the JAX package on the
    same files: TDOAs within 0.05 samples, positions within 5 mm."""
    from pyaudiolocalization_tpu_torch.utils.audio_io import write_wav
    monkeypatch.chdir(tmp_path)
    fs = 44100
    cfg = copy.deepcopy(jpkg.DEFAULT_CONFIG)
    cfg.update(fs=fs, duration=12.0, source_position=[0.2, 0.6, 0.4])
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               analyze_correlation=False,
                               visualize_correlation=False)
    scene = jpkg.SceneConfig.from_dict(cfg)
    sigs = np.asarray(simulate_signals_fast(
        scene.source_position, scene.mic_positions, float(fs), 343.0,
        scene.duration, "noise", scene.freq, scene.plane_coeffs,
        scene.plane_material_ids, scene.materials.absorption,
        scene.materials.freq, 1, 0.01, key=jax.random.PRNGKey(20),
        dtype=jnp.float64))
    n = sigs.shape[-1]
    assert tpkg.api._physical_nfft(n, fs, 0.05) == 1 << 20
    paths = []
    for k, x in enumerate(sigs):
        paths.append(str(tmp_path / f"mic{k + 1}.wav"))
        write_wav(paths[-1], 0.9 * x / np.max(np.abs(x)), fs)
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        want = jpkg.localize_sound_source(cfg, audio_files=paths,
                                          use_simulation=False, dtype=jdt)
        got = tpkg.localize_sound_source(cfg, audio_files=paths,
                                         use_simulation=False, device="cpu",
                                         dtype=tdt)
        assert np.any(np.abs(want["tdoas"]) > 0)
        np.testing.assert_allclose(np.asarray(got["tdoas"]) * fs,
                                   np.asarray(want["tdoas"]) * fs, rtol=0,
                                   atol=0.05)
        np.testing.assert_allclose(got["estimated_position"],
                                   want["estimated_position"], rtol=0,
                                   atol=5e-3)


def test_api_audio_file_errors(tmp_path):
    cfg = _config("physical")
    with pytest.raises(ValueError, match="Audio files must be provided"):
        tpkg.localize_sound_source(cfg, use_simulation=False, device="cpu")
    with pytest.raises(ValueError, match="number of audio files"):
        tpkg.localize_sound_source(cfg, use_simulation=False, device="cpu",
                                   audio_files=["a.wav"])
    with pytest.raises(FileNotFoundError):
        tpkg.localize_sound_source(cfg, use_simulation=False, device="cpu",
                                   audio_files=[str(tmp_path / "a.wav")] * 4)


def test_recorded_fixture_matches_its_golden():
    """tests/data/recorded/ (the files chip_smoke.py reads on the card) are
    the bytes tests/data/torch_recorded_golden.json records, and the port
    reads them on the CPU in float64 to the golden's channels within 1e-12
    (64 points and the norm of each)."""
    import hashlib
    import json
    golden = json.load(open(os.path.join(DATA,
                                         "torch_recorded_golden.json")))
    paths = [os.path.join(DATA, "recorded", f["name"])
             for f in golden["files"]]
    for path, f in zip(paths, golden["files"]):
        with open(path, "rb") as fh:
            assert hashlib.sha256(fh.read()).hexdigest() == f["sha256"]
    rows = taio.read_audio_files(paths, golden["fs"], dtype=torch.float64,
                                 device="cpu")
    for row, want in zip(rows, golden["channels"]):
        got = row.numpy()[want["index"]]
        np.testing.assert_allclose(got, want["samples"], rtol=0, atol=1e-12)
        assert abs(np.linalg.norm(row.numpy()) - want["norm"]) \
            <= 1e-12 * want["norm"]
