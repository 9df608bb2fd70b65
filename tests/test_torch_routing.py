"""Which kernel launches a path reaches, and with which schedule, checked on
the CPU: the wrappers' CUDA branch is forced (``cuda_fft._use_plain``
returns False), the kernel library is a stub, and every launch through
``cuda_fft._launch`` is recorded with its arguments instead of run.  The
outputs are left as allocated, so these tests read the launches only.

They hold the split of all eight transforming kernels up to 2^26 (strips
of 8 at 2,048, of 4 at 4,096, of 2 at 8,192), above that one limit the
three-pass split of all eight (``long_plan``), the byte cap on the
split's scratch (``_launch_rows``, ``scene_chunk``, ``_scene_bytes``),
the GCC routes of K1, K2 and K5 (``gcc_route``: one block a scene,
``gcc_rows``, the mic rows' spectra on the split and in one block, the
three-pass split) on both sides of every fit limit, K3's render through
the base rows' spectra from 2^20 (on the three-pass split above 2^26)
with its finish spread over the card, the row chunks of K4a, K4b, K6
and K9, the scene chunks of K1, K2, K3 and K5 at the sweep's 65,535 grid
limit and under the byte cap at 2^25 to 2^27, their one-block schedules
up to 4,096 points and
their scratch, the exact-length parity path (K7 only), the api from
recorded files (K1, K4a, K4b), the compat layer's single pair (K4a + K9
at a power of two, K7 otherwise), the api from a recording long enough
for K1 at 2^21 (one launch on the split), array calibration (K1 over the
events at a power of two, K7 at the exact length) and beamformed
extraction (no kernel).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pyaudiolocalization_tpu_torch.models import tdoa as ttdoa
from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
from pyaudiolocalization_tpu_torch.parallel import sweep as tsw


class _StubLibrary:
    """Any ``palt_*`` entry; never called (``_launch`` is stubbed)."""

    def __getattr__(self, name):
        return name


@pytest.fixture
def launches(monkeypatch):
    """(name, args) of every launch, in order, with the CUDA branch forced
    on CPU tensors and scratch buffers shrunk to a stub."""
    calls = []

    def launch(name, device, entry, *args):
        cf.LAUNCHES[name] += 1
        calls.append((name, args))

    monkeypatch.setattr(cf, "_use_plain", lambda *tensors: False)
    monkeypatch.setattr(cf, "_library", _StubLibrary)
    monkeypatch.setattr(cf, "_launch", launch)
    monkeypatch.setattr(cf, "_scratch", lambda rows, nfft, device:
                        torch.empty((1, 1, 2), device=device))
    cf.reset_launches()
    yield calls
    cf.reset_launches()


def _named(calls, name):
    return [args for n, args in calls if n == name]


def _no_tables(monkeypatch):
    """Stubs the twiddle tables (``cuda_fft._twiddles``,
    ``_long_twiddles``), which no launch here reads: at 2^26 and 2^27 they
    are 2^25 to 2^26 entries, built in float64."""
    for name in ("_twiddles", "_long_twiddles"):
        monkeypatch.setattr(cf, name, lambda nfft, device: torch.empty(
            (1, 2), device=device))


# ---------------------------------------------------------------------------
# K4a, K4b and K6 above 2^20: the split to 2^26, the three-pass split above
# ---------------------------------------------------------------------------

def test_spectrum_above_2_20_launches_k4a_on_the_radix2_passes(launches):
    """sig1's spectrum at nfft 2^21 (the bootstrap of a 23.7 s recording at
    44.1 kHz) reaches one K4a launch of its half-length transform
    (``half_plan``): 2^20 points on the split, n1 = 1,024, with strips of
    16 columns and pass-2 strips of 16 rows."""
    sig = torch.zeros(1_046_019)
    spec = ttdoa._spectrum(sig, 1 << 21)
    assert spec.shape == ((1 << 20) + 1,) and spec.dtype == torch.complex64
    (args,) = _named(launches, "fft_real")
    rows, length, nfft, n1, cols, s2, n1a, half = args[1:9]
    assert (rows, length, nfft, n1) == (1, 1_046_019, 1 << 21, 1024)
    assert (cols, s2, n1a, half) == (16, 16, 0, 1)
    assert [n for n, _ in launches] == ["fft_real"]


@pytest.mark.parametrize("length,bits,n1,strips", [
    (4_200_000, 23, 2048, (8, 8, 0)), (8_400_000, 24, 4096, (16, 8, 64))])
def test_spectrum_at_2_23_and_2_24_launches_k4a_on_the_split(
        launches, length, bits, n1, strips):
    """sig1's spectrum at nfft 2^23 (a 47.5 s recording at 44.1 kHz under
    ``max_expected_delay=None``) and 2^24 (95 s) reaches one K4a launch of
    its half-length transform: 2^22 points on the split (2,048 x 2,048,
    strips of 8 columns and pass-2 strips of 8 rows), and 2^23 on the
    three-pass split from ``HALF_LONG_MIN`` (64 x 64 x 2,048, 16 columns,
    8 rows)."""
    spec = ttdoa._spectrum(torch.zeros(length), 1 << bits)
    assert spec.shape == ((1 << (bits - 1)) + 1,)
    (args,) = _named(launches, "fft_real")
    assert args[1:5] == (1, length, 1 << bits, n1)
    assert args[5:9] == strips + (1,)
    assert [n for n, _ in launches] == ["fft_real"]


def test_spectrum_above_2_22_launches_k4a_on_the_radix2_passes(launches,
                                                              monkeypatch):
    """At nfft 2^27, past K4a's two-pass split (``FFT_SPLIT_MAX``, 2^24),
    K4a's one launch of its half-length transform takes the three-pass
    split of 2^26 points, not the radix-2 passes: n1 = 32,768 = 256 x 128
    (n1a = 256) with n2 = 2,048, column strips of 16 and pass-2 strips of
    8 rows."""
    _no_tables(monkeypatch)
    spec = ttdoa._spectrum(torch.zeros(600_000), 1 << 27)
    assert spec.shape == ((1 << 26) + 1,)
    (args,) = _named(launches, "fft_real")
    assert args[1:5] == (1, 600_000, 1 << 27, 32768)
    assert args[5:9] == (16, 8, 256, 1)
    assert [n for n, _ in launches] == ["fft_real"]


@pytest.mark.parametrize("mode,kernel", [("permutation", "bootstrap_peaks"),
                                         ("noise", "noise_bootstrap_peaks")])
def test_bootstrap_at_2_21_runs_both_nulls_on_the_passes(launches, mode,
                                                         kernel):
    """bootstrap_significance at nfft 2^21 with each null: K4a (sig1's
    half-length transform: 2^20 points, n1 = 1,024, 16 columns) and K4b
    (or K6) on the split, n1 = 2,048, with strips of 8 columns and 8 rows
    (``boot_strip``)."""
    gen = torch.Generator().manual_seed(0)
    sig1 = torch.randn(600_000, generator=gen)
    sig2 = torch.randn(600_000, generator=gen)
    ttdoa.bootstrap_significance(sig1, sig2, gen, num_bootstrap=4,
                                 bootstrap_mode=mode, nfft=1 << 21)
    assert [n for n, _ in launches] == ["fft_real", kernel]
    assert _named(launches, "fft_real")[0][4:6] == (1024, 16)
    (args,) = _named(launches, kernel)
    # (.., rows, length or n_samp, nfft, n1, column strip, row strip, ..)
    assert args[2:8] == (4, 600_000, 1 << 21, 2048, 8, 8)


@pytest.mark.parametrize("bits,n1,strips,half", [
    (23, 2048, (8, 2), (2048, 8)), (24, 4096, (4, 2), (4096, 16))])
@pytest.mark.parametrize("mode,kernel", [("permutation", "bootstrap_peaks"),
                                         ("noise", "noise_bootstrap_peaks")])
def test_bootstrap_at_2_23_and_2_24_runs_both_nulls_on_the_split(
        launches, monkeypatch, mode, kernel, bits, n1, strips, half):
    """At nfft 2^23 and 2^24 both nulls run K4a (sig1's half-length
    transform: 2^22 points on the split, 2^23 on the three-pass split)
    and K4b (or K6) on the split, the long side in the rows: 2,048 x 4,096
    with strips of 8 columns and 2 rows, 4,096 x 4,096 with 4 and 2; one
    buffer of the packed rows (no ping-pong copy), K4a's of one packed row
    of half the points."""
    gen = torch.Generator().manual_seed(0)
    sig1 = torch.randn(600_000, generator=gen)
    sig2 = torch.randn(600_000, generator=gen)
    scratch = []
    stub = cf._scratch
    monkeypatch.setattr(cf, "_scratch", lambda rows, nfft, device: (
        scratch.append((rows, nfft)) or stub(rows, nfft, device)))
    ttdoa.bootstrap_significance(sig1, sig2, gen, num_bootstrap=4,
                                 bootstrap_mode=mode, nfft=1 << bits)
    assert [n for n, _ in launches] == ["fft_real", kernel]
    assert _named(launches, "fft_real")[0][4:6] == half
    (args,) = _named(launches, kernel)
    # (.., rows, length or n_samp, nfft, n1, column strip, row strip, ..)
    assert args[2:8] == (4, 600_000, 1 << bits, n1) + strips
    assert scratch == [(1, 1 << (bits - 1)), (2, 1 << bits)]


@pytest.mark.parametrize("mode,kernel", [("permutation", "bootstrap_peaks"),
                                         ("noise", "noise_bootstrap_peaks")])
def test_bootstrap_above_2_22_runs_both_nulls_on_the_passes(
        launches, monkeypatch, mode, kernel):
    """At nfft 2^27, past K4a's, K4b's and K6's two-pass split (2^24),
    both nulls run K4a (sig1's half-length transform: 2^26 points, n1 =
    32,768, n1a = 256, 16 columns, 8 rows) and K4b (or K6) on the
    three-pass split, not the radix-2 passes: n1 = 65,536, column strips
    of 16, row strips of 2, n1a = 256, one buffer of the packed rows (no
    ping-pong copy)."""
    _no_tables(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    sig1 = torch.randn(600_000, generator=gen)
    sig2 = torch.randn(600_000, generator=gen)
    scratch = []
    stub = cf._scratch
    monkeypatch.setattr(cf, "_scratch", lambda rows, nfft, device: (
        scratch.append((rows, nfft)) or stub(rows, nfft, device)))
    ttdoa.bootstrap_significance(sig1, sig2, gen, num_bootstrap=4,
                                 bootstrap_mode=mode, nfft=1 << 27)
    assert [n for n, _ in launches] == ["fft_real", kernel]
    assert _named(launches, "fft_real")[0][4:9] == (32768, 16, 8, 256, 1)
    (args,) = _named(launches, kernel)
    # (.., rows, length or n_samp, nfft, n1, column strip, row strip, n1a)
    assert args[2:9] == (4, 600_000, 1 << 27, 65536, 16, 2, 256)
    assert scratch == [(1, 1 << 26), (2, 1 << 27)]


@pytest.mark.parametrize("nfft,n1,strips", [
    (4096, 1, (0, 0)), (1 << 16, 256, (16, 16)), (1 << 20, 1024, (16, 16)),
    (1 << 21, 2048, (8, 16)), (1 << 22, 2048, (8, 8)),
    (1 << 23, 2048, (8, 4)), (1 << 24, 4096, (4, 4)),
    (1 << 25, 16384, (16, 8)), (1 << 26, 32768, (16, 8)),
    (1 << 27, 65536, (16, 8))])
def test_fft_real_schedule_by_length(launches, monkeypatch, nfft, n1,
                                     strips):
    """K4a's n1 (``_split_n1``) and the strips of its passes on a pair of
    rows: 16 and 16 up to 2^20, 8 columns from n1 = 2,048 and 8 rows at
    n2 = 2,048, 4 rows at n2 = 4,096 (2^23), 4 columns at n1 = 4,096
    (2^24); one block (n1 = 1) reads neither and gets 0; above 2^24 the
    three-pass split, n1 = nfft / 2,048 = n1a x n1b (16,384 = 128 x 128 at
    2^25, 32,768 = 256 x 128 at 2^26, 65,536 = 256 x 256 at 2^27), its
    column passes' 16 columns and pass 2's 8 rows.  n1a is 0 up to
    2^24."""
    _no_tables(monkeypatch)
    cf.fft_real(torch.zeros(2, 100), nfft)
    (args,) = _named(launches, "fft_real")
    assert args[3:5] == (nfft, n1)
    assert args[5:7] == strips
    assert args[7] == (cf.long_plan(nfft).n1a if nfft > cf.FFT_SPLIT_MAX
                       else 0)
    assert args[8] == 0                                   # two rows packed


def _route(kernel, nfft, length=None):
    """Calls ``kernel`` once at nfft on 4 mics a scene (or one row pair) of
    ``length`` samples (nfft / 2 + 100 by default)."""
    from pyaudiolocalization_tpu_torch.parallel.sweep import _pairs
    pi, pj = _pairs(4)
    length = length or nfft // 2 + 100
    mask = torch.ones(nfft // 2 + 1)
    base, fade = torch.zeros(1, length), torch.ones(length)
    tau, gains = torch.zeros(1, 4, 1), torch.ones(1, 4, 1)
    spec = torch.zeros(1, nfft // 2 + 1, dtype=torch.complex64)
    calls = {
        "gcc_all_pairs": lambda: cf.gcc_all_pairs(
            torch.zeros(1, 4, length), pi, pj, nfft, mask),
        "gcc_windowed": lambda: cf.gcc_windowed(
            torch.zeros(1, 4, length), pi, pj, nfft, 1, mask),
        "delay_sum": lambda: cf.delay_sum(base, tau, gains, nfft, length,
                                          fade, True),
        "scene_windowed": lambda: cf.scene_windowed(
            base, tau, gains, pi, pj, nfft, length, 1, fade, mask),
        "whitened_corr": lambda: cf.whitened_corr(spec, spec, mask, nfft)}
    calls[kernel]()


# Where each kernel's n1 sits in its launch's arguments.
N1_ARGS = {"gcc_all_pairs": slice(4, 6), "gcc_windowed": slice(4, 6),
           "delay_sum": slice(7, 9), "scene_windowed": slice(7, 10),
           "whitened_corr": slice(3, 5)}


@pytest.mark.parametrize("kernel,nfft,n1", [
    (k, n, n1) for k in ("gcc_windowed", "scene_windowed", "gcc_all_pairs")
    for n, n1 in ((1 << 20, 1024), (1 << 21, 2048), (1 << 22, 2048))] + [
    ("delay_sum", n, n1) for n, n1 in ((1 << 20, 1024), (1 << 21, 2048),
                                       (1 << 22, 2048))] + [
    ("gcc_all_pairs", 1 << 23, 2048), ("gcc_windowed", 1 << 23, 2048),
    ("scene_windowed", 1 << 23, 2048),
    ("whitened_corr", 1 << 20, 1024), ("whitened_corr", 1 << 21, 2048),
    ("whitened_corr", 1 << 22, 2048), ("whitened_corr", 1 << 23, 2048)] + [
    (k, 1 << 24, 4096) for k in ("gcc_all_pairs", "gcc_windowed",
                                 "scene_windowed", "delay_sum",
                                 "whitened_corr")] + [
    ("delay_sum", 1 << 23, 2048)] + [
    (k, 1 << 25, 16384) for k in ("gcc_all_pairs", "gcc_windowed",
                                  "scene_windowed", "delay_sum",
                                  "whitened_corr")])
def test_other_kernels_keep_their_routes_above_2_20(launches, kernel, nfft,
                                                    n1):
    """K9's split, the GCCs' of K1, K2 and K5 (4 mics a scene) and the
    renders of K3 and K5 take the split of K4a, K4b and K6
    (``FFT_SPLIT_MAX``): n1 = 1,024 at 2^20, 2,048 from 2^21 to 2^23 and
    4,096 at 2^24, the GCCs through their mic rows' spectra and the
    renders through their base rows' spectra (``render_route``); at 2^25
    the three-pass split through them, n1 = 16,384, as K4a's (its other
    lengths are ``test_spectra_routes_reach_2_26``'s)."""
    _route(kernel, nfft)
    (args,) = _named(launches, kernel)
    if kernel == "scene_windowed":
        assert args[7:10] == (nfft, n1, n1)
    else:
        assert args[N1_ARGS[kernel]] == (nfft, n1)
    assert cf.render_route(nfft).n1 == cf.gcc_route(nfft, 4).n1 == n1
    want = cf.ROUTE_LONG if nfft > cf.FFT_SPLIT_MAX else cf.ROUTE_SPECTRA
    if kernel in ("delay_sum", "scene_windowed"):
        kind = args[18] if kernel == "delay_sum" else args[34]
        assert kind == want
    if kernel in ("gcc_all_pairs", "gcc_windowed", "scene_windowed"):
        kind = args[10 if kernel == "scene_windowed" else 6]
        assert kind == want


# Where K3's and K5's render route (kind, column strip, K4a's pass-2
# strip, row strip), its buffers (zb, z0, z1; K5's z0 is its packed mic
# rows, spec its GCC's spectra), the spectra and the finish's (groups,
# partials) sit in each launch's arguments; K3's n1a follows its strips,
# K5's its GCC's strips.
RENDER_ARGS = {"delay_sum": (slice(18, 22), slice(15, 18), 23, slice(24, 26)),
               "scene_windowed": (slice(34, 38), slice(26, 29), 30,
                                  slice(38, 40))}
N1A_ARGS = {"delay_sum": 22, "scene_windowed": 14}


@pytest.mark.parametrize("nfft,n1,strips", [
    (1 << 20, 1024, (16, 16, 16)), (1 << 21, 2048, (8, 16, 16)),
    (1 << 22, 2048, (8, 8, 8)), (1 << 23, 2048, (8, 4, 4)),
    (1 << 24, 4096, (4, 4, 4)), (1 << 25, 16384, (16, 8, 2)),
    (1 << 26, 32768, (16, 8, 2)), (1 << 27, 65536, (16, 8, 2)),
    (1 << 28, 131072, (16, 8, 2))])
def test_renders_from_2_20_take_the_base_rows_spectra(launches, monkeypatch,
                                                      nfft, n1, strips):
    """K3 and K5 on one scene of 4 mics: from 2^20 to 2^24 the render
    through the base rows' spectra (``render_route``), n1 1,024 / 2,048 /
    2,048 / 2,048 / 4,096 with ``spectra_plan``'s strips (8 columns from
    n1 = 2,048 and 4 at 4,096, K4a's pass-2 strip of one packed base row,
    8 rows at n2 = 2,048 and 4 at 4,096), K4a's packed base rows in the
    packed mic rows' buffer, the spectra, and the finish spread over 128
    blocks a packed mic row with its partials (``finish_groups``); above
    2^24 (2^25 to 2^28) the same on the three-pass split (n1 = nfft /
    2,048 with its n1a, 16 columns, K4a's pass-2 strip of 8 rows and 2
    rows in the mix row pass), with a second buffer of packed mic rows,
    which its pass A' writes."""
    length = None
    if nfft > 1 << 25:     # no table, and short rows, from 2^26
        _no_tables(monkeypatch)
        length = 1000
    _route("delay_sum", nfft, length)
    _route("scene_windowed", nfft, length)
    long = nfft > cf.FFT_SPLIT_MAX
    kind = cf.ROUTE_LONG if long else cf.ROUTE_SPECTRA
    for name in RENDER_ARGS:
        (args,) = _named(launches, name)
        rsched, bufs, spec, finish = RENDER_ARGS[name]
        assert args[7:9] == (nfft, n1)
        assert args[rsched] == (kind,) + strips
        assert args[N1A_ARGS[name]] == cf._long_n1a(nfft) == (
            cf.long_plan(nfft).n1a if long else 0)
        zb, z0, z1 = args[bufs]
        groups, part = args[finish]
        assert zb == z0 and (z1 is not None) == long and z1 != z0
        assert args[spec] is not None
        assert groups == cf.finish_groups(nfft, 4) == 128
        assert part is not None


@pytest.mark.parametrize("nfft,kind,n1", [
    (512, cf.ROUTE_BLOCK, 1), (4096, cf.ROUTE_BLOCK, 1),
    (8192, cf.ROUTE_ROWS, 128), (65536, cf.ROUTE_ROWS, 256),
    (1 << 19, cf.ROUTE_ROWS, 1024)])
def test_renders_up_to_2_19_keep_their_launches(launches, nfft, kind, n1):
    """Up to 2^19 K3 and K5 render as before the spectra route: one block
    up to 4,096 (no buffer), ``render_rows`` on the split (one copy of the
    packed base and mic rows), no strips, no render spectra, and the
    finish one block a mic row (groups 1, no partials) even for one scene
    of 4 mics."""
    _route("delay_sum", nfft)
    _route("scene_windowed", nfft)
    for name in RENDER_ARGS:
        (args,) = _named(launches, name)
        rsched, bufs, spec, finish = RENDER_ARGS[name]
        assert args[7:9] == (nfft, n1)
        assert args[rsched] == (kind, 0, 0, 0)
        assert args[finish] == (1, None)
        zb, z0, z1 = args[bufs]
        assert (zb is not None) == (kind == cf.ROUTE_ROWS) and z1 is None
        assert zb != z0 or zb is None
        if name == "delay_sum":
            assert args[spec] is None
            assert (z0 is not None) == (kind == cf.ROUTE_ROWS)


@pytest.mark.parametrize("nfft,rows,want", [
    (1 << 19, 4, 1), (1 << 20, 4, 128), (1 << 20, 2, 128), (1 << 21, 6, 88),
    (1 << 22, 12, 44), (1 << 20, 131, 4), (1 << 20, 132, 1),
    (1 << 20, 256, 1), (1 << 23, 4, 128), (1 << 24, 6, 88),
    (1 << 24, 132, 1), (1 << 25, 4, 128), (1 << 26, 4, 128),
    (1 << 26, 24, 22), (1 << 27, 4, 128), (1 << 28, 6, 88),
    (1 << 30, 4, 128), (1 << 27, 132, 1)])
def test_finish_groups_rule(nfft, rows, want):
    """The finish's blocks a packed mic row (``finish_groups``): one block a
    mic row up to 2^19 and wherever a launch's rows fill the card's 132
    SMs; else (the render's spectra routes: the split from 2^20 to 2^26,
    the three-pass split above, to 2^30) enough for 264 blocks, at most
    128 a packed row."""
    assert cf.finish_groups(nfft, rows) == want


def test_spread_finish_partials_cover_each_scene_chunk(launches):
    """Each scene chunk's launch takes the finish's groups of its own rows,
    and the partials hold the largest need: 2 scenes x 4 mics at 2^20
    need 8 rows x 3 x 64 blocks."""
    base, fade = torch.zeros(2, 1000), torch.ones(1000)
    tau, gains = torch.zeros(2, 4, 1), torch.ones(2, 4, 1)
    groups, part = cf._finish_scratch(1 << 20, 2, 2, 4, "cpu")
    assert groups == [cf.finish_groups(1 << 20, 8)] == [66]
    assert part.numel() == 8 * 3 * 66
    groups, part = cf._finish_scratch(1 << 20, 67, 64, 4, "cpu")
    assert groups == [1, cf.finish_groups(1 << 20, 12)] == [1, 44]
    assert part.numel() == 12 * 3 * 44
    assert cf._finish_scratch(65536, 3, 3, 4, "cpu") == ([1], None)
    cf.delay_sum(base, tau, gains, 1 << 20, 1000, fade, True)
    (args,) = _named(launches, "delay_sum")
    assert args[24] == 66 and args[1] == 2


@pytest.mark.parametrize("nfft,strips", [(1 << 21, (8, 16, 16)),
                                         (1 << 22, (8, 8, 8)),
                                         (1 << 23, (8, 4, 4)),
                                         (1 << 24, (4, 4, 4))])
def test_k1_and_k9_above_2_20_take_k4a_strips(launches, nfft, strips):
    """Above 2^20 K1 launches with ``spectra_plan``'s strips — 8 columns
    (4 at 2^24), K4a's pass-2 strip (``fft_real_rows_strip``) and the row
    pass's (16 rows at 2^21, 8 at 2^22, 4 at 2^23 and 2^24) — K4a's
    packed rows and the cross rows in one buffer, and the spectra in a
    second; K9 with the same column and row strips; on ``gcc_rows``
    (65,536 at 4 mics) K1's split passes no strip."""
    _route("gcc_all_pairs", nfft)
    _route("whitened_corr", nfft)
    (k1,) = _named(launches, "gcc_all_pairs")
    assert k1[6] == cf.ROUTE_SPECTRA and k1[7:10] == strips
    spec0, spec1, cpl0 = k1[17:20]
    assert spec0 == cpl0 and None not in (spec0, spec1) and k1[10] == 0
    (k9,) = _named(launches, "whitened_corr")
    assert k9[5:7] == (strips[0], strips[2])
    launches.clear()
    cf.gcc_all_pairs(torch.zeros(1, 4, 50000), [0], [1], 65536,
                     torch.ones(32769))
    (k1,) = _named(launches, "gcc_all_pairs")
    assert k1[5:10] == (256, cf.ROUTE_ROWS, 0, 0, 0)


# ---------------------------------------------------------------------------
# The GCC routes of K1, K2 and K5: one rule, every fit limit
# ---------------------------------------------------------------------------

# Where each GCC wrapper's (n1, route, column strip, K4a's pass-2 strip,
# row strip) and its buffers sit in its launch's arguments: K1's and K2's
# (spec0, spec1, cross0; n1a after the row strip), K2's (keys, count,
# part), K5's (packed mic rows 0 and 1, cross0, spectra) and (keys, count,
# part).
GCC_ARGS = {"gcc_all_pairs": (slice(5, 10), slice(17, 20), None),
            "gcc_windowed": (slice(5, 10), slice(18, 21), slice(21, 24)),
            "scene_windowed": (slice(9, 14), slice(27, 31), slice(31, 34))}
# (nfft, the most mics a scene that one block a scene or ``gcc_rows``
# holds): one block up to 52 mics at 1,024, 24 at 2,048, 10 at 4,096;
# ``gcc_rows`` up to 52 at 8,192, 24 at 16,384 and 32,768, 10 at 65,536
# and 131,072, 4 at 2^18 and 2^19; never at 2^20 and above.
FIT_LIMITS = ((1024, 52), (2048, 24), (4096, 10), (8192, 52), (16384, 24),
              (32768, 24), (65536, 10), (131072, 10), (1 << 18, 4),
              (1 << 19, 4), (1 << 20, 1), (1 << 21, 1), (1 << 22, 1))
ROUTE_CASES = [(n, m, old) for n, limit in FIT_LIMITS
               for m, old in ((limit, True), (limit + 1, False))
               if m >= 2] + [(1 << 23, 4, False), (1 << 24, 4, False),
                             (1 << 25, 4, False), (1 << 27, 3, False),
                             (1 << 27, 4, False)]


def _gcc_call(kernel, nfft, mics):
    """One call of a GCC wrapper, one scene of ``mics`` mics at nfft."""
    from pyaudiolocalization_tpu_torch.parallel.sweep import _pairs
    pi, pj = _pairs(mics)
    length = min(nfft, 300)
    mask = torch.ones(nfft // 2 + 1)
    if kernel == "gcc_all_pairs":
        cf.gcc_all_pairs(torch.zeros(1, mics, length), pi, pj, nfft, mask)
    elif kernel == "gcc_windowed":
        cf.gcc_windowed(torch.zeros(1, mics, length), pi, pj, nfft, 1, mask)
    else:
        cf.scene_windowed(torch.zeros(1, length), torch.zeros(1, mics, 1),
                          torch.ones(1, mics, 1), pi, pj, nfft, length, 1,
                          torch.ones(length), mask)


@pytest.mark.parametrize("kernel", list(GCC_ARGS))
@pytest.mark.parametrize("nfft,mics,fits", ROUTE_CASES)
def test_gcc_routes_by_shape(launches, monkeypatch, kernel, nfft, mics,
                             fits):
    """K1, K2 and K5's GCC stage on both sides of every fit limit: where
    one block a scene or ``gcc_rows`` fits they launch as before the
    spectra routes (n1 1 or the split's, no strip, the same buffers);
    beyond it, up to 2^24, through the mic rows' spectra — in one block up
    to 4,096 (n1 = 1, the spectra and nothing else), on the split above
    (K4a's strips, K4a's packed buffer shared with the cross rows, the
    spectra, K2's and K5's partials) — and at 2^25 and 2^27 through them
    on the three-pass split (``long_plan``'s strips, its n1a, the same buffers
    and partials; K5's second buffer of packed mic rows); never on radix-2
    passes.  K5's route is K2's at every shape."""
    if nfft > cf.FFT_SPLIT_MAX:
        _no_tables(monkeypatch)
    _gcc_call(kernel, nfft, mics)
    (args,) = _named(launches, kernel)
    sched, bufs, parts = GCC_ARGS[kernel]
    n1, kind, cols, s2, rows = args[sched]
    route = cf.gcc_route(nfft, mics)
    assert (n1, kind) == (route.n1, route.kind)
    split = cf.fft_real_split(nfft)[0]
    if fits:
        want = cf.ROUTE_BLOCK if nfft <= 4096 else cf.ROUTE_ROWS
        assert (n1, kind) == (1 if nfft <= 4096 else split, want)
    elif nfft > cf.FFT_SPLIT_MAX:
        assert (n1, kind) == (split, cf.ROUTE_LONG)
    elif nfft <= 4096:
        assert (n1, kind) == (1, cf.ROUTE_SPECTRA_BLOCK)
    else:
        assert (n1, kind) == (split, cf.ROUTE_SPECTRA)
    if kind == cf.ROUTE_SPECTRA:
        assert (cols, rows) == cf.split_strips(split, nfft // split)
        assert s2 == cf.fft_real_rows_strip(nfft // split, (mics + 1) // 2)
    elif kind == cf.ROUTE_LONG:
        assert (cols, s2, rows) == (16, 8, 2)
    else:
        assert (cols, s2, rows) == (0, 0, 0)
    n1a = args[14 if kernel == "scene_windowed" else 10]
    assert n1a == (cf.long_plan(nfft).n1a if kind == cf.ROUTE_LONG else 0)
    got = [b is not None for b in args[bufs]]
    spectra = kind in (cf.ROUTE_SPECTRA, cf.ROUTE_LONG)
    if kernel == "scene_windowed":
        # (packed mic rows 0 and 1, cross0, spectra); the packed rows take
        # the cross rows on the spectra routes, and on the three-pass
        # split the render's pass A' writes the second buffer.
        want = {cf.ROUTE_BLOCK: [True, False, False, False],
                cf.ROUTE_ROWS: [True, False, True, False],
                cf.ROUTE_SPECTRA: [True, False, True, True],
                cf.ROUTE_SPECTRA_BLOCK: [True, False, False, True],
                cf.ROUTE_LONG: [True, True, True, True]}[kind]
    else:
        # (spec0, spec1, cross0): spec1 the spectra on the spectra routes,
        # cross0 K4a's packed buffer on the split's.
        want = {cf.ROUTE_BLOCK: [False] * 3,
                cf.ROUTE_ROWS: [True, False, True],
                cf.ROUTE_SPECTRA: [True, True, True],
                cf.ROUTE_SPECTRA_BLOCK: [False, True, False],
                cf.ROUTE_LONG: [True, True, True]}[kind]
    if spectra:
        assert args[bufs][2] == args[bufs][0]
    assert got == want
    if parts is not None:
        split_route = kind in (cf.ROUTE_ROWS, cf.ROUTE_SPECTRA,
                               cf.ROUTE_LONG)
        assert all((p is not None) == split_route for p in args[parts])


def test_no_gcc_route_runs_the_passes_up_to_2_22():
    """For 2 to 128 mics at every power of two from 4 to 2^30 (2^22 before
    the spectra routes reached 2^24, 2^24 before they reached 2^26, 2^26
    before the three-pass split took K2, K3 and K5 to 2^30) the GCC of
    K1, K2 and K5 takes one block, ``gcc_rows`` or the mic rows' spectra
    on the split or, above 2^24, on the three-pass split, one rule for the
    three, and the render of K3 and K5 (``render_route``) the same split
    as the GCC at each length; K9 (``corr_schedule``) too.  No route of
    radix-2 passes is left."""
    for bits in range(2, 31):
        nfft = 1 << bits
        render = cf.render_route(nfft)
        assert (render.kind == cf.ROUTE_LONG) == (bits > 24)
        assert cf.corr_schedule(nfft) == cf.fft_real_split(nfft)[0] > 0
        for mics in range(2, 129):
            route = cf.gcc_route(nfft, mics)
            assert route.n1 > 0 and route.n1 == render.n1
            assert (route.kind == cf.ROUTE_LONG) == (bits > 24)
            if route.kind == cf.ROUTE_LONG or render.kind == (
                    cf.ROUTE_SPECTRA):
                assert route == render
            if route.kind in (cf.ROUTE_SPECTRA, cf.ROUTE_LONG):
                assert route.n1 == cf.fft_real_split(nfft)[0]


@pytest.mark.parametrize("nfft,mics,want", [
    (4096, 10, (cf.ROUTE_BLOCK, 1)), (2048, 24, (cf.ROUTE_BLOCK, 1)),
    (1024, 52, (cf.ROUTE_BLOCK, 1)), (8192, 52, (cf.ROUTE_ROWS, 128)),
    (32768, 24, (cf.ROUTE_ROWS, 256)), (65536, 4, (cf.ROUTE_ROWS, 256)),
    (65536, 10, (cf.ROUTE_ROWS, 256)), (1 << 19, 4, (cf.ROUTE_ROWS, 1024))])
def test_shapes_that_fit_keep_their_launches(launches, nfft, mics, want):
    """The shapes one block a scene or ``gcc_rows`` held before the
    spectra routes launch K1, K2 and K5 as they did: the same n1, no
    strip, K1's and K2's packed mic rows and cross rows (none in one
    block), no spectra."""
    for kernel in GCC_ARGS:
        _gcc_call(kernel, nfft, mics)
        (args,) = _named(launches, kernel)
        sched, bufs, _ = GCC_ARGS[kernel]
        assert args[sched] == (want[1], want[0], 0, 0, 0)
        if kernel != "scene_windowed":
            split = want[0] == cf.ROUTE_ROWS
            got = [b is not None for b in args[bufs]]
            assert got == [split, False, split]
        else:
            assert args[bufs][3] is None
        launches.clear()


def test_window_partials_follow_the_column_strip():
    """``window_cols``' partials: a block sum per column strip, 16
    columns on ``gcc_rows`` and up to 2^20, 8 from 2^21 to 2^23, 4 at
    2^24 (1,024 blocks a row); ``long_cols_window``'s a block sum per
    block (j1b, strip of 16 columns), n1b x 128: 16,384 at 2^25 and 2^26,
    32,768 at 2^27 and 2^28, 65,536 at 2^30; none in one block."""
    for nfft, mics, blocks in ((65536, 4, 16), (1 << 20, 4, 64),
                               (1 << 21, 4, 128), (1 << 22, 12, 256),
                               (1 << 23, 4, 512), (1 << 24, 4, 1024),
                               (1 << 25, 4, 16384), (1 << 26, 4, 16384),
                               (1 << 27, 4, 32768), (1 << 28, 3, 32768),
                               (1 << 30, 4, 65536)):
        keys, count, part = cf._window_scratch(3, nfft,
                                               cf.gcc_route(nfft, mics),
                                               "cpu")
        assert (keys.numel(), count.numel(), part.numel()) == (
            6, 3, 2 * 3 * blocks)
    assert cf._window_scratch(3, 4096, cf.gcc_route(4096, 12), "cpu") == (
        None, None, None)


# The spectra routes past 2^24: (n1, column strip, K4a's pass-2 strip, row
# strip, n1a) at 2^25, 2^26 and 2^27 (one scene of 4 mics, one row pair),
# the three-pass split of all five.
LONG_SPECTRA = {25: (16384, 16, 8, 2, 128), 26: (32768, 16, 8, 2, 256),
                27: (65536, 16, 8, 2, 256)}


@pytest.mark.parametrize("bits", [25, 26, 27])
@pytest.mark.parametrize("kernel", ["whitened_corr", "gcc_all_pairs",
                                    "gcc_windowed", "delay_sum",
                                    "scene_windowed"])
def test_spectra_routes_reach_2_26(launches, monkeypatch, kernel, bits):
    """Each of K9, K1, K2, K3 and K5 takes the split to ``FFT_SPLIT_MAX``
    (2^24), and at 2^25, 2^26 and 2^27 the three-pass split (n1 = nfft /
    2,048 = n1a x n1b, 16 columns and 2 rows a strip, K4a's pass 2 in
    strips of 8 rows at n2 = 2,048), one scratch copy (K1's and K2's
    packed rows shared with the cross rows, the spectra beside them; K5's
    the same and the render's base rows in its mic rows' buffer; the
    render a second buffer of packed mic rows, which its pass A'
    writes)."""
    nfft = 1 << bits
    _no_tables(monkeypatch)
    _route(kernel, nfft, 1000)
    (args,) = _named(launches, kernel)
    n1, cs, s2, rs, n1a = LONG_SPECTRA[bits]
    kind = cf.ROUTE_LONG if n1a else cf.ROUTE_SPECTRA
    if kernel == "whitened_corr":
        assert args[3:8] == (nfft, n1, cs, rs, n1a)
        assert args[11] is not None                # z: one scratch copy
        return
    if kernel in RENDER_ARGS:
        rsched, bufs, _, _ = RENDER_ARGS[kernel]
        assert args[7:9] == (nfft, n1)
        assert args[rsched] == (kind, cs, s2, rs)
        assert args[N1A_ARGS[kernel]] == n1a
        zb, z0, z1 = args[bufs]
        assert zb == z0 and (z1 is not None) == bool(n1a)
    if kernel in GCC_ARGS:
        sched, bufs, _ = GCC_ARGS[kernel]
        assert args[sched] == (n1, kind, cs, s2, rs)
        got = [b is not None for b in args[bufs]]
        if kernel == "scene_windowed":
            assert got == [True, bool(n1a), True, True]
        else:
            assert got == [True, True, True]
            assert args[10] == n1a
        assert args[bufs][0] == args[bufs][2]


@pytest.mark.parametrize("bits,n1a", [(27, 256), (28, 512)])
@pytest.mark.parametrize("mics", [3, 4])
def test_k9_and_k1_take_the_three_pass_split_above_2_26(launches, monkeypatch,
                                                        bits, n1a, mics):
    """Above 2^26 K9 (three row pairs) and K1 (one scene of 3 or 4 mics: an
    odd and an even pair count) launch on the three-pass split
    (``long_plan``): n1 = nfft / 2,048 with its n1a, 16 columns and 2 rows
    a strip (K1's K4a pass-2 strip 8), one scratch buffer (K9's packed
    rows; K1's packed mic rows, which the cross rows reuse, beside the
    spectra), and K2 the same launch as K1's."""
    _no_tables(monkeypatch)
    nfft = 1 << bits
    n1 = nfft // 2048
    scratch = []
    stub = cf._scratch
    monkeypatch.setattr(cf, "_scratch", lambda rows, n, device: (
        scratch.append(rows) or stub(rows, n, device)))
    from pyaudiolocalization_tpu_torch.parallel.sweep import _pairs
    pi, pj = _pairs(mics)
    # Never read: the launches are stubbed.
    spec = torch.empty((3, nfft // 2 + 1), dtype=torch.complex64)
    mask = torch.empty(nfft // 2 + 1)
    cf.whitened_corr(spec, spec, mask, nfft)
    (k9,) = _named(launches, "whitened_corr")
    assert k9[2:8] == (3, nfft, n1, 16, 2, n1a)
    assert k9[11] is not None and scratch == [2]
    scratch.clear()
    cf.gcc_all_pairs(torch.zeros(1, mics, 1000), pi, pj, nfft, mask)
    (k1,) = _named(launches, "gcc_all_pairs")
    assert k1[1:11] == (1, mics, 1000, nfft, n1, cf.ROUTE_LONG, 16, 8, 2,
                        n1a)
    spec0, spec1, cross0 = k1[17:20]
    assert spec0 == cross0 and spec1 is not None
    assert scratch == [max((mics + 1) // 2, (len(pi) + 1) // 2)]
    scratch.clear()
    cf.gcc_windowed(torch.zeros(1, mics, 1000), pi, pj, nfft, 1, mask)
    (k2,) = _named(launches, "gcc_windowed")
    assert k2[1:11] == k1[1:11]
    assert k2[18] == k2[20] and k2[19] is not None
    assert None not in k2[21:24]                  # keys, count, partials
    assert scratch == [max((mics + 1) // 2, (len(pi) + 1) // 2)]


@pytest.mark.parametrize("bits,n1a", [(27, 256), (28, 512)])
@pytest.mark.parametrize("mics", [3, 4])
def test_k2_k3_and_k5_take_the_three_pass_split_above_2_26(
        launches, monkeypatch, bits, n1a, mics):
    """Above 2^26 K2, K3 and K5 (one scene of 3 or 4 mics) launch on the
    three-pass split, no longer on radix-2 passes: K2 as K1 (its n1, n1a,
    16 columns and 2 rows a strip, K4a's packed mic rows shared with the
    cross rows beside the spectra, and its partials: a block sum for each
    of ``long_cols_window``'s n1b x 128 blocks a cross row), K3 with the
    base rows' spectra, the packed mic rows, the second buffer its pass
    A' writes and the finish spread over ``finish_groups``' blocks, K5
    both stages with one spectra buffer of the GCC's rows and the render's
    second buffer, K5's buffers the ones ``_scene_bytes`` counts."""
    _no_tables(monkeypatch)
    nfft = 1 << bits
    n1 = nfft // 2048
    scratch = []
    stub = cf._scratch
    monkeypatch.setattr(cf, "_scratch", lambda rows, n, device: (
        scratch.append(rows) or stub(rows, n, device)))
    from pyaudiolocalization_tpu_torch.parallel.sweep import _pairs
    pi, pj = _pairs(mics)
    couples = (len(pi) + 1) // 2
    packed = (mics + 1) // 2
    length = 1000
    mask = torch.empty(nfft // 2 + 1)
    base, fade = torch.zeros(1, length), torch.ones(length)
    tau, gains = torch.zeros(1, mics, 1), torch.ones(1, mics, 1)
    sched = (n1, cf.ROUTE_LONG, 16, 8, 2, n1a)
    cf.gcc_windowed(torch.zeros(1, mics, length), pi, pj, nfft, 1, mask)
    (k2,) = _named(launches, "gcc_windowed")
    assert k2[5:11] == sched
    assert scratch == [max(packed, couples)]
    assert None not in k2[18:24] and k2[18] == k2[20]
    scratch.clear()
    cf.delay_sum(base, tau, gains, nfft, length, fade, True)
    (k3,) = _named(launches, "delay_sum")
    assert k3[8] == n1 and k3[18:23] == (cf.ROUTE_LONG, 16, 8, 2, n1a)
    zb, z0, z1 = k3[15:18]
    assert zb == z0 and None not in (z1, k3[23]) and z1 != z0
    assert scratch == [packed, packed]
    assert k3[24] == cf.finish_groups(nfft, mics) > 1 and k3[25] is not None
    scratch.clear()
    cf.scene_windowed(base, tau, gains, pi, pj, nfft, length, 1, fade, mask)
    (k5,) = _named(launches, "scene_windowed")
    assert k5[7:15] == (nfft, n1) + sched
    assert k5[34:38] == (cf.ROUTE_LONG, 16, 8, 2)
    zb, z0, z1, c0, spec = k5[26:31]
    assert zb == z0 == c0 and None not in (z1, spec) and z1 != z0
    assert None not in k5[31:34] and k5[38] == k3[24]
    assert scratch == [max(packed, couples), packed]
    # A scene's half rows (mics packed across scenes: an odd count's last
    # row shares its packed row with the next scene's first).
    halves = max(mics, 2 * couples) + 2 * mics
    assert cf._scene_bytes(nfft, mics, couples) == halves * nfft * 4


@pytest.mark.parametrize("bits,scenes,chunks", [
    (24, 30, [24, 6]), (25, 25, [8, 8, 8, 1]), (26, 13, [4, 4, 4, 1]),
    (27, 5, [2, 2, 1])])
def test_scene_chunks_cap_their_scratch_by_bytes(launches, monkeypatch, bits,
                                                 scenes, chunks):
    """K1, K2, K3 and K5 over ``scenes`` scenes of 4 mics through the
    spectra: each launch takes at most as many scenes as keep its scratch
    within ``SPLIT_SCRATCH_BYTES`` (``scene_chunk``, ``_scene_bytes``:
    0.67 GB a scene at 2^24, on the three-pass split 1.88 GB at 2^25,
    3.76 GB at 2^26, 7.52 GB at 2^27), 24, 8, 4 and 2 scenes, the same
    chunks for the four, so that the sweep's fused and split paths stay
    equal to the bit; each chunk's finish spreads over the blocks of its
    own rows."""
    nfft = 1 << bits
    if bits > 25:
        _no_tables(monkeypatch)
    from pyaudiolocalization_tpu_torch.parallel.sweep import _pairs
    pi, pj = _pairs(4)
    out = 1000
    mask = torch.ones(nfft // 2 + 1)
    base, fade = torch.zeros(scenes, out), torch.ones(out)
    tau, gains = torch.zeros(scenes, 4, 1), torch.ones(scenes, 4, 1)
    sig = torch.zeros(scenes, 4, out)
    assert cf.scene_chunk(scenes, 4, 6, nfft) == chunks[0]
    assert chunks[0] * cf._scene_bytes(nfft, 4, 3) <= cf.SPLIT_SCRATCH_BYTES
    assert (chunks[0] + 2) * cf._scene_bytes(nfft, 4, 3) > (
        cf.SPLIT_SCRATCH_BYTES)
    cf.gcc_all_pairs(sig, pi, pj, nfft, mask)
    cf.gcc_windowed(sig, pi, pj, nfft, 1, mask)
    cf.delay_sum(base, tau, gains, nfft, out, fade, True)
    cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, 1, fade, mask)
    for name in ("gcc_all_pairs", "gcc_windowed", "delay_sum",
                 "scene_windowed"):
        assert [a[1] for a in _named(launches, name)] == chunks, name
    k3 = _named(launches, "delay_sum")
    assert [a[24] for a in k3] == [cf.finish_groups(nfft, 4 * c)
                                   for c in chunks]
    assert k3[1][0] - k3[0][0] == chunks[0] * out * 4


@pytest.mark.parametrize("bits,gb", [(27, 7.52), (28, 15.03),
                                     (29, 30.06), (30, 60.13)])
def test_scene_bytes_on_the_three_pass_split(bits, gb):
    """``_scene_bytes`` of a 4-mic scene (6 pairs, 3 couples) above 2^26:
    K5's scratch on the three-pass split, the most of the four wrappers' —
    the packed mic rows, large enough for the cross rows (6 half rows),
    the second buffer of packed mic rows that the render's pass A' writes
    (4) and every mic row's spectrum (4): 14 half rows of 4 nfft bytes,
    7.52 GB at 2^27 to 60.1 GB at 2^30.  K1
    and K2 hold 10 of them, K3 9.  One scene a launch up to 2^30, where
    its 60.1 GB fit an 80 GB card beside the twiddle table's 4.3 GB; from
    2^28 two scenes at once pass ``SPLIT_SCRATCH_BYTES`` (16 GiB), from
    2^29 one does, and a chunk short of the batch keeps two all the
    same."""
    nfft = 1 << bits
    per = cf._scene_bytes(nfft, 4, 3)
    assert per == 14 * nfft * 4 and abs(per / 1e9 - gb) < 0.01
    assert cf._scene_bytes(cf.FFT_SPLIT_MAX, 4, 3) == (
        10 * cf.FFT_SPLIT_MAX * 4)          # the split's count at 2^26
    assert cf.scene_chunk(1, 4, 6, nfft) == 1
    assert cf.scene_chunk(5, 4, 6, nfft) == 2
    assert (per <= cf.SPLIT_SCRATCH_BYTES) == (bits <= 28)
    assert per + 8 * (nfft // 2 + nfft // 8192) < 80e9


# Where each transforming kernel's (nfft, n1) sits in its launch's
# arguments (K5's n1 of its render, then of its GCC).
N1_OF = dict(N1_ARGS, fft_real=slice(3, 5), bootstrap_peaks=slice(4, 6),
             noise_bootstrap_peaks=slice(4, 6))


@pytest.mark.parametrize("bits,n1", [(24, 4096), (25, 16384), (26, 32768),
                                     (27, 65536)])
def test_all_transforming_kernels_leave_the_split_together(
        launches, monkeypatch, bits, n1):
    """All eight kernels that transform (K4a, K4b, K6, K9, K1, K2, K3, K5)
    launch on the split at 2^24 (``FFT_SPLIT_MAX``, n1 = 4,096), one
    limit; at 2^25, 2^26 and 2^27 all eight the three-pass split (n1 =
    nfft / 2,048)."""
    nfft = 1 << bits
    length = None
    if bits > 25:          # no table, and short rows, at 2^26 and 2^27
        _no_tables(monkeypatch)
        length = 1000
    for kernel in ("gcc_all_pairs", "gcc_windowed", "delay_sum",
                   "scene_windowed", "whitened_corr"):
        _route(kernel, nfft, length)
    rows = torch.zeros(2, 100)
    s1 = torch.zeros(nfft // 2 + 1, dtype=torch.complex64)
    cf.fft_real(rows, nfft)
    cf.bootstrap_peaks(s1, rows, nfft)
    cf.noise_bootstrap_peaks(s1, torch.zeros((2, 2), dtype=torch.int32),
                             100, nfft)
    assert len(launches) == 8
    for name, args in launches:
        got = args[N1_OF[name]]
        if name == "scene_windowed":
            got = args[7:10]
        assert got == (nfft,) + (n1,) * (len(got) - 1), name


# ---------------------------------------------------------------------------
# Row chunks: K4a, K4b, K6 and K9 beyond 65,535 packed rows
# ---------------------------------------------------------------------------

def _row_counts(calls, name, index):
    return [args[index] for args in _named(calls, name)]


@pytest.mark.parametrize("bits,draws,want", [
    (22, 1000, [1000]), (23, 1000, [512, 488]),
    (24, 1000, [256, 256, 256, 232]), (24, 300, [256, 44]),
    (25, 100, [100]), (25, 200, [128, 72]), (26, 100, [64, 36]),
    (27, 40, [32, 8]), (28, 20, [16, 4])])
def test_bootstraps_cap_their_scratch_by_bytes(launches, monkeypatch, bits,
                                               draws, want):
    """K4b's and K6's launches take at most ``_launch_rows`` rows: as many
    as keep the scratch within ``SPLIT_SCRATCH_BYTES`` (16 GiB; one buffer
    of packed rows on the split), an even count.  1,000 draws at 2^22 keep
    one launch (16.8 GB); 512 rows a launch at 2^23, 256 at 2^24, 128 at
    2^25 (100 draws keep one launch), 64 at 2^26, 32 at 2^27 and 16 at
    2^28 on the three-pass split.  Each chunk's rows, seeds and peaks start
    where the previous chunk ended, and the scratch holds the first
    chunk's packed rows."""
    _no_tables(monkeypatch)
    nfft = 1 << bits
    n1 = cf._split_n1(nfft)
    assert cf._launch_rows(n1, nfft) == want[0] or len(want) == 1
    scratch = []
    stub = cf._scratch
    monkeypatch.setattr(cf, "_scratch", lambda rows, n, device: (
        scratch.append(rows) or stub(rows, n, device)))
    s1 = torch.empty(nfft // 2 + 1, dtype=torch.complex64)
    cf.bootstrap_peaks(s1, torch.zeros(draws, 16), nfft)
    cf.noise_bootstrap_peaks(s1, torch.zeros(draws, 2, dtype=torch.int32),
                             16, nfft)
    assert scratch == [(want[0] + 1) // 2] * 2
    assert scratch[0] * nfft * 8 <= cf.SPLIT_SCRATCH_BYTES
    for name in ("bootstrap_peaks", "noise_bootstrap_peaks"):
        calls = _named(launches, name)
        assert [args[2] for args in calls] == want
        assert [args[5] for args in calls] == [n1] * len(want)
        starts = np.cumsum([0] + want[:-1])
        assert [args[-1] - calls[0][-1] for args in calls] == list(4 * starts)
        step = 16 * 4 if name == "bootstrap_peaks" else 2 * 4
        assert [args[1] - calls[0][1] for args in calls] == list(
            step * starts)


def test_fft_real_caps_its_scratch_by_bytes(launches, monkeypatch):
    """K4a chunks by the same rule (``_launch_rows``): at the real cap
    1,000 rows of 2^22 stay one launch and 2^23 takes 512 a launch; with
    the cap lowered to four packed rows of 2^23, 11 rows launch as 8 and
    2, then the odd last row's half-length transform, each launch's rows
    and spectra starting where the previous one ended."""
    nfft = 1 << 23
    assert cf.SPLIT_SCRATCH_BYTES == 16 << 30
    assert cf._launch_rows(cf._split_n1(1 << 22), 1 << 22) == 1024
    assert cf._launch_rows(cf._split_n1(nfft), nfft) == 512
    assert cf._launch_rows(1, 4096) == cf.ROW_CHUNK
    assert cf._launch_rows(cf._split_n1(1 << 16), 1 << 16) == 65536
    monkeypatch.setattr(cf, "SPLIT_SCRATCH_BYTES", 4 * nfft * 8)
    cf.fft_real(torch.zeros(11, 8), nfft)
    calls = _named(launches, "fft_real")
    assert [args[1] for args in calls] == [8, 2, 1]
    assert [args[8] for args in calls] == [0, 0, 1]
    for i, rows in ((1, 8), (2, 10)):
        assert calls[i][0] - calls[0][0] == rows * 8 * 4
        assert calls[i][-1] - calls[0][-1] == rows * (nfft // 2 + 1) * 8


def test_row_kernels_launch_in_chunks_beyond_the_grid(launches):
    rows = cf.ROW_CHUNK + 3
    assert cf.ROW_CHUNK == 131_070 and cf.ROW_CHUNK % 2 == 0
    x = torch.zeros(rows, 8)
    spec = cf.fft_real(x, 64)
    assert spec.shape == (rows, 33)
    assert _row_counts(launches, "fft_real", 1) == [cf.ROW_CHUNK, 3]
    s1 = torch.zeros(33, dtype=torch.complex64)
    assert cf.bootstrap_peaks(s1, x, 64).shape == (rows,)
    assert _row_counts(launches, "bootstrap_peaks", 2) == [cf.ROW_CHUNK, 3]
    seeds = torch.zeros(rows, 2, dtype=torch.int32)
    assert cf.noise_bootstrap_peaks(s1, seeds, 8, 64).shape == (rows,)
    assert _row_counts(launches, "noise_bootstrap_peaks", 2) == [
        cf.ROW_CHUNK, 3]
    a = torch.zeros(rows, 33, dtype=torch.complex64)
    mask = torch.ones(33)
    assert cf.whitened_corr(a, a, mask, 64).shape == (rows, 64)
    assert _row_counts(launches, "whitened_corr", 2) == [cf.ROW_CHUNK, 3]
    # Each chunk's rows and outputs start where the previous chunk ended.
    first, second = _named(launches, "fft_real")
    assert second[0] - first[0] == cf.ROW_CHUNK * 8 * 4
    assert second[-1] - first[-1] == cf.ROW_CHUNK * 33 * 8


# ---------------------------------------------------------------------------
# Scene chunks: K2, K3 and K5 at the sweep's grid limit
# ---------------------------------------------------------------------------

SPEC = tsw.SweepSpec(fs=8000.0, duration=0.05)
CAP_SCENES = 21_846     # one past 65,535 / 3 couples at 4 mics


class _Reached(Exception):
    pass


def _stop(*args, **kwargs):
    raise _Reached


def test_sweep_across_the_chunk_boundary_launches_each_stage_per_chunk(
        launches, monkeypatch):
    """21,846 scenes at 4 mics (nfft 512): the fused path launches K5 once
    per chunk, the split path K3 and K2 once per chunk, over the same
    chunks (21,844 + 2 scenes) and the same scene offsets."""
    assert SPEC.nfft == 512 and tsw._mono_scene_eligible(SPEC)
    assert cf.scene_chunk(CAP_SCENES, 4, 6, SPEC.nfft) == 21_844
    monkeypatch.setattr(tsw, "_solve_from_window", _stop)
    for fused in (True, False):
        gen = torch.Generator().manual_seed(3)
        with pytest.raises(_Reached):
            tsw._run_scenes(SPEC, gen, CAP_SCENES, torch.float32, fused)
    k5 = _named(launches, "scene_windowed")
    k3 = _named(launches, "delay_sum")
    k2 = _named(launches, "gcc_windowed")
    assert [a[1] for a in k5] == [21_844, 2]
    assert [a[1] for a in k3] == [21_844, 2]
    assert [a[1] for a in k2] == [21_844, 2]
    # Scene 21,844's base row, delays and seeds in the second chunk.
    for args in (k5, k3):
        assert args[1][0] - args[0][0] == 21_844 * SPEC.total_samples * 4
        assert args[1][3] - args[0][3] == 21_844 * 4 * 1 * 4
    # The outputs: K2's and K5's windows and statistics, K3's signals.
    assert k5[1][-2] - k5[0][-2] == k2[1][-2] - k2[0][-2]
    assert k5[1][-1] - k5[0][-1] == 21_844 * 6 * 3 * 4
    assert k3[1][-1] - k3[0][-1] == 21_844 * 4 * SPEC.num_samples * 4
    assert k2[1][0] - k2[0][0] == 21_844 * 4 * SPEC.num_samples * 4


@pytest.mark.parametrize("scenes,chunks", [(21_845, [21_845]),
                                           (43_690, [21_844, 21_844, 2])])
def test_scene_wrappers_chunk_by_one_rule(launches, scenes, chunks):
    """K2, K3 and K5 called directly split a batch into the same chunks."""
    nfft, out, wq = 256, 200, 1
    pi, pj = tsw._pairs(4)
    base = torch.zeros(scenes, 220)
    tau = torch.zeros(scenes, 4, 1)
    gains = torch.ones(scenes, 4, 1)
    fade = torch.ones(out)
    mask = torch.ones(nfft // 2 + 1)
    snr = torch.zeros(scenes)
    seeds = torch.zeros(scenes, 2, dtype=torch.int32)
    cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    cf.gcc_windowed(torch.zeros(scenes, 4, out), pi, pj, nfft, wq, mask)
    cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq, fade, mask,
                      snr, seeds)
    for name in ("delay_sum", "gcc_windowed", "scene_windowed"):
        assert [a[1] for a in _named(launches, name)] == chunks, name


@pytest.mark.parametrize("nfft,mics,kind", [
    (512, 4, cf.ROUTE_BLOCK), (2048, 3, cf.ROUTE_BLOCK),
    (4096, 10, cf.ROUTE_BLOCK), (4096, 11, cf.ROUTE_SPECTRA_BLOCK),
    (2048, 25, cf.ROUTE_SPECTRA_BLOCK)])
def test_scene_wrappers_run_one_block_up_to_4096(launches, nfft, mics, kind):
    """Up to 4,096 points K3 launches with n1 = 1 and no scratch, K2 with
    the GCC stage's route, n1 = 1 either way: one block a scene where a
    scene's rows fit, no scratch; else through the mic rows' spectra, a
    block a packed cross row, with the spectra alone (no packed rows, no
    cross rows); and K5 with both: the packed mic rows that carry the
    finished signals from ``render_block`` to the GCC stage, and the
    spectra beyond the one-block mic limit; no partials buffer either
    way."""
    scenes, out, wq = 3, nfft - nfft // 8, 1
    pi, pj = tsw._pairs(mics)
    base = torch.zeros(scenes, out)
    tau = torch.zeros(scenes, mics, 1)
    gains = torch.ones(scenes, mics, 1)
    fade = torch.ones(out)
    mask = torch.ones(nfft // 2 + 1)
    snr = torch.zeros(scenes)
    seeds = torch.zeros(scenes, 2, dtype=torch.int32)
    cf.delay_sum(base, tau, gains, nfft, out, fade, True, snr, seeds)
    cf.gcc_windowed(torch.zeros(scenes, mics, out), pi, pj, nfft, wq, mask)
    cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq, fade, mask,
                      snr, seeds)
    spectra = kind == cf.ROUTE_SPECTRA_BLOCK
    (k3,) = _named(launches, "delay_sum")
    assert k3[8] == 1 and k3[15:18] == (None,) * 3
    (k2,) = _named(launches, "gcc_windowed")
    assert k2[5:10] == (1, kind, 0, 0, 0) and k2[21:24] == (None,) * 3
    # spec0, spec1 (the spectra), c0
    assert [b is not None for b in k2[18:21]] == [False, spectra, False]
    (k5,) = _named(launches, "scene_windowed")
    assert k5[8:11] == (1, 1, kind) and k5[26] is None
    assert k5[27] is not None and k5[31:34] == (None,) * 3
    # z1, c0, the spectra
    assert [b is not None for b in k5[28:31]] == [False, False, spectra]


# ---------------------------------------------------------------------------
# Parity mode at its exact length: K7 only
# ---------------------------------------------------------------------------

def test_exact_length_parity_run_reaches_k7_and_no_power_of_two_kernel(
        launches, tmp_path, monkeypatch):
    """localize_sound_source in parity mode (the reference's exact-length
    render, the pre-sync, the 2n - 1 transform, the bootstrap at that
    length) with calibration delays, float32 as on the card: the GCC's and
    the bootstrap's whitening go through K7, and nothing reaches K1, K3,
    K4a or K4b (or any other kernel).  The stubbed K7 leaves its input
    in place, so the numbers are not checked here."""
    import copy

    import pyaudiolocalization_tpu_torch as tpkg
    monkeypatch.chdir(tmp_path)
    cfg = copy.deepcopy(tpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25, source_position=[0.2, 0.6, 0.4])
    cfg["localization"].update(lag_mode="reference", num_bootstrap=40,
                               visualize_correlation=False)
    calibration = [{"delay": d, "amplitude": 1.0, "snr": 6.0}
                   for d in (0.001, -0.002, 0.0005, 0.0)]
    tpkg.localize_sound_source(cfg, calibration_data=calibration,
                               device="cpu", dtype=torch.float32)
    names = {n for n, _ in launches}
    assert names == {"whiten"}
    # One launch for the six pairs' cross-spectra, then one a chunk of
    # each pair's 40 resampled rows.
    assert cf.LAUNCHES["whiten"] == 1 + 6


# ---------------------------------------------------------------------------
# Per-bin absorption: plain torch, never K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["carrier", "per-bin"])
def test_per_bin_render_launches_no_k3(launches, mode):
    """simulate_signals_fast in float32, as on the card: the carrier render
    is one K3 launch; the per-bin render (the JAX package's XLA path, its
    Pallas render being scalar-gain only) launches no kernel at all."""
    from pyaudiolocalization_tpu_torch.models.simulator import \
        simulate_signals_fast
    mics = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                     [0.0, 0.0, 1.0]])
    planes = np.array([[1.0, 0.0, 0.0, -3.0], [0.0, 1.0, 0.0, -3.0]])
    out = simulate_signals_fast(
        [0.2, 0.6, 0.4], mics, 8000.0, 343.0, 0.25, "chirp", 1000.0, planes,
        [1, 2], [0.01, 0.05, 0.1], [2e-6, 3e-5, 1e-5], 2, 0.01,
        dtype=torch.float32, device="cpu", absorption_mode=mode)
    assert out.shape == (4, 2000)
    want = ["delay_sum"] if mode == "carrier" else []
    assert [n for n, _ in launches] == want
    if mode == "per-bin":
        assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------------------
# Recorded audio and the compat layer
# ---------------------------------------------------------------------------

def test_recorded_api_reaches_k1_k4a_k4b(launches, tmp_path, monkeypatch):
    """localize_sound_source from four WAV files (use_simulation=False),
    physical mode in float32 as on the card, resampled 16 -> 8 kHz: the
    GCC is K1, each pair's permutation null K4a then K4b; no render (K3)
    and no windowed kernel.  The stubbed kernels leave their outputs as
    allocated, so the host-side uncertainty, which would factor that
    garbage, is stubbed too."""
    import copy

    import pyaudiolocalization_tpu_torch as tpkg
    from pyaudiolocalization_tpu_torch import api
    monkeypatch.setattr(api.uncertainty_ops, "position_uncertainty",
                        lambda *a, **k: None)
    from pyaudiolocalization_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(0)
    base = rng.uniform(-0.5, 0.5, 4000)
    paths = []
    for k, shift in enumerate((0, 3, 5, 9)):
        paths.append(str(tmp_path / f"mic{k}.wav"))
        write_wav(paths[-1], np.roll(base, shift), 16000)
    cfg = copy.deepcopy(tpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               num_bootstrap=16, visualize_correlation=False)
    tpkg.localize_sound_source(cfg, audio_files=paths, use_simulation=False,
                               device="cpu", dtype=torch.float32)
    names = [n for n, _ in launches]
    assert set(names) == {"gcc_all_pairs", "fft_real", "bootstrap_peaks"}
    assert cf.LAUNCHES["gcc_all_pairs"] == 1
    assert cf.LAUNCHES["fft_real"] == cf.LAUNCHES["bootstrap_peaks"] == 6


def test_recorded_api_at_2_21_launches_k1_once_on_the_split(
        launches, tmp_path, monkeypatch):
    """localize_sound_source from four WAV files of 1,100,000 samples at 8
    kHz (past 2^20, so the GCC transforms at 2^21 with
    ``max_expected_delay`` 0.05): one K1 launch over the scene, on the
    split n1 = 2,048 (K4a's passes into the spectra, K9's row pass, the
    column pass), never K1's radix-2 passes; the permutation null K4a and
    K4b on their split (K4a's one-row spectra as half-length transforms of
    2^20 points, n1 = 1,024).  Kernels stubbed as in
    ``test_recorded_api_reaches_k1_k4a_k4b``."""
    import copy

    import pyaudiolocalization_tpu_torch as tpkg
    from pyaudiolocalization_tpu_torch import api
    monkeypatch.setattr(api.uncertainty_ops, "position_uncertainty",
                        lambda *a, **k: None)
    from pyaudiolocalization_tpu_torch.utils.audio_io import write_wav
    rng = np.random.default_rng(1)
    base = rng.uniform(-0.5, 0.5, 1_100_000)
    paths = []
    for k, shift in enumerate((0, 3, 5, 9)):
        paths.append(str(tmp_path / f"mic{k}.wav"))
        write_wav(paths[-1], np.roll(base, shift), 8000)
    cfg = copy.deepcopy(tpkg.DEFAULT_CONFIG)
    cfg.update(fs=8000, duration=0.25)
    cfg["localization"].update(lag_mode="physical", sync_mode="none",
                               num_bootstrap=4, visualize_correlation=False)
    tpkg.localize_sound_source(cfg, audio_files=paths, use_simulation=False,
                               device="cpu", dtype=torch.float32)
    (k1,) = _named(launches, "gcc_all_pairs")
    assert k1[1:6] == (1, 4, 1_100_000, 1 << 21, 2048)
    assert cf.LAUNCHES["gcc_all_pairs"] == 1
    assert {n for n, _ in launches} == {"gcc_all_pairs", "fft_real",
                                        "bootstrap_peaks"}
    assert {a[4] for a in _named(launches, "fft_real")} == {1024}
    assert {a[2] for a in _named(launches, "bootstrap_peaks")} == {4}


@pytest.mark.parametrize("n2,want", [(1025, ["fft_real", "whitened_corr"]),
                                     (1000, ["whiten"])])
def test_compat_single_pair_routes_by_length(launches, n2, want):
    """compat.get_time_delays_phat on float32 rows: n1 + n2 - 1 a power of
    two (2,048) reaches K4a and K9; any other length K7's whitening."""
    from pyaudiolocalization_tpu_torch import compat
    rng = np.random.default_rng(1)
    compat.get_time_delays_phat(rng.standard_normal(1024),
                                rng.standard_normal(n2), 8000.0,
                                lag_mode="physical", device="cpu")
    assert [n for n, _ in launches] == want


# ---------------------------------------------------------------------------
# The serving path: streaming GCC, the moving render, tracking, the stream
# ---------------------------------------------------------------------------

TETRA = np.array([[0.0, 0.0, 0.0], [1.2, 0.0, 0.0], [0.6, 1.2, 0.0],
                  [0.6, 0.6, 1.0]])
BOX = (np.zeros(3), np.array([1.2, 1.2, 1.0]))


def _noise(m, n, seed=0):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


@pytest.mark.parametrize("weighting,want", [("phat", ["whiten"]),
                                            ("ml", []), ("scot", [])])
def test_streaming_gcc_whitens_through_k7(launches, weighting, want):
    """PHAT whitens the Welch-averaged cross-spectra (a fresh tensor) in
    one K7 launch over every pair's bins; the ratio weightings launch no
    kernel."""
    from pyaudiolocalization_tpu_torch.ops import gccphat
    pi, pj = np.triu_indices(4, 1)
    corr, _ = gccphat.gcc_phat_streaming(_noise(4, 8192), pi, pj,
                                         frame=2048, weighting=weighting,
                                         device="cpu")
    assert corr.shape == (6, 1025)
    assert [n for n, _ in launches] == want
    if want:
        (args,) = _named(launches, "whiten")
        assert args[1] == 6 * 1025


def test_moving_render_is_one_k3_launch_over_its_frames(launches):
    """simulate_moving_source in float32: every WOLA frame a scene of one
    K3 launch (1 path a mic, pow2-circular at next_pow2(frame + budget), no
    finalize in the kernel)."""
    from pyaudiolocalization_tpu_torch.models import simulator
    from pyaudiolocalization_tpu_torch.ops.fftutils import next_pow2
    start, vel = np.array([0.3, 0.4, 0.3]), np.array([1.0, 0.2, 0.0])
    out = simulator.simulate_moving_source(start, vel, TETRA, 16000.0,
                                           343.0, 0.25, "chirp", frame=512,
                                           dtype=torch.float32, device="cpu")
    assert out.shape == (4, 4000)
    (args,) = _named(launches, "delay_sum")
    budget, lead = simulator._moving_margins(start, vel, TETRA, 16000.0,
                                             343.0, 0.25, 512)
    frames = -(-(4000 + 2 * lead) // 256)
    total = 512 + budget
    # (base, scenes, length, tau, gains, mics, paths, nfft, n1, out, fade,
    #  finalize, ...)
    assert args[1] == frames and args[2] == total
    assert args[5:8] == (4, 1, next_pow2(total)) and args[9] == total
    assert args[11] == 0
    assert [n for n, _ in launches] == ["delay_sum"]


def test_moving_render_over_the_chunk_limit_launches_per_chunk(launches):
    """A render with more frames than one launch's grid takes (scene
    chunks at 8 mics) launches K3 once per ``cuda_fft.scene_chunk``."""
    from pyaudiolocalization_tpu_torch.models import simulator
    cube = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
                     [1, 0, 1], [0, 1, 1], [1, 1, 1]], float)
    chunk = cf.scene_chunk(10 ** 6, 8, 0, cf.FFT_REAL_ONE_BLOCK)
    fs = 8000.0
    # A still source: the margins do not depend on the duration.
    _, lead = simulator._moving_margins([0.5] * 3, [0.0] * 3, cube, fs,
                                        343.0, 1.0, 64)
    duration = ((chunk + 3) * 32 - 2 * lead) / fs
    simulator.simulate_moving_source(
        [0.5] * 3, [0.0] * 3, cube, fs, 343.0, duration, "sine", frame=64,
        dtype=torch.float32, device="cpu")
    chunks = [a[1] for a in _named(launches, "delay_sum")]
    assert chunks == [chunk, 3] or chunks == [chunk, 4], chunks
    # The frames' length takes one block: no scratch caps the chunk.
    assert all(a[7] <= cf.FFT_REAL_ONE_BLOCK
               for a in _named(launches, "delay_sum"))


@pytest.mark.parametrize("weighting,segment,k1", [
    ("phat", 2048, 1), ("phat", 3000, 1), ("scot", 2048, 0)])
def test_trajectory_runs_k1_over_its_segments(launches, weighting, segment,
                                              k1):
    """localize_trajectory 'srp': PHAT is one K1 launch over every segment
    at next_pow2(segment) (a 3,000-sample segment at 4,096); another
    weighting takes the unfused GCC and launches nothing."""
    from pyaudiolocalization_tpu_torch.models import tracking
    tracking.localize_trajectory(_noise(4, 12000), TETRA, 16000.0, 343.0,
                                 *BOX, segment=segment, coarse_n=6, fine_n=4,
                                 weighting=weighting, device="cpu")
    runs = _named(launches, "gcc_all_pairs")
    assert len(runs) == k1 and len(launches) == k1
    if k1:
        segments = 1 + (12000 - segment) // (segment // 2)
        assert runs[0][1:5] == (segments, 4, segment, 4096 if segment == 3000
                                else 2048)


@pytest.mark.parametrize("nfft,want", [(2048, ["gcc_all_pairs"]),
                                       (3000, ["whiten"])])
def test_gcc_over_segment_axes_needs_a_power_of_two(launches, nfft, want):
    """The all-pairs GCC over (segments, subframes) axes launches K1 only
    at a power-of-two length; at another length it takes the unfused
    branch, whose PHAT is one K7 launch over every pair's bins."""
    from pyaudiolocalization_tpu_torch.ops import gccphat
    pi, pj = np.triu_indices(4, 1)
    x = torch.as_tensor(_noise(4, 1500 * 6)).reshape(3, 2, 4, 1500)
    gccphat.gcc_phat_all_pairs(x, pi, pj, nfft=nfft)
    assert [n for n, _ in launches] == want


def test_compensated_tracking_runs_k1_over_segments_and_subframes(launches):
    """motion='compensated': one K1 launch over (segments x subframes) rows
    of subframes at next_pow2(2 * subframe), for localize_trajectory and
    for track_multiple; the stream's compensated step one a hop over its
    frame's subframes, besides the K7 of its EMA."""
    from pyaudiolocalization_tpu_torch.models import online, tracking
    sigs = _noise(4, 8192)
    tracking.localize_trajectory(sigs, TETRA, 16000.0, 343.0, *BOX,
                                 segment=2048, coarse_n=6, fine_n=4,
                                 motion="compensated", max_speed=2.0,
                                 device="cpu")
    (args,) = _named(launches, "gcc_all_pairs")
    assert args[1:5] == (7 * 8, 4, 256, 512)
    launches.clear()
    tracking.track_multiple(sigs, TETRA, 16000.0, 343.0, *BOX,
                            num_sources=2, segment=2048, hop=2048,
                            coarse_n=6, fine_n=4, motion="compensated",
                            max_speed=2.0, motion_iterations=1,
                            device="cpu")
    (args,) = _named(launches, "gcc_all_pairs")
    assert args[1:5] == (4 * 8, 4, 256, 512)
    launches.clear()
    loc = online.StreamingLocalizer(TETRA, 16000.0, 343.0, *BOX, frame=2048,
                                    hop=1024, num_sources=2, coarse_n=6,
                                    fine_n=4, motion="compensated",
                                    max_speed=2.0, device="cpu")
    online.OnlineTracker(loc, max_speed=2.0).run(sigs)
    names = [n for n, _ in launches]
    assert names.count("gcc_all_pairs") == names.count("whiten") == 8
    assert _named(launches, "gcc_all_pairs")[0][1:5] == (8, 4, 256, 512)


@pytest.mark.parametrize("motion", ["static", "compensated"])
def test_track_multiple_launches_k1_once(launches, motion):
    from pyaudiolocalization_tpu_torch.models import tracking
    tracking.track_multiple(_noise(4, 8192), TETRA, 16000.0, 343.0, *BOX,
                            num_sources=2, segment=2048, coarse_n=6,
                            fine_n=4, motion=motion, max_speed=2.0,
                            suppression="claim", device="cpu")
    assert [n for n, _ in launches] == ["gcc_all_pairs"]


@pytest.mark.parametrize("kw,want", [
    (dict(), "whiten"), (dict(num_sources=2), "whiten"),
    (dict(num_sources=2, suppression="claim"), "whiten"),
    (dict(weighting="ml"), None), (dict(method="capon"), None),
    (dict(method="music", num_sources=2), None)])
def test_stream_step_whitens_a_new_tensor_through_k7(launches, kw, want):
    """The srp stream's PHAT step is one K7 launch a hop, out of place on a
    complex tensor built from the EMA planes (they are real tensors that
    the next hop reads); the other weightings and the narrowband methods
    launch nothing."""
    from pyaudiolocalization_tpu_torch.models import online
    loc = online.StreamingLocalizer(TETRA, 16000.0, 343.0, *BOX, frame=1024,
                                    hop=512, coarse_n=6, fine_n=4,
                                    device="cpu", **kw)
    state = loc.init_state()
    sigs = _noise(4, 4096)
    for s in range(8):
        state = loc.step(state, sigs[:, s * 512:(s + 1) * 512]).state
    runs = _named(launches, "whiten")
    assert len(launches) == (8 if want else 0) == len(runs)
    for args in runs:
        assert args[1] == 6 * 513 and args[0] != args[3]
    if runs:
        # The last hop's input lived beside the planes it was built from
        # (earlier hops' memory may since hold other tensors).
        assert runs[-1][0] not in (state.cross_r.data_ptr(),
                                   state.cross_i.data_ptr())


# ---------------------------------------------------------------------------
# Beamformed extraction and array calibration
# ---------------------------------------------------------------------------

CAL_SOURCES = np.array([[0.2, 0.3, 0.6], [0.9, 0.8, 0.4], [0.1, 0.9, 0.9],
                        [0.8, 0.1, 0.8], [0.5, 0.6, 0.2]])


@pytest.mark.parametrize("nfft,want", [(None, ["whiten"]),
                                       (8192, ["gcc_all_pairs"])])
def test_calibration_runs_k1_over_its_events(launches, nfft, want):
    """calibrate_array_geometry at a power-of-two nfft: one K1 launch with
    the K events as its scene axis; at the exact length 2N - 1 the unfused
    branch, whose PHAT is one K7 launch over every event's pairs."""
    from pyaudiolocalization_tpu_torch.models import arraycal
    sigs = _noise(5 * 4, 4000).reshape(5, 4, 4000)
    arraycal.calibrate_array_geometry(sigs, CAL_SOURCES, TETRA, 48000.0,
                                      343.0, nfft=nfft,
                                      max_expected_delay=0.02, sweeps=4,
                                      device="cpu")
    assert [n for n, _ in launches] == want
    (args,) = _named(launches, want[0])
    if nfft:
        assert args[1:5] == (5, 4, 4000, 8192)
    else:
        assert args[1] == 5 * 6 * 4000   # (K, P, (2N - 1)//2 + 1) bins


def test_extraction_launches_no_kernel(launches):
    """Delay-and-sum, the alignment and MVDR / LCMV extraction are
    torch.fft and torch.linalg on either device: no kernel."""
    from pyaudiolocalization_tpu_torch.models import beamformer
    sigs = _noise(4, 3000)
    pos = np.array([0.3, 0.6, 0.4])
    beamformer.extract_source(sigs, TETRA, pos, 16000.0, 343.0,
                              device="cpu")
    beamformer.align_to_position(sigs, TETRA, pos, 16000.0, 343.0,
                                 device="cpu")
    for taps in (1, 3):
        beamformer.extract_source_mvdr(sigs, TETRA, pos, 16000.0, 343.0,
                                       taps=taps, device="cpu")
    assert launches == []
