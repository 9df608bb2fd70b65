#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

Drives the port's main paths on ``cuda`` at full width (4 mics, 44.1 kHz,
1 s, nfft 65,536; the narrowband trio's 8-mic cube at 16 kHz x 0.25 s),
in twelve phases:

1. device report (``nvidia-smi`` name and power limit);
2. build of the kernels from ``pyaudiolocalization_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at an edge shape, with kernel and plain times taken in
   turns, the least time the card could take (``bound_ms``) and, where one
   PyTorch call computes the same function, that call's time (K4a also
   at no_gate's 131,072, the single pair's two rows and 1024 rows against
   ``torch.fft.rfft``, with device times, two rows of a 23.7 s
   recording at 2^21 and one row at 2^22 on the split with strips of 8,
   2 device kernels a call, one row at 2^23 (2,048 x 4,096: strips of 8
   columns and 4 rows) and at 2^24 (4,096 x 4,096: 4 and 4) on the split
   too, 2, and one row at 2^25 on the radix-2 passes, 27; K4b also at
   no_gate's 131,072 and two rows, with its device time and kernels per
   call, and above 2^20 at 64 and 1,000 rows of the 23.7 s pair at 2^21
   and 3 rows at 2^22, 2^23 and 2^24, 3 device kernels a call, and 3 rows
   at 2^25 on the passes, 52; K6 also at 131,072 and at K4b's shapes above
   2^20 (the passes at 2^25: 51 kernels) and at 300 draws at 2^24 (two
   launches under the scratch's byte cap), each shape equal to K4b on the
   same draws, with its device
   time and kernels per call, as K5, K3 and K2 at the sweep's and the
   api's shapes; K3, K2 and K5 also at an odd mic count on the split, K5
   at the api's scene, each within 1e-6 of K3 then K2, and K3, K2 and K5
   across the scene chunks (21,846 scenes at nfft 512: two launches a
   call, K5 bit-equal to K3 then K2); up to 4,096 points in one block
   (``render_block``, ``window_block``), K3 at the trio sweep's 512 x 8
   mics and the moving render's frames, K3, K2 and K5 at the short
   sweep's 512 x 4 at 2,048 (K5 bit-equal to K3 then K2) and across the
   chunks, each held to one device kernel a launch (K5 two); K7 also on a
   view that starts one
   bin in and at a chunk of parity mode's bootstrap (256 x 44,100 bins),
   with its device time and ``torch.sgn``'s; K1
   and K9 at every shape with their device time and the device kernels a
   call runs, held to their route (``cuda_fft.gcc_route``): K1 3 on
   ``gcc_rows``, 1 in one block; K9 2 and 1, also at 131,072; through the
   mic rows' spectra on the split K1 at 11 mics x 65,536, 8 mics x 2^18,
   1 x 4 mics of an 18 s recording (2^20) and of the 23.7 s recording's
   length and at 8 mics (2^21) and at 4 mics x 2,000,000 samples (2^22),
   and K2 at the fast path's 4 mics at 2^20, 2^21 and 2^22, 4 device
   kernels a call (K4a's two passes into the mic rows' spectra, K9's row
   pass over pairs of them, the column pass), and through them in one
   block K1 at 128 x 16 mics and K2 and K5 at 512 x 12 mics at 4,096 (2
   device kernels, K5 3; K5 also at 6 mics x 2^18, 8; K5 bit-equal to K3
   then K2 on both); K3 through the base rows' spectra at the fast path's
   one scene of 4 mics at 2^20, 2^21 and 2^22, 2 scenes x 3 mics x 3
   paths at 2^21 (8 device kernels a call: K4a's two passes,
   ``render_spec_rows``, ``render_cols``, 4 steps of the finish spread
   over the card) and 64 scenes x 4 mics at 2^20 (5: one
   ``render_finalize``), and K5 at the fast path's three (12, bit-equal
   to K3 then K2); and K9 at one pair of each length, 2, each above
   2^20 (K1 from 2^20) held to its float32 twin within the limit plus the
   twin's own distance from its float64 run, measured in the same run;
   phase 11's shapes: K1 over segments x subframes, K3 over the moving
   render's 132 frames, K7 at 6 x 4,097 and 28 x 2,049 bins; phase 12's:
   K1 over array calibration's 8 x 4 and 12 x 6 events of 4,800 samples
   at 16,384);
   for K10's three kernels (``ops/rowdft.py``) the cases phase 7 does not
   run: the
   inverse, rep = 8 and zero_top at n2 = 64 and 1024, the lane DFT's
   whitening prologue on independent spectra, the GCC-like chain on four
   planes of their own and on the TPU tool's scaled copies, precision
   controls of K10a (one or two of the three TF32 products) that must
   miss the limit the kernel meets, and the device kernels a call of K10a
   and K10c runs (one a transform);
4. ``localize_sound_source`` in physical mode
   (``python -m pyaudiolocalization_tpu_torch --physical --no-calibration
   --no-plots``) on the demo scene and an off-centre chirp scene, cold and
   warm, held against ``tests/data/torch_slice_golden.json`` (TDOAs within
   0.05 samples, position within 5 mm, ``significant`` equal); then the
   demo scene with ``analyze_correlation=False``, which takes the windowed
   fast path, held against ``tests/data/torch_sweep_golden.json``; then
   the off-centre scene at 20 s and 60 s on the fast path (K3 at 2^20
   and 2^22 through the base rows' spectra, K2 through the mic rows'),
   cold and warm, with the device time by kernel (no radix-2 pass of K3
   or K2) and the TDOAs within 0.05 samples of the port's on the CPU;
4b. the options path of ``localize_sound_source``, cold and warm: both
   scenes with the noise-null bootstrap (K6, no permutation) against the
   slice golden, with the noise and permutation nulls of one pair held
   within 5 % of each other and the bootstrap stage timed both ways;
   SCOT + median + FIR + DBSCAN + robust LM; ``max_expected_delay=None``
   (K1 at 131,072) + adaptive + Wiener + calibration delays; and
   ``get_time_delays_phat`` at the exact length (K7) and at 65,536 (K4a +
   K9) — these against ``tests/data/torch_options_golden.json``; and both
   nulls at nfft 2^21 (K4a with K4b or K6 on the split, 2,048 x 1,024)
   against their twins on the same draws;
5. the batched Monte-Carlo sweep at ``bench.py``'s ``bench_full_sweep``
   spec on 512 scenes: the fused path (K5) against the split path (K3 with
   noise, then K2) per scene on the same draws, the hit rate and median
   error against the JAX sweep's, ``localize_batch`` on 256 numpy-built
   scenes against the JAX answers for the first 64, warm scenes/s, and a
   stage breakdown; then 21,846 scenes at nfft 512, one past the grid
   rows of one launch at 4 mics: fused (K5 twice) against split (K3 and
   K2 twice each), equal to the bit;
6. SRP and multi-source, against ``tests/data/torch_srp_golden.json``:
   ``localize_sound_source`` with ``solver='srp'`` and ``'srp+lm'`` on
   both scenes, cold and warm; the reverberant sweep of
   ``bench_reverberant_sweep`` (512 scenes, 37 paths a mic) with each
   solver, statistics against the JAX sweep's, warm scenes/s and a stage
   breakdown; the multi-source cube of ``bench_multi_source`` (128 scenes)
   with spatial and claim suppression; ``localize_batch`` srp on 32
   numpy-built scenes against the JAX answers; and batched GCC-PHAT pairs/s
   at ``bench_gcc_phat``'s shape (256 x 4 x 44,100, nfft 65,536).  Each
   path must launch K3 and K1 (the all-pairs GCC over every scene) and no
   windowed kernel;
7. K10's A/B bench (``tools/torch_rowdft_bench.py``) once at the TPU
   tool's five shapes: the row DFT on the tensor cores against butterfly
   stages on chip, the lane DFT, the full forward by both schedules
   against ``torch.fft.fft`` and K4a (against ``torch.fft.rfft``), and the
   chain by both schedules, every kernel case held against its twin at
   every shape; n2 = 512 on 1024 planes (N = 65,536) gives K10's entries
   of the ``kernels`` line;
8. parity mode and the default demo, against
   ``tests/data/torch_parity_golden.json`` (``parity_phase``):
   ``run_calibration`` on the card; ``localize_sound_source`` in parity
   mode (``lag_mode='reference'``: pre-sync, exact-length GCC and
   bootstrap, calibration delays applied as given) with the JAX package's
   calibration data, cold and warm, launching K7 and no other kernel; the
   default demo's configuration (the physical lag axis with the pre-sync)
   the same way; ``python -m pyaudiolocalization_tpu_torch --no-plots``
   in-process.  Sync shifts, TDOAs where each pair's peak is clear of
   its runner-up (a near-tie's flip is reported), the position (or the
   DE cost) and ``significant`` away from the threshold;
9. the narrowband solvers, per-bin absorption and the sweep's remaining
   modes, against ``tests/data/torch_narrowband_golden.json``
   (``narrowband_phase``): ``localize_sound_source`` with ``solver`` 'beam',
   'music' and 'capon' on the demo and off-centre scenes, cold and warm
   (K3, K1, K4a, K4b; no K2 or K5), the fix within 2 mm (MUSIC 15 mm) of
   the golden where its coarse map is clear, the jackknife std within a
   factor of 2; ``python -m pyaudiolocalization_tpu_torch --solver music
   --no-plots`` in-process; per-bin absorption on the demo scene and on
   the off-centre scene with physically scaled coefficients (K1, K4a,
   K4b, no K3: the per-bin render is plain torch, as in the JAX package);
   the narrowband trio sweeps (512 scenes each, 800 Hz on the 8-mic cube)
   and the two-tone sweeps (128, 'music' and 'capon'), K3 alone, their
   statistics against the JAX sweep's; ``localize_batch`` on 32 tone
   scenes a solver (no kernel) against the JAX answers; ``lm-robust`` and
   ``de`` fused (K5) against split (K3 then K2) on the same draws, and
   Wiener on the split (K3, K2); warm scenes/s, device idle shares, peak
   memory and stage breakdowns (the api's, each trio sweep's, DE's
   generations), each beside the card's name and power limit.  Phase 3
   adds K3 at the trio sweep's shape.
10. recorded audio, the compat layer and the checkpointed sweep, against
   ``tests/data/torch_recorded_golden.json`` (``recorded_phase``): the four
   files of ``tests/data/recorded/`` (48 kHz x 1 s: two PCM16 WAVs, a float
   WAV, a FLAC; their SHA-256 against the golden's) read with the
   resampling on the card, each channel within 1e-5 of the golden at 64
   points and by its norm, the resampler's device time, ``house_lo.ogg``
   against its independent decode; ``localize_sound_source`` from the
   files, cold and warm, in physical mode (K1, K4a, K4b; TDOAs within 0.05
   samples, position within 5 mm, ``significant`` where clear) and parity
   mode with the pre-sync (K7 alone, ``check_parity``); a 4 x 24 s
   recording at 48 kHz written by ``write_wav`` and read back (nfft 2^21:
   K1, K4a and K6 on their split; TDOAs within 0.5
   samples of the injected delays), with the resampling's time and peak
   memory, a warm call's wall time and its device time by kernel, then
   the same recording under ``max_expected_delay=None`` (nfft 2^22: K1,
   K4a and K6 on their split of 8-wide strips) the same way; neither run
   launches a radix-2 pass of K1; a 4 x 60 s recording at 44.1 kHz under
   ``max_expected_delay=None`` (nfft 2^23: K4a and K6 on their split past
   2^22, K1 on its passes) the same way, with no radix-2 pass of K4a or
   K6; 4-mic recordings at 44.1 kHz (no
   resampling) of 16 s on the full core (K1 at 2^20) and of 16, 30 and
   60 s on the fast path (K2 at 2^20, 2^21 and 2^22), the GCC through the
   mic rows' spectra, each the same way, none with a radix-2 pass of K1
   or K2;
   ``compat`` on the card (speed of sound, the single pair at the exact
   length by K7 and at a power of two by K4a + K9, the permutation null by
   K4a + K4b within 5 %, the significance metrics, ``noise_reduction`` by
   'conv' and 'prefix' within 1e-4 and 'scan' on 4,410 samples, timed);
   ``run_sweep_checkpointed`` at ``bench_full_sweep``'s spec, 4 chunks x
   512, stopped after chunk 2 and resumed equal to the bit to the
   uninterrupted run (K5 once a chunk), its scenes/s beside a warm
   ``monte_carlo_sweep``; each step a ``utils.profiling.stage``, the stage
   report printed.
11. the serving and tracking path, against
   ``tests/data/torch_serving_golden.json`` and the JAX-drawn bases of
   ``tests/data/torch_serving_bases.npz`` (``serving_phase``): the moving
   render of examples/track_moving_source.py (tetrahedral array, 16 kHz,
   2 s, 1.5 m/s, frame 512; K3) on the golden's noise base and of a
   chirp synthesized in float64, each channel within 3e-5 of the golden's
   float64 render at 64 points and by norm (the JAX package's float32
   render is 1.0e-5 off it), and ``simulate_moving_source`` of the chirp
   (synthesized in float32) within 1e-2;
   ``localize_trajectory`` on it (segment 4096, coarse_n 32, fine_n 12,
   Kalman; K1), static and compensated, within 5 mm of the golden where
   its coarse margin is clear, the compensated mean error within 0.05 m;
   ``track_multiple`` on the crossing walkers of EVALUATION.md (12 x 128
   ms, 4-mic tetra, 1.2 m/s; K3 renders, K1), static and compensated, and
   three walkers on an 8-mic room array, compensated: identities held
   (each walker's nearest track the same on the first and last segment),
   the rate bank's host pool recorded, compensated errors within 0.035 m a
   track on the two walkers and 0.1 m on three; ``gcc_phat_streaming`` on 4 x
   60 s at 44.1 kHz, frame 8192, PHAT (K7) and 'ml', TDOAs within 0.05
   samples of the injected half-sample delays, with device time and peak
   memory; ``StreamingLocalizer`` by ``run()`` and ``step()`` at
   examples/online_localization.py's configuration on 10 s (K7), two
   talkers on the 8-mic cube ('spatial', 'claim'; K7), 'music' and
   'capon' on two tones (no kernel), each talker within 3 cm (tail
   median), and ``OnlineTracker`` over the compensated stream on the
   crossing walkers (K1, K7), within 0.1 m a talker; ms a hop warm and the
   real-time factor, beside the card's name and power limit.
12. beamformed extraction, array calibration and the mesh, against
   ``tests/data/torch_extraction_golden.json`` and the JAX-drawn bases of
   ``tests/data/torch_extraction_bases.npz``
   (``extraction_calibration_mesh_phase``): EVALUATION.md's extraction
   protocol at full size (8-mic cube, 16 kHz, frame 256, hop 64, three
   scenes, white-noise and 1 kHz sine interferers at 0.25 s and 1.0 s;
   renders K3, extraction no kernel): delay-and-sum, MVDR (taps 1) and
   LCMV (taps 3) SIR within 0.5 dB and target gain within 0.02 of the
   float64 golden, the sine rows' MVDR more than 10 dB above
   delay-and-sum, warm ms a call; ``calibrate_array_geometry`` on
   examples/calibrate_array_geometry.py's scene (tetrahedron, 8 events at
   48 kHz x 0.1 s, survey seed 11) at ``nfft=None`` (K7) and 16,384 (one
   K1 launch over the events): TDOAs equal to the golden's where its
   margins are clear, positions within 1e-4 m, worst-mic error at most 3
   mm; the 6-mic, 12-event self-calibration with the golden's k-means
   seeds, its worst inter-mic distance error within 1 mm of the golden's
   and its positions no farther from float64 than the JAX package's
   float32 run's plus 5 mm;
   a one-rank NCCL mesh in this process, ``bench_full_sweep``'s 512
   scenes (K5) equal to ``run_sweep_checkpointed(..., 512, 512)`` to the
   bit; two spawned gloo ranks sharing the card, 256 scenes each (K5),
   each shard equal to its chunk of ``run_sweep_checkpointed(..., 512,
   256)`` and both summaries equal; scenes/s over five alternated warm
   repeats of the meshed and the mesh-less sweep, and one profiled call of
   each (one card: no multi-card rate).
13. the measurement tools (``evaluation_fuzz_phase``): the ten sections of
   EVALUATION.md's accuracy tables at tools/eval_sweep.py's full counts
   through tools/torch_eval_sweep.py (K5, K3, K1, K7), printed beside the
   JAX package's rows of ``tests/data/torch_eval_golden.json`` under the
   card's name and power limit, and held to them by the tool's ``hold``
   (PERF.md section 2): hit counts within 3 pooled binomial sigma, p90
   within 1.5x (2 mm under 2 cm) or by its quantile, the NEES coverage by
   the binomial rule and its median within 15 %, the CRLB to 1e-9, the
   extraction SIRs within 1.5 dB, the walkers' identities held where the
   golden's hold and each mean error within 2x or under 0.1 m; then
   tools/torch_path_fuzz.py (K5, K3, K2, K1, K4a, K9): every
   configuration's TDOAs within 0.5 sample and, with 4 mics or more,
   estimates within 1 mm of the plain twins on the same signals (a scene
   whose TDOA ladder nearly ties is exempt, at most one in ten; one whose
   SRP coarse map ties has its TDOAs held and its fix counted).

Every path runs with the launch counts set to 0 just before it and read
just after; each must have launched its kernels.  Any failure raises, and
the script exits non-zero.  The last line is ``{"ok": true, "device":
{...}}``.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SLICE_GOLDEN = REPO / "tests" / "data" / "torch_slice_golden.json"
SWEEP_GOLDEN = REPO / "tests" / "data" / "torch_sweep_golden.json"
OPTIONS_GOLDEN = REPO / "tests" / "data" / "torch_options_golden.json"
SRP_GOLDEN = REPO / "tests" / "data" / "torch_srp_golden.json"
PARITY_GOLDEN = REPO / "tests" / "data" / "torch_parity_golden.json"
NB_GOLDEN = REPO / "tests" / "data" / "torch_narrowband_golden.json"
RECORDED_GOLDEN = REPO / "tests" / "data" / "torch_recorded_golden.json"
FS = 44100.0
NFFT = 65536
N = 44100
SWEEP_SCENES = 512
BATCH_SCENES = 256
MULTI_SCENES = 128
GCC_SCENES = 256      # bench.py's bench_gcc_phat batch
# H100 SXM data sheet: HBM3 bandwidth and the float32 rate outside the
# tensor cores (at the full 700 W power limit).
PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = 67e12
CSRC = "pyaudiolocalization_tpu_torch/csrc/kernels.cu"
ROWDFT_CSRC = "pyaudiolocalization_tpu_torch/csrc/rowdft.cu"
MXU_TOOL = "tools/mxu_rowdft_bench.py"
PALLAS = "pyaudiolocalization_tpu/ops/pallas_fft.py"
PALLAS_KERNELS = "pyaudiolocalization_tpu/ops/pallas_kernels.py"
NULL_DRAWS = 1000
# Phase 3's cases added after their kernel's first slice: (kernel, tag) ->
# the seed of the random stream they draw from (each later group its own,
# so that adding cases leaves every earlier case's inputs as they were).
ADDED = {("delay_sum", "odd"): 1, ("gcc_windowed", "odd"): 1,
         ("noise_bootstrap_peaks", "no_gate"): 1, ("scene_windowed", "api"): 1,
         ("scene_windowed", "odd"): 1, ("gcc_all_pairs", "mics11"): 2,
         ("whitened_corr", "no_gate"): 2, ("fft_real", "long"): 3,
         ("whiten", "boot"): 3, ("delay_sum", "chunks"): 3,
         ("gcc_windowed", "chunks"): 3, ("scene_windowed", "chunks"): 3,
         ("delay_sum", "trio"): 4, ("gcc_all_pairs", "subframes"): 5,
         ("gcc_all_pairs", "walkers"): 5, ("delay_sum", "moving"): 5,
         ("whiten", "stream"): 5, ("whiten", "stream28"): 5,
         ("gcc_all_pairs", "calibration"): 6,
         ("gcc_all_pairs", "calibration6"): 6, ("delay_sum", "short"): 7,
         ("gcc_windowed", "short"): 7, ("scene_windowed", "short"): 7,
         ("fft_real", "long22"): 8, ("fft_real", "split23"): 8,
         ("bootstrap_peaks", "long"): 8, ("bootstrap_peaks", "long1000"): 8,
         ("bootstrap_peaks", "long22"): 8, ("bootstrap_peaks", "split23"): 8,
         ("noise_bootstrap_peaks", "long"): 8,
         ("noise_bootstrap_peaks", "long1000"): 8,
         ("noise_bootstrap_peaks", "long22"): 8,
         ("noise_bootstrap_peaks", "split23"): 8,
         ("gcc_all_pairs", "long"): 9, ("gcc_all_pairs", "long8"): 9,
         ("gcc_all_pairs", "long22"): 9, ("whitened_corr", "long"): 9,
         ("whitened_corr", "long22"): 9, ("gcc_all_pairs", "spectra20"): 10,
         ("gcc_all_pairs", "spectra18"): 10,
         ("gcc_all_pairs", "spectra_block"): 10,
         ("gcc_windowed", "fast20"): 10, ("gcc_windowed", "fast21"): 10,
         ("gcc_windowed", "fast22"): 10,
         ("gcc_windowed", "spectra_block"): 10,
         ("scene_windowed", "spectra_block"): 10,
         ("scene_windowed", "spectra18"): 10, ("delay_sum", "fast20"): 11,
         ("delay_sum", "fast21"): 11, ("delay_sum", "fast22"): 11,
         ("delay_sum", "odd21"): 11, ("delay_sum", "scenes20"): 11,
         ("scene_windowed", "fast20"): 11, ("scene_windowed", "fast21"): 11,
         ("scene_windowed", "fast22"): 11, ("fft_real", "split24"): 12,
         ("fft_real", "passes25"): 12, ("bootstrap_peaks", "split24"): 12,
         ("bootstrap_peaks", "passes25"): 12,
         ("noise_bootstrap_peaks", "split24"): 12,
         ("noise_bootstrap_peaks", "draws24"): 12,
         ("noise_bootstrap_peaks", "passes25"): 12}
# The sweep across K2's, K3's and K5's scene-chunk boundary: one scene past
# the 65,535 grid rows of one launch at 4 mics (3 couples), at nfft 512.
CHUNK_SCENES = 21846
LONG_NFFT = 1 << 21       # K4a's, K4b's and K6's split of 8-wide strips
LONG_SAMPLES = 1046019    # 23.7 s at 44.1 kHz: the api's nfft passes 2^20
LONG_DRAWS = 64
# Phase 3's cases above 2^20: (samples, nfft) of one row at K9's and the
# GCCs' largest split (2,048 x 2,048: 8 columns and 8 rows a strip), at
# K4a's, K4b's and K6's splits past it (2,048 x 4,096: 8 columns, 4 rows;
# 4,096 x 4,096: 4 and 4; a 47.5 s and a 95 s recording at 44.1 kHz under
# ``max_expected_delay=None``) and past those (the radix-2 passes), with
# their device kernels a call there (K4a: the packing, 25 passes, the
# split; K4b: the packing, 25 forward passes, the whitening, 24 inverse
# ones and the last with the maxima; K6: its first pass draws the rows);
# K6's draws at 2^24 that take two launches under the byte cap.
LONG22 = (2000000, 1 << 22)
SPLIT23 = (4200000, 1 << 23)
SPLIT24 = (8400000, 1 << 24)
PASSES25 = (16800000, 1 << 25)
DRAWS24 = 300
# Phase 3's cases of the GCCs' spectra routes: one scene's samples at the
# fast path's (and the full core's) 2^20, 2^21 and 2^22 under
# DEFAULT_CONFIG (18.1, 34.0 and 68.0 s at 44.1 kHz).
FAST_SAMPLES = {1 << 20: 800000, 1 << 21: 1500000, 1 << 22: 3000000}
PASSES25_KERNELS = {"fft_real": 27, "bootstrap_peaks": 52,
                    "noise_bootstrap_peaks": 51}
# The card's name and power limit (nvidia-smi), set by main().
CARD = ["not read"]
# Device kernels a call of K3 or K2 runs at phase 3's one-block shapes
# (nfft <= 4,096: one a scene chunk; K5 twice as many).
ONE_BLOCK_KERNELS = {"trio": 1, "short": 1, "chunks": 2}
# Device kernels a call of K5 runs at phase 3's spectra-route shapes: at
# 4,096 ``render_block``, ``fft_real_block``, ``corr_block``; at 2^18 the
# render's split (3) and finalize, then the GCC's four; at the fast path's
# 2^20 to 2^22 the render through the base rows' spectra (4), the finish
# spread over the card (``finish_spread``, 4 steps), then the GCC's four.
SPECTRA_K5_KERNELS = {"spectra_block": 3, "spectra18": 8, "fast20": 12,
                      "fast21": 12, "fast22": 12}
# Device kernels a call of K3 runs through the base rows' spectra with
# the finalize and the noise: K4a's two passes, ``render_spec_rows``,
# ``render_cols``, then the finish, 4 steps of ``finish_spread`` where a
# call's rows leave the card idle (one scene), else one
# ``render_finalize`` (64 scenes).
RENDER_SPECTRA_KERNELS = {"fast20": 8, "fast21": 8, "fast22": 8,
                          "odd21": 8, "scenes20": 5}

# name -> (source, TPU kernel it replaces)
KERNELS = {
    "delay_sum": (CSRC, f"{PALLAS}:1851"),
    "gcc_all_pairs": (CSRC, f"{PALLAS}:922"),
    "gcc_windowed": (CSRC, f"{PALLAS}:1095"),
    "fft_real": (CSRC, f"{PALLAS}:685"),
    "bootstrap_peaks": (CSRC, f"{PALLAS}:1227"),
    "scene_windowed": (CSRC, f"{PALLAS}:1600"),
    "noise_bootstrap_peaks": (CSRC, f"{PALLAS}:1326"),
    "whiten": (CSRC, f"{PALLAS_KERNELS}:34"),
    "whitened_corr": (CSRC, f"{PALLAS}:707"),
    "row_dft": (ROWDFT_CSRC, f"{MXU_TOOL}:328"),
    "row_stages": (ROWDFT_CSRC, f"{MXU_TOOL}:328"),
    "lane_dft": (ROWDFT_CSRC, f"{MXU_TOOL}:328"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Bounds: the larger of bytes / HBM rate and operations / float32 rate.
# Bytes count each input read once and each output written once; a complex
# N-point FFT counts 5 N log2 N operations, a real one half that.
# ---------------------------------------------------------------------------

def _rfft_ops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gcc_ops(scenes, mics, pairs, n):
    """Forward spectra, whitening (~15 operations a bin) and inverses."""
    return scenes * ((mics + pairs) * _rfft_ops(n) + pairs * (n // 2) * 15)


def render_ops(scenes, mics, paths, n, out, noise):
    """Base spectra, ramp synthesis (~20 operations a path and bin),
    inverses, finalize (~10 a sample) and Philox + Box-Muller (~80)."""
    return scenes * (_rfft_ops(n) + mics * (
        _rfft_ops(n) + paths * (n // 2) * 20 + out * (10 + 80 * noise)))


def scene_bound(name, scenes, mics, paths, total, out, nfft, wq, noise):
    """Bound of one call of K3 (``delay_sum``), K2 (``gcc_windowed`` of
    (scenes, mics, out) signals) or K5 (``scene_windowed``, noise always
    on): base rows of ``total`` samples, ``paths`` (tau, gain) pairs a mic
    row of ``out`` samples, windows of 2 * wq * 128 lags and 3 statistics a
    pair (wq None: no window)."""
    pairs = mics * (mics - 1) // 2
    window = 0 if wq is None else scenes * pairs * (2 * wq * 128 + 3)
    render = scenes * total + 2 * scenes * mics * paths + out
    gcc = gcc_ops(scenes, mics, pairs, nfft) + 3 * scenes * pairs * nfft
    if name == "delay_sum":
        return bound(4 * (render + 3 * scenes * noise + scenes * mics * out),
                     render_ops(scenes, mics, paths, nfft, out, noise))
    if name == "gcc_windowed":
        return bound(4 * (scenes * mics * out + nfft // 2 + 1 + window), gcc)
    return bound(4 * (render + 3 * scenes + nfft // 2 + 1 + window),
                 render_ops(scenes, mics, paths, nfft, out, 1) + gcc)


def compare(name, kernel_fn, plain_fn, tol, reps, least, scale_by_max=False,
            library_fn=None):
    """Kernel vs plain on the same inputs: the max abs error, checked
    against ``tol`` (relative to max|plain| when ``scale_by_max``), and the
    times, measured in turns (plain, kernel, kernel, plain).  Outputs may
    be tuples of tensors.  ``least`` is (bound ms, what sets it).  Logs one
    line; returns (error, kernel ms, plain ms, library ms or None, bound
    ms, what sets it)."""
    import torch
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    scale = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name}: kernel output shape "
                                 f"{tuple(g.shape)} or non-finite values")
        err = max(err, float((g - w).abs().max()))
        scale = max(scale, float(w.abs().max()))
    limit = tol * scale if scale_by_max else tol
    if not err <= limit:
        raise AssertionError(f"{name}: max |kernel - plain| = {err:.3e} > "
                             f"{limit:.3e}")
    p1 = time_ms(plain_fn, reps)
    k1 = time_ms(kernel_fn, reps)
    k2 = time_ms(kernel_fn, reps)
    p2 = time_ms(plain_fn, reps)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    lib_ms = time_ms(library_fn, reps) if library_fn is not None else None
    log(f"{name}: max_abs_err={err:.3e} (limit {limit:.3e}) kernel "
        f"{k_ms:.4f} ms plain {p_ms:.4f} ms"
        + (f" library {lib_ms:.4f} ms" if lib_ms is not None else "")
        + f" bound {least[0]:.5f} ms ({least[1]})")
    return (err, k_ms, p_ms, lib_ms) + tuple(least)


def kernel_phase(cf, torch):
    """Phase 3: every kernel against its plain version on the card, at the
    main paths' shapes ("main", recorded) and edge shapes.  Tolerances are
    float32's: transforms of log2(nfft) radix-2 passes in the kernel and in
    cuFFT, on values bounded by 1 (correlations, peaks, finalized renders)
    or relative to the spectrum's peak (fft_real); noisy renders add the
    Philox normals, equal integers in both, float32 log/cos within a few
    units in the last place."""
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    from pyaudiolocalization_tpu_torch.ops.fftutils import next_pow2
    dev = torch.device("cuda")
    # Cases added in a later slice (ADDED) draw from a stream of their own,
    # so that adding a case leaves the inputs of every other case as they
    # were.
    streams = {seed: torch.Generator(device=dev).manual_seed(seed)
               for seed in {0, *ADDED.values()}}
    stream = [streams[0]]

    def draw(kernel, tag):
        stream[0] = streams[ADDED.get((kernel, tag), 0)]

    def randn(*shape):
        return torch.randn(shape, generator=stream[0], device=dev)

    def rand(*shape):
        return torch.rand(shape, generator=stream[0], device=dev)

    def randint(*shape):
        return torch.randint(-2 ** 31, 2 ** 31, shape, generator=stream[0],
                             dtype=torch.int32, device=dev)

    def pairs(m):
        pp = [(i, j) for i in range(m) for j in range(i + 1, m)]
        return [p[0] for p in pp], [p[1] for p in pp]

    def scene_inputs(b, m, paths, total, out):
        base = torch.zeros((b, total), device=dev)
        base[:, :out] = randn(b, out)
        tau = (rand(b, m, paths) * (total - out)).contiguous()
        gains = rand(b, m, paths)
        gains[..., 0] = 1.0  # the strongest path has gain 1 (scene_paths)
        snr = 20.0 + 20.0 * rand(b)
        seeds = randint(b, 2)
        fade = fade_window(total, dtype=torch.float32,
                           device=dev)[:out].contiguous()
        return base, tau, gains.contiguous(), snr, seeds, fade

    from pyaudiolocalization_tpu_torch.ops import noise as noise_ops
    bench = _load_tool("torch_rowdft_bench")
    device_ms = bench.device_ms
    twin_rows = bench.twin_rows

    def log_device(name, fn, calls=5, kernels=None):
        """Logs the device time and kernels per call (``torch.profiler``);
        raises unless a call runs ``kernels`` device kernels, where
        given."""
        dev_k = traced(bench, fn, calls, kernels)
        log(f"{name} device time per call: {dev_k['total']:.4f} ms in "
            f"{dev_k['kernels']:g} kernels ({bench._split(dev_k)})")
        if kernels is not None and dev_k["kernels"] != kernels:
            raise AssertionError(f"{name}: {dev_k['kernels']:g} device "
                                 f"kernels a call, want {kernels}")

    def twin_gap(name, plain, *inputs):
        """max |plain(inputs) - plain(inputs widened to float64)|: the
        float32 twin's distance from its float64 run.  Above 2^20 a kernel
        is held to its float32 twin within the limit plus this distance,
        which float32 rounding of a 2^21- or 2^22-point transform sets."""
        wide = [x.to(torch.complex128 if x.is_complex() else torch.float64)
                for x in inputs]
        gap = float((plain(*inputs).double() - plain(*wide)).abs().max())
        log(f"{name}: max |float32 twin - float64 twin| = {gap:.3e}")
        return gap

    results = {}
    reverb, multi = srp_specs()
    trio = _spec(json.loads(NB_GOLDEN.read_text())["trio/beam"]["spec"])
    # The short-frame sweep (the verify recipe's and EVALUATION.md's
    # weighting section): 16 kHz x 0.1 s, 1,694 padded samples at 2,048.
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    short = sw.SweepSpec(fs=16000.0, duration=0.1)
    short_wq = sw._tdoa_window_wq(short)
    # K3: render.  Main paths: the sweep's split render (512 scenes, 1
    # path, noise, 44,356 padded samples), the single scene's (22 paths =
    # direct + 21 image sources of 3 planes at order 3, 50,292 padded
    # samples, no noise), the reverberant SRP sweep's (512 scenes, 37
    # paths, noise) and the multi-source cube's raw per-source renders (128
    # scenes x 2 sources, 8 mics, no finalize); raw renders are held
    # relative to their peak.  Up to 4,096 points (the edge, the trio
    # sweep's 8-mic render, the short sweep's and the chunks at 512) K3 is
    # one device kernel a launch (``render_block``), one launch a scene
    # chunk.
    for tag, (b, m, paths, total, out, nfft, noise, fin) in {
            "main": (SWEEP_SCENES, 4, 1, 44356, N, NFFT, True, True),
            "scene": (1, 4, 22, 50292, N, NFFT, True, True),
            "api": (1, 4, 22, 50292, N, NFFT, False, True),
            "reverb": (SWEEP_SCENES, 4, 37, reverb.total_samples,
                       reverb.num_samples, next_pow2(reverb.total_samples),
                       True, True),
            "multi": (2 * MULTI_SCENES, 8, 1, multi.total_samples,
                      multi.num_samples, next_pow2(multi.total_samples),
                      False, False),
            "odd": (3, 3, 5, 7000, 6000, 8192, True, True),
            "edge": (3, 3, 5, 3500, 3000, 4096, True, True),
            "chunks": (CHUNK_SCENES, 4, 1, 448, 400, 512, True, True),
            "trio": (SWEEP_SCENES, 8, 1, trio.total_samples,
                     trio.num_samples, next_pow2(trio.total_samples), True,
                     True),
            "short": (SWEEP_SCENES, 4, 1, short.total_samples,
                      short.num_samples, short.nfft, True, True),
            "fast20": (1, 4, 1, 900000, FAST_SAMPLES[1 << 20], 1 << 20,
                       True, True),
            "fast21": (1, 4, 1, 1600000, FAST_SAMPLES[1 << 21], 1 << 21,
                       True, True),
            "fast22": (1, 4, 1, 3100000, FAST_SAMPLES[1 << 22], 1 << 22,
                       True, True),
            "odd21": (2, 3, 3, 1600000, 1500000, 1 << 21, True, True),
            "scenes20": (64, 4, 1, 900000, FAST_SAMPLES[1 << 20], 1 << 20,
                         True, True)}.items():
        draw("delay_sum", tag)
        base, tau, gains, snr, seeds, fade = scene_inputs(b, m, paths,
                                                          total, out)
        nz = (snr, seeds) if noise else (None, None)
        res = compare(
            f"delay_sum[{tag}] B={b} M={m} paths={paths} nfft={nfft} "
            f"out={out} noise={noise} finalize={fin}",
            lambda: cf.delay_sum(base, tau, gains, nfft, out, fade, fin,
                                 *nz),
            lambda: cf.delay_sum_plain(base, tau, gains, nfft, out, fade,
                                       fin, *nz),
            tol=2e-5, reps=3 if b > 1 else 20, scale_by_max=not fin,
            least=scene_bound("delay_sum", b, m, paths, total, out, nfft,
                              None, noise))
        if tag in ("main", "scene", "reverb", "trio", "short",
                   "chunks") or tag in RENDER_SPECTRA_KERNELS:
            log_device(f"delay_sum[{tag}] ({render_note(cf, nfft, b * m)})",
                       lambda: cf.delay_sum(base, tau, gains, nfft, out,
                                            fade, fin, *nz),
                       kernels=ONE_BLOCK_KERNELS.get(tag)
                       or RENDER_SPECTRA_KERNELS.get(tag))
        if tag == "chunks":
            per_call(cf, "delay_sum", lambda: cf.delay_sum(
                base, tau, gains, nfft, out, fade, fin, *nz), 2)
        if tag == "main":
            results["delay_sum"] = res

    # K1: all-pairs GCC-PHAT, band (300, 3400) Hz.  One scene: the api's
    # (B=None) and, at the alias-free length of max_expected_delay=None,
    # whitening every bin (the Wiener front end has no band).  A scene
    # axis: bench_gcc_phat's batch (recorded; PHAT over every bin), the
    # reverberant SRP sweep's and the multi-source cube's, and an odd edge
    # (odd scenes, mics and pairs).  The split at 65,536 and 131,072 (3
    # device kernels a call), one block at 4,096 and below (1).  Through
    # the mic rows' spectra on the split (4 device kernels a call: K4a's
    # two passes into the spectra, K9's row pass reading pairs of them,
    # the column pass): "mics11", 11 mics at 65,536, whose strips do not
    # fit ``gcc_rows``; the 23.7 s recording's 4 mics and 8 mics at 2^21, 4
    # mics at 2^22; 4 mics of an 18 s recording at 2^20 (DEFAULT_CONFIG's
    # full core) and 8 mics at 2^18.  Through them in one block (2 device
    # kernels): 128 scenes of 16 mics at 4,096.
    for tag, (b, m, length, nfft, band) in {
            "api": (None, 4, N, NFFT, (300.0, 3400.0)),
            "no_gate": (None, 4, N, 2 * NFFT, None),
            "main": (GCC_SCENES, 4, N, NFFT, None),
            "reverb": (SWEEP_SCENES, 4, reverb.num_samples, reverb.nfft,
                       (300.0, 3400.0)),
            "multi": (MULTI_SCENES, 8, multi.num_samples, multi.nfft,
                      (300.0, 3400.0)),
            "edge": (5, 3, 1500, 2048, (300.0, 3400.0)),
            "mics11": (None, 11, N, NFFT, (300.0, 3400.0)),
            "long": (None, 4, LONG_SAMPLES, LONG_NFFT, (300.0, 3400.0)),
            "long8": (None, 8, LONG_SAMPLES, LONG_NFFT, (300.0, 3400.0)),
            "long22": (None, 4) + LONG22 + (None,),
            "spectra20": (None, 4, FAST_SAMPLES[1 << 20], 1 << 20,
                          (300.0, 3400.0)),
            "spectra18": (None, 8, 200000, 1 << 18, (300.0, 3400.0)),
            "spectra_block": (MULTI_SCENES, 16, 4000, 4096,
                              (300.0, 3400.0))}.items():
        draw("gcc_all_pairs", tag)
        pi, pj = pairs(m)
        sig = (randn(m, length) if b is None
               else randn(b, m, length)).contiguous()
        mask = cf.band_mask(nfft, band, FS, device=dev)
        scenes = b or 1
        nbytes = 4 * (scenes * (m * length + len(pi) * nfft) + nfft // 2 + 1)
        tol = 1e-6
        if nfft >= cf.STAGE_SPLIT_MAX:
            tol += twin_gap(f"gcc_all_pairs[{tag}]", lambda x, w: (
                cf.gcc_all_pairs_plain(x, pi, pj, nfft, w)), sig, mask)
        res = compare(
            f"gcc_all_pairs[{tag}] B={b} M={m} P={len(pi)} nfft={nfft}",
            lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
            lambda: cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask),
            tol=tol, reps=20 if scenes == 1 else 3,
            least=bound(nbytes, gcc_ops(scenes, m, len(pi), nfft)))
        log_device(f"gcc_all_pairs[{tag}] ({route_note(cf, nfft, m)})",
                   lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
                   kernels=gcc_kernels(cf, nfft, m))
        if tag == "main":
            results["gcc_all_pairs"] = res
        del sig

    # K2: windowed GCC.  Main: the sweep's (512 scenes, wq 6); also the
    # api fast path's single scene (wq 21), an odd edge shape, the short
    # sweep's 512 scenes at 2,048 and the chunks at 512 (one device kernel
    # a launch, ``window_block``).  Through the mic rows' spectra: the
    # api fast path's single scene of 4 mics at 2^20, 2^21 and 2^22 (18 s
    # to 68 s recordings; 4 device kernels a call, ``window_cols`` last)
    # and 512 scenes of 12 mics at 4,096 (2 device kernels, ``corr_block``
    # with the window's epilogue).
    for tag, (b, m, length, nfft, wq) in {
            "main": (SWEEP_SCENES, 4, N, NFFT, 6),
            "api": (1, 4, N, NFFT, 21),
            "odd": (3, 3, 6000, 8192, 2),
            "edge": (2, 3, 3000, 4096, 2),
            "chunks": (CHUNK_SCENES, 4, 400, 512, 2),
            "short": (SWEEP_SCENES, 4, short.num_samples, short.nfft,
                      short_wq),
            "fast20": (1, 4, FAST_SAMPLES[1 << 20], 1 << 20, 21),
            "fast21": (1, 4, FAST_SAMPLES[1 << 21], 1 << 21, 21),
            "fast22": (1, 4, FAST_SAMPLES[1 << 22], 1 << 22, 21),
            "spectra_block": (SWEEP_SCENES, 12, 4000, 4096, 2)}.items():
        draw("gcc_windowed", tag)
        pi, pj = pairs(m)
        sig = randn(b, m, length).contiguous()
        mask = cf.band_mask(nfft, (300.0, 3400.0), FS, device=dev)
        p = len(pi)
        new_route = tag.startswith(("fast", "spectra"))
        tol = 2e-6 if tag == "chunks" else 1e-6
        if nfft > cf.STAGE_SPLIT_MAX:
            tol += twin_gap(f"gcc_windowed[{tag}]", lambda x, w: (
                cf.gcc_windowed_plain(x, pi, pj, nfft, wq, w)[0]), sig, mask)
        # "chunks": float32 rounding over 131,076 rows of 512 lags needs
        # 2e-6, and its margin is small.  `window_block` reads 8.7e-7
        # from the float32 twin on these inputs (the radix-2 passes 1.6e-6)
        # but 2.1e-6 on the A/B tool's inputs of one run, where neither
        # side is exact: at this shape the float32 twin lies up to 1.5e-6
        # from its float64 run, the kernel up to 1.2e-6
        # (tools/torch_rowdft_bench.py, which holds K2 here to that run).
        res = compare(
            f"gcc_windowed[{tag}] B={b} M={m} P={p} nfft={nfft} wq={wq}",
            lambda: cf.gcc_windowed(sig, pi, pj, nfft, wq, mask),
            lambda: cf.gcc_windowed_plain(sig, pi, pj, nfft, wq, mask),
            tol=tol, reps=3 if b > 1 else 20,
            least=scene_bound("gcc_windowed", b, m, 0, 0, length, nfft, wq,
                              0))
        if tag in ("main", "api", "short", "chunks") or new_route:
            log_device(f"gcc_windowed[{tag}] ({route_note(cf, nfft, m)})",
                       lambda: cf.gcc_windowed(sig, pi, pj, nfft, wq, mask),
                       kernels=gcc_kernels(cf, nfft, m) if new_route
                       else ONE_BLOCK_KERNELS.get(tag))
        if tag == "chunks":
            per_call(cf, "gcc_windowed", lambda: cf.gcc_windowed(
                sig, pi, pj, nfft, wq, mask), 2)
        if tag == "main":
            results["gcc_windowed"] = res
        del sig

    # K4a: the bootstrap's and the api's single row (main), no_gate's at
    # 131,072, the single pair's two rows, 1024 rows of phase 7's length
    # and an edge of one block; torch.fft.rfft is the library call.  The
    # device time per call (torch.profiler) is logged beside the CUDA-event
    # time, which a single row's host time between calls dominates.
    # "long": the single pair's two rows of a 23.7 s recording at 2^21 and
    # "long22" one row at 2^22, on the split with strips of 8 columns (2
    # device kernels a call); "split23" and "split24" one row at 2^23 and
    # 2^24 on K4a's split past K9's (the long side in the rows: 2,048 x
    # 4,096 and 4,096 x 4,096, 2 device kernels); "passes25" one row at
    # 2^25, past it, on the radix-2 passes.
    for tag, (rows_n, length, nfft) in {
            "main": (1, N, NFFT), "no_gate": (1, N, 2 * NFFT),
            "single_pair": (2, N, NFFT), "rows": (1024, NFFT, NFFT),
            "edge": (1, 3000, 4096),
            "long": (2, LONG_SAMPLES, LONG_NFFT),
            "long22": (1,) + LONG22, "split23": (1,) + SPLIT23,
            "split24": (1,) + SPLIT24, "passes25": (1,) + PASSES25}.items():
        draw("fft_real", tag)
        x = randn(rows_n, length).contiguous()
        res = compare(
            f"fft_real[{tag}] rows={rows_n} len={length} nfft={nfft}"
            f"{split_note(cf, nfft, rows_n)}",
            lambda: cf.fft_real(x, nfft),
            lambda: cf.fft_real_plain(x, nfft), tol=5e-6,
            reps=20 if rows_n < 1024 else 5,
            least=bound(rows_n * (4 * length + 8 * (nfft // 2 + 1)),
                        rows_n * _rfft_ops(nfft)),
            scale_by_max=True,
            library_fn=lambda: torch.fft.rfft(x, n=nfft))
        log(f"fft_real[{tag}] device time per call: kernel "
            f"{device_ms(lambda: cf.fft_real(x, nfft))['total']:.4f} ms, "
            f"torch.fft.rfft "
            f"{device_ms(lambda: torch.fft.rfft(x, n=nfft))['total']:.4f} ms")
        if tag in ("long", "long22", "split23", "split24", "passes25"):
            log_device(f"fft_real[{tag}]", lambda: cf.fft_real(x, nfft),
                       kernels=PASSES25_KERNELS["fft_real"]
                       if tag == "passes25" else 2)
        if tag == "main":
            results["fft_real"] = res
        del x

    def long_kernels(name, tag):
        """Device kernels a call of K4b or K6 at a case above 2^20: three
        on the split (the column pass, the row pass, the column pass with
        the maxima), six where the draws take two launches under the
        scratch's byte cap, the radix-2 passes' count at 2^25; None
        below."""
        if tag.startswith(("long", "split")):
            return 3
        if tag == "draws24":
            return 6
        return PASSES25_KERNELS[name] if tag == "passes25" else None

    # K4b: bootstrap null at 1000 permuted rows, at the main path's 65,536
    # and no_gate's 131,072 (three launches over the four-step split);
    # edges: two rows (16-row strips) and 999 rows at 4,096 (one block).
    # Above 2^20: the 23.7 s pair's null at phase 10's 64 draws and at the
    # default 1,000 (2,048 x 1,024: strips of 8 columns, 16 rows), 3 rows
    # at 2^22 (8 columns, 8 rows), at 2^23 (8 columns, 4 rows) and at 2^24
    # (4 and 4), 3 device kernels a call each, and 3 rows at 2^25 on the
    # radix-2 passes; their twins run in chunks of rows (the bench tool's
    # ``twin_rows``; up to 2^16 one call).
    # The device time per call and the device kernels a call runs
    # (torch.profiler) are logged beside the CUDA-event time.
    for tag, (rows_n, length, nfft) in {
            "main": (1000, N, NFFT), "no_gate": (1000, N, 2 * NFFT),
            "two": (2, N, NFFT), "edge": (999, 3000, 4096),
            "long": (LONG_DRAWS, LONG_SAMPLES, LONG_NFFT),
            "long1000": (NULL_DRAWS, LONG_SAMPLES, LONG_NFFT),
            "long22": (3,) + LONG22, "split23": (3,) + SPLIT23,
            "split24": (3,) + SPLIT24, "passes25": (3,) + PASSES25}.items():
        draw("bootstrap_peaks", tag)
        sig2 = randn(length)
        keys = rand(rows_n, length)
        rows = sig2[torch.argsort(keys, dim=-1)].contiguous()
        del keys
        s1 = cf.fft_real_plain(randn(1, length), nfft)[0].contiguous()
        res = compare(
            f"bootstrap_peaks[{tag}] rows={rows_n} len={length} nfft={nfft}"
            f"{split_note(cf, nfft, rows_n)}",
            lambda: cf.bootstrap_peaks(s1, rows, nfft),
            lambda: twin_rows(lambda r: cf.bootstrap_peaks_plain(s1, r, nfft),
                              rows, nfft),
            tol=1e-6, reps=3,
            least=bound(8 * (nfft // 2 + 1) + 4 * rows_n * (length + 1),
                        rows_n * (2 * _rfft_ops(nfft) + (nfft // 2) * 15)))
        log_device(f"bootstrap_peaks[{tag}]",
                   lambda: cf.bootstrap_peaks(s1, rows, nfft),
                   kernels=long_kernels("bootstrap_peaks", tag))
        if tag == "main":
            results["bootstrap_peaks"] = res
        del rows

    # K6: the noise null, 1000 draws of 44,100 samples (edge: an odd draw
    # count and n_samp <= nfft/2, the TPU kernel's pruned shape), K4b's
    # shapes above 2^20 and 300 draws at 2^24 (two launches of 256 and 44
    # under ``cuda_fft.SPLIT_SCRATCH_BYTES``).  Bound: K4b's transforms
    # and whitening plus ~10
    # operations per uniform draw.  K6 runs K4b's schedules with the draws
    # made where they are read, so on the same draws (the twin's) its peaks
    # must equal K4b's exactly.
    for tag, (rows_n, n_samp, nfft) in {
            "main": (NULL_DRAWS, N, NFFT),
            "no_gate": (NULL_DRAWS, N, 2 * NFFT),
            "edge": (999, 1500, 4096),
            "long": (LONG_DRAWS, LONG_SAMPLES, LONG_NFFT),
            "long1000": (NULL_DRAWS, LONG_SAMPLES, LONG_NFFT),
            "long22": (3,) + LONG22, "split23": (3,) + SPLIT23,
            "split24": (3,) + SPLIT24, "draws24": (DRAWS24,) + SPLIT24,
            "passes25": (3,) + PASSES25}.items():
        draw("noise_bootstrap_peaks", tag)
        s1 = cf.fft_real_plain(randn(1, n_samp), nfft)[0].contiguous()
        seeds = randint(rows_n, 2)
        res = compare(
            f"noise_bootstrap_peaks[{tag}] draws={rows_n} n_samp={n_samp} "
            f"nfft={nfft}{split_note(cf, nfft, rows_n)}",
            lambda: cf.noise_bootstrap_peaks(s1, seeds, n_samp, nfft),
            lambda: twin_rows(lambda sd: cf.noise_bootstrap_peaks_plain(
                s1, sd, n_samp, nfft), seeds, nfft),
            tol=1e-6, reps=1 if tag == "draws24" else 3,
            least=bound(8 * (nfft // 2 + 1) + 8 * rows_n + 4 * rows_n,
                        rows_n * (2 * _rfft_ops(nfft) + (nfft // 2) * 15
                                  + 10 * n_samp)))
        got = cf.noise_bootstrap_peaks(s1, seeds, n_samp, nfft)
        draws = twin_rows(lambda sd: noise_ops.uniform(sd, n_samp), seeds,
                          nfft)
        want = cf.bootstrap_peaks(s1, draws, nfft)
        del draws
        if not torch.equal(got, want):
            raise AssertionError(
                f"noise_bootstrap_peaks[{tag}] departs from bootstrap_peaks "
                f"on the same draws by {float((got - want).abs().max()):.3e}")
        log(f"noise_bootstrap_peaks[{tag}] equals bootstrap_peaks on the "
            "same draws")
        log_device(f"noise_bootstrap_peaks[{tag}]",
                   lambda: cf.noise_bootstrap_peaks(s1, seeds, n_samp, nfft),
                   kernels=long_kernels("noise_bootstrap_peaks", tag))
        if tag == "main":
            results["noise_bootstrap_peaks"] = res
    # The cases above 2^22 leave tens of GB in the allocator's cache (the
    # 300 draws' 16 GiB scratch, their 10 GB of twin draws): give it back,
    # so that the cases and phases that follow start as they did before.
    torch.cuda.empty_cache()

    # K7: PHAT whitening.  Main: the single pair at the exact length 88,199
    # (44,100 bins); edges: three odd rows, and 44,100 bins that start
    # between two 16-byte words (a view one bin in).  16 bytes a bin.  The
    # device times per call of K7 and torch.sgn are logged beside the
    # CUDA-event times, which the host's time between calls dominates.
    # "boot": a chunk of parity mode's exact-length bootstrap (BOOT_CHUNK
    # rows of the 88,199-point transform's 44,100 bins).
    from pyaudiolocalization_tpu_torch.models.tdoa import BOOT_CHUNK
    for tag, shape in {"main": (1, N), "edge": (3, 1025),
                       "misaligned": (1, N + 1),
                       "boot": (BOOT_CHUNK, N)}.items():
        draw("whiten", tag)
        spec = torch.complex(randn(*shape), randn(*shape)).contiguous()
        if tag == "misaligned":
            spec = spec[..., 1:]
        bins = spec.numel()
        res = compare(
            f"whiten[{tag}] shape={tuple(spec.shape)}",
            lambda: cf.whiten(spec), lambda: cf.whiten_plain(spec),
            tol=1e-6, reps=20, scale_by_max=True,
            least=bound(16 * bins, 6 * bins),
            library_fn=lambda: torch.sgn(spec))
        log(f"whiten[{tag}] device time per call: kernel "
            f"{device_ms(lambda: cf.whiten(spec), 50)['total']:.4f} ms, "
            f"torch.sgn "
            f"{device_ms(lambda: torch.sgn(spec), 50)['total']:.4f} ms")
        if tag == "main":
            results["whiten"] = res

    # The serving path's shapes (phase 11).  K1: the trajectory's segments
    # x subframes (14 segments of the 2 s capture x 8 subframes of 512
    # samples, 4 mics, at 1,024 points) and the crossing walkers' (12 x 8
    # x 256 at 512); K3: every frame of the moving render a scene (1 path,
    # no finalize, the faded frame + budget at the next power of two; the
    # frames carry the windowed base in their first 512 samples); K7: the
    # stream's EMA cross-spectra, 6 pairs x 4,097 bins and 28 x 2,049.
    serving = _load_tool("torch_serving_golden")
    for tag, (lead, m, length, nfft) in {
            "subframes": ((14, 8), 4, 512, 1024),
            "walkers": ((12, 8), 4, 256, 512)}.items():
        draw("gcc_all_pairs", tag)
        pi, pj = pairs(m)
        sig = randn(*lead, m, length).contiguous()
        mask = cf.band_mask(nfft, None, serving.FS, device=dev)
        scenes = math.prod(lead)
        nbytes = 4 * (scenes * (m * length + len(pi) * nfft) + nfft // 2 + 1)
        compare(f"gcc_all_pairs[{tag}] B={lead} M={m} P={len(pi)} "
                f"nfft={nfft}",
                lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
                lambda: cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask),
                tol=1e-6, reps=20,
                least=bound(nbytes, gcc_ops(scenes, m, len(pi), nfft)))
        log_device(f"gcc_all_pairs[{tag}] (schedule n1="
                   f"{cf.gcc_route(nfft, m).n1})",
                   lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
                   kernels=1)
    mv = serving.MOVING
    budget, lead_s = serving.moving_margins(mv["start"], mv["velocity"],
                                            serving.TETRA, mv["duration"],
                                            mv["frame"])
    frames = -(-int(serving.FS * (mv["duration"] + 2.0 * lead_s
                                  / serving.FS)) // (mv["frame"] // 2))
    total, m = mv["frame"] + budget, 4
    nfft = next_pow2(total)
    draw("delay_sum", "moving")
    base = torch.zeros((frames, total), device=dev)
    base[:, :mv["frame"]] = randn(frames, mv["frame"])
    tau = (rand(frames, m, 1) * budget).contiguous()
    gains = rand(frames, m, 1).contiguous()
    fade = fade_window(total, dtype=torch.float32, device=dev)
    compare(f"delay_sum[moving] B={frames} M={m} paths=1 nfft={nfft} "
            f"out={total} noise=False finalize=False",
            lambda: cf.delay_sum(base, tau, gains, nfft, total, fade, False),
            lambda: cf.delay_sum_plain(base, tau, gains, nfft, total, fade,
                                       False),
            tol=2e-5, reps=20, scale_by_max=True,
            least=scene_bound("delay_sum", frames, m, 1, total, total, nfft,
                              None, 0))
    log_device("delay_sum[moving]",
               lambda: cf.delay_sum(base, tau, gains, nfft, total, fade,
                                    False), kernels=1)
    for tag, shape in {"stream": (6, 4097), "stream28": (28, 2049)}.items():
        draw("whiten", tag)
        spec = torch.complex(randn(*shape), randn(*shape)).contiguous()
        bins = spec.numel()
        compare(f"whiten[{tag}] shape={shape}",
                lambda: cf.whiten(spec), lambda: cf.whiten_plain(spec),
                tol=1e-6, reps=20, scale_by_max=True,
                least=bound(16 * bins, 6 * bins),
                library_fn=lambda: torch.sgn(spec))
        log(f"whiten[{tag}] device time per call: kernel "
            f"{device_ms(lambda: cf.whiten(spec), 50)['total']:.4f} ms, "
            f"torch.sgn "
            f"{device_ms(lambda: torch.sgn(spec), 50)['total']:.4f} ms")

    # Phase 12's shapes: K1 over array calibration's events (48 kHz x 0.1
    # s, 4,800 samples, at nfft 16,384, no band): the tetrahedron's 8 and
    # the 6-mic array's 12.
    for tag, (b, m) in {"calibration": (8, 4),
                        "calibration6": (12, 6)}.items():
        draw("gcc_all_pairs", tag)
        pi, pj = pairs(m)
        length, nfft = 4800, 16384
        sig = randn(b, m, length).contiguous()
        mask = cf.band_mask(nfft, None, 48000.0, device=dev)
        nbytes = 4 * (b * (m * length + len(pi) * nfft) + nfft // 2 + 1)
        compare(f"gcc_all_pairs[{tag}] B={b} M={m} P={len(pi)} nfft={nfft}",
                lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
                lambda: cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask),
                tol=1e-6, reps=20,
                least=bound(nbytes, gcc_ops(b, m, len(pi), nfft)))
        log_device(f"gcc_all_pairs[{tag}] ({route_note(cf, nfft, m)})",
                   lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
                   kernels=gcc_kernels(cf, nfft, m))

    # K9: whitened correlation of two K4a spectra, no band
    # (phat_correlation).  Main: the single pair at nfft 65,536; no_gate's
    # 131,072 (both on the split, 2 device kernels a call); edge: three row
    # pairs in one block (1); above 2^20 the single pair of a 23.7 s
    # recording at 2^21 and of 2,000,000 samples at 2^22 (the split with
    # strips of 8, 2 device kernels a call).
    for tag, (rows_n, length, nfft) in {"main": (1, N, NFFT),
                                        "edge": (3, 3000, 4096),
                                        "no_gate": (1, N, 2 * NFFT),
                                        "long": (1, LONG_SAMPLES, LONG_NFFT),
                                        "long22": (1,) + LONG22}.items():
        draw("whitened_corr", tag)
        spec = cf.fft_real_plain(randn(2 * rows_n, length), nfft)
        a, b = spec[:rows_n].contiguous(), spec[rows_n:].contiguous()
        mask = cf.band_mask(nfft, None, None, device=dev)
        bins = nfft // 2 + 1
        tol = 1e-6
        if nfft > cf.STAGE_SPLIT_MAX:
            tol += twin_gap(f"whitened_corr[{tag}]", lambda x, y, w: (
                cf.whitened_corr_plain(x, y, w, nfft)), a, b, mask)
        res = compare(
            f"whitened_corr[{tag}] rows={rows_n} nfft={nfft}",
            lambda: cf.whitened_corr(a, b, mask, nfft),
            lambda: cf.whitened_corr_plain(a, b, mask, nfft),
            tol=tol, reps=20,
            least=bound(16 * rows_n * bins + 4 * bins + 4 * rows_n * nfft,
                        rows_n * (_rfft_ops(nfft) + (nfft // 2) * 15)))
        n1 = cf.corr_schedule(nfft)
        log_device(f"whitened_corr[{tag}] (schedule n1={n1})",
                   lambda: cf.whitened_corr(a, b, mask, nfft),
                   kernels={1: 1, 0: None}.get(n1, 2))
        if tag == "main":
            results["whitened_corr"] = res

    # K5: the whole scene.  Main: the sweep's 512 scenes; the api's scene
    # (22 paths, wq 21) and an odd mic count on the split; edge: out ==
    # nfft in one block; the short sweep's 512 scenes at 2,048 and the
    # chunks at 512 (two device kernels a launch, ``render_block`` and
    # ``window_block``).  Through the mic rows' spectra: 512 scenes of 12
    # mics at 4,096 (``render_block``, K4a's ``fft_real_block`` over the
    # finished signals, ``corr_block``: 3 device kernels) and one scene of
    # 6 mics at 2^18 (the render's split and finalize, then the GCC's 4: 8).
    # Fused and split must agree to 1e-6 with equal argmax: they run the
    # same stage code; at the short sweep's shape, across the chunks and
    # on the spectra routes to the bit.
    for tag, (b, m, paths, total, out, nfft, wq) in {
            "main": (SWEEP_SCENES, 4, 1, 44356, N, NFFT, 6),
            "api": (1, 4, 22, 50292, N, NFFT, 21),
            "odd": (3, 3, 2, 7000, 6000, 8192, 2),
            "edge": (2, 2, 2, 1024, 1024, 1024, 2),
            "chunks": (CHUNK_SCENES, 4, 1, 448, 400, 512, 2),
            "short": (SWEEP_SCENES, 4, 1, short.total_samples,
                      short.num_samples, short.nfft, short_wq),
            "spectra_block": (SWEEP_SCENES, 12, 1, 4094, 4000, 4096, 2),
            "spectra18": (1, 6, 1, 250000, 200000, 1 << 18, 8),
            "fast20": (1, 4, 1, 900000, FAST_SAMPLES[1 << 20], 1 << 20, 21),
            "fast21": (1, 4, 1, 1600000, FAST_SAMPLES[1 << 21], 1 << 21, 21),
            "fast22": (1, 4, 1, 3100000, FAST_SAMPLES[1 << 22], 1 << 22,
                       21)}.items():
        draw("scene_windowed", tag)
        pi, pj = pairs(m)
        base, tau, gains, snr, seeds, fade = scene_inputs(b, m, paths,
                                                          total, out)
        mask = cf.band_mask(nfft, (300.0, 3400.0), FS, device=dev)
        res = compare(
            f"scene_windowed[{tag}] B={b} M={m} paths={paths} nfft={nfft} "
            f"out={out} wq={wq}",
            lambda: cf.scene_windowed(base, tau, gains, pi, pj, nfft, out,
                                      wq, fade, mask, snr, seeds),
            lambda: cf.scene_windowed_plain(base, tau, gains, pi, pj, nfft,
                                            out, wq, fade, mask, snr, seeds),
            tol=1e-5, reps=3,
            least=scene_bound("scene_windowed", b, m, paths, total, out,
                              nfft, wq, 1))
        split = cf.gcc_windowed(cf.delay_sum(base, tau, gains, nfft, out,
                                             fade, True, snr, seeds),
                                pi, pj, nfft, wq, mask)
        fused = cf.scene_windowed(base, tau, gains, pi, pj, nfft, out, wq,
                                  fade, mask, snr, seeds)
        gap = max(float((a - c).abs().max()) for a, c in zip(fused, split))
        log(f"scene_windowed[{tag}] vs delay_sum -> gcc_windowed kernels: "
            f"max |diff| = {gap:.3e}")
        if gap > 1e-6:
            raise AssertionError(f"scene_windowed[{tag}] departs from the "
                                 f"split kernels by {gap:.3e}")
        if tag in ("chunks", "short") or tag in SPECTRA_K5_KERNELS:
            if not all(torch.equal(a, c) for a, c in zip(fused, split)):
                raise AssertionError(f"scene_windowed[{tag}] is not "
                                     "bit-equal to delay_sum -> gcc_windowed")
            log(f"scene_windowed[{tag}] equals delay_sum -> gcc_windowed to "
                "the bit")
        if tag == "chunks":
            per_call(cf, "scene_windowed", lambda: cf.scene_windowed(
                base, tau, gains, pi, pj, nfft, out, wq, fade, mask, snr,
                seeds), 2)
        if tag in ("main", "api", "short", "chunks") or (
                tag in SPECTRA_K5_KERNELS):
            log_device(f"scene_windowed[{tag}] ({route_note(cf, nfft, m)}; "
                       f"{render_note(cf, nfft, b * m)})",
                       lambda: cf.scene_windowed(base, tau, gains, pi, pj,
                                                 nfft, out, wq, fade, mask,
                                                 snr, seeds), 3,
                       SPECTRA_K5_KERNELS.get(tag)
                       or 2 * ONE_BLOCK_KERNELS.get(tag, 0) or None)
        if tag == "main":
            results["scene_windowed"] = res
    start = time.perf_counter()
    rowdft_checks(torch)
    log(f"K10 checks of phase 3: {time.perf_counter() - start:.1f} s")
    return results


def split_note(cf, nfft, rows):
    """" strips c/r/b": the strips of the split's column passes (K4a's pass
    1, K4b's and K6's passes 1 and 3), K4a's pass 2 and K4b's and K6's row
    pass at nfft for ``rows`` rows (``cuda_fft.split_plan``; no launch
    takes a thread-block cluster); "" off the split."""
    if not cf.FFT_REAL_ONE_BLOCK < nfft <= cf.FFT_SPLIT_MAX:
        return ""
    plan = cf.split_plan(nfft, (rows + 1) // 2)
    return (f" strips {plan.cols.strip}/{plan.rows.strip}/"
            f"{plan.boot_rows.strip}")


def gcc_kernels(cf, nfft, mics):
    """Device kernels a call of K1 or K2 runs at nfft with ``mics`` mics a
    scene, by its route (``cuda_fft.gcc_route``): 1 in one block a scene,
    3 on ``gcc_rows`` (K4a's column pass, the row pass, the column pass),
    4 through the mic rows' spectra on the split (K4a's two passes, K9's
    row pass, the column pass), 2 through them in one block (K4a's
    ``fft_real_block``, ``corr_block``); None on the passes."""
    kind = cf.gcc_route(nfft, mics).kind
    return {cf.ROUTE_BLOCK: 1, cf.ROUTE_ROWS: 3, cf.ROUTE_SPECTRA: 4,
            cf.ROUTE_SPECTRA_BLOCK: 2}.get(kind)


def route_note(cf, nfft, mics):
    """'route <name>, n1=<n1>' of K1's and K2's GCC at nfft and ``mics``."""
    route = cf.gcc_route(nfft, mics)
    return f"route {cf.ROUTE_NAMES[route.kind]}, n1={route.n1}"


def render_note(cf, nfft, rows):
    """'render <name>, n1=<n1>, finish <groups>' of K3's render (K5's) at
    nfft for a call of ``rows`` mic rows: its route and the finish's
    blocks a packed mic row (``cuda_fft.finish_groups``); 'render
    n1=<n1>' from a tree without them, for the A/B tool's
    ``--recording``."""
    if not hasattr(cf, "render_route"):
        return f"render n1={cf.scene_stages(nfft, 1)[0]}"
    route = cf.render_route(nfft)
    return (f"render {cf.ROUTE_NAMES[route.kind]}, n1={route.n1}, finish "
            f"{cf.finish_groups(nfft, rows)}")


def per_call(cf, name, fn, want):
    """Raises unless one call of ``fn`` launches ``name`` ``want`` times
    (a launch a scene chunk)."""
    before = cf.LAUNCHES[name]
    fn()
    got = cf.LAUNCHES[name] - before
    log(f"{name}: {got} launches a call")
    if got != want:
        raise AssertionError(f"{name}: {got} launches a call, want {want}")


def traced(bench, fn, calls, want=None):
    """``device_ms`` of ``fn`` (the tool's ``torch.profiler`` trace).  A
    trace now and then records no kernel at all, or only some of a call's,
    and never one that did not run: up to three traces are taken until one
    records ``want`` kernels a call (or, without ``want``, a whole number
    of them), and the one that records the most is returned."""
    best = None
    for _ in range(3):
        dev = bench.device_ms(fn, calls)
        if best is None or dev["kernels"] > best["kernels"]:
            best = dev
        whole = dev["kernels"] and float(dev["kernels"]).is_integer()
        if whole and want in (None, dev["kernels"]):
            break
    return best


def rowdft_checks(torch):
    """Phase 3 for K10, the cases that phase 7's bench (which holds every
    kernel against its twin at its five shapes) does not run: the inverse,
    rep 8 and zero_top at edge shapes; the lane DFT's whitening prologue on
    independent spectra; the chain on four planes of their own and the TPU
    tool's chain (four scaled copies of one plane) at n2 = 64; the
    precision controls, K10a with one or two of the three TF32 products,
    which must miss the limit that the kernel meets; and the device
    kernels a call of K10a (rep 1 and 3) and K10c runs, one a transform
    (``torch.profiler``).  Limits are ``rowdft.TRANSFORM_TOL`` and
    ``CHAIN_TOL`` of max|twin|."""
    from pyaudiolocalization_tpu_torch.ops import rowdft as rd
    bench = _load_tool("torch_rowdft_bench")
    check = bench.check
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    tt = rd.TRANSFORM_TOL

    def planes(*shape):
        return (torch.randn(shape + (rd.N1,), generator=gen, device=dev),
                torch.randn(shape + (rd.N1,), generator=gen, device=dev))

    def held(name, got, want, tol=tt):
        err, scale = check(name, got, want, tol)
        log(f"{name}: {err / scale:.3e} of max (limit {tol:g})")
        return err / scale

    for kind in ("row_dft", "row_stages"):
        fn = getattr(rd, kind)
        for tag, (b, n2, kw) in {
                "inverse": (64, 64, {"inverse": True}),
                "rep8": (32, 1024, {"rep": 8}),
                "zero_top": (32, 1024, {"zero_top": True})}.items():
            xr, xi = planes(b, n2)
            args = (xr[:, :n2 // 2].contiguous(),) if tag == "zero_top" \
                else (xr, xi)
            held(f"{kind}[{tag}] B={b} n2={n2}", fn(*args, **kw),
                 rd.row_dft_plain(*args, **kw))
    for b, n2 in ((64, 64), (32, 1024)):
        xr, xi = planes(b, n2)
        yr, yi = planes(b, n2)
        for kw in ({"conj": True, "twiddle": True}, {"twiddle": True},
                   {"conj": True, "twiddle": True, "cross": (yr, yi)}):
            tag = "+".join(k for k in kw if k != "cross") + (
                " whitened cross" if "cross" in kw else "")
            held(f"lane_dft[{tag}] B={b} n2={n2}", rd.lane_dft(xr, xi, **kw),
                 rd.lane_dft_plain(xr, xi, **kw))
    x4, _ = planes(4, 32, 64)
    for schedule in ("mxu", "stages"):
        held(f"chain[{schedule}, four planes] B=32 n2=64",
             rd.chain(x4, schedule), rd.chain_plain(x4), rd.CHAIN_TOL)
        held(f"chain[{schedule}, the tool's scaled copies] B=32 n2=64",
             rd.chain(x4[0], schedule), rd.chain_plain(x4[0]), rd.CHAIN_TOL)
    # The controls: the same kernel with fewer TF32 products.
    xr, xi = planes(64, 512)
    want = rd.row_dft_plain(xr, xi)
    for terms in (3, 2, 1):
        got = rd._row_launch("row_dft", xr, xi, 512, False, 1, 1.0,
                             terms=terms)
        label = f"row_dft[{terms} TF32 products] B=64 n2=512"
        if terms == 3:
            held(label, got, want)
            continue
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel = err / max(float(w.abs().max()) for w in want)
        log(f"{label} (control): {rel:.3e} of max, must exceed {tt:g}")
        if not rel > tt:
            raise AssertionError(f"{label}: the control meets the limit "
                                 f"{tt:g}, which cannot see the 3xTF32 "
                                 "split")
    # One device kernel a transform.
    for name, fn, want_kernels in (
            ("row_dft", lambda: rd.row_dft(xr, xi), 1),
            ("row_dft rep 3", lambda: rd.row_dft(xr, xi, rep=3), 3),
            ("lane_dft twiddle", lambda: rd.lane_dft(xr, xi, twiddle=True),
             1)):
        dev_ms = traced(bench, fn, 3, want_kernels)
        log(f"{name} B=64 n2=512: {dev_ms['kernels']:g} device kernels a "
            f"call, {dev_ms['total']:.4f} ms ({bench._split(dev_ms)})")
        if dev_ms["kernels"] != want_kernels:
            raise AssertionError(f"{name}: {dev_ms['kernels']:g} device "
                                 f"kernels a call, want {want_kernels}")


# ---------------------------------------------------------------------------
# Phase 4: localize_sound_source
# ---------------------------------------------------------------------------

def scene_configs(default_config):
    base = copy.deepcopy(default_config)
    base["localization"]["lag_mode"] = "physical"
    base["localization"]["sync_mode"] = "none"
    off = copy.deepcopy(base)
    off["source_position"] = [0.2, 0.6, 0.4]
    off["signal_type"] = "chirp"
    return {"default": base, "off_centre": off}


def check_scene(name, res, want, seconds, run):
    est = [float(v) for v in res["estimated_position"]]
    tdoas = [float(v) for v in res["tdoas"]]
    td_err = max(abs(a - b) for a, b in zip(tdoas, want["tdoas"]))
    pos_err = sum((a - b) ** 2 for a, b in
                  zip(est, want["estimated_position"])) ** 0.5
    log(f"main path {name} {run}: {seconds:.3f} s wall, position "
        f"{[round(v, 5) for v in est]} (golden delta {pos_err:.2e} m), max "
        f"TDOA delta {td_err * FS:.3f} samples")
    if not all(map(math.isfinite, est + tdoas)):
        raise AssertionError(f"{name}: non-finite output")
    if td_err > 0.05 / FS:
        raise AssertionError(f"{name}: TDOAs {tdoas} vs golden "
                             f"{want['tdoas']}")
    if pos_err > 5e-3:
        raise AssertionError(f"{name}: position {est} vs golden "
                             f"{want['estimated_position']}")


def run_path(cf, name, fn, expect, forbid=()):
    """Runs ``fn`` with every launch count set to 0 just before and read
    just after; every kernel in ``expect`` must have launched, none in
    ``forbid``.  Returns (fn's result, the counts)."""
    cf.reset_launches()
    out = fn()
    counts = dict(cf.LAUNCHES)
    log(f"launches on {name}: {counts}")
    missing = [k for k in expect if counts[k] == 0]
    extra = [k for k in forbid if counts[k] != 0]
    if missing or extra:
        raise AssertionError(f"{name}: kernels not launched {missing}, "
                             f"launched though off the path {extra}")
    return out, counts


def main_path_phase(cf, torch, slice_golden, sweep_golden, launches):
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import localize_sound_source

    def timed(cfg):
        start = time.perf_counter()
        res = localize_sound_source(cfg, device="cuda", dtype=torch.float32)
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    def full_path():
        for name, cfg in scene_configs(DEFAULT_CONFIG).items():
            want = slice_golden["scenes"][name]
            for run in ("cold", "warm"):
                res, seconds = timed(cfg)
                check_scene(name, res, want, seconds, run)
                pairs = sorted(res["correlation_metrics"])
                sig = [res["correlation_metrics"][p]["significant"]
                       for p in pairs]
                if [list(p) for p in pairs] != want["pairs"]:
                    raise AssertionError(f"{name}: pair order {pairs}")
                if sig != want["significant"]:
                    raise AssertionError(f"{name}: significant {sig} vs "
                                         f"golden {want['significant']}")

    def fast_path():
        cfg = scene_configs(DEFAULT_CONFIG)["default"]
        cfg["localization"]["analyze_correlation"] = False
        cfg["localization"]["visualize_correlation"] = False
        for run in ("cold", "warm"):
            res, seconds = timed(cfg)
            check_scene("fast_path", res, sweep_golden["fast_path"],
                        seconds, run)

    _, counts = run_path(cf, "the full main path", full_path,
                         ("delay_sum", "gcc_all_pairs", "fft_real",
                          "bootstrap_peaks"))
    _add(launches, counts)
    _, counts = run_path(cf, "the windowed fast path", fast_path,
                         ("delay_sum", "gcc_windowed"),
                         ("gcc_all_pairs", "bootstrap_peaks"))
    _add(launches, counts)
    long_scenes(cf, torch, launches)


# The long simulated scenes of phase 4 (seconds, the nfft of K3's render
# and of K2's GCC there) and the kernels of K3's radix-2 render, which
# none of them may run.
LONG_SCENES = ((20, 1 << 20), (60, 1 << 22))
K3_PASS_KERNELS = ("pack_rows", "stockham_pass", "render_mix")


def long_scenes(cf, torch, launches, hold_spectra=True):
    """Phase 4's long simulated scenes: the off-centre chirp scene at 20 s
    and 60 s through the api's windowed fast path
    (``analyze_correlation=False``): K3 renders at 2^20 and 2^22 through
    the base rows' spectra, its finish spread over the card, and K2's GCC
    goes through the mic rows' spectra.  For each, a cold and a warm
    call's wall time and one more call's device time by kernel, which
    holds no kernel of K3's or K2's radix-2 passes (``hold_spectra`` False
    only logs them, for an A/B against a tree that runs them); the TDOAs
    within 0.05 samples of the same scene through the port on the CPU
    (float32, the kernels' plain twins)."""
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import localize_sound_source
    bench = _load_tool("torch_rowdft_bench")
    for seconds, nfft in LONG_SCENES:
        cfg = scene_configs(DEFAULT_CONFIG)["off_centre"]
        cfg["duration"] = float(seconds)
        cfg["localization"].update(analyze_correlation=False,
                                   visualize_correlation=False)
        name = (f"the {seconds} s simulated scene (fast path, nfft {nfft}; "
                f"{render_note(cf, nfft, 4)}; GCC {route_note(cf, nfft, 4)})")

        def run():
            return _wall(torch, lambda: localize_sound_source(
                cfg, device="cuda", dtype=torch.float32))

        (_, cold), counts = run_path(
            cf, name, run, ("delay_sum", "gcc_windowed"),
            ("gcc_all_pairs", "bootstrap_peaks", "scene_windowed"))
        _add(launches, counts)
        (res, warm), counts = run_path(cf, f"{name}, warm", run,
                                       ("delay_sum", "gcc_windowed"))
        _add(launches, counts)
        dev = bench.device_ms(run, 1)
        log(f"{name}: cold {cold:.3f} s, warm {warm:.3f} s wall; device "
            f"time a call {dev['total']:.3f} ms in {dev['kernels']:g} "
            "kernels, by kernel: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(
                    dev.items(), key=lambda kv: -kv[1])
                if k not in ("total", "kernels")) + f" {card_note()}")
        passes = [k for k in dev
                  if any(p in k for p in K3_PASS_KERNELS + K2_PASS_KERNELS)]
        log(f"{name}: K3's and K2's radix-2 pass kernels in the trace: "
            f"{passes or 'none'}")
        if hold_spectra and (passes or "render_spec_rows" not in dev):
            raise AssertionError(f"{name}: K3 or K2 ran the radix-2 passes "
                                 f"{passes}, or no render_spec_rows")
        cpu, cpu_s = _wall(torch, lambda: localize_sound_source(
            cfg, device="cpu", dtype=torch.float32))
        got = [float(t) * FS for t in res["tdoas"]]
        want = [float(t) * FS for t in cpu["tdoas"]]
        err = max(abs(a - b) for a, b in zip(got, want))
        log(f"{name}: TDOAs {[round(v, 4) for v in got]} samples on the "
            f"card, {[round(v, 4) for v in want]} on the CPU ({cpu_s:.1f} "
            f"s), max |diff| {err:.4f} samples")
        if not err <= 0.05 or not all(map(math.isfinite, got)):
            raise AssertionError(f"{name}: the TDOAs depart from the CPU's "
                                 f"by {err:.4f} samples")


# ---------------------------------------------------------------------------
# Phase 4b: the options path
# ---------------------------------------------------------------------------

def render(cfg, torch):
    """The scene's mic signals on the card, as the physical path renders
    them (float32)."""
    from pyaudiolocalization_tpu_torch.models import acoustics
    from pyaudiolocalization_tpu_torch.models.simulator import \
        simulate_signals_fast
    from pyaudiolocalization_tpu_torch.utils.config import SceneConfig
    scene = SceneConfig.from_dict(cfg)
    loc = scene.localization
    c = acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    return simulate_signals_fast(
        scene.source_position, scene.mic_positions, scene.fs, c,
        scene.duration, scene.signal_type, scene.freq, scene.plane_coeffs,
        scene.plane_material_ids, scene.materials.absorption,
        scene.materials.freq, loc.max_reflections, loc.absorption_threshold,
        generator=torch.Generator(device="cuda").manual_seed(0),
        dtype=torch.float32, device="cuda",
        absorption_mode=scene.absorption_mode)


def null_thresholds(cfg, pair, torch):
    """(peak, noise-null threshold, permutation threshold) of one pair of
    a scene, each null over 1000 draws at the path's transform length, on
    the path's filtered signals."""
    from pyaudiolocalization_tpu_torch import api
    from pyaudiolocalization_tpu_torch.models import tdoa
    from pyaudiolocalization_tpu_torch.ops import filters, gccphat
    from pyaudiolocalization_tpu_torch.utils.config import SceneConfig
    loc = SceneConfig.from_dict(cfg).localization
    sigs = render(cfg, torch)
    filtered = filters.noise_reduction(sigs, FS, method=loc.filter_method)
    nfft = api._physical_nfft(sigs.shape[-1], FS, loc.max_expected_delay)
    i, j = pair
    corr = gccphat.gcc_phat_all_pairs(filtered, [i], [j], nfft=nfft,
                                      band=api._resolve_phat_band(loc), fs=FS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    thr = [float(tdoa.bootstrap_significance(
        filtered[i], filtered[j], gen, NULL_DRAWS, bootstrap_mode=mode,
        nfft=nfft)) for mode in ("noise", "permutation")]
    return float(corr.max()), thr[0], thr[1]


def bootstrap_stage(cfg, torch):
    """Warm host time (synchronized) of the bootstrap stage of one call:
    the six pairs' nulls in noise mode, in permutation mode, and the
    permutation draws alone."""
    from pyaudiolocalization_tpu_torch import api
    from pyaudiolocalization_tpu_torch.models import tdoa
    from pyaudiolocalization_tpu_torch.ops import filters
    sigs = filters.noise_reduction(render(cfg, torch), FS)
    nfft = api._physical_nfft(sigs.shape[-1], FS, 0.05)
    gen = torch.Generator(device="cuda").manual_seed(6)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]

    def nulls(mode):
        return [tdoa.bootstrap_significance(sigs[i], sigs[j], gen,
                                            NULL_DRAWS, bootstrap_mode=mode,
                                            nfft=nfft) for i, j in pairs]

    def draws():
        return [tdoa.permuted_rows(sigs[j], NULL_DRAWS, gen)
                for _, j in pairs]

    for name, fn in (("noise nulls (K4a + K6)", lambda: nulls("noise")),
                     ("permutation nulls (draws + K4a + K4b)",
                      lambda: nulls("permutation")),
                     ("permutation draws alone", draws)):
        fn()
        best = min(_wall(torch, fn)[1] for _ in range(3))
        log(f"  bootstrap stage, 6 pairs x {NULL_DRAWS}: {name}: "
            f"{best * 1e3:.3f} ms (best of 3, warm)")


def options_phase(cf, torch, slice_golden, options_golden, launches):
    """The physical-mode options of localize_sound_source at full width,
    each case cold and warm with its own launch counts:

    1. noise_null: the demo and off-centre scenes with the noise null (K6
       in place of K4b), against the slice golden;
    2. weighted: SCOT + median + FIR + DBSCAN + robust LM, no metrics;
    3. no_gate: max_expected_delay=None (K1 at 131,072) + adaptive +
       Wiener + calibration delays;
    4. single_pair: get_time_delays_phat at the exact length (K7) and at
       nfft 65,536 (K4a + K9);
    cases 2-4 against tests/data/torch_options_golden.json."""
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import api, localize_sound_source
    from pyaudiolocalization_tpu_torch.models import tdoa
    cases = options_golden["cases"]

    def timed(cfg, **kw):
        start = time.perf_counter()
        res = localize_sound_source(cfg, device="cuda", dtype=torch.float32,
                                    **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    # Each call's own thresholds, in pair order, as the timed run drew them.
    null_fn = tdoa.bootstrap_significance
    thresholds = []

    def recorded_null(*args, **kw):
        thresholds.append(null_fn(*args, **kw))
        return thresholds[-1]

    def noise_null():
        out = {}
        tdoa.bootstrap_significance = recorded_null
        try:
            for name, cfg in scene_configs(DEFAULT_CONFIG).items():
                cfg["localization"]["bootstrap_mode"] = "noise"
                for run in ("cold", "warm"):
                    thresholds.clear()
                    res, seconds = timed(cfg)
                    check_scene(f"noise_null {name}", res,
                                slice_golden["scenes"][name], seconds, run)
                out[name] = (cfg, res, [float(t) for t in thresholds])
        finally:
            tdoa.bootstrap_significance = null_fn
        return out

    runs, counts = run_path(
        cf, "options path 1 (noise_null)", noise_null,
        ("delay_sum", "gcc_all_pairs", "fft_real", "noise_bootstrap_peaks"),
        ("bootstrap_peaks",))
    _add(launches, counts)
    # The null does not move the TDOAs or the fix; it decides
    # 'significant', which may differ from the golden (a permutation null
    # on another machine) only where the peak lies within 5 % of the
    # threshold that the warm run drew.
    for name, (cfg, res, thr) in runs.items():
        want = slice_golden["scenes"][name]
        pairs = list(res["correlation_metrics"])
        if [list(p) for p in pairs] != want["pairs"] or len(thr) != len(pairs):
            raise AssertionError(f"noise_null {name}: pairs {pairs}, "
                                 f"{len(thr)} thresholds")
        for pair, sig, t in zip(pairs, want["significant"], thr):
            got = res["correlation_metrics"][pair]["significant"]
            if got == sig:
                continue
            peak = float(res["correlation_matrix"][pair])
            log(f"noise_null {name} pair {pair}: significant {got} vs "
                f"golden {sig}; peak {peak:.6f}, the run's noise null "
                f"{t:.6f}")
            if abs(peak - t) > 0.05 * t:
                raise AssertionError(f"noise_null {name} pair {pair}: "
                                     "significant departs from the golden "
                                     "away from the threshold")
    peak, thr_noise, thr_perm = null_thresholds(
        runs["off_centre"][0], (0, 1), torch)
    gap = abs(thr_noise - thr_perm) / thr_perm
    log(f"noise_null off_centre pair (0, 1): peak {peak:.6f}, noise null "
        f"{thr_noise:.6f}, permutation null {thr_perm:.6f} "
        f"({100 * gap:.2f} % apart, {NULL_DRAWS} draws each)")
    if gap > 0.05:
        raise AssertionError("the noise null departs from the permutation "
                             "null by more than 5 %")
    bootstrap_stage(runs["off_centre"][0], torch)

    def golden_case(name, expect, forbid=()):
        case = cases[name]
        calib = case.get("calibration_data")

        def run():
            for run_name in ("cold", "warm"):
                res, seconds = timed(case["config"], calibration_data=calib)
                check_scene(name, res, case, seconds, run_name)

        _, counts = run_path(cf, f"options path ({name})", run, expect,
                             forbid)
        _add(launches, counts)

    golden_case("weighted", ("delay_sum",), ("gcc_all_pairs", "gcc_windowed"))
    if api._physical_nfft(N, FS, None) != 2 * NFFT:
        raise AssertionError("max_expected_delay=None misses the 131,072 "
                             "transform")
    golden_case("no_gate", ("delay_sum", "gcc_all_pairs", "fft_real",
                            "bootstrap_peaks"),
                ("gcc_windowed", "noise_bootstrap_peaks"))

    for scene, case in cases["single_pair"].items():
        sigs = render(case["config"], torch)
        for nfft, expect in ((None, ("whiten",)),
                             (NFFT, ("fft_real", "whitened_corr"))):
            want = case["delays"][f"nfft_{nfft or 'exact'}"]

            def run():
                for run_name in ("cold", "warm"):
                    start = time.perf_counter()
                    got = float(tdoa.get_time_delays_phat(
                        sigs[0], sigs[1], FS, lag_mode="physical",
                        nfft=nfft).delays[0])
                    seconds = time.perf_counter() - start
                    log(f"single_pair {scene} nfft={nfft or 'exact'} "
                        f"{run_name}: {seconds:.4f} s, delay {got * FS:.3f} "
                        f"samples (golden {want * FS:.3f})")
                    if abs(got - want) * FS > 0.05:
                        raise AssertionError(f"single_pair {scene}: {got} "
                                             f"vs golden {want}")

            _, counts = run_path(
                cf, f"options path (single_pair {scene} nfft="
                f"{nfft or 'exact'})", run, expect,
                ("gcc_all_pairs",))
            _add(launches, counts)
    long_null(cf, torch, tdoa, launches)


def long_null(cf, torch, tdoa, launches):
    """bootstrap_significance at nfft 2^21 (a 23.7 s pair at 44.1 kHz),
    both nulls, on the split of K4a with K4b or K6: the
    permutation rows are drawn once and go to the kernel path and to the
    twins; the noise null's seeds are the ones its generator draws.  Held
    within 1e-5 (peaks of float32 correlations at most 1)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    sig1 = torch.randn(LONG_SAMPLES, generator=gen, device=dev)
    sig2 = torch.roll(sig1, 37) + torch.randn(LONG_SAMPLES, generator=gen,
                                              device=dev)
    rows = tdoa.permuted_rows(sig2, LONG_DRAWS, gen)
    out = {}

    def kernels():
        out["permutation"] = float(tdoa.bootstrap_threshold(sig1, rows,
                                                            LONG_NFFT))
        out["noise"] = float(tdoa.bootstrap_significance(
            sig1, sig2, torch.Generator(device=dev).manual_seed(9),
            LONG_DRAWS, bootstrap_mode="noise", nfft=LONG_NFFT))

    start = time.perf_counter()
    _, counts = run_path(cf, "options path (nulls at nfft 2^21)", kernels,
                         ("fft_real", "bootstrap_peaks",
                          "noise_bootstrap_peaks"))
    seconds = time.perf_counter() - start
    _add(launches, counts)
    s1 = cf.fft_real_plain(sig1[None], LONG_NFFT)[0]
    seeds = torch.randint(-2 ** 31, 2 ** 31, (LONG_DRAWS, 2),
                          generator=torch.Generator(device=dev).manual_seed(9),
                          dtype=torch.int32, device=dev)
    want = {"permutation": cf.bootstrap_peaks_plain(s1, rows, LONG_NFFT),
            "noise": cf.noise_bootstrap_peaks_plain(s1, seeds, LONG_SAMPLES,
                                                    LONG_NFFT)}
    for mode, peaks in want.items():
        ref = float(torch.quantile(peaks, 0.95))
        log(f"null at nfft {LONG_NFFT} ({mode}, {LONG_DRAWS} draws of "
            f"{LONG_SAMPLES}): kernels {out[mode]:.6f}, twins {ref:.6f}, "
            f"|diff| {abs(out[mode] - ref):.2e}")
        if not abs(out[mode] - ref) < 1e-5:
            raise AssertionError(f"the {mode} null at nfft {LONG_NFFT} "
                                 "departs from its twins")
    log(f"both nulls at nfft {LONG_NFFT}: {seconds:.3f} s wall (cold)")


def _add(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


# ---------------------------------------------------------------------------
# Phase 5: the sweep
# ---------------------------------------------------------------------------

def _load_tool(name):
    path = REPO / "tools" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _wall(torch, fn):
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def sweep_stages(torch, sw, spec):
    """Warm stage breakdown of one fused 512-scene sweep, each stage timed
    with a synchronize on both sides."""
    from pyaudiolocalization_tpu_torch.models import tdoa as tdoa_ops
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    c = spec.speed_of_sound
    dt = torch.float32
    times = {}

    def stage(name, fn):
        out, seconds = _wall(torch, fn)
        times[name] = seconds * 1e3
        return out

    sources, mics, snr = stage("draw scenes", lambda: sw._random_scene(
        spec, gen, SWEEP_SCENES, dt, dev))
    base, seeds = stage("draw base signals + seeds", lambda: sw._draw_signals(
        spec, gen, SWEEP_SCENES, dt, dev))
    paths = stage("paths", lambda: sw._source_paths(spec, sources[:, 0],
                                                    mics, c))
    pi, pj = spec.pairs
    wq = sw._tdoa_window_wq(spec)

    def k5():
        padded = torch.zeros((SWEEP_SCENES, spec.total_samples), device=dev)
        padded[:, :spec.num_samples] = base[:, 0]
        fade = fade_window(spec.total_samples, dtype=dt,
                           device=dev)[:spec.num_samples].contiguous()
        return cf.scene_windowed(
            padded, (paths.delays * spec.fs).contiguous(),
            paths.gains.contiguous(), pi, pj, spec.nfft, spec.num_samples,
            wq, fade, sw._band_mask(spec, (spec.lowcut, spec.highcut), base),
            snr_db=snr.contiguous(), seeds=seeds)

    win, stats = stage("K5 scene_windowed", k5)
    td = stage("windowed TDOA ladder", lambda: -tdoa_ops.
               tdoa_single_from_window(win, stats, wq, spec.nfft, spec.fs,
                                       spec.max_tdoa))
    est, _ = stage("k-means + multi-start LM", lambda: sw._solve_from_td(
        spec, mics, td, c, gen))
    stage("covariance + summary", lambda: sw.uncertainty_ops.
          position_covariance(est, mics, pi, pj, td, c))
    total = sum(times.values())
    for name, ms in times.items():
        log(f"  sweep stage {name}: {ms:.3f} ms ({100 * ms / total:.1f} %)")
    log(f"  sweep stages total: {total:.3f} ms for {SWEEP_SCENES} scenes")


def sweep_phase(cf, torch, sweep_golden, launches):
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    spec = sw.SweepSpec(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in sweep_golden["spec"].items()})
    if not sw._mono_scene_eligible(spec):
        raise AssertionError("the full-width sweep spec misses the fused "
                             "path")

    # (a) the sweep (fused by its gate) vs the split path on the same
    # draws (the same seed on the same device).
    summary, counts = run_path(
        cf, "the sweep (fused path)", lambda: sw.monte_carlo_sweep(
            spec, 7, SWEEP_SCENES, device="cuda"),
        ("scene_windowed",), ("delay_sum", "gcc_windowed"))
    _add(launches, counts)
    fused = summary.results
    gen = torch.Generator(device="cuda").manual_seed(7)
    split, counts = run_path(
        cf, "the split sweep", lambda: sw._run_scenes(
            spec, gen, SWEEP_SCENES, torch.float32, False),
        ("delay_sum", "gcc_windowed"), ("scene_windowed",))
    _add(launches, counts)
    td_gap = float((fused.tdoas - split.tdoas).abs().max()) * spec.fs
    pos_gap = float((fused.estimate - split.estimate).abs().max())
    log(f"fused vs split over {SWEEP_SCENES} scenes: max TDOA difference "
        f"{td_gap:.4f} samples, max estimate difference {pos_gap:.3e} m")
    if not (td_gap < 0.5 and pos_gap < 1e-3):
        raise AssertionError("fused and split sweep paths disagree")
    if not bool(torch.isfinite(fused.estimate).all()):
        raise AssertionError("non-finite sweep estimates")

    # (b) statistics against the JAX sweep.
    check_statistics("sweep", fused.error, sweep_golden["sweep"])

    # (c) localize_batch on numpy-built scenes.
    builder = _load_tool("torch_sweep_golden")
    signals, _ = builder.batch_scenes(
        sweep_golden["localize_batch"]["seed"], BATCH_SCENES, spec.fs,
        spec.duration, spec.mic_positions, spec.speed_of_sound,
        spec.source_box_lo, spec.source_box_hi)
    signals = torch.as_tensor(signals, device="cuda")
    (est, _, td), counts = run_path(
        cf, "localize_batch", lambda: sw.localize_batch(
            spec, signals, spec.mic_positions, 3, device="cuda"),
        ("gcc_windowed",), ("delay_sum", "scene_windowed"))
    _add(launches, counts)
    k = sweep_golden["localize_batch"]["num_scenes"]
    want_td = torch.tensor(sweep_golden["localize_batch"]["tdoas"])
    want_est = torch.tensor(sweep_golden["localize_batch"]["estimates"])
    td_gap = float((td[:k].double().cpu() - want_td).abs().max()) * spec.fs
    pos_gap = float((est[:k].double().cpu() - want_est).norm(dim=-1).max())
    log(f"localize_batch vs JAX on the first {k} of {BATCH_SCENES} scenes: "
        f"max TDOA difference {td_gap:.4f} samples, max position "
        f"difference {pos_gap:.3e} m")
    if not (td_gap < 0.05 and pos_gap < 5e-3):
        raise AssertionError("localize_batch departs from the JAX answers")

    # Warm throughput: host wall clock around work that ends in a sync.
    _, sweep_s = _wall(torch, lambda: sw.monte_carlo_sweep(
        spec, 21, SWEEP_SCENES, device="cuda"))
    _, batch_s = _wall(torch, lambda: sw.localize_batch(
        spec, signals, spec.mic_positions, 4, device="cuda"))
    log(f"warm monte_carlo_sweep: {SWEEP_SCENES / sweep_s:.1f} scenes/s "
        f"({sweep_s:.3f} s for {SWEEP_SCENES} scenes)")
    log(f"warm localize_batch: {BATCH_SCENES / batch_s:.1f} scenes/s "
        f"({batch_s:.3f} s for {BATCH_SCENES} scenes)")
    sweep_stages(torch, sw, spec)
    chunk_sweep(cf, torch, sw, launches)


def chunk_sweep(cf, torch, sw, launches):
    """The sweep across the scene-chunk boundary: 21,846 scenes at 4 mics
    and nfft 512 (one past the 65,535 grid rows of one launch), fused (K5
    a chunk) against split (K3 then K2, a chunk each) on the same draws,
    scene by scene to the bit."""
    spec = sw.SweepSpec(fs=8000.0, duration=0.05)
    if spec.nfft != 512 or not sw._mono_scene_eligible(spec):
        raise AssertionError("the chunk sweep's spec misses the fused path")
    runs = {}
    for name, fused, expect, forbid in (
            ("fused", True, ("scene_windowed",),
             ("delay_sum", "gcc_windowed")),
            ("split", False, ("delay_sum", "gcc_windowed"),
             ("scene_windowed",))):
        gen = torch.Generator(device="cuda").manual_seed(13)
        (res, seconds), counts = run_path(
            cf, f"the sweep across the scene chunks ({name})",
            lambda: _wall(torch, lambda: sw._run_scenes(
                spec, gen, CHUNK_SCENES, torch.float32, fused)),
            expect, forbid)
        _add(launches, counts)
        short = [k for k in expect if counts[k] < 2]
        if short:
            raise AssertionError(f"{short}: fewer than two launches over "
                                 f"{CHUNK_SCENES} scenes")
        runs[name] = res
        log(f"sweep of {CHUNK_SCENES} scenes ({name}): {seconds:.3f} s "
            f"wall, {CHUNK_SCENES / seconds:.1f} scenes/s")
    fused, split = runs["fused"], runs["split"]
    if not (torch.equal(fused.tdoas, split.tdoas)
            and torch.equal(fused.estimate, split.estimate)):
        raise AssertionError("fused and split sweeps across the scene "
                             "chunks are not bit-equal")
    if not bool(torch.isfinite(fused.estimate).all()):
        raise AssertionError("non-finite estimates across the scene chunks")
    log(f"fused equals split to the bit over {CHUNK_SCENES} scenes; hit rate "
        f"{float((fused.error < 0.1).float().mean()):.4f}")


# ---------------------------------------------------------------------------
# Phase 6: SRP and multi-source
# ---------------------------------------------------------------------------

SRP_PATH = ("delay_sum", "gcc_all_pairs")
WINDOWED = ("gcc_windowed", "scene_windowed")


def _spec(args):
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw

    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v
    return sw.SweepSpec(**{k: tup(v) for k, v in args.items()})


def srp_specs():
    """bench.py's reverberant SRP sweep and multi-source cube, as the SRP
    golden records them."""
    golden = json.loads(SRP_GOLDEN.read_text())
    return (_spec(golden["reverberant"]["spec"]),
            _spec(golden["multi_spatial"]["spec"]))


def check_statistics(name, err, want):
    """Hit rate within 3 binomial sigma of the JAX sweep's and median error
    within a factor of 2 (a broken estimator moves the median by orders of
    magnitude; two draws of a few hundred scenes move it by well under a
    factor of 2).  ``err`` holds every source's error of every scene."""
    err = err.double().cpu().flatten()
    hit = float((err < 0.1).double().mean())
    median = float(err.median())
    n1, n2 = err.numel(), want.get("num_errors", want["num_scenes"])
    pooled = (hit * n1 + want["hit_rate"] * n2) / (n1 + n2)
    pooled = min(max(pooled, 1.0 / (n1 + n2)), 1.0 - 1.0 / (n1 + n2))
    sigma = math.sqrt(pooled * (1 - pooled) * (1 / n1 + 1 / n2))
    log(f"{name} statistics: hit rate {hit:.4f} (JAX {want['hit_rate']:.4f},"
        f" 3 sigma = {3 * sigma:.4f}), median error {median:.5f} m (JAX "
        f"{want['median_error_m']:.5f} m), rmse "
        f"{float(err.pow(2).mean().sqrt()):.5f} m over {n1} errors")
    if abs(hit - want["hit_rate"]) > 3 * sigma:
        raise AssertionError(f"{name}: hit rate departs from the JAX "
                             "sweep's")
    if not want["median_error_m"] / 2 <= median <= 2 * want["median_error_m"]:
        raise AssertionError(f"{name}: median error departs from the JAX "
                             "sweep's by more than a factor of 2")


def srp_sweep_stages(torch, sw, spec):
    """Warm stage breakdown of one 512-scene SRP sweep (the split path:
    K3, then K1 over every scene, the full ladder, the SRP search), each
    stage timed with a synchronize on both sides."""
    from pyaudiolocalization_tpu_torch.models import srp as srp_ops
    from pyaudiolocalization_tpu_torch.models import tdoa as tdoa_ops
    from pyaudiolocalization_tpu_torch.models.simulator import render_scene
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    c = spec.speed_of_sound
    n = spec.num_samples
    pi, pj = spec.pairs
    times = {}

    def stage(name, fn):
        out, seconds = _wall(torch, fn)
        times[name] = seconds * 1e3
        return out

    sources, mics, snr = stage("draw scenes", lambda: sw._random_scene(
        spec, gen, SWEEP_SCENES, torch.float32, dev))
    base, seeds = stage("draw base signals + seeds", lambda: sw._draw_signals(
        spec, gen, SWEEP_SCENES, torch.float32, dev))
    paths = stage("paths (image sources)", lambda: sw._source_paths(
        spec, sources[:, 0], mics, c))
    sigs = stage("K3 delay_sum", lambda: render_scene(
        base[:, 0], paths.delays, paths.gains, spec.fs, spec.total_samples,
        n, finalize=True, snr_db=snr, noise_seeds=seeds))
    corr = stage("K1 gcc_all_pairs", lambda: sw._correlate(
        spec, sigs, (spec.lowcut, spec.highcut)))
    td = stage("TDOA ladder", lambda: -tdoa_ops.time_delays_from_corr(
        corr, n, n, spec.fs, threshold_method=spec.threshold_method,
        max_expected_delay=spec.max_tdoa).delays[..., 0])
    lower, upper, kw = sw._srp_args(spec, corr)
    ml = srp_ops._resolve_max_lag(kw["max_lag_samples"], mics, spec.fs, c)
    coarse_fn, fine_fn = stage("SRP windows + pooling", lambda: srp_ops.
                               _map_fns(corr, mics, pi, pj, spec.fs, c,
                                        kw["pool_samples"], ml))
    cell = (upper - lower) / srp_ops.COARSE_N

    def coarse():
        pts = srp_ops._grid_points(lower, upper, srp_ops.COARSE_N)
        return srp_ops._take_point(pts, torch.argmax(coarse_fn(pts), -1))

    center = stage("SRP coarse map (24^3)", coarse)
    pos, _ = stage("SRP fine map (12^3)", lambda: srp_ops._fine_stage(
        fine_fn, center, cell, 12))
    est, _ = stage("SRP refine", lambda: srp_ops.axis_refine(
        fine_fn, pos, cell, 12, lower, upper))
    stage("covariance", lambda: sw.uncertainty_ops.position_covariance(
        est, mics, pi, pj, td, c))
    total = sum(times.values())
    for name, ms in times.items():
        log(f"  srp sweep stage {name}: {ms:.3f} ms "
            f"({100 * ms / total:.1f} %)")
    log(f"  srp sweep stages total: {total:.3f} ms for {SWEEP_SCENES} "
        "scenes")


def srp_phase(cf, torch, srp_golden, launches):
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import localize_sound_source
    from pyaudiolocalization_tpu_torch.ops import gccphat
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw

    def record(name, fn, expect=SRP_PATH, forbid=WINDOWED):
        torch.cuda.reset_peak_memory_stats()
        out, counts = run_path(cf, name, fn, expect, forbid)
        _add(launches, counts)
        log(f"  peak device memory on {name}: "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
        return out

    # (1) localize_sound_source with the SRP solvers, both scenes.
    def api_scenes():
        for solver in ("srp", "srp+lm"):
            for name, cfg in scene_configs(DEFAULT_CONFIG).items():
                cfg["localization"]["solver"] = solver
                want = srp_golden["scenes"][f"{name}/{solver}"]
                for run in ("cold", "warm"):
                    start = time.perf_counter()
                    res = localize_sound_source(cfg, device="cuda",
                                                dtype=torch.float32)
                    torch.cuda.synchronize()
                    check_scene(f"{name}/{solver}", res, want,
                                time.perf_counter() - start, run)
                    if res["uncertainty"]["heuristic"] != want["heuristic"]:
                        raise AssertionError(f"{name}/{solver}: heuristic "
                                             "flag departs from the golden")

    record("the api's SRP solvers", api_scenes,
           SRP_PATH + ("fft_real", "bootstrap_peaks"))

    # (2) the reverberant SRP sweep, each solver: statistics, warm rate.
    reverb, multi = srp_specs()
    for solver, key in (("srp", "reverberant"), ("srp+lm", "reverberant_lm")):
        spec = dataclasses.replace(reverb, solver=solver)
        if sw._mono_scene_eligible(spec) or sw._use_windowed(spec):
            raise AssertionError(f"{solver}: the SRP sweep takes a windowed "
                                 "path")
        summary = record(f"the reverberant {solver} sweep",
                         lambda: sw.monte_carlo_sweep(spec, 7, SWEEP_SCENES,
                                                      device="cuda"))
        if not bool(torch.isfinite(summary.results.estimate).all()):
            raise AssertionError(f"{solver}: non-finite sweep estimates")
        check_statistics(f"reverberant {solver} sweep",
                         summary.results.error, srp_golden[key])
        _, seconds = _wall(torch, lambda: sw.monte_carlo_sweep(
            spec, 21, SWEEP_SCENES, device="cuda"))
        log(f"warm reverberant {solver} sweep: "
            f"{SWEEP_SCENES / seconds:.1f} scenes/s ({seconds:.3f} s for "
            f"{SWEEP_SCENES} scenes)")
    srp_sweep_stages(torch, sw, reverb)

    # (3) the multi-source cube, spatial and claim suppression.
    for sup in ("spatial", "claim"):
        spec = dataclasses.replace(multi, suppression=sup)
        summary = record(f"the multi-source {sup} sweep",
                         lambda: sw.monte_carlo_sweep(spec, 7, MULTI_SCENES,
                                                      device="cuda"))
        if summary.results.estimate.shape != (MULTI_SCENES, 2, 3):
            raise AssertionError("multi-source estimates of shape "
                                 f"{tuple(summary.results.estimate.shape)}")
        check_statistics(f"multi-source {sup} sweep", summary.results.error,
                         srp_golden[f"multi_{sup}"])
        _, seconds = _wall(torch, lambda: sw.monte_carlo_sweep(
            spec, 21, MULTI_SCENES, device="cuda"))
        log(f"warm multi-source {sup} sweep: "
            f"{MULTI_SCENES / seconds:.1f} scenes/s ({seconds:.3f} s for "
            f"{MULTI_SCENES} scenes)")

    # (4) localize_batch srp on numpy-built scenes, per scene.
    case = srp_golden["localize_batch"]
    spec = _spec(case["spec"])
    signals, _ = _load_tool("torch_sweep_golden").batch_scenes(
        case["seed"], case["num_scenes"], spec.fs, spec.duration,
        spec.mic_positions, spec.speed_of_sound, spec.source_box_lo,
        spec.source_box_hi)
    signals = torch.as_tensor(signals, device="cuda")
    est, _, td = record("localize_batch srp", lambda: sw.localize_batch(
        spec, signals, spec.mic_positions, device="cuda"),
        ("gcc_all_pairs",), WINDOWED + ("delay_sum",))
    td_gap = float((td.double().cpu() - torch.tensor(case["tdoas"])).abs()
                   .max()) * spec.fs
    gaps = (est.double().cpu() - torch.tensor(case["estimates"])).norm(
        dim=-1)
    clear = torch.tensor(case["coarse_margin"]) > 1e-3
    log(f"localize_batch srp vs JAX on {case['num_scenes']} scenes: max "
        f"TDOA difference {td_gap:.4f} samples, max position difference "
        f"{float(gaps[clear].max()):.3e} m on the {int(clear.sum())} scenes "
        f"with a clear coarse margin, {float(gaps.max()):.3e} m on all")
    if not (td_gap < 0.05 and float(gaps[clear].max()) < 5e-3):
        raise AssertionError("localize_batch srp departs from the JAX "
                             "answers")

    # (5) batched GCC-PHAT at bench_gcc_phat's shape.
    pi, pj = sw._pairs(4)
    x = torch.randn((GCC_SCENES, 4, N), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    record("batched GCC-PHAT", lambda: gccphat.gcc_phat_all_pairs(
        x, pi, pj, nfft=NFFT), ("gcc_all_pairs",), WINDOWED + ("delay_sum",))
    ms = time_ms(lambda: gccphat.gcc_phat_all_pairs(x, pi, pj, nfft=NFFT), 5)
    log(f"batched GCC-PHAT {GCC_SCENES} x 4 x {N} -> nfft {NFFT}: "
        f"{ms:.3f} ms, {GCC_SCENES * len(pi) / ms * 1e3:.0f} pairs/s")


# ---------------------------------------------------------------------------
# Phase 8: parity mode and the default demo
# ---------------------------------------------------------------------------

PARITY_FORBID = ("gcc_all_pairs", "delay_sum", "fft_real", "bootstrap_peaks",
                 "gcc_windowed", "scene_windowed", "noise_bootstrap_peaks",
                 "whitened_corr")
DEMO_PATH = ("delay_sum", "gcc_all_pairs", "fft_real", "bootstrap_peaks")
# A pair's chosen peak is "clear" of its runner-up above this relative
# margin; below it a float32 run may pick the other peak of a near-tie.
CLEAR_MARGIN = 1e-3


def check_parity(name, res, shifts, golden, fs):
    """One run against the golden case: sync shifts before rounding within
    one step of the spline's fine grid (4/99 sample, plus float32's 2^-8)
    and the same pads;
    TDOAs equal in samples where the pair's margin is clear (a flip
    elsewhere is reported, and must be the JAX package's float32 answer,
    an unclear pair's, or a move to the adjacent lag where the golden's
    neighbour gap is not clear); the position within 5 mm where every TDOA
    agrees
    (the cost within 1 % where the JAX run fell back to DE);
    'significant' where the peak is 10 % clear of the JAX threshold."""
    want, want32 = golden["float64"], golden["float32"]
    gap = max(abs(a - b) for a, b in zip(shifts, want["sync_shifts"]))
    pads = [max(0, int(round(s - min(shifts)))) for s in shifts]
    log(f"{name}: sync shifts {[round(s, 4) for s in shifts]} (golden "
        f"{[round(s, 4) for s in want['sync_shifts']]}, max |diff| "
        f"{gap:.4f} samples), pads {pads}")
    # One step of the spline's fine grid (4/99 sample: signals equal to
    # rounding refine their lag-0 peak to either side of 0) plus float32's
    # resolution of a shift near 44,100 samples (2^-8).
    if gap > 4.0 / 99 + 2.0 ** -8 or pads != want["sync_pads"]:
        raise AssertionError(f"{name}: sync shifts {shifts} vs golden "
                             f"{want['sync_shifts']}")
    tdoas = [float(v) for v in res["tdoas"]]
    agree = True
    for k, (td, m) in enumerate(zip(tdoas, want["margins"])):
        diff = abs(td - want["tdoas"][k]) * fs
        if diff < 0.01:
            continue
        agree = False
        alt = abs(td - want32["tdoas"][k]) * fs < 0.01
        # A move to the adjacent lag where the chosen sample is not clear
        # of its neighbour (golden files before the field have none).
        gap = want.get("neighbour_gaps", [1.0] * len(tdoas))[k]
        near = diff < 1.01 and gap <= CLEAR_MARGIN
        log(f"{name} pair {want['pairs'][k]}: TDOA {td * fs:.3f} samples vs "
            f"golden {want['tdoas'][k] * fs:.3f} (float32 golden "
            f"{want32['tdoas'][k] * fs:.3f}), peak margin {m:.2e}, "
            f"neighbour gap {gap:.2e}: a flip")
        if m > CLEAR_MARGIN and not alt and not near:
            raise AssertionError(f"{name}: TDOA of pair {k} departs from the "
                                 "golden where its peak is clear")
    est = [float(v) for v in res["estimated_position"]]
    pos_err = sum((a - b) ** 2 for a, b in
                  zip(est, want["estimated_position"])) ** 0.5
    log(f"{name}: position {[round(v, 5) for v in est]} (golden delta "
        f"{pos_err:.2e} m), cost {float(res['cost']):.4e} (golden "
        f"{want['cost']:.4e}), DE fallback {want['heuristic']}")
    if not all(map(math.isfinite, est + tdoas)):
        raise AssertionError(f"{name}: non-finite output")
    if agree and want["heuristic"]:
        if abs(float(res["cost"]) - want["cost"]) > 0.01 * max(
                abs(want["cost"]), 1e-12):
            raise AssertionError(f"{name}: DE cost departs from the golden")
    elif agree and pos_err > 5e-3:
        raise AssertionError(f"{name}: position {est} vs golden "
                             f"{want['estimated_position']}")
    elif not agree:
        log(f"{name}: position not held (a TDOA flipped at a near-tie)")
    pairs = sorted(res["correlation_metrics"])
    for k, pair in enumerate(pairs):
        peak, thr = want["peak"][k], want["threshold"][k]
        got = res["correlation_metrics"][pair]["significant"]
        if abs(peak - thr) > 0.1 * thr and got != want["significant"][k]:
            raise AssertionError(f"{name} pair {pair}: significant {got} vs "
                                 f"golden {want['significant'][k]}")


def parity_stages(torch, calibration):
    """Warm stage breakdown of one parity-mode call on the demo scene (the
    second of two passes; each stage timed with a synchronize on both
    sides): the calibration run, the exact 2N render, the pre-sync, the
    front end, the exact-length GCC, the ladder, the six nulls (and their
    permutation draws alone), the clustered LM."""
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG, api
    from pyaudiolocalization_tpu_torch import run_calibration
    from pyaudiolocalization_tpu_torch.models import simulator, sync, tdoa
    from pyaudiolocalization_tpu_torch.ops import filters, gccphat
    from pyaudiolocalization_tpu_torch.utils.config import SceneConfig
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["localization"]["lag_mode"] = "reference"
    scene = SceneConfig.from_dict(cfg)
    loc = scene.localization
    c = api.acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    pi = [p[0] for p in scene.mic_pairs]
    pj = [p[1] for p in scene.mic_pairs]
    f32 = torch.float32
    mics = torch.as_tensor(scene.mic_positions, dtype=f32, device="cuda")
    calib = torch.as_tensor([d["delay"] for d in calibration], dtype=f32,
                            device="cuda")
    for _ in range(2):
        gen = torch.Generator(device="cuda").manual_seed(0)
        times = {}

        def stage(name, fn):
            out, seconds = _wall(torch, fn)
            times[name] = seconds * 1e3
            return out

        stage("run_calibration", lambda: run_calibration(
            cfg, dtype=f32, device="cuda"))
        sigs = stage("simulate (exact 2N render)", lambda: (
            simulator.simulate_signals(
                scene.source_position, scene.mic_positions, scene.fs, c,
                scene.duration, scene.signal_type, scene.freq,
                scene.plane_coeffs, scene.plane_material_ids,
                scene.materials.absorption, scene.materials.freq,
                loc.max_reflections, loc.absorption_threshold,
                generator=gen, dtype=f32, device="cuda")))
        x = stage("pre-sync", lambda: torch.stack(
            sync.synchronize_signals(list(sigs), scene.fs)))
        n = x.shape[-1]
        nfft = 2 * n - 1
        filtered = stage("Butterworth", lambda: filters.noise_reduction(
            x, scene.fs, method=loc.filter_method))
        corr = stage("exact-length GCC (K7)", lambda: (
            gccphat.gcc_phat_all_pairs(filtered, pi, pj, nfft=nfft)))
        res = stage("reference ladder", lambda: tdoa.time_delays_from_corr(
            corr, n, n, scene.fs, threshold_method="median",
            max_expected_delay=loc.max_expected_delay, lag_mode="reference"))
        stage(f"6 nulls x {NULL_DRAWS} (draws, exact transforms, K7)",
              lambda: [tdoa.bootstrap_significance(
                  filtered[i], filtered[j], gen, NULL_DRAWS, nfft=nfft)
                  for i, j in zip(pi, pj)])
        stage("  of which the permutation draws", lambda: [
            tdoa.permuted_rows(filtered[j], NULL_DRAWS, gen) for j in pj])
        td = api._calibrated(res.delays[..., 0], calib, pi, pj)
        weights = tdoa.compute_weights(tdoa.correlation_snr(corr))
        stage("k-means guesses + multi-start LM", lambda: api._solve(
            mics, c, gen, pi, pj, td, weights, loc))
    total = sum(v for k, v in times.items() if not k.startswith(" "))
    for name, ms in times.items():
        log(f"  parity stage {name}: {ms:.3f} ms ({100 * ms / total:.1f} %)")
    log(f"  parity stages total: {total:.3f} ms (warm)")


def parity_phase(cf, torch, parity_golden, launches):
    """Parity mode and the default demo at full width (44.1 kHz x 1 s, 4
    mics, 3 reflection orders, Butterworth, 1000 permutation draws a pair),
    in a temporary working directory (parity mode draws its figure):

    1. run_calibration on the card: one entry a mic, every SNR below the
       gate (SURVEY.md Q2: the default materials leave the recordings
       signal-free; the port's generator is not the JAX package's);
    2. localize_sound_source in parity mode (lag_mode='reference') with
       the JAX package's calibration data, cold and warm, on the demo scene
       (a near-tie at every pair: the source is equidistant from the mics)
       and an off-centre one (clear peaks): K7 only;
    3. the default demo's configuration (the physical lag axis with the
       reference pre-sync, calibration behind the SNR gate), cold and warm,
       with the same calibration data;
    4. ``python -m pyaudiolocalization_tpu_torch --no-plots`` in-process,
       with the port's own calibration (which the gate sets aside, so its
       answer is case 3's).
    Each against tests/data/torch_parity_golden.json (``check_parity``)."""
    import os
    import tempfile
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import __main__ as demo
    from pyaudiolocalization_tpu_torch import localize_sound_source
    from pyaudiolocalization_tpu_torch import run_calibration
    from pyaudiolocalization_tpu_torch.models import sync
    calibration = parity_golden["calibration_data"]
    cwd = os.getcwd()
    shifts_fn = sync._sync_shifts
    seen = {}

    def recorded_shifts(*args, **kw):
        seen["shifts"] = [float(v) for v in shifts_fn(*args, **kw).tolist()]
        return shifts_fn(*args, **kw)

    os.chdir(tempfile.mkdtemp(prefix="chip_smoke_parity_"))
    sync._sync_shifts = recorded_shifts
    try:
        (results, _sig, rec), counts = run_path(
            cf, "run_calibration", lambda: run_calibration(
                DEFAULT_CONFIG, dtype=torch.float32, device="cuda"), ())
        snr = [r["snr"] for r in results]
        log(f"run_calibration on the card: delays "
            f"{[r['delay'] for r in results]}, snr {snr}")
        if (len(results) != 4 or tuple(rec.shape) != (4, N)
                or not all(s < 20.0 for s in snr)):
            raise AssertionError("run_calibration: shapes or a signal above "
                                 "the SNR gate (Q2 says noise only)")
        for name, case in parity_golden["cases"].items():
            parity = case["lag_mode"] == "reference"
            expect, forbid = ((("whiten",), PARITY_FORBID) if parity
                              else (DEMO_PATH, WINDOWED))
            cfg = copy.deepcopy(DEFAULT_CONFIG)
            cfg["localization"]["lag_mode"] = case["lag_mode"]
            cfg["localization"]["visualize_correlation"] = False
            cfg["source_position"] = case["source_position"]

            def run():
                for run_name in ("cold", "warm"):
                    start = time.perf_counter()
                    res = localize_sound_source(
                        cfg, calibration_data=calibration, device="cuda",
                        dtype=torch.float32, show_plots=False)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - start
                    log(f"{name} {run_name}: {seconds:.3f} s wall")
                    check_parity(f"{name} {run_name}", res, seen["shifts"],
                                 case, FS)

            _, counts = run_path(cf, f"the {name} path", run, expect, forbid)
            _add(launches, counts)
        # The command-line demo, its result caught on its way out.
        got = {}
        api_fn = demo.localize_sound_source

        def caught(*args, **kw):
            got["res"] = api_fn(*args, **kw)
            return got["res"]

        demo.localize_sound_source = caught
        try:
            start = time.perf_counter()
            _, counts = run_path(cf, "python -m pyaudiolocalization_tpu_torch"
                                 " --no-plots", lambda: demo.main(
                                     ["--no-plots"]), DEMO_PATH, WINDOWED)
            seconds = time.perf_counter() - start
        finally:
            demo.localize_sound_source = api_fn
        _add(launches, counts)
        log(f"the command-line demo: {seconds:.3f} s wall (calibration "
            f"included)")
        check_parity("the command-line demo", got["res"], seen["shifts"],
                     parity_golden["cases"]["demo"], FS)
        parity_stages(torch, calibration)
    finally:
        sync._sync_shifts = shifts_fn
        os.chdir(cwd)


# ---------------------------------------------------------------------------
# Phase 9: the narrowband solvers, per-bin absorption, the sweep's modes
# ---------------------------------------------------------------------------

NB_FORBID = ("gcc_windowed", "scene_windowed")
# The sweep's render of tones and the narrowband search: K3 only.
NB_SWEEP_FORBID = ("gcc_all_pairs", "gcc_windowed", "scene_windowed")
PRODUCTION = tuple(k for k in KERNELS if k not in ("row_dft", "row_stages",
                                                   "lane_dft"))
# Position tolerances against the golden: the float32 eigh of cuSOLVER
# bounds MUSIC's fine stage near 1 cm (EVALUATION.md "Narrowband trio").
NB_POS_TOL = {"beam": 2e-3, "music": 15e-3, "capon": 2e-3}


def card_note():
    """The card's name and power limit, beside every number logged."""
    return f"[{CARD[0]}]"


def idle_share(torch, bench, fn):
    """(wall ms, device ms, idle share) of one warm call of ``fn``: the
    device's kernel time (``torch.profiler``) against the host's wall
    clock around the same call."""
    dev = bench.device_ms(fn, 1)
    _, wall = _wall(torch, fn)
    wall_ms = wall * 1e3
    return wall_ms, dev["total"], 1.0 - dev["total"] / wall_ms


def check_nb_fix(name, solver, est, want, margin):
    """A narrowband fix against the golden: within NB_POS_TOL where the
    golden coarse map's top is clear of its runner-up (CLEAR_MARGIN);
    a near-tie is reported, not held."""
    gap = sum((float(a) - b) ** 2 for a, b in zip(est, want)) ** 0.5
    clear = margin > CLEAR_MARGIN
    log(f"{name}: position {[round(float(v), 5) for v in est]} (golden "
        f"delta {gap:.2e} m, coarse margin {margin:.2e}"
        f"{'' if clear else ': a near-tie, not held'})")
    if not all(math.isfinite(float(v)) for v in est):
        raise AssertionError(f"{name}: non-finite fix")
    if clear and gap > NB_POS_TOL[solver]:
        raise AssertionError(f"{name}: position {list(est)} vs golden "
                             f"{want}")
    return gap


def api_nb_stages(torch, solver, cfg):
    """Warm stage breakdown of one narrowband localize_sound_source call
    (the demo scene, the second of two passes; each stage timed with a
    synchronize on both sides), and the same scene's per-bin render with
    the material table's frequency coefficients scaled to 1e-5 of the
    reference's (physically scaled)."""
    from pyaudiolocalization_tpu_torch import api
    from pyaudiolocalization_tpu_torch.models import simulator, tdoa
    from pyaudiolocalization_tpu_torch.ops import filters, gccphat
    from pyaudiolocalization_tpu_torch.utils.config import SceneConfig
    scene = SceneConfig.from_dict(cfg)
    loc = scene.localization
    c = api.acoustics.speed_of_sound_host(scene.celsius, scene.humidity)
    pi = [p[0] for p in scene.mic_pairs]
    pj = [p[1] for p in scene.mic_pairs]
    f32 = torch.float32
    mics = torch.as_tensor(scene.mic_positions, dtype=f32, device="cuda")
    blo, bhi, _, _ = api._srp_grid_knobs(scene, loc, scene.fs, c)
    band = api._resolve_phat_band(loc)
    for _ in range(2):
        gen = torch.Generator(device="cuda").manual_seed(0)
        times = {}

        def stage(name, fn):
            out, seconds = _wall(torch, fn)
            times[name] = seconds * 1e3
            return out

        sigs = stage("render (K3)", lambda: simulator.simulate_signals_fast(
            scene.source_position, scene.mic_positions, scene.fs, c,
            scene.duration, scene.signal_type, scene.freq,
            scene.plane_coeffs, scene.plane_material_ids,
            scene.materials.absorption, scene.materials.freq,
            loc.max_reflections, loc.absorption_threshold, generator=gen,
            dtype=f32, device="cuda"))
        n = sigs.shape[-1]
        nfft = api._physical_nfft(n, scene.fs, loc.max_expected_delay)
        filtered = stage("Butterworth", lambda: filters.noise_reduction(
            sigs, scene.fs, method=loc.filter_method))
        corr = stage("GCC (K1)", lambda: gccphat.gcc_phat_all_pairs(
            filtered, pi, pj, nfft=nfft, band=band, fs=scene.fs))
        stage("TDOA ladder", lambda: tdoa.time_delays_from_corr(
            corr, n, n, scene.fs, max_expected_delay=loc.max_expected_delay))
        stage(f"6 nulls x {loc.num_bootstrap} (K4a, K4b)", lambda: [
            tdoa.bootstrap_significance(filtered[i], filtered[j], gen,
                                        loc.num_bootstrap, nfft=nfft)
            for i, j in zip(pi, pj)])
        locate = api.narrowband_locate(solver, mics, scene.fs, c, band, nfft)
        lower, upper = (torch.as_tensor(b, dtype=f32, device="cuda")
                        for b in (blo, bhi))
        fix = stage(f"{solver} fix (two-stage search)",
                    lambda: locate(filtered, lower, upper))
        stage("jackknife (4 chunks, 4 searches)",
              lambda: api.uncertainty_ops.group_jackknife_covariance(
                  filtered, lambda s, lo, hi: locate(s, lo, hi).position,
                  fix.position, 0.12 * (upper - lower)))
        per_bin = stage("per-bin render (plain torch, the same scene)",
                        lambda: simulator.simulate_signals_fast(
                            scene.source_position, scene.mic_positions,
                            scene.fs, c, scene.duration, scene.signal_type,
                            scene.freq, scene.plane_coeffs,
                            scene.plane_material_ids,
                            scene.materials.absorption,
                            scene.materials.freq * 1e-5,
                            loc.max_reflections, loc.absorption_threshold,
                            generator=gen, dtype=f32, device="cuda",
                            absorption_mode="per-bin"))
        if not bool(torch.isfinite(per_bin).all()):
            raise AssertionError("per-bin render: non-finite samples")
    total = sum(times.values())
    for name, ms in times.items():
        log(f"  api {solver} stage {name}: {ms:.3f} ms "
            f"({100 * ms / total:.1f} %) {card_note()}")
    log(f"  api {solver} stages total: {total:.3f} ms (warm) {card_note()}")


def nb_sweep_stages(torch, sw, spec):
    """Warm stage breakdown of one 512-scene narrowband sweep (render, STFT
    or spectra, bins and refined frequencies, eigh or inverse, coarse and
    fine maps), over the whole batch at once (not in the sweep's scene
    chunks); each stage timed with a synchronize on both sides."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    times = {}

    def stage(name, fn):
        out, seconds = _wall(torch, fn)
        times[name] = seconds * 1e3
        return out

    for _ in range(2):     # the second pass is the warm one reported
        _nb_sweep_pass(torch, sw, spec, gen, stage)
    total = sum(times.values())
    for name, ms in times.items():
        log(f"  {spec.solver} sweep stage {name}: {ms:.3f} ms "
            f"({100 * ms / total:.1f} %) {card_note()}")
    log(f"  {spec.solver} sweep stages total: {total:.3f} ms for "
        f"{SWEEP_SCENES} scenes in one batch, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"{card_note()}")


def _nb_sweep_pass(torch, sw, spec, gen, stage):
    from pyaudiolocalization_tpu_torch.models import beamformer, capon
    from pyaudiolocalization_tpu_torch.models import music
    from pyaudiolocalization_tpu_torch.models import srp as srp_ops
    from pyaudiolocalization_tpu_torch.models.simulator import render_scene
    dev = gen.device
    c = spec.speed_of_sound
    torch.cuda.reset_peak_memory_stats()
    sources, mics, snr = stage("draw scenes", lambda: sw._random_scene(
        spec, gen, SWEEP_SCENES, torch.float32, dev))
    base, seeds = stage("draw base signals + seeds", lambda: sw._draw_signals(
        spec, gen, SWEEP_SCENES, torch.float32, dev))
    paths = stage("paths", lambda: sw._source_paths(spec, sources[:, 0], mics,
                                                    c))
    sigs = stage("K3 delay_sum", lambda: render_scene(
        base[:, 0], paths.delays, paths.gains, spec.fs, spec.total_samples,
        spec.num_samples, finalize=True, snr_db=snr, noise_seeds=seeds))
    band = (spec.lowcut, spec.highcut)
    blo, bhi = sw._srp_box(spec)
    lower, upper = srp_ops._box(blo, bhi, sigs)
    if spec.solver == "beam":
        spectra = stage("spectra (rfft)", lambda: torch.fft.rfft(
            sigs, n=spec.nfft))
        idx, w = stage("bin selection", lambda: beamformer.select_bins(
            spectra, spec.fs, spec.nfft, 12, band))

        def map_fn(p):
            return beamformer.steered_power_map(spectra, idx, w, p, mics,
                                                spec.fs, spec.nfft, c)
    else:
        snaps = stage("STFT (snapshots)", lambda: music.snapshot_frames(
            sigs, 256))
        idx, w = stage("bin selection", lambda: beamformer.select_bins(
            torch.mean(torch.abs(snaps), -2), spec.fs, 256, 8, band))
        omega = stage("refined frequencies", lambda: music.refine_bin_freqs(
            snaps, idx, spec.fs, 256, 128))
        cov = stage("embedded covariances", lambda: music.embedded_covariances(
            snaps, idx))
        if spec.solver == "music":
            subs = stage("eigh (noise subspaces)", lambda: torch.linalg.eigh(
                cov)[1][..., :2 * spec.num_mics - 2])

            def map_fn(p):
                return music.music_map(subs, omega, w, p, mics, c)
        else:
            inv = stage("loaded inverse", lambda: capon.loaded_inverse(
                cov, 1e-3))

            def map_fn(p):
                return capon.capon_map(inv, omega, w, p, mics, c)

    def coarse():
        pts = srp_ops._grid_points(lower, upper, srp_ops.COARSE_N)
        return srp_ops._take_point(pts, torch.argmax(map_fn(pts), -1))

    center = stage("coarse map (24^3)", coarse)
    stage("fine map (12^3)", lambda: srp_ops._fine_stage(
        map_fn, center, (upper - lower) / srp_ops.COARSE_N, 12))


def de_stages(torch, sw, spec):
    """Warm stage breakdown of one fused 512-scene 'de' sweep: K5, the
    windowed ladder, the clustered guesses, the DE generations (counted)
    and the L-BFGS-B polish."""
    from pyaudiolocalization_tpu_torch.models import solver as solver_ops
    from pyaudiolocalization_tpu_torch.models import tdoa as tdoa_ops
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    c = spec.speed_of_sound
    dt = torch.float32
    pi, pj = spec.pairs
    wq = sw._tdoa_window_wq(spec)
    times = {}

    def stage(name, fn):
        out, seconds = _wall(torch, fn)
        times[name] = seconds * 1e3
        return out

    sources, mics, snr = stage("draw scenes", lambda: sw._random_scene(
        spec, gen, SWEEP_SCENES, dt, dev))
    base, seeds = stage("draw base signals + seeds", lambda: sw._draw_signals(
        spec, gen, SWEEP_SCENES, dt, dev))
    paths = sw._source_paths(spec, sources[:, 0], mics, c)

    def k5():
        padded = torch.zeros((SWEEP_SCENES, spec.total_samples), device=dev)
        padded[:, :spec.num_samples] = base[:, 0]
        fade = fade_window(spec.total_samples, dtype=dt,
                           device=dev)[:spec.num_samples].contiguous()
        return cf.scene_windowed(
            padded, (paths.delays * spec.fs).contiguous(),
            paths.gains.contiguous(), pi, pj, spec.nfft, spec.num_samples,
            wq, fade, sw._band_mask(spec, (spec.lowcut, spec.highcut), base),
            snr_db=snr.contiguous(), seeds=seeds)

    win, stats = stage("K5 scene_windowed", k5)
    td = stage("windowed TDOA ladder", lambda: -tdoa_ops.
               tdoa_single_from_window(win, stats, wq, spec.nfft, spec.fs,
                                       spec.max_tdoa))
    guesses, _ = stage("k-means guesses", lambda: solver_ops.
                       heuristic_initial_guesses(mics, pi, pj, td, c, gen))
    lower, upper = solver_ops.dynamic_bounds(mics, td, c)
    weights = torch.ones_like(td)
    generations = [0]

    def objective(x):
        one = x.dim() == 2
        generations[0] += not one
        xs = x[:, None] if one else x
        r = solver_ops.tdoa_residuals(xs, mics[:, None], pi, pj,
                                      td[:, None], c, weights[:, None])
        e = torch.sum(r * r, -1)
        return e[:, 0] if one else e

    de = stage("DE generations", lambda: solver_ops.
               differential_evolution_batched(
                   objective, lower, upper, gen, popsize=spec.de_popsize,
                   maxiter=spec.de_maxiter, init=guesses))
    stage("L-BFGS-B polish", lambda: solver_ops.lbfgsb_minimize_batched(
        objective, de.x, lower, upper))
    total = sum(times.values())
    for name, ms in times.items():
        log(f"  de sweep stage {name}: {ms:.3f} ms "
            f"({100 * ms / total:.1f} %) {card_note()}")
    log(f"  de sweep: {generations[0] - 1} generations (a host read each), "
        f"{times['DE generations'] / max(generations[0] - 1, 1):.3f} ms a "
        f"generation; stages total {total:.3f} ms for {SWEEP_SCENES} scenes "
        f"{card_note()}")


def narrowband_phase(cf, torch, nb_golden, sweep_golden, launches):
    """Phase 9: the narrowband solvers, per-bin absorption and the sweep's
    lm-robust, DE and Wiener modes, against
    tests/data/torch_narrowband_golden.json (module docstring)."""
    import os
    import tempfile
    import warnings
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import __main__ as demo
    from pyaudiolocalization_tpu_torch import localize_sound_source
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    from pyaudiolocalization_tpu_torch.utils.config import SceneConfig
    from pyaudiolocalization_tpu_torch.utils.materials import MaterialTable
    bench = _load_tool("torch_rowdft_bench")
    scenes_tool = _load_tool("torch_narrowband_golden")
    start_phase = time.perf_counter()

    def record(name, fn, expect, forbid):
        torch.cuda.reset_peak_memory_stats()
        out, counts = run_path(cf, name, fn, expect, forbid)
        _add(launches, counts)
        log(f"  peak device memory on {name}: "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
            f"{card_note()}")
        return out

    def timed(cfg, **kw):
        start = time.perf_counter()
        res = localize_sound_source(cfg, device="cuda", dtype=torch.float32,
                                    **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - start

    # (1) localize_sound_source with beam / music / capon, both scenes.
    def check_api(name, solver, res, want):
        check_nb_fix(name, solver, res["estimated_position"],
                     want["estimated_position"], want["coarse_margin"])
        td_err = max(abs(float(a) - b) for a, b in
                     zip(res["tdoas"], want["tdoas"]))
        std = [float(v) for v in res["uncertainty"]["std"]]
        ratio = max(max(a / b, b / a) for a, b in zip(std, want["std"]))
        log(f"{name}: max TDOA delta {td_err * FS:.3f} samples, jackknife "
            f"std {[round(v, 5) for v in std]} (golden "
            f"{[round(v, 5) for v in want['std']]}, worst ratio "
            f"{ratio:.3f})")
        if td_err > 0.05 / FS:
            raise AssertionError(f"{name}: TDOAs vs golden")
        if not ratio <= 2.0 or res["uncertainty"]["heuristic"]:
            raise AssertionError(f"{name}: jackknife std departs from the "
                                 "golden's by more than a factor of 2")

    for solver in ("beam", "music", "capon"):
        def api_scenes(solver=solver):
            for name, cfg in scenes_tool.scene_configs(DEFAULT_CONFIG,
                                                   solver).items():
                want = nb_golden["scenes"][f"{name}/{solver}"]
                for run in ("cold", "warm"):
                    res, seconds = timed(cfg)
                    log(f"api {name}/{solver} {run}: {seconds:.3f} s wall "
                        f"{card_note()}")
                    check_api(f"api {name}/{solver} {run}", solver, res,
                              want)

        record(f"the api's {solver}", api_scenes,
               ("delay_sum", "gcc_all_pairs", "fft_real", "bootstrap_peaks"),
               NB_FORBID)
        api_nb_stages(torch, solver, scenes_tool.scene_configs(
            DEFAULT_CONFIG, solver)["default"])
    # The command-line demo, its result caught on its way out.
    got = {}
    api_fn = demo.localize_sound_source

    def caught(*args, **kw):
        got["res"] = api_fn(*args, **kw)
        return got["res"]

    cwd = os.getcwd()
    os.chdir(tempfile.mkdtemp(prefix="chip_smoke_nb_"))
    demo.localize_sound_source = caught
    try:
        start = time.perf_counter()
        record("python -m pyaudiolocalization_tpu_torch --solver music "
               "--no-plots", lambda: demo.main(["--solver", "music",
                                                "--no-plots"]),
               ("delay_sum", "gcc_all_pairs", "fft_real", "bootstrap_peaks"),
               NB_FORBID)
        log(f"the command-line demo (--solver music): "
            f"{time.perf_counter() - start:.3f} s wall (calibration "
            f"included) {card_note()}")
    finally:
        demo.localize_sound_source = api_fn
        os.chdir(cwd)
    check_api("the command-line demo --solver music", "music", got["res"],
              nb_golden["scenes"]["default/music"])

    # (2) per-bin absorption: plain torch render (no K3), then the full
    # core's K1 and the bootstrap.
    def per_bin():
        for name, cfg, table in scenes_tool.per_bin_cases(DEFAULT_CONFIG):
            want = nb_golden["per_bin"][name]
            scene = (cfg if table is None else SceneConfig.from_dict(
                cfg, materials=MaterialTable.from_dict(table)))
            for run in ("cold", "warm"):
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    res, seconds = timed(scene)
                check_scene(f"per-bin {name}", res, want, seconds, run)

    record("per-bin absorption", per_bin,
           ("gcc_all_pairs", "fft_real", "bootstrap_peaks"),
           ("delay_sum",) + NB_FORBID)

    # (3) the narrowband sweep at the trio spec, and its two-tone spec.
    trio = _spec(nb_golden["trio/beam"]["spec"])
    for solver in ("beam", "music", "capon"):
        spec = dataclasses.replace(trio, solver=solver)
        summary = record(f"the {solver} sweep (trio spec)",
                         lambda: sw.monte_carlo_sweep(spec, 7, SWEEP_SCENES,
                                                      device="cuda"),
                         ("delay_sum",), NB_SWEEP_FORBID)
        if not bool(torch.isfinite(summary.results.estimate).all()):
            raise AssertionError(f"{solver}: non-finite sweep estimates")
        check_statistics(f"{solver} sweep", summary.results.error,
                         nb_golden[f"trio/{solver}"])
        wall, dev_ms, idle = idle_share(torch, bench, lambda: sw.
                                        monte_carlo_sweep(spec, 21,
                                                          SWEEP_SCENES,
                                                          device="cuda"))
        log(f"warm {solver} sweep: {SWEEP_SCENES / wall * 1e3:.1f} scenes/s "
            f"({wall:.3f} ms wall, {dev_ms:.3f} ms device, idle share "
            f"{idle:.3f}) {card_note()}")
        nb_sweep_stages(torch, sw, spec)
    two = _spec(nb_golden["two_tone/music"]["spec"])
    for solver in ("music", "capon"):
        spec = dataclasses.replace(two, solver=solver)
        summary = record(f"the two-tone {solver} sweep",
                         lambda: sw.monte_carlo_sweep(spec, 7, MULTI_SCENES,
                                                      device="cuda"),
                         ("delay_sum",), NB_SWEEP_FORBID)
        if summary.results.estimate.shape != (MULTI_SCENES, 2, 3):
            raise AssertionError("two-tone estimates of shape "
                                 f"{tuple(summary.results.estimate.shape)}")
        check_statistics(f"two-tone {solver} sweep", summary.results.error,
                         nb_golden[f"two_tone/{solver}"])
        _, seconds = _wall(torch, lambda: sw.monte_carlo_sweep(
            spec, 21, MULTI_SCENES, device="cuda"))
        log(f"warm two-tone {solver} sweep: {MULTI_SCENES / seconds:.1f} "
            f"scenes/s ({seconds:.3f} s) {card_note()}")
    # localize_batch on numpy-built tone scenes: no kernel at all.
    case = nb_golden["localize_batch"]
    signals, _ = scenes_tool.tone_scenes(
        case["seed"], case["num_scenes"], trio.fs, trio.duration,
        trio.mic_positions, trio.speed_of_sound, trio.source_box_lo,
        trio.source_box_hi, trio.freq)
    signals = torch.as_tensor(signals, device="cuda")
    for solver in ("beam", "music", "capon"):
        spec = dataclasses.replace(trio, solver=solver)
        est, _, _ = record(f"localize_batch {solver}",
                           lambda: sw.localize_batch(
                               spec, signals, spec.mic_positions,
                               device="cuda"), (), PRODUCTION)
        want = case[solver]
        gaps = [check_nb_fix(f"localize_batch {solver} scene {b}", solver,
                             est[b].tolist(), want["estimates"][b],
                             want["coarse_margin"][b])
                for b in range(case["num_scenes"])]
        log(f"localize_batch {solver} vs JAX on {case['num_scenes']} "
            f"scenes: max position difference {max(gaps):.3e} m")

    # (4) lm-robust and de, fused against split; Wiener on the split.
    full = _spec(sweep_golden["spec"])
    for solver in ("lm-robust", "de"):
        spec = dataclasses.replace(full, solver=solver)
        if not sw._mono_scene_eligible(spec):
            raise AssertionError(f"{solver}: the sweep misses the fused "
                                 "path")
        summary = record(f"the {solver} sweep (fused path)",
                         lambda: sw.monte_carlo_sweep(spec, 7, SWEEP_SCENES,
                                                      device="cuda"),
                         ("scene_windowed",), ("delay_sum", "gcc_windowed"))
        fused = summary.results
        gen = torch.Generator(device="cuda").manual_seed(7)
        split = record(f"the split {solver} sweep", lambda: sw._run_scenes(
            spec, gen, SWEEP_SCENES, torch.float32, False),
            ("delay_sum", "gcc_windowed"), ("scene_windowed",))
        td_gap = float((fused.tdoas - split.tdoas).abs().max()) * spec.fs
        pos_gap = float((fused.estimate - split.estimate).abs().max())
        log(f"{solver} fused vs split over {SWEEP_SCENES} scenes: max TDOA "
            f"difference {td_gap:.4f} samples, max estimate difference "
            f"{pos_gap:.3e} m")
        if not (td_gap < 0.5 and pos_gap < 1e-3):
            raise AssertionError(f"{solver}: fused and split sweeps "
                                 "disagree")
        check_statistics(f"{solver} sweep", fused.error,
                         nb_golden[f"modes/{solver}"])
        wall, dev_ms, idle = idle_share(torch, bench, lambda: sw.
                                        monte_carlo_sweep(spec, 21,
                                                          SWEEP_SCENES,
                                                          device="cuda"))
        log(f"warm {solver} sweep: {SWEEP_SCENES / wall * 1e3:.1f} scenes/s "
            f"({wall:.3f} ms wall, {dev_ms:.3f} ms device, idle share "
            f"{idle:.3f}) {card_note()}")
    de_stages(torch, sw, dataclasses.replace(full, solver="de"))
    spec = dataclasses.replace(full, filter_method="wiener")
    if sw._mono_scene_eligible(spec) or not sw._use_windowed(spec):
        raise AssertionError("wiener: not on the split windowed path")
    summary = record("the Wiener sweep", lambda: sw.monte_carlo_sweep(
        spec, 7, SWEEP_SCENES, device="cuda"), ("delay_sum", "gcc_windowed"),
        ("scene_windowed", "gcc_all_pairs"))
    check_statistics("Wiener sweep", summary.results.error,
                     nb_golden["modes/wiener"])
    wall, dev_ms, idle = idle_share(torch, bench, lambda: sw.
                                    monte_carlo_sweep(spec, 21, SWEEP_SCENES,
                                                      device="cuda"))
    log(f"warm Wiener sweep: {SWEEP_SCENES / wall * 1e3:.1f} scenes/s "
        f"({wall:.3f} ms wall, {dev_ms:.3f} ms device, idle share "
        f"{idle:.3f}) {card_note()}")
    log(f"phase 9: {time.perf_counter() - start_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 7: K10's A/B bench
# ---------------------------------------------------------------------------

def rowdft_phase(cf, launches):
    """tools/torch_rowdft_bench.py once (3 timed calls a case) at the TPU
    tool's five shapes, each kernel case held against its twin; it must
    launch all three K10 kernels and K4a.  Returns the kernels line's
    entries of K10a/b/c at n2 = 512, B = 1024 (N = 65,536, the production
    length).  Bounds count the plane's bytes (each input read once, each
    output written once) and 5 N log2 N operations per complex N-point
    transform, whatever implements them (not the tensor cores' extra
    products)."""
    bench = _load_tool("torch_rowdft_bench")
    start = time.perf_counter()
    res, counts = run_path(cf, "K10's A/B bench", lambda: bench.run(3, log),
                           ("row_dft", "row_stages", "lane_dft", "fft_real"))
    _add(launches, counts)
    log(f"phase 7: {time.perf_counter() - start:.1f} s")
    b, n2 = 1024, 512
    main = res[(n2, b)]
    ms, err = main["ms"], main["err"]
    points = b * n2 * 128
    row_bound = bound(16 * points, b * 128 * 5 * n2 * math.log2(n2))
    lane_bound = bound(16 * points, b * n2 * 5 * 128 * 7)
    return {
        "row_dft": (err["rowdft"][0], ms["rowdft"], ms["row_plain"],
                    ms["torch_row"]) + row_bound,
        "row_stages": (err["stages"][0], ms["stages"], ms["row_plain"],
                       ms["torch_row"]) + row_bound,
        "lane_dft": (err["lane"][0], ms["lane"], ms["lane_plain"],
                     ms["torch_lane"]) + lane_bound}


# ---------------------------------------------------------------------------
# Phase 10: recorded audio, the compat layer, the checkpointed sweep
# ---------------------------------------------------------------------------

RECORDED_DIR = REPO / "tests" / "data" / "recorded"
HOUSE_OGG = REPO / "tests" / "data" / "house_lo.ogg"
HOUSE_GOLDEN = REPO / "tests" / "data" / "house_lo_golden.npz"
RECORDED_PATH = ("gcc_all_pairs", "fft_real", "bootstrap_peaks")
RECORDED_FORBID = ("delay_sum", "gcc_windowed", "scene_windowed",
                   "noise_bootstrap_peaks")
# The realistic recording: 4 mics x 24 s at 48 kHz of one seeded noise
# source, each mic delayed by a whole number of 48 kHz samples.
LONG_FILE_FS = 48000
LONG_SECONDS = 24
LONG_DELAYS = (0, 24, 61, 97)
# The compat inputs (tools/torch_recorded_golden.py builds the same rows).
PAIR_SEED, FILTER_SEED = 21, 22
EXACT_N, POW2_N, SCAN_N = 11025, 16384, 4410
CKPT_CHUNKS = 4


def check_probe(name, row, want, tol=1e-5):
    """A row against the golden's 64 evenly spaced samples (within ``tol``;
    the rows are bounded by a few units) and its norm (within ``tol``
    relative)."""
    import torch
    x = torch.as_tensor(row).double().cpu().flatten()
    got = x[torch.tensor(want["index"])]
    err = float((got - torch.tensor(want["samples"])).abs().max())
    norm = float(torch.linalg.norm(x))
    rel = abs(norm - want["norm"]) / want["norm"]
    log(f"{name}: max |sample - golden| {err:.2e} at 64 points, norm "
        f"{norm:.6f} (golden {want['norm']:.6f}, rel {rel:.2e})")
    if not (err <= tol and rel <= tol):
        raise AssertionError(f"{name}: departs from the golden")


def check_significant(name, res, want):
    """'significant' equal to the golden where the pair's peak is 10 % clear
    of the JAX threshold."""
    pairs = sorted(res["correlation_metrics"])
    if [list(p) for p in pairs] != want["pairs"]:
        raise AssertionError(f"{name}: pair order {pairs}")
    for k, pair in enumerate(pairs):
        peak, thr = want["peak"][k], want["threshold"][k]
        got = res["correlation_metrics"][pair]["significant"]
        if abs(peak - thr) > 0.1 * thr and got != want["significant"][k]:
            raise AssertionError(f"{name} pair {pair}: significant {got} vs "
                                 f"golden {want['significant'][k]}")


def recorded_reads(cf, torch, golden, launches):
    """Step 1: the four recorded files (their SHA-256 against the golden's)
    read with the resampling on the card, each channel against the golden;
    the resampler's device time on the four rows; house_lo.ogg against its
    independent decode (tests/test_vorbis.py's bounds)."""
    import hashlib
    import numpy as np
    from pyaudiolocalization_tpu_torch.ops.resample import resample
    from pyaudiolocalization_tpu_torch.utils import audio_io
    paths = [str(RECORDED_DIR / f["name"]) for f in golden["files"]]
    for path, f in zip(paths, golden["files"]):
        if hashlib.sha256(Path(path).read_bytes()).hexdigest() != f["sha256"]:
            raise AssertionError(f"{path}: not the golden's bytes")
    (rows, seconds), counts = run_path(
        cf, "read_audio_files (4 x 1 s at 48 kHz)", lambda: _wall(
            torch, lambda: audio_io.read_audio_files(
                paths, FS, dtype=torch.float32, device="cuda")), (),
        PRODUCTION)
    _add(launches, counts)
    log(f"read_audio_files, 4 files (2 PCM16 WAV, float WAV, FLAC) 48 -> "
        f"44.1 kHz: {seconds * 1e3:.2f} ms wall (cold) {card_note()}")
    for k, (row, want) in enumerate(zip(rows, golden["channels"])):
        if row.device.type != "cuda" or tuple(row.shape) != (N,):
            raise AssertionError(f"channel {k}: {row.device} {row.shape}")
        check_probe(f"recorded channel {k}", row, want)
    mono = torch.stack([torch.as_tensor(
        audio_io.read_audio_file(p)[0][:, 0], dtype=torch.float32,
        device="cuda") for p in paths])
    bench = _load_tool("torch_rowdft_bench")
    wall, dev, idle = idle_share(torch, bench, lambda: resample(
        mono, float(golden["file_fs"]), FS))
    log(f"resample 4 x 48,000 -> 44,100 on the card: device "
        f"{dev:.4f} ms, wall {wall:.3f} ms, idle {100 * idle:.1f} % "
        f"{card_note()}")
    pcm, fs = audio_io.read_audio_file(str(HOUSE_OGG))
    ref = np.load(HOUSE_GOLDEN)
    mine = np.clip(np.round(pcm[:, 0] * 32768.0), -32768, 32767).astype(
        np.int64)
    diff = np.abs(mine - ref["pcm"].astype(np.int64))
    rms = float(np.sqrt(np.mean(diff.astype(float) ** 2)))
    log(f"house_lo.ogg: {pcm.shape[0]} samples at {fs} Hz, max |diff| "
        f"{int(diff.max())} LSB, rms {rms:.3f} against its golden decode")
    if fs != int(ref["fs"]) or diff.max() > 8 or rms >= 1.5:
        raise AssertionError("house_lo.ogg departs from its golden decode")
    return paths


def recorded_api(cf, torch, golden, paths, launches):
    """Step 2: localize_sound_source from the files, cold and warm: physical
    mode (K1, K4a, K4b) against the float64 golden (TDOAs within 0.05
    samples, position within 5 mm, 'significant' where clear), then parity
    mode with the pre-sync (K7 alone) by ``check_parity``."""
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import localize_sound_source
    from pyaudiolocalization_tpu_torch.models import sync
    cases = golden["cases"]
    shifts_fn = sync._sync_shifts
    seen = {}

    def recorded_shifts(*args, **kw):
        out = shifts_fn(*args, **kw)
        seen["shifts"] = [float(v) for v in out.tolist()]
        return out

    def run(cfg, check):
        for run_name in ("cold", "warm"):
            start = time.perf_counter()
            res = localize_sound_source(cfg, audio_files=paths,
                                        use_simulation=False, device="cuda",
                                        dtype=torch.float32)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - start
            if res["actual_position"] is not None:
                raise AssertionError("recorded run: actual_position is set")
            check(run_name, res, seconds)

    def physical(run_name, res, seconds):
        # The float64 golden: the card resamples with float64 positions
        # (ops/resample.py), the JAX package's float32 run does not.
        want = cases["physical"]["float64"]
        check_scene("recorded physical", res, want, seconds,
                    f"{run_name} {card_note()}")
        check_significant("recorded physical", res, want)

    def parity(run_name, res, seconds):
        log(f"recorded parity {run_name}: {seconds:.3f} s wall "
            f"{card_note()}")
        check_parity(f"recorded parity {run_name}", res, seen["shifts"],
                     cases["parity"], FS)

    cfg = scene_configs(DEFAULT_CONFIG)["off_centre"]
    _, counts = run_path(cf, "the recorded physical path",
                         lambda: run(cfg, physical), RECORDED_PATH,
                         RECORDED_FORBID)
    _add(launches, counts)
    cfg = copy.deepcopy(DEFAULT_CONFIG)
    cfg["localization"].update(lag_mode="reference",
                               visualize_correlation=False)
    sync._sync_shifts = recorded_shifts
    try:
        _, counts = run_path(cf, "the recorded parity path",
                             lambda: run(cfg, parity), ("whiten",),
                             PARITY_FORBID)
    finally:
        sync._sync_shifts = shifts_fn
    _add(launches, counts)


# Device kernels of K1's radix-2 passes (``palt_gcc_all_pairs`` at n1 =
# 0): the packing, the passes, the cross-spectra and the split into pairs.
K1_PASS_KERNELS = ("pack_rows", "stockham_pass", "gcc_cross", "split_pairs")
K2_PASS_KERNELS = ("pack_rows", "stockham_pass", "gcc_cross",
                   "last_pass_window")
# Step 4's recordings at 44.1 kHz (no resampling): seconds, the path and
# the nfft its GCC transforms at under DEFAULT_CONFIG.
SPECTRA_RECORDINGS = ((16, "full core", 1 << 20), (16, "fast path", 1 << 20),
                      (30, "fast path", 1 << 21), (60, "fast path", 1 << 22))


def _noise_recording(seed, fs, n, delays, prefix):
    """Paths of 4 WAV files written by the port's write_wav at ``fs``: n
    samples each of one seeded noise source delayed by ``delays`` whole
    samples, plus a tenth of independent noise."""
    import os
    import tempfile
    import numpy as np
    from pyaudiolocalization_tpu_torch.utils import audio_io
    rng = np.random.default_rng(seed)
    lead = max(delays)
    src = rng.standard_normal(n + lead)
    tmp = tempfile.mkdtemp(prefix=prefix)
    paths = []
    for k, d in enumerate(delays):
        x = src[lead - d:lead - d + n] + 0.1 * rng.standard_normal(n)
        paths.append(os.path.join(tmp, f"mic{k + 1}.wav"))
        audio_io.write_wav(paths[-1], 0.9 * x / np.max(np.abs(x)), fs)
    return paths


def _localize_recording(cf, torch, launches, name, paths, med, want,
                        note):
    """``localize_sound_source`` from ``paths`` on the card in physical
    mode with the noise null at ``LONG_DRAWS`` draws a pair under
    ``max_expected_delay=med`` (K1, K4a and K6; no K4b, K3, K2 or K5):
    each TDOA within 0.5 samples of ``want``, then a second, warm call's
    wall time and one more call's device time by kernel
    (``torch.profiler``), logged; returns that device time."""
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG
    from pyaudiolocalization_tpu_torch import localize_sound_source
    cfg = scene_configs(DEFAULT_CONFIG)["default"]
    cfg["localization"].update(bootstrap_mode="noise",
                               num_bootstrap=LONG_DRAWS,
                               max_expected_delay=med)

    def run():
        return _wall(torch, lambda: localize_sound_source(
            cfg, audio_files=paths, use_simulation=False, device="cuda",
            dtype=torch.float32))

    expect = ("gcc_all_pairs", "fft_real", "noise_bootstrap_peaks")
    (res, seconds), counts = run_path(
        cf, name, run, expect, ("bootstrap_peaks",) + RECORDED_FORBID[:3])
    _add(launches, counts)
    got = [float(t) * FS for t in res["tdoas"]]
    err = max(abs(a - b) for a, b in zip(got, want))
    log(f"{name} localized in {seconds:.3f} s wall ({note} and "
        f"{LONG_DRAWS} noise draws a pair included): TDOAs "
        f"{[round(v, 3) for v in got]} samples, injected "
        f"{[round(v, 3) for v in want]}, max |diff| {err:.3f} samples "
        f"{card_note()}")
    if not err < 0.5 or not all(map(math.isfinite, got)):
        raise AssertionError(f"{name}: the TDOAs depart from the "
                             "injected delays")
    (_, warm), counts = run_path(cf, f"{name}, warm", run, expect)
    _add(launches, counts)
    dev = _load_tool("torch_rowdft_bench").device_ms(run, 1)
    log(f"{name} warm: {warm:.3f} s wall; device time a call "
        f"{dev['total']:.3f} ms in {dev['kernels']:g} kernels, by kernel: "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
            dev.items(), key=lambda kv: -kv[1])
            if k not in ("total", "kernels")) + f" {card_note()}")
    return dev


def _pair_delays(delays, scale=1.0):
    """The injected TDOA of every mic pair (i < j), in samples."""
    return [(delays[j] - delays[i]) * scale
            for i in range(4) for j in range(i + 1, 4)]


def long_recording(cf, torch, launches, hold_split=True):
    """Step 3: 4 mics x 24 s at 48 kHz of a seeded noise source with
    whole-sample delays, written by the port's write_wav and read back:
    after resampling n >= LONG_SAMPLES, so under DEFAULT_CONFIG's
    ``max_expected_delay`` (0.05 s: the circular next_pow2(n)) the GCC
    and the noise null transform at 2^21, and under
    ``max_expected_delay=None`` (next_pow2(2n - 1)) at 2^22: K1 through
    its mic rows' spectra, K4a with K6, all on their split of 8-wide
    strips.  For each, each TDOA within 0.5 samples of its injected delay
    x 44,100 / 48,000; then a second, warm call's wall time and one more
    call's device time by kernel (``torch.profiler``), which holds no
    kernel of K1's radix-2 passes (``K1_PASS_KERNELS``; ``hold_split``
    False only logs them, for an A/B against a tree that runs them)."""
    from pyaudiolocalization_tpu_torch import api
    from pyaudiolocalization_tpu_torch.utils import audio_io
    n = LONG_FILE_FS * LONG_SECONDS
    paths = _noise_recording(24, LONG_FILE_FS, n, LONG_DELAYS,
                             "chip_smoke_long_")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows, seconds = _wall(torch, lambda: audio_io.read_audio_files(
        paths, FS, dtype=torch.float32, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    length = int(rows[0].shape[-1])
    log(f"24 s recording: read + resample 4 x {n:,} -> {length:,} samples "
        f"{seconds:.3f} s wall, peak device memory {peak:.3f} GiB "
        f"{card_note()}")
    want = _pair_delays(LONG_DELAYS, FS / LONG_FILE_FS)
    for med, nfft_want in ((0.05, LONG_NFFT), (None, LONG22[1])):
        nfft = api._physical_nfft(length, FS, med)
        name = f"the 24 s recording (noise null, max_expected_delay={med})"
        log(f"{name}: nfft {nfft}, K1's schedule n1="
            f"{cf.gcc_route(nfft, 4).n1}")
        if length < LONG_SAMPLES or nfft != nfft_want:
            raise AssertionError(f"{name} misses nfft {nfft_want}")
        dev = _localize_recording(cf, torch, launches, name, paths, med,
                                  want, "files, resampling")
        passes = [k for k in dev if any(p in k for p in K1_PASS_KERNELS)]
        if passes and hold_split:
            raise AssertionError(f"{name} ran K1's radix-2 passes: {passes}")
        log(f"{name}: K1's radix-2 pass kernels in the trace: "
            f"{passes or 'none'}")


# Step 3b's recording: 4 mics x 60 s at 44.1 kHz (no resampling) with
# whole-sample delays near the 24 s recording's once resampled, whose GCC
# and noise null transform at 2^23 under ``max_expected_delay=None``
# (next_pow2(2n - 1)); and the device kernels of K4a's and K6's radix-2
# passes (``palt_fft_real`` and ``palt_noise_bootstrap_peaks`` at n1 = 0)
# that K1's passes there do not run too.
REC23_SECONDS = 60
REC23_DELAYS = (0, 22, 56, 89)
K4A_K6_PASS_KERNELS = ("split_spectra", "noise_first_pass", "boot_whiten",
                       "last_pass_max")


def recording23(cf, torch, launches, hold_split=True):
    """Step 3b: 4 mics x 60 s at 44.1 kHz of a seeded noise source with
    whole-sample delays (``REC23_DELAYS``), written by the port's write_wav
    and read back without resampling, localized under
    ``max_expected_delay=None`` with the noise null at ``LONG_DRAWS`` draws
    a pair: nfft 2^23, K4a and K6 on their split past 2^22 (2,048 x 4,096),
    K1 on its radix-2 passes.  Each TDOA within 0.5 samples of its injected
    delay; then a second, warm call's wall time and one more call's device
    time by kernel (``torch.profiler``), which holds no kernel of K4a's or
    K6's passes (``K4A_K6_PASS_KERNELS``; ``hold_split`` False only logs
    them, for an A/B against a tree that runs them); K1's pass kernels
    (``K1_PASS_KERNELS``) are logged, not held."""
    from pyaudiolocalization_tpu_torch import api
    n = int(FS) * REC23_SECONDS
    paths = _noise_recording(60, FS, n, REC23_DELAYS, "chip_smoke_rec23_")
    nfft = api._physical_nfft(n, FS, None)
    name = (f"the {REC23_SECONDS} s recording at 44.1 kHz (noise null, "
            "max_expected_delay=None)")
    log(f"{name}: nfft {nfft}, K4a's and K6's schedule n1="
        f"{cf._split_n1(nfft)}, K1's n1={cf.gcc_route(nfft, 4).n1}")
    if nfft != SPLIT23[1]:
        raise AssertionError(f"{name} misses nfft {SPLIT23[1]}")
    dev = _localize_recording(cf, torch, launches, name, paths, None,
                              _pair_delays(REC23_DELAYS), "files")
    passes = [k for k in dev if any(p in k for p in K4A_K6_PASS_KERNELS)]
    if passes and hold_split:
        raise AssertionError(f"{name} ran K4a's or K6's radix-2 passes: "
                             f"{passes}")
    log(f"{name}: K4a's and K6's radix-2 pass kernels in the trace: "
        f"{passes or 'none'}; K1's (on its passes at 2^23): "
        f"{[k for k in dev if any(p in k for p in K1_PASS_KERNELS)]}")


def spectra_recordings(cf, torch, launches, hold_spectra=True):
    """Step 4: 4-mic recordings at 44.1 kHz written by the port's
    write_wav and read back (no resampling), whose GCC transforms at 2^20
    to 2^22 under DEFAULT_CONFIG, where K1's and K2's GCC go through the
    mic rows' spectra (``SPECTRA_RECORDINGS``): a 16 s recording on the
    full core (K1 at 2^20, the permutation null's K4a and K4b at
    ``LONG_DRAWS`` draws a pair), and 16,
    30 and 60 s ones on the windowed fast path (K2 at 2^20, 2^21 and
    2^22).  For each, each TDOA within 0.5 samples of its injected delay;
    then a warm call's wall time and one more call's device time by
    kernel, which holds no kernel of K1's or K2's radix-2 passes
    (``K1_PASS_KERNELS``, ``K2_PASS_KERNELS``; ``hold_spectra`` False only
    logs them, for an A/B against a tree that runs them)."""
    import os
    import tempfile
    import numpy as np
    from pyaudiolocalization_tpu_torch import DEFAULT_CONFIG, api
    from pyaudiolocalization_tpu_torch import localize_sound_source
    from pyaudiolocalization_tpu_torch.utils import audio_io
    rng = np.random.default_rng(20)
    pairs = [(i, j) for i in range(4) for j in range(i + 1, 4)]
    want = [float(LONG_DELAYS[j] - LONG_DELAYS[i]) for i, j in pairs]
    lead = max(LONG_DELAYS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_spectra_")
    files = {}
    for seconds, path, nfft_want in SPECTRA_RECORDINGS:
        if seconds not in files:
            n = int(FS) * seconds
            src = rng.standard_normal(n + lead)
            files[seconds] = []
            for k, d in enumerate(LONG_DELAYS):
                x = src[lead - d:lead - d + n] + 0.1 * rng.standard_normal(n)
                files[seconds].append(os.path.join(tmp, f"s{seconds}_{k}.wav"))
                audio_io.write_wav(files[seconds][-1],
                                   0.9 * x / np.max(np.abs(x)), int(FS))
        n = int(FS) * seconds
        nfft = api._physical_nfft(n, FS, 0.05)
        kernel = "gcc_all_pairs" if path == "full core" else "gcc_windowed"
        name = f"the {seconds} s recording ({path}, nfft {nfft})"
        log(f"{name}: GCC {route_note(cf, nfft, 4)}")
        if nfft != nfft_want:
            raise AssertionError(f"{name} misses nfft {nfft_want}")
        cfg = scene_configs(DEFAULT_CONFIG)["default"]
        cfg["localization"].update(visualize_correlation=False,
                                   num_bootstrap=LONG_DRAWS)
        expect, forbid = RECORDED_PATH, RECORDED_FORBID
        if path != "full core":
            cfg["localization"]["analyze_correlation"] = False
            expect = ("gcc_windowed",)
            forbid = ("gcc_all_pairs", "fft_real", "bootstrap_peaks",
                      "delay_sum", "scene_windowed")

        def run():
            return _wall(torch, lambda: localize_sound_source(
                cfg, audio_files=files[seconds], use_simulation=False,
                device="cuda", dtype=torch.float32))

        (res, wall), counts = run_path(cf, name, run, expect, forbid)
        _add(launches, counts)
        got = [float(t) * FS for t in res["tdoas"]]
        err = max(abs(a - b) for a, b in zip(got, want))
        log(f"{name} localized in {wall:.3f} s wall (files read): TDOAs "
            f"{[round(v, 3) for v in got]} samples, injected {want}, max "
            f"|diff| {err:.3f} samples {card_note()}")
        if not err < 0.5 or not all(map(math.isfinite, got)):
            raise AssertionError(f"{name}: the TDOAs depart from the "
                                 "injected delays")
        (_, warm), counts = run_path(cf, f"{name}, warm", run, (kernel,))
        _add(launches, counts)
        dev = _load_tool("torch_rowdft_bench").device_ms(run, 1)
        log(f"{name} warm: {warm:.3f} s wall; device time a call "
            f"{dev['total']:.3f} ms in {dev['kernels']:g} kernels, by kernel: "
            + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                dev.items(), key=lambda kv: -kv[1])
                if k not in ("total", "kernels")) + f" {card_note()}")
        passes = [k for k in dev if any(
            p in k for p in K1_PASS_KERNELS + K2_PASS_KERNELS)]
        if passes and hold_spectra:
            raise AssertionError(f"{name} ran K1's or K2's radix-2 passes: "
                                 f"{passes}")
        log(f"{name}: K1's and K2's radix-2 pass kernels in the trace: "
            f"{passes or 'none'}")


def compat_on_card(cf, torch, golden, launches):
    """Step 5: the compat layer on the card, numpy in and out, against the
    golden's float64 answers: the speed of sound; get_time_delays_phat at
    the exact length (K7) and at a power of two (K4a + K9), each recovering
    the injected fractional delay within one sample (and within one sample
    of the golden's whole-sample peak); the permutation null
    (K4a + K4b) within 5 %; the significance test and the metric dict (SNR
    and peak-to-peak within 1e-3 relative, 'significant' equal);
    noise_reduction 'conv' and 'prefix' within 1e-4 of the golden, 'scan'
    on 4,410 samples, each timed."""
    import numpy as np
    from pyaudiolocalization_tpu_torch import compat
    from pyaudiolocalization_tpu_torch.ops import filters
    g = golden["compat"]
    c = compat.speed_of_sound(20.0, 50.0)
    log(f"compat.speed_of_sound(20, 50) on the card: {c:.4f} m/s (golden "
        f"{g['speed_of_sound']:.4f})")
    if abs(c - g["speed_of_sound"]) > 1e-3 or abs(c - 343.62) > 0.01:
        raise AssertionError("compat.speed_of_sound departs")
    row = np.random.default_rng(PAIR_SEED).standard_normal(POW2_N)
    delay = g["injected_delay_s"]
    exact = row[:EXACT_N]
    pairs = {"exact": (exact, compat.fractional_delay(exact, delay, FS)),
             "pow2": (row, np.append(compat.fractional_delay(row, delay, FS),
                                     0.0))}
    for name, expect, forbid in (
            ("exact", ("whiten",), ("fft_real", "whitened_corr")),
            ("pow2", ("fft_real", "whitened_corr"), ("whiten",))):
        a, b = pairs[name]
        (delays, corr, _), counts = run_path(
            cf, f"compat.get_time_delays_phat ({name}, {a.size} + {b.size})",
            lambda: compat.get_time_delays_phat(a, b, FS,
                                                lag_mode="physical"),
            expect, forbid)
        _add(launches, counts)
        want = g[f"delays_{name}"][0]
        log(f"compat.get_time_delays_phat {name}: delay {delays[0]:.6e} s "
            f"(golden {want:.6e}, injected {-delay:.6e}), corr length "
            f"{corr.size}, peak {corr.max():.5f} (golden "
            f"{g[f'corr_peak_{name}']:.5f})")
        # Whole-sample peaks: 0.30 m is 38.50 samples, a near-tie of 38
        # and 39, so the card may pick the golden's neighbour.
        if abs(-delays[0] - delay) * FS >= 1.0 or abs(
                delays[0] - want) * FS > 1.0 + 1e-6:
            raise AssertionError(f"compat delay ({name}) departs")
    a, b = pairs["pow2"]
    compat.seed(0)
    thr, counts = run_path(
        cf, "compat.bootstrap_significance (pow2)",
        lambda: compat.bootstrap_significance(a, b, FS),
        ("fft_real", "bootstrap_peaks"), ("whiten",))
    _add(launches, counts)
    rel = abs(thr - g["bootstrap_threshold"]) / g["bootstrap_threshold"]
    log(f"compat.bootstrap_significance: {thr:.6f} (golden "
        f"{g['bootstrap_threshold']:.6f}, rel {rel:.3e})")
    if rel > 0.05:
        raise AssertionError("compat bootstrap threshold departs by > 5 %")
    corr = compat.phat_correlation(a, b)
    (snr, significant), counts = run_path(
        cf, "compat.perform_significance_test", lambda:
        compat.perform_significance_test(corr, a, b, FS),
        ("fft_real", "bootstrap_peaks"))
    _add(launches, counts)
    metrics, counts = run_path(
        cf, "compat.compute_cross_correlation_metrics", lambda:
        compat.compute_cross_correlation_metrics(corr, a, b, FS),
        ("fft_real", "bootstrap_peaks"))
    _add(launches, counts)
    want_t, want_m = g["significance_test"], g["metrics"]
    log(f"compat significance: snr {snr:.4f} (golden {want_t['snr']:.4f}), "
        f"significant {significant}; metrics {metrics} (golden {want_m})")
    for got_v, want_v in ((snr, want_t["snr"]), (metrics["snr"],
                                                  want_m["snr"]),
                          (metrics["peak_to_peak_ratio"],
                           want_m["peak_to_peak_ratio"])):
        if abs(got_v - want_v) > 1e-3 * abs(want_v):
            raise AssertionError("compat significance metrics depart")
    if (significant != want_t["significant"]
            or metrics["significant"] != want_m["significant"]):
        raise AssertionError("compat significance calls depart")
    x = np.random.default_rng(FILTER_SEED).standard_normal(int(FS))
    xt = torch.tensor(x, dtype=torch.float32, device="cuda")
    for method, fn in (
            ("conv", lambda: compat.noise_reduction(x, FS)),
            ("prefix", lambda: filters.noise_reduction(
                xt, FS, lfilter_method="prefix")),
            ("scan", lambda: filters.noise_reduction(
                xt[:SCAN_N], FS, lfilter_method="scan"))):
        y, counts = run_path(cf, f"noise_reduction ({method})", fn, (),
                             PRODUCTION)
        _, seconds = _wall(torch, fn)
        log(f"noise_reduction lfilter_method={method!r} on "
            f"{SCAN_N if method == 'scan' else int(FS)} samples: "
            f"{seconds * 1e3:.3f} ms wall (warm) {card_note()}")
        check_probe(f"noise_reduction ({method})", y,
                    g["noise_reduction"][method], tol=1e-4)


def checkpoint_sweep(cf, torch, sweep_golden, launches):
    """Step 6: run_sweep_checkpointed at bench_full_sweep's spec, 4 chunks
    x 512 scenes: uninterrupted, then stopped after chunk 2 by a log_fn
    that raises, then resumed; the resumed results equal the
    uninterrupted run's to the bit, K5 launches once a chunk, and the
    statistics agree with the JAX sweep's.  Scenes/s with the checkpoint
    writes beside a warm monte_carlo_sweep of 512 in the same call."""
    import os
    import tempfile
    import numpy as np
    from pyaudiolocalization_tpu_torch.parallel import (
        load_checkpoint, monte_carlo_sweep, run_sweep_checkpointed)
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    spec = sw.SweepSpec(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in sweep_golden["spec"].items()})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    total = CKPT_CHUNKS * SWEEP_SCENES

    class Stop(Exception):
        pass

    def stop(msg):
        if msg.startswith(f"chunk 2/{CKPT_CHUNKS}"):
            raise Stop(msg)

    def sweep(path, log_fn=None):
        return _wall(torch, lambda: run_sweep_checkpointed(
            spec, 31, total, SWEEP_SCENES, path, log_fn=log_fn,
            device="cuda"))

    full_path = os.path.join(tmp, "full.npz")
    part_path = os.path.join(tmp, "part.npz")
    (full, seconds), counts = run_path(
        cf, "the checkpointed sweep (uninterrupted)",
        lambda: sweep(full_path), ("scene_windowed",),
        ("delay_sum", "gcc_windowed"))
    _add(launches, counts)
    runs = {"uninterrupted": counts["scene_windowed"]}

    def interrupted():
        try:
            sweep(part_path, stop)
        except Stop:
            return load_checkpoint(part_path)[0]
        raise AssertionError("the interrupting log_fn did not stop the sweep")

    done, counts = run_path(cf, "the checkpointed sweep (stopped after "
                            "chunk 2)", interrupted, ("scene_windowed",))
    _add(launches, counts)
    runs["stopped"] = counts["scene_windowed"]
    logs = []
    (resumed, resumed_s), counts = run_path(
        cf, "the checkpointed sweep (resumed)",
        lambda: sweep(part_path, logs.append), ("scene_windowed",))
    _add(launches, counts)
    runs["resumed"] = counts["scene_windowed"]
    log(f"checkpointed sweep: K5 launches {runs}, chunks done before the "
        f"stop {done}, resume log {logs[:1]}")
    if runs != {"uninterrupted": CKPT_CHUNKS, "stopped": 2,
                "resumed": CKPT_CHUNKS - 2} or done != 2:
        raise AssertionError("the checkpointed sweep's chunks do not match "
                             "K5's launches")
    for field, a, b in zip(full.results._fields, resumed.results,
                           full.results):
        if not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"resumed sweep's {field} differs from the "
                                 "uninterrupted run's")
    check_statistics("checkpointed sweep", torch.as_tensor(
        full.results.error), sweep_golden["sweep"])
    _, plain_s = _wall(torch, lambda: monte_carlo_sweep(
        spec, 21, SWEEP_SCENES, device="cuda"))
    size = os.path.getsize(full_path) / 2 ** 20
    log(f"checkpointed sweep: resumed equals uninterrupted to the bit over "
        f"{total} scenes; {total / seconds:.1f} scenes/s with a {size:.2f} "
        f"MiB .npz written a chunk ({seconds:.3f} s), resumed half "
        f"{total / 2 / resumed_s:.1f} scenes/s; warm monte_carlo_sweep of "
        f"{SWEEP_SCENES} {SWEEP_SCENES / plain_s:.1f} scenes/s "
        f"{card_note()}")


def recorded_phase(cf, torch, golden, sweep_golden, launches):
    """Phase 10: recorded audio, the compat layer and the checkpointed
    sweep (steps 1-6 above), each step a ``utils.profiling.stage``, the
    stage report at the end."""
    from pyaudiolocalization_tpu_torch.utils import profiling
    start = time.perf_counter()
    profiling.reset()
    with profiling.stage("phase 10: read the recorded files"):
        paths = recorded_reads(cf, torch, golden, launches)
    with profiling.stage("phase 10: the api from the files"):
        recorded_api(cf, torch, golden, paths, launches)
    with profiling.stage("phase 10: the 24 s recording"):
        long_recording(cf, torch, launches)
    with profiling.stage("phase 10: the 60 s recording at 2^23"):
        recording23(cf, torch, launches)
    with profiling.stage("phase 10: the spectra routes' recordings"):
        spectra_recordings(cf, torch, launches)
    with profiling.stage("phase 10: compat on the card"):
        compat_on_card(cf, torch, golden, launches)
    with profiling.stage("phase 10: the checkpointed sweep"):
        checkpoint_sweep(cf, torch, sweep_golden, launches)
    for name, rep in profiling.report().items():
        log(f"profiling.stage {name}: {rep['total_s']:.3f} s "
            f"({rep['calls']} call) {card_note()}")
    log(f"phase 10: {time.perf_counter() - start:.1f} s")


# ---------------------------------------------------------------------------
# Phase 11: the serving and tracking path
# ---------------------------------------------------------------------------

SERVING_GOLDEN = REPO / "tests" / "data" / "torch_serving_golden.json"
SERVING_BASES = REPO / "tests" / "data" / "torch_serving_bases.npz"
SERVING_FORBID = ("gcc_windowed", "scene_windowed", "fft_real",
                  "bootstrap_peaks", "noise_bootstrap_peaks",
                  "whitened_corr")
STREAM_SECONDS = 60.0
STREAM_FS = 44100.0
# Injected delays (samples) of the long capture: half-sample fractions,
# where the parabola through a whitened peak is unbiased (a 0.3 fraction
# reads ~0.1 sample off on the CPU as on the card).
STREAM_DELAYS = (0.0, 2.5, -7.5, 12.0)
GOLDEN_TOL = 5e-3


def _render_base(torch, tool, base, mover, mics, duration, frame):
    """The port's moving render of a given base (``_render_moving``, K3),
    finalized as ``simulate_moving_source`` finalizes."""
    from pyaudiolocalization_tpu_torch.models import simulator
    from pyaudiolocalization_tpu_torch.ops import signal as sig_ops
    budget, lead = tool.moving_margins(mover["start"], mover["velocity"],
                                       mics, duration, frame)
    out = simulator._render_moving(
        torch.as_tensor(base, device="cuda"), mover["start"],
        mover["velocity"], mics, tool.FS, tool.C, frame, budget, lead,
        1000.0, 0.01, 1e-6)
    return sig_ops.dynamic_range_compression(sig_ops.normalize_signal(out))


# The moving render's limit against the float64 golden: float32 delays in
# samples (K3's input) round by ~1e-5 sample at 200 samples, and the JAX
# package's own float32 render departs from its float64 render by 1.0e-5
# at the probes (the golden's ``noise_float32``).
RENDER_TOL = 3e-5
# A chirp synthesized in float32 over the 2.1 s base: its phase (~1e4
# radians) rounds by ~1e-3 rad, which the finalized render carries.
CHIRP32_TOL = 1e-2


def check_probes(name, got, want, idx, tol=RENDER_TOL):
    import numpy as np
    got = got.detach().double().cpu().numpy()
    probe = float(np.max(np.abs(got[:, idx] - np.asarray(want["probes"]))))
    norms = np.linalg.norm(got, axis=-1)
    rel = float(np.max(np.abs(norms - want["norms"])
                       / np.asarray(want["norms"])))
    log(f"{name}: max probe delta {probe:.2e}, max norm delta {rel:.2e} "
        "relative")
    if not (np.isfinite(got).all() and probe <= tol and rel <= tol):
        raise AssertionError(f"{name}: probes {probe:.2e} / norms {rel:.2e} "
                             f"vs the golden, limit {tol}")


def _identities_held(pos, truth):
    """Whether the track nearest each source on the first segment is still
    the one nearest it on the last (pos, truth (S, K, 3))."""
    import numpy as np

    def nearest(t):
        return [int(np.argmin(np.linalg.norm(pos[t] - truth[t, j], axis=-1)))
                for j in range(truth.shape[1])]
    first = nearest(0)
    return len(set(first)) == len(first) and first == nearest(-1)


# The crossing walkers' compensated mean error a track at the rate bank's
# host pool (CPU float32 on the golden's bases: 0.032 / 0.014 m).
WALKERS_MEAN_TOL = 0.035


def _identity_errors(pos, truth):
    """Per-track errors after matching tracks to sources on the first
    segment (pos, truth (S, K, 3))."""
    import numpy as np
    k = pos.shape[1]
    order = [int(np.argmin(np.linalg.norm(pos[0] - truth[0, j], axis=-1)))
             for j in range(k)]
    if len(set(order)) != k:
        raise AssertionError(f"first-segment match is not one to one: "
                             f"{order}")
    return np.stack([np.linalg.norm(pos[:, order[j]] - truth[:, j],
                                    axis=-1) for j in range(k)], 1)


def serving_moving(cf, torch, tool, golden, bases, launches):
    """The moving render: the golden's noise base and a chirp synthesized
    in float64 through ``_render_moving``, and the chirp through
    ``simulate_moving_source`` (synthesized in float32), each one K3
    launch, against the golden's float64 channels."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import simulator
    g = golden["moving"]
    mover = dict(start=g["start"], velocity=g["velocity"])
    chirp64 = simulator._moving_base("chirp", g["chirp_freq"], tool.FS,
                                     g["duration"], g["lead"], None,
                                     torch.float64, "cuda")

    def renders():
        noise = _render_base(torch, tool, bases["moving"], mover, g["mics"],
                             g["duration"], g["frame"])
        chirp = _render_base(torch, tool, chirp64.float(), mover, g["mics"],
                             g["duration"], g["frame"])
        public = simulator.simulate_moving_source(
            g["start"], g["velocity"], g["mics"], tool.FS, tool.C,
            g["duration"], "chirp", freq=g["chirp_freq"], frame=g["frame"],
            dtype=torch.float32)
        return noise, chirp, public

    (noise, chirp, public), counts = run_path(
        cf, "the moving render", renders, ("delay_sum",), SERVING_FORBID)
    _add(launches, counts)
    if counts["delay_sum"] != 3:
        raise AssertionError(f"moving render: {counts['delay_sum']} K3 "
                             "launches for three renders, want 3")
    idx = np.asarray(g["probe_index"])
    jax32 = np.max(np.abs(np.asarray(g["noise_float32"]["probes"])
                          - np.asarray(g["noise"]["probes"])))
    log(f"moving render: the JAX package's float32 render departs from the "
        f"golden by {jax32:.2e} at the probes")
    check_probes("moving render (noise base)", noise, g["noise"], idx)
    check_probes("moving render (chirp)", chirp, g["chirp"], idx)
    check_probes("simulate_moving_source (chirp in float32)", public,
                 g["chirp"], idx, CHIRP32_TOL)
    _, wall = _wall(torch, renders)
    log(f"moving render warm: {wall * 1e3 / 3:.2f} ms a 2 s x 4-mic render "
        f"{card_note()}")
    return noise


def serving_trajectory(cf, torch, tool, golden, capture, launches):
    """localize_trajectory on the moving capture, static and compensated
    (K1 over the segments, or over segments x subframes)."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import tracking
    lower, upper = tool.ROOM_BOX
    g = golden["moving"]
    for motion in ("static", "compensated"):
        want = golden["trajectory"][motion]

        def track():
            return tracking.localize_trajectory(
                capture, g["mics"], tool.FS, tool.C, lower, upper,
                motion=motion, **tool.TRAJECTORY)

        tr, counts = run_path(cf, f"localize_trajectory ({motion})", track,
                              ("gcc_all_pairs",), SERVING_FORBID)
        _add(launches, counts)
        pos = tr.positions.cpu().numpy()
        if not np.isfinite(pos).all():
            raise AssertionError(f"trajectory {motion}: non-finite fixes")
        clear = np.asarray(want["margins"]) > CLEAR_MARGIN
        delta = np.linalg.norm(pos - np.asarray(want["positions"]), axis=-1)
        truth = np.asarray(g["start"]) + tr.times.cpu().numpy()[:, None] \
            * np.asarray(g["velocity"])
        err = np.linalg.norm(pos - truth, axis=-1)
        log(f"trajectory {motion}: {pos.shape[0]} segments, golden delta "
            f"max {delta[clear].max() if clear.any() else 0.0:.2e} m on "
            f"{int(clear.sum())} clear segments (all: max {delta.max():.2e}),"
            f" mean error vs truth {err.mean():.4f} m")
        if clear.any() and delta[clear].max() > GOLDEN_TOL:
            raise AssertionError(f"trajectory {motion}: {delta} vs golden")
        if motion == "compensated":
            vel = tr.velocities.cpu().numpy()
            log(f"trajectory compensated velocities (m/s, truth "
                f"{g['velocity']}): median "
                f"{np.round(np.median(vel, 0), 3).tolist()}")
            if err.mean() > 0.05:
                raise AssertionError(f"compensated trajectory error "
                                     f"{err.mean():.3f} m > 0.05 m")
        _, wall = _wall(torch, track)
        log(f"trajectory {motion} warm: {wall * 1e3:.1f} ms for "
            f"{pos.shape[0]} segments {card_note()}")


def serving_walkers(cf, torch, tool, golden, bases, launches):
    """track_multiple on the crossing walkers (4-mic tetra, K = 2, static
    and compensated) and three walkers on the 8-mic room array
    (compensated), each render K3, each tracking K1.  Returns the 2-walker
    capture."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import tracking
    lower, upper = tool.ROOM_BOX
    duration = tool.NUM_SEG * tool.SEGMENT / tool.FS
    mix2 = None
    for name in ("walkers", "walkers3"):
        g = golden[name]

        def render():
            return sum(_render_base(torch, tool, bases[f"{name}_{k}"], w,
                                    g["mics"], duration, 1024)
                       for k, w in enumerate(g["walkers"]))

        mix, counts = run_path(cf, f"{name}: render", render,
                               ("delay_sum",), SERVING_FORBID)
        _add(launches, counts)
        if name == "walkers":
            mix2 = mix
        for motion in ("static", "compensated"):
            if motion not in g:
                continue

            def track():
                return tracking.track_multiple(
                    mix, g["mics"], tool.FS, tool.C, lower, upper,
                    num_sources=len(g["walkers"]), motion=motion,
                    **tool.MULTI)

            mt, counts = run_path(cf, f"track_multiple {name} ({motion})",
                                  track, ("gcc_all_pairs",), SERVING_FORBID)
            _add(launches, counts)
            pos = mt.positions.cpu().numpy()
            truth = tool.walker_truth(g["walkers"], mt.times.cpu().numpy())
            err = _identity_errors(pos, truth)
            if motion == "compensated":
                pool = tracking._rate_bank_pool(
                    lower, upper, tool.MULTI["coarse_n"], tool.FS, tool.C)
                held = _identities_held(pos, truth)
                log(f"track_multiple {name} compensated: rate bank pool "
                    f"{pool} samples, identities held {held}")
                limit = WALKERS_MEAN_TOL if name == "walkers" else 0.1
                if not held or err.mean(0).max() > limit:
                    raise AssertionError(
                        f"{name} compensated (pool {pool}): identities "
                        f"held {held}, mean errors {err.mean(0)} (limit "
                        f"{limit} m)")
            gold = _identity_errors(np.asarray(g[motion]["positions"]),
                                    truth)
            _, wall = _wall(torch, track)
            log(f"track_multiple {name} {motion}: mean error per track "
                f"{np.round(err.mean(0), 4).tolist()} m, final "
                f"{np.round(err[-1], 4).tolist()} (golden means "
                f"{np.round(gold.mean(0), 4).tolist()}), associated "
                f"{float(mt.associated.float().mean()):.2f}; warm "
                f"{wall * 1e3:.1f} ms for {pos.shape[0]} segments "
                f"{card_note()}")
            if motion == "compensated" and (err.mean(0).max() > 0.1
                                            or err[-1].max() > 0.4):
                raise AssertionError(f"{name} compensated: errors {err}")
    return mix2


def serving_streaming_gcc(cf, torch, launches):
    """gcc_phat_streaming on 4 mics x 60 s at 44.1 kHz, frame 8192, PHAT
    (K7) and 'ml' (no kernel): TDOAs within 0.05 samples of the injected
    delays; device time and peak memory."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.ops import gccphat
    n = int(STREAM_SECONDS * STREAM_FS)
    nfft = 1 << int(math.ceil(math.log2(n + 256)))
    gen = torch.Generator(device="cuda").manual_seed(14)
    base = torch.randn(nfft, generator=gen, device="cuda",
                       dtype=torch.float64)
    freqs = torch.fft.rfftfreq(nfft, device="cuda", dtype=torch.float64)
    spec = torch.fft.rfft(base)
    delays = torch.tensor(STREAM_DELAYS, device="cuda", dtype=torch.float64)
    sigs = torch.fft.irfft(spec * torch.exp(-2j * math.pi * freqs
                                            * delays[:, None]), nfft)[:, :n]
    sigs = (sigs + 0.3 * torch.randn(sigs.shape, generator=gen,
                                     device="cuda", dtype=torch.float64)
            ).float().contiguous()
    del base, spec
    pi, pj = np.triu_indices(4, 1)
    want = np.array([-(STREAM_DELAYS[j] - STREAM_DELAYS[i])
                     for i, j in zip(pi, pj)])
    for weighting, expect in (("phat", ("whiten",)), ("ml", ())):
        def gcc():
            corr, lags = gccphat.gcc_phat_streaming(
                sigs, pi, pj, frame=8192, weighting=weighting)
            return gccphat.tdoa_from_streaming(corr, lags, STREAM_FS)

        torch.cuda.reset_peak_memory_stats()
        tdoa, counts = run_path(cf, f"gcc_phat_streaming ({weighting})",
                                gcc, expect,
                                SERVING_FORBID + ("gcc_all_pairs",
                                                  "delay_sum"))
        _add(launches, counts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        err = np.abs(tdoa.cpu().numpy() * STREAM_FS - want)
        ms = time_ms(gcc, 3)
        log(f"gcc_phat_streaming {weighting}: 4 x {STREAM_SECONDS:g} s at "
            f"{STREAM_FS:g} Hz, frame 8192: max TDOA error {err.max():.4f} "
            f"samples, {ms:.2f} ms a call (CUDA events), peak memory "
            f"{peak:.3f} GiB {card_note()}")
        if not err.max() <= 0.05:
            raise AssertionError(f"streaming GCC {weighting}: TDOA errors "
                                 f"{err} samples")


def _per_hop(torch, fn, hops, hop_s):
    _, wall = _wall(torch, fn)
    ms = wall * 1e3 / hops
    return ms, hop_s * 1e3 / ms


def serving_streams(cf, torch, tool, golden, walkers_mix, launches):
    """StreamingLocalizer by run() and step() on the example's 10 s
    capture (K7), two talkers on the 8-mic cube ('spatial', 'claim'; K7),
    'music' and 'capon' on two tones (no kernel), and OnlineTracker over
    the compensated stream on the crossing walkers (K1 and K7); ms a hop
    warm and the real-time factor."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import online
    captures = {name: tool.static_capture(name) for name in tool.CAPTURES}
    for case, spec in tool.STREAMS.items():
        mics = tool.MIC_SETS[spec["mics"]]
        sources = np.asarray([s[0] for s in
                              tool.CAPTURES[spec["capture"]]["sources"]])
        capture = captures[spec["capture"]]
        loc = online.StreamingLocalizer(mics, tool.FS, tool.C, np.zeros(3),
                                        np.ones(3), **spec["kw"])
        expect = ("whiten",) if loc.method == "srp" else ()
        (pos, _), counts = run_path(
            cf, f"StreamingLocalizer {case}", lambda: loc.run(capture),
            expect, SERVING_FORBID + ("delay_sum", "gcc_all_pairs"))
        _add(launches, counts)
        want = np.asarray(golden["stream"][case]["positions"])
        delta = np.abs(pos - want).reshape(pos.shape[0], -1).max(1)
        tail = pos[pos.shape[0] // 2:].reshape(-1, len(sources), 3)
        err = np.stack([np.min(np.linalg.norm(
            tail[:, :, None] - s, axis=-1), 1) for s in sources], 1)
        med = np.median(err, 0)
        hops = capture.shape[1] // loc.hop
        ms, rtf = _per_hop(torch, lambda: loc.run(capture), hops,
                           loc.hop / tool.FS)
        log(f"stream {case}: {pos.shape[0]} hops, tail-median error per "
            f"talker {np.round(med, 4).tolist()} m, golden delta median "
            f"{np.median(delta):.2e} max {delta.max():.2e}; warm run() "
            f"{ms:.3f} ms a hop = {rtf:.1f}x real time {card_note()}")
        if not np.isfinite(pos).all() or med.max() > 0.03:
            raise AssertionError(f"stream {case}: errors {med}")
        if case in ("srp", "two_claim", "music"):
            wall_ms, dev_ms, idle = idle_share(
                torch, _load_tool("torch_rowdft_bench"),
                lambda: loc.run(capture))
            log(f"stream {case} run(): {wall_ms:.1f} ms wall, {dev_ms:.2f} "
                f"ms of device time ({dev_ms / hops:.3f} a hop), device "
                f"idle {idle:.1%} {card_note()}")
        if case == "srp":
            def stepped():
                state, out = loc.init_state(), []
                for s in range(hops):
                    o = loc.step(state, capture[:, s * loc.hop:
                                                (s + 1) * loc.hop])
                    state = o.state
                    out.append(o.position)
                return torch.stack(out).cpu().numpy()

            step_pos, counts = run_path(cf, "StreamingLocalizer srp step()",
                                        stepped, expect)
            _add(launches, counts)
            warm = loc.frame // loc.hop - 1
            if not np.array_equal(step_pos[warm:], pos):
                raise AssertionError("step() and run() disagree")
            ms, rtf = _per_hop(torch, stepped, hops, loc.hop / tool.FS)
            log(f"stream srp step(): equal to run(); warm {ms:.3f} ms a hop "
                f"= {rtf:.1f}x real time (a block upload a hop) "
                f"{card_note()}")
    g = golden["walkers"]
    kw = {k: v for k, v in golden["tracker"].items()
          if k not in ("positions", "associated")}
    lower, upper = tool.ROOM_BOX
    trk = online.OnlineTracker(online.StreamingLocalizer(
        g["mics"], tool.FS, tool.C, lower, upper, **kw), max_speed=3.0)
    capture = walkers_mix.cpu().numpy()
    (pos, _, ok), counts = run_path(
        cf, "OnlineTracker (compensated)", lambda: trk.run(capture),
        ("gcc_all_pairs", "whiten"), SERVING_FORBID + ("delay_sum",))
    _add(launches, counts)
    hop = kw["hop"]
    times = (np.arange(trk.warmup - 1, capture.shape[1] // hop) * hop
             / tool.FS)[:pos.shape[0]]
    err = _identity_errors(pos, tool.walker_truth(g["walkers"], times))
    hops = capture.shape[1] // hop
    ms, rtf = _per_hop(torch, lambda: trk.run(capture), hops, hop / tool.FS)
    log(f"OnlineTracker compensated: mean error per talker "
        f"{np.round(err.mean(0), 4).tolist()} m, associated "
        f"{ok.mean():.2f}; warm {ms:.3f} ms a hop = {rtf:.1f}x real time "
        f"{card_note()}")
    if err.mean(0).max() > 0.1:
        raise AssertionError(f"OnlineTracker errors {err.mean(0)}")


def serving_phase(cf, torch, launches):
    """Phase 11: the serving and tracking path (module docstring, 11)."""
    import numpy as np
    start = time.perf_counter()
    tool = _load_tool("torch_serving_golden")
    golden = json.loads(SERVING_GOLDEN.read_text())
    with np.load(SERVING_BASES) as npz:
        bases = {k: npz[k] for k in npz.files}
    capture = serving_moving(cf, torch, tool, golden, bases, launches)
    serving_trajectory(cf, torch, tool, golden, capture, launches)
    mix = serving_walkers(cf, torch, tool, golden, bases, launches)
    serving_streaming_gcc(cf, torch, launches)
    serving_streams(cf, torch, tool, golden, mix, launches)
    log(f"phase 11: {time.perf_counter() - start:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: beamformed extraction, array calibration and the mesh
# ---------------------------------------------------------------------------

EXTRACTION_GOLDEN = REPO / "tests" / "data" / "torch_extraction_golden.json"
EXTRACTION_BASES = REPO / "tests" / "data" / "torch_extraction_bases.npz"
ALL_KERNELS = tuple(KERNELS)
SIR_TOL_DB = 0.5
GAIN_TOL = 0.02
CAL_POS_TOL = 1e-4
#: How much farther from the float64 golden than the JAX package's own
#: float32 self-calibration the card's may land (m): a seventh of that
#: run's 3.3-3.6 cm offset along the anchor's rigid mode.
SELF_CAL_ROOM = 5e-3
MESH_SEED = 41
MESH_JOIN_S = 120.0
MESH_REPEATS = 5


def _free_field(torch, tool, base, source, mics, fs, c, duration):
    """The golden's free-field render of a float32 base on the card (K3)."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import simulator
    ff = tool.FREE_FIELD
    paths, _, _ = simulator._scene_geometry(
        source, mics, c, 500.0, None, None, ff["absorption"],
        ff["freq_table"], 0, ff["threshold"], torch.float32, "cuda")
    budget = simulator.static_delay_budget(np.asarray(source), mics,
                                           np.zeros((0, 4)), 0, fs)
    out = int(duration * fs)
    total = out + int(np.ceil(budget * fs))
    return simulator.render_scene(
        torch.as_tensor(base, dtype=torch.float32, device="cuda"),
        paths.delays, paths.gains, fs, total, out, pad_mode="pow2")


def _var(torch, x):
    return float(torch.var(x, correction=0))


def extraction_sirs(torch, tool, s_only, i_only, ps):
    """tools/eval_sweep.py's extraction protocol for one scene on the card
    (the golden tool's ``_sirs``): delay-and-sum SIR, and MVDR / LCMV SIR
    and target gain with weights adapted on the mix, applied to each
    component."""
    from pyaudiolocalization_tpu_torch.models import beamformer as bf
    fs, c, frame, hop = tool.X_FS, tool.X_C, tool.FRAME, tool.HOP
    n = s_only.shape[-1]
    s_al = bf.align_to_position(s_only, tool.CUBE, ps, fs, c, device="cuda")
    i_al = bf.align_to_position(i_only, tool.CUBE, ps, fs, c, device="cuda")
    ds = bf.extract_source(s_only, tool.CUBE, ps, fs, c, device="cuda")
    di = bf.extract_source(i_only, tool.CUBE, ps, fs, c, device="cuda")
    row = {"das_ratio": _var(torch, ds) / _var(torch, di)}
    tau0 = torch.zeros(len(tool.CUBE), device="cuda")
    for taps, loading in tool.TAPS_LOADING.items():
        wr, wi = bf.mvdr_weights(bf.stack_taps(
            bf.stft_analysis(s_al + i_al, frame, hop), taps, True), tau0, fs,
            frame, loading, taps)

        def apply(al):
            y = bf.apply_weights(wr, wi, bf.stack_taps(
                bf.stft_analysis(al, frame, hop), taps, False))
            return bf.wola_synthesis(y, frame, hop, n)

        so, io = apply(s_al), apply(i_al)
        row[f"taps{taps}_ratio"] = _var(torch, so) / _var(torch, io)
        row[f"taps{taps}_gain"] = _var(torch, so) / _var(torch, ds)
    return row


def extraction_step(cf, torch, tool, golden, bases, launches):
    """EVALUATION.md's extraction protocol at full size: 3 scenes of the
    8-mic cube at 16 kHz, white-noise and 1 kHz sine interferers at 0.25 s
    and 1.0 s, taps 1 and 3; renders on K3, extraction on no kernel.  Each
    case's mean SIR within 0.5 dB and target gain within 0.02 of the
    float64 golden; the sine rows' MVDR more than 10 dB above
    delay-and-sum; warm ms a call."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import beamformer as bf
    from pyaudiolocalization_tpu_torch.ops import signal as sig_ops
    scenes = tool.extraction_scenes()

    def renders():
        out = {}
        for duration in tool.X_DURATIONS:
            for kind, freq in tool.INTERFERERS:
                for i, (ps, pi) in enumerate(scenes):
                    s_only = _free_field(
                        torch, tool, bases[f"target_{duration:g}s_{i}"], ps,
                        tool.CUBE, tool.X_FS, tool.X_C, duration)
                    ibase = (bases[f"interferer_{duration:g}s_{i}"]
                             if kind == "noise" else sig_ops.generate_signal(
                                 "sine", tool.X_FS, duration, freq,
                                 dtype=torch.float32, device="cuda"))
                    i_only = _free_field(torch, tool, ibase, pi, tool.CUBE,
                                         tool.X_FS, tool.X_C, duration)
                    i_only = i_only * math.sqrt(_var(torch, s_only)
                                                / _var(torch, i_only))
                    out[(kind, duration, i)] = (s_only, i_only)
        return out

    mixes, counts = run_path(cf, "extraction: the scene renders", renders,
                             ("delay_sum",), tuple(k for k in ALL_KERNELS
                                                   if k != "delay_sum"))
    _add(launches, counts)

    def extract():
        return {key: extraction_sirs(torch, tool, s, i,
                                     scenes[key[2]][0])
                for key, (s, i) in mixes.items()}

    rows, counts = run_path(cf, "extraction (delay-and-sum, MVDR, LCMV)",
                            extract, (), ALL_KERNELS)
    _add(launches, counts)
    for duration in tool.X_DURATIONS:
        for kind, _ in tool.INTERFERERS:
            name = f"{kind}_{duration:g}s"
            want = golden[name]
            got_rows = [rows[(kind, duration, i)] for i in range(len(scenes))]
            got = {"das_sir_db": 10 * np.log10(np.mean(
                [r["das_ratio"] for r in got_rows]))}
            for t in tool.TAPS_LOADING:
                got[f"taps{t}_sir_db"] = 10 * np.log10(np.mean(
                    [r[f"taps{t}_ratio"] for r in got_rows]))
                got[f"taps{t}_gain"] = float(np.mean(
                    [r[f"taps{t}_gain"] for r in got_rows]))
            deltas = {k: got[k] - want[k] for k in got}
            log(f"extraction {name}: das {got['das_sir_db']:.2f} dB, MVDR "
                f"{got['taps1_sir_db']:.2f} dB gain {got['taps1_gain']:.3f},"
                f" LCMV taps 3 {got['taps3_sir_db']:.2f} dB gain "
                f"{got['taps3_gain']:.3f}; golden deltas "
                + ", ".join(f"{k} {v:+.3f}" for k, v in deltas.items()))
            bad = [k for k, v in deltas.items()
                   if abs(v) > (GAIN_TOL if "gain" in k else SIR_TOL_DB)]
            if bad or not all(map(math.isfinite, got.values())):
                raise AssertionError(f"extraction {name}: {bad} off the "
                                     f"golden ({deltas})")
            if kind == "sine" and not (got["taps1_sir_db"]
                                       > got["das_sir_db"] + 10.0):
                raise AssertionError(f"extraction {name}: MVDR does not beat "
                                     "delay-and-sum by 10 dB")
    s_only, i_only = mixes[("noise", 1.0, 0)]
    mix = s_only + i_only
    ps = scenes[0][0]
    for name, fn in (
            ("extract_source", lambda: bf.extract_source(
                mix, tool.CUBE, ps, tool.X_FS, tool.X_C, device="cuda")),
            ("extract_source_mvdr taps 1", lambda: bf.extract_source_mvdr(
                mix, tool.CUBE, ps, tool.X_FS, tool.X_C, device="cuda")),
            ("extract_source_mvdr taps 3", lambda: bf.extract_source_mvdr(
                mix, tool.CUBE, ps, tool.X_FS, tool.X_C, taps=3,
                device="cuda"))):
        log(f"{name} warm: {time_ms(fn, 10):.3f} ms a call on 8 mics x 1.0 "
            f"s at 16 kHz (CUDA events); {device_note(torch, fn)} "
            f"{card_note()}")


def device_note(torch, fn):
    """Device time and kernels of one warm call of ``fn`` (the profiler
    trace), its wall time and the device's idle share, as one string."""
    dev = _load_tool("torch_rowdft_bench").device_ms(fn, 1)
    _, wall = _wall(torch, fn)
    return (f"device {dev['total']:.3f} ms in {dev['kernels']:g} kernels, "
            f"wall {wall * 1e3:.1f} ms, device idle "
            f"{1.0 - dev['total'] / (wall * 1e3):.1%}")


def calibration_stages(torch, tool, events, c):
    """Warm stage breakdown of the tetrahedron's calibration at 16,384:
    K1 over the events, the TDOA ladder, the SNR weights, the 60 refine
    sweeps (each stage timed to a synchronize)."""
    from pyaudiolocalization_tpu_torch.models import arraycal
    from pyaudiolocalization_tpu_torch.models import tdoa
    from pyaudiolocalization_tpu_torch.ops import gccphat
    pi, pj = tool.pairs(len(tool.TETRA))
    n = events.shape[-1]
    corr, t_gcc = _wall(torch, lambda: gccphat.gcc_phat_all_pairs(
        events, pi, pj, nfft=16384))
    res, t_ladder = _wall(torch, lambda: tdoa.time_delays_from_corr(
        corr, n, n, tool.C_FS, max_expected_delay=tool.MAX_DELAY))
    w, t_weights = _wall(torch, lambda: tdoa.compute_weights(
        tdoa.correlation_snr(corr)))
    _, t_refine = _wall(torch, lambda: arraycal.refine_mic_positions(
        -res.delays[..., 0], tool.SOURCES, tool.TETRA, pi, pj, c,
        weights=w, device="cuda"))
    log(f"calibration tetra_16384 stages (warm): K1 {t_gcc * 1e3:.2f} ms, "
        f"TDOA ladder {t_ladder * 1e3:.2f}, weights {t_weights * 1e3:.2f}, "
        f"60 refine sweeps {t_refine * 1e3:.2f} {card_note()}")


def _cal_events(torch, tool, bases, name, true, sources, c):
    return torch.stack([_free_field(
        torch, tool, bases[f"{name}_event_{k}"], src, true, tool.C_FS, c,
        tool.C_DURATION) for k, src in enumerate(sources)])


def calibration_step(cf, torch, tool, golden, bases, launches):
    """examples/calibrate_array_geometry.py's scene on the card: the
    tetrahedron's 8 events at 48 kHz x 0.1 s (known sources) and the
    6-mic array's 12 (joint self-calibration with the golden's k-means
    seeds), each at nfft=None (the exact length: K7 whitens) and 16,384
    (one K1 launch over the events).  TDOAs equal to the golden's where
    its margins are clear, the tetrahedron's positions within 1e-4 m when
    all are, its worst-mic error at most 3 mm, the self-calibrated shape
    (worst inter-mic distance error) within 1 mm
    of the golden's, and its absolute positions no farther from float64
    than the JAX package's float32 run plus ``SELF_CAL_ROOM`` (they keep
    the anchor's rigid part, which float32 leaves centimetres from
    float64)."""
    import numpy as np
    from pyaudiolocalization_tpu_torch.models import arraycal
    g = golden
    c, fs = g["c"], tool.C_FS
    tetra_true, six_true = tool.true_geometries()
    (tetra_ev, six_ev), counts = run_path(
        cf, "calibration: the event renders", lambda: (
            _cal_events(torch, tool, bases, "tetra", tetra_true,
                        tool.SOURCES, c),
            _cal_events(torch, tool, bases, "six", six_true, tool.SOURCES12,
                        c)),
        ("delay_sum",), tuple(k for k in ALL_KERNELS if k != "delay_sum"))
    _add(launches, counts)
    calibration_stages(torch, tool, tetra_ev, c)
    for name, events, survey, true in (("tetra", tetra_ev, tool.TETRA,
                                        tetra_true),
                                       ("six", six_ev, tool.MICS6,
                                        six_true)):
        for nfft in tool.C_NFFTS:
            tag = f"{name}_{nfft or 'exact'}"
            want = g[tag]
            kernel = "gcc_all_pairs" if nfft else "whiten"

            def calibrate():
                if name == "tetra":
                    return arraycal.calibrate_array_geometry(
                        events, tool.SOURCES, survey, fs, c, nfft=nfft,
                        max_expected_delay=tool.MAX_DELAY, device="cuda")
                return arraycal.calibrate_array_geometry(
                    events, None, survey, fs, c, nfft=nfft,
                    max_expected_delay=tool.MAX_DELAY,
                    seed_indices=want["seed_indices"], device="cuda")

            res, counts = run_path(
                cf, f"calibrate_array_geometry {tag}", calibrate, (kernel,),
                tuple(k for k in ALL_KERNELS if k != kernel))
            _add(launches, counts)
            if counts[kernel] != 1:
                raise AssertionError(f"{tag}: {counts[kernel]} {kernel} "
                                     "launches, want 1 over the events")
            td = res.tdoas.double().cpu().numpy()
            margins = np.asarray(want["margins"])
            clear = margins > CLEAR_MARGIN
            td_err = np.abs(td - np.asarray(want["tdoas"])) * fs
            mics = res.mic_positions.double().cpu().numpy()
            pos_err = np.linalg.norm(mics - np.asarray(want["mic_positions"]),
                                     axis=-1).max()
            _, wall = _wall(torch, calibrate)
            if nfft:
                log(f"calibration {tag} warm: {device_note(torch, calibrate)}"
                    f" {card_note()}")
            msg = (f"calibration {tag}: least TDOA margin {margins.min():.3e}"
                   f" ({int(clear.sum())}/{clear.size} clear), max TDOA "
                   f"delta {td_err[clear].max():.4f} samples where clear, "
                   f"positions {pos_err:.2e} m from the golden")
            if not (np.isfinite(mics).all() and td_err[clear].max() <= 0.05):
                raise AssertionError(msg)
            if name == "tetra":
                if clear.all() and pos_err > CAL_POS_TOL:
                    raise AssertionError(msg)
                worst = np.linalg.norm(mics - true, axis=-1).max()
                surveyed = np.linalg.norm(np.asarray(survey) - true,
                                          axis=-1).max()
                log(f"{msg}; worst-mic error {worst * 1e3:.2f} mm (golden "
                    f"{want['worst_mic_error'] * 1e3:.2f} mm, survey "
                    f"{surveyed * 1e3:.1f} mm); warm {wall * 1e3:.1f} ms "
                    f"{card_note()}")
                if worst > 3e-3:
                    raise AssertionError(f"{tag}: worst-mic error {worst}")
            else:
                # The absolute positions of a self-calibration keep the
                # rigid, data-null part that only the weak anchor pins:
                # float32 leaves it centimetres from float64, as the JAX
                # package's own float32 run shows (float32_offset).  The
                # shape is the result.
                shape = np.abs(tool.pairwise(mics)
                               - tool.pairwise(true)).max()
                shape_gap = np.abs(tool.pairwise(mics) - tool.pairwise(
                    want["mic_positions"])).max()
                jax32 = np.linalg.norm(mics - np.asarray(
                    want["float32_mic_positions"]), axis=-1).max()
                msg += (f" (the JAX package's float32 run "
                        f"{want['float32_offset']:.2e} m, the card "
                        f"{jax32:.2e} m from that run), inter-mic distances "
                        f"{shape_gap:.2e} m from the golden's")
                log(f"{msg}; worst inter-mic distance error "
                    f"{shape * 1e3:.2f} mm (golden "
                    f"{want['worst_shape_error'] * 1e3:.2f} mm); warm "
                    f"{wall * 1e3:.1f} ms {card_note()}")
                if abs(shape - want["worst_shape_error"]) > 1e-3:
                    raise AssertionError(f"{tag}: shape error {shape}")
                if pos_err > want["float32_offset"] + SELF_CAL_ROOM:
                    raise AssertionError(
                        f"{tag}: positions {pos_err} m from float64, the "
                        f"JAX package's float32 run {want['float32_offset']}"
                        f" m, room {SELF_CAL_ROOM} m")


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_rank(rank, port, out_dir, spec_kw, scenes):
    """One of two gloo ranks on cuda:0: the meshed sweep (K5 over its
    scenes), then a warm repeat timed; results, summary and launches to
    out_dir/rank{r}.npz, or the traceback to rank{r}.err."""
    import os
    import traceback
    import numpy as np
    try:
        import torch
        torch.cuda.set_device(0)
        from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
        from pyaudiolocalization_tpu_torch.parallel import (
            SweepSpec, monte_carlo_sweep, multihost)
        multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
        mesh = multihost.global_scene_mesh(device="cuda:0")
        spec = SweepSpec(**spec_kw)
        cf.reset_launches()
        out = monte_carlo_sweep(spec, MESH_SEED, scenes, mesh=mesh)
        k5 = cf.LAUNCHES["scene_windowed"]
        torch.cuda.synchronize()
        mesh.barrier()
        start = time.perf_counter()
        monte_carlo_sweep(spec, MESH_SEED, scenes, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        res = {f"shard_{k}": v.cpu().numpy()
               for k, v in zip(out.results._fields, out.results)}
        res["summary"] = np.array([float(out.rmse), float(out.mean_error),
                                   float(out.hit_rate)])
        res["k5"] = np.array(k5)
        res["seconds"] = np.array(seconds)
        import torch.distributed as dist
        dist.destroy_process_group()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def mesh_step(cf, torch, sweep_golden, launches):
    """A one-rank NCCL mesh in this process: bench_full_sweep's spec on
    512 scenes (K5) equal to ``run_sweep_checkpointed(..., 512, 512)`` to
    the bit; then two spawned gloo ranks on the one card, 256 scenes each
    (K5), each shard equal to its chunk of ``run_sweep_checkpointed(...,
    512, 256)`` and both summaries equal; scenes/s beside the mesh-less
    sweep."""
    import multiprocessing
    import os
    import tempfile
    import numpy as np
    import torch.distributed as dist
    from pyaudiolocalization_tpu_torch.parallel import (
        monte_carlo_sweep, multihost, run_sweep_checkpointed)
    from pyaudiolocalization_tpu_torch.parallel import sweep as sw
    spec_kw = {k: tuple(v) if isinstance(v, list) else v
               for k, v in sweep_golden["spec"].items()}
    spec = sw.SweepSpec(**spec_kw)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    fields = sw.SceneResult._fields
    windowed = ("scene_windowed",)
    split = ("delay_sum", "gcc_windowed")

    def equal(a, b, what):
        for field, x, y in zip(fields, a, b):
            x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
            if not np.array_equal(x, np.asarray(y), equal_nan=True):
                raise AssertionError(f"{what}: {field} differs")

    multihost.initialize(f"localhost:{_free_port()}", 1, 0, backend="nccl")
    try:
        mesh = multihost.global_scene_mesh()
        (out, mesh_s), counts = run_path(
            cf, "the one-rank NCCL mesh sweep", lambda: _wall(
                torch, lambda: monte_carlo_sweep(spec, MESH_SEED,
                                                 SWEEP_SCENES, mesh=mesh)),
            windowed, split)
        _add(launches, counts)
        ref, counts = run_path(
            cf, "run_sweep_checkpointed (one chunk)",
            lambda: run_sweep_checkpointed(
                spec, MESH_SEED, SWEEP_SCENES, SWEEP_SCENES,
                os.path.join(tmp, "one.npz"), device="cuda"),
            windowed, split)
        _add(launches, counts)
        equal(out.results, ref.results, "one-rank NCCL mesh vs one chunk")

        def meshed():
            return monte_carlo_sweep(spec, MESH_SEED, SWEEP_SCENES,
                                     mesh=mesh)

        def plain():
            return monte_carlo_sweep(spec, MESH_SEED, SWEEP_SCENES,
                                     device="cuda")

        # Warm repeats of each, alternated within the process group's life,
        # then one profiled call of each: the meshed sweep adds one
        # all-reduce of 3 floats.
        mesh_s, plain_s = [], []
        for _ in range(MESH_REPEATS):
            mesh_s.append(_wall(torch, meshed)[1])
            plain_s.append(_wall(torch, plain)[1])
        mesh_dev, plain_dev = device_note(torch, meshed), device_note(
            torch, plain)
    finally:
        dist.destroy_process_group()

    def rates(samples):
        return ", ".join(f"{SWEEP_SCENES / t:.1f}" for t in samples)

    log(f"one-rank NCCL mesh: {SWEEP_SCENES} scenes equal to "
        f"run_sweep_checkpointed's one chunk to the bit, summary rmse "
        f"{float(out.rmse):.4f} m hit rate {float(out.hit_rate):.4f}; warm "
        f"scenes/s over {MESH_REPEATS} alternated repeats: meshed "
        f"[{rates(mesh_s)}] (median "
        f"{SWEEP_SCENES / float(np.median(mesh_s)):.1f}), without a mesh "
        f"[{rates(plain_s)}] (median "
        f"{SWEEP_SCENES / float(np.median(plain_s)):.1f}); profiled: meshed "
        f"{mesh_dev}; without a mesh {plain_dev} {card_note()}")

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_mesh_rank,
                         args=(r, port, tmp, spec_kw, SWEEP_SCENES))
             for r in range(2)]
    start = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(MESH_JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [open(os.path.join(tmp, f)).read()
              for f in sorted(os.listdir(tmp)) if f.endswith(".err")]
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"two-rank mesh: {len(alive)} ranks still "
                             f"running after {MESH_JOIN_S} s, errors "
                             f"{errors}")
    wall = time.perf_counter() - start
    ranks = []
    for r in range(2):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    half = SWEEP_SCENES // 2
    chunks, counts = run_path(
        cf, "run_sweep_checkpointed (two chunks)",
        lambda: run_sweep_checkpointed(
            spec, MESH_SEED, SWEEP_SCENES, half,
            os.path.join(tmp, "two.npz"), device="cuda"),
        windowed, split)
    _add(launches, counts)
    for r, ranked in enumerate(ranks):
        if int(ranked["k5"]) < 1:
            raise AssertionError(f"rank {r} launched no K5")
        equal([ranked[f"shard_{k}"] for k in fields],
              [getattr(chunks.results, k)[r * half:(r + 1) * half]
               for k in fields], f"rank {r}'s shard vs chunk {r}")
    if not np.array_equal(ranks[0]["summary"], ranks[1]["summary"]):
        raise AssertionError(f"rank summaries differ: {ranks[0]['summary']}"
                             f" vs {ranks[1]['summary']}")
    slowest = max(float(r["seconds"]) for r in ranks)
    log(f"two gloo ranks on one card: each shard ({half} scenes, K5 "
        f"launches {[int(r['k5']) for r in ranks]}) equal to its chunk to "
        f"the bit, summaries equal (rmse {ranks[0]['summary'][0]:.4f} m); "
        f"warm {SWEEP_SCENES / slowest:.1f} scenes/s for the two ranks "
        f"sharing the card (the slower rank's {slowest:.3f} s), "
        f"{wall:.1f} s wall with the processes' start; only one card here,"
        f" so no multi-card rate is measured {card_note()}")


def extraction_calibration_mesh_phase(cf, torch, sweep_golden, launches):
    """Phase 12: beamformed extraction, array calibration and the mesh
    (module docstring, 12)."""
    import numpy as np
    start = time.perf_counter()
    tool = _load_tool("torch_extraction_golden")
    golden = json.loads(EXTRACTION_GOLDEN.read_text())
    with np.load(EXTRACTION_BASES) as npz:
        bases = {k: npz[k] for k in npz.files}
    extraction_step(cf, torch, tool, golden["extraction"], bases, launches)
    calibration_step(cf, torch, tool, golden["calibration"], bases,
                     launches)
    mesh_step(cf, torch, sweep_golden, launches)
    log(f"phase 12: {time.perf_counter() - start:.1f} s")


EVAL_GOLDEN = REPO / "tests" / "data" / "torch_eval_golden.json"
# The kernels each half of phase 13 must launch (PERF.md section 6).
EVAL_KERNELS = ("scene_windowed", "delay_sum", "gcc_all_pairs", "whiten")
FUZZ_KERNELS = ("scene_windowed", "delay_sum", "gcc_windowed",
                "gcc_all_pairs", "fft_real", "whitened_corr")


def evaluation_fuzz_phase(cf, torch, launches):
    """Phase 13: the measurement tools (module docstring, 13)."""
    import contextlib
    import io
    start = time.perf_counter()
    ev = _load_tool("torch_eval_sweep")
    fz = _load_tool("torch_path_fuzz")
    golden = json.loads(EVAL_GOLDEN.read_text())
    results = {"rows": [], "extract": [], "tracking": [], "scale": 1}
    seen = {name: 0 for name in cf.LAUNCHES}
    for name in ev.SECTIONS:
        t0 = time.perf_counter()
        part, counts = run_path(cf, f"evaluation {name}",
                                lambda: ev.run_sections([name], 1, "cuda"),
                                ())
        _add(launches, counts)
        _add(seen, counts)
        for key in ("rows", "extract", "tracking"):
            results[key] += part[key]
        if "extract_scenes" in part:
            results["extract_scenes"] = part["extract_scenes"]
        log(f"evaluation {name}: {time.perf_counter() - t0:.1f} s "
            f"{card_note()}")
    missing = [k for k in EVAL_KERNELS if seen[k] == 0]
    if missing:
        raise AssertionError(f"evaluation: kernels not launched {missing}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ev.print_tables(results, golden, f" — {CARD[0]}")
    for line in buf.getvalue().splitlines():
        log(line)
    bad = ev.hold(results, golden)
    if bad:
        raise AssertionError("evaluation against the golden:\n"
                             + "\n".join(bad))
    log(f"evaluation: {len(results['rows'])} sweep rows, "
        f"{len(results['extract'])} extraction cases and "
        f"{len(results['tracking'])} tracking modes hold")
    t0 = time.perf_counter()
    out, counts = run_path(cf, "kernel-path fuzz",
                           lambda: fz.run_fuzz("cuda", emit=log),
                           FUZZ_KERNELS)
    _add(launches, counts)
    log(f"fuzz: {len(out['records'])} configurations, {out['scenes']} "
        f"scenes, {out['ties']} ladder ties, {out['map_ties']} coarse-map "
        f"ties, {time.perf_counter() - t0:.1f} s {card_note()}")
    if not out["ok"]:
        raise AssertionError("fuzz: " + "; ".join(
            f"config {r['config']}: td {r['max_td_diff_samples']:.3g} "
            f"samples, est {r['max_est_diff_m']:.3g} m, ties {r['ties']}"
            for r in out["records"] if not r["ok"])
            + f"; ladder ties {out['ties']} of {out['scenes']} scenes")
    log(f"phase 13: {time.perf_counter() - start:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not (REPO / "pyaudiolocalization_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    # Full float32 everywhere in the reference computations.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slice_golden = json.loads(SLICE_GOLDEN.read_text())
    sweep_golden = json.loads(SWEEP_GOLDEN.read_text())
    options_golden = json.loads(OPTIONS_GOLDEN.read_text())
    srp_golden = json.loads(SRP_GOLDEN.read_text())
    parity_golden = json.loads(PARITY_GOLDEN.read_text())
    nb_golden = json.loads(NB_GOLDEN.read_text())
    recorded_golden = json.loads(RECORDED_GOLDEN.read_text())

    # Phase 1: device.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    CARD[0] = smi
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} ({smi})")

    # Phase 2: build.
    build_s = cf.build()
    log(f"kernel build: {build_s:.2f} s")
    ptxas = cf.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "stack frame" in line):
                log(f"  {line.strip()}")

    # Phase 3: kernels against their plain versions.
    results = kernel_phase(cf, torch)

    # Phases 4, 4b, 5, 6, 7, 8, 9, 10, 11, 12 and 13: the main paths, each
    # with its own launch counts.
    launches = {name: 0 for name in KERNELS}
    main_path_phase(cf, torch, slice_golden, sweep_golden, launches)
    options_phase(cf, torch, slice_golden, options_golden, launches)
    sweep_phase(cf, torch, sweep_golden, launches)
    srp_phase(cf, torch, srp_golden, launches)
    results.update(rowdft_phase(cf, launches))
    parity_phase(cf, torch, parity_golden, launches)
    narrowband_phase(cf, torch, nb_golden, sweep_golden, launches)
    recorded_phase(cf, torch, recorded_golden, sweep_golden, launches)
    serving_phase(cf, torch, launches)
    extraction_calibration_mesh_phase(cf, torch, sweep_golden, launches)
    evaluation_fuzz_phase(cf, torch, launches)
    log(f"launches over the main paths: {launches}")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main paths: "
                             f"{missing}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        err, k_ms, p_ms, lib_ms, b_ms, b_by = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
