"""Multipath scene simulator (counterpart of the JAX package's
models/simulator.py; reference: main.py:66-124).

Ported: the physical-mode path, ``simulate_signals_fast``, which renders at
a static power-of-two length from a host-side delay budget through
``render_scene(pad_mode="pow2")`` and kernel K3 (ops/cuda_fft.delay_sum),
with in-render measurement noise and a leading scene axis for the sweep;
and the reference-parity ``simulate_signals``, with the reference's
data-dependent padding rule and the exact 2N render
(``render_scene(pad_mode="exact")``, plain PyTorch as the JAX package's
XLA path: no TPU kernel took that length).  ``absorption_mode='per-bin'``
evaluates the attenuation law at every rfft bin of either render
(``scene_path_slopes``, gains referenced at f = 0): the JAX package renders
such scenes on XLA, never through its Pallas render, which synthesizes
scalar gains only (models/simulator.py:135-143 there), so here they are
plain PyTorch on either device and never reach K3.

``simulate_moving_source`` is the moving source's WOLA render: Hann
frames of the base (one ``unfold``), each rendered at the static delay and
gain of the source's position at the frame's centre, then overlap-added.
The frames are the scene axis of one ``ops/delay.delay_and_sum`` call at
the pow2-circular length, so the card renders every frame in one K3 launch
(or one a ``cuda_fft.scene_chunk``); the overlap-add is ``fold``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import cuda_fft
from ..ops import noise as noise_ops
from ..ops import signal as sig_ops
from ..ops.delay import delay_and_sum, fade_window
from ..ops.fftutils import next_pow2
from ..utils.device import resolve_device
from . import acoustics

AIR_ID = 0  # MaterialTable guarantees the fallback material at row 0.

# float64's smallest normal is ~2.2e-308; a channel whose strongest path is
# below that is all-zero for the float64 reference too.
_F64_LOG_TINY = -708.0


class ScenePaths(NamedTuple):
    delays: torch.Tensor  # (..., M, 1 + I) seconds; column 0 = direct path
    gains: torch.Tensor   # (..., M, 1 + I) attenuation * acceptance mask


def scene_paths(source: torch.Tensor, mic_positions: torch.Tensor, c,
                frequency, images: acoustics.ImageSources,
                absorption_table: torch.Tensor,
                freq_table: torch.Tensor) -> ScenePaths:
    """Delay/gain matrix for the direct path + every (masked) image source
    (main.py:104-118: the direct path uses 'air', each image its plane's
    material).  Gains are computed in log space and rescaled per mic so the
    strongest path has gain 1 (identical after the per-mic normalization,
    and exact in float32 where the reference's ~exp(-90) attenuations
    underflow).  ``source`` (..., 3) and ``mic_positions`` (..., M, 3)
    may carry a leading scene axis, with images from ``image_sources`` of
    the same scenes."""
    d_direct = torch.linalg.norm(source[..., None, :] - mic_positions,
                                 dim=-1)
    la_direct = acoustics.log_attenuation(d_direct, AIR_ID, frequency,
                                          absorption_table, freq_table)
    if images.positions.shape[-2] == 0:
        la_all = la_direct[..., None]
        delays = d_direct[..., None] / c
    else:
        d_img = torch.linalg.norm(
            images.positions[..., None, :, :]
            - mic_positions[..., :, None, :], dim=-1)            # (..., M, I)
        la_img = acoustics.log_attenuation(
            d_img, images.material_ids, frequency, absorption_table,
            freq_table)
        la_img = torch.where(images.accepted[..., None, :], la_img,
                             torch.full_like(la_img, -np.inf))
        la_all = torch.cat([la_direct[..., None], la_img], -1)  # (..., M, 1+I)
        delays = torch.cat([d_direct[..., None], d_img], -1) / c
    ref = torch.amax(la_all, dim=-1, keepdim=True)              # (..., M, 1)
    alive = ref > _F64_LOG_TINY
    shifted = la_all - torch.where(alive, ref, torch.zeros_like(ref))
    gains = torch.where(torch.isfinite(la_all), torch.exp(shifted),
                        torch.zeros_like(la_all))
    return ScenePaths(delays, torch.where(alive, gains,
                                          torch.zeros_like(gains)))


def scene_path_slopes(source: torch.Tensor, mic_positions: torch.Tensor,
                      images: acoustics.ImageSources,
                      freq_table: torch.Tensor) -> torch.Tensor:
    """Per-path log-gain frequency slopes (..., M, 1 + I) for per-bin
    absorption (``acoustics.attenuation_freq_slope``): the direct path uses
    'air', each image its plane's material, as in ``scene_paths``.  Rejected
    paths keep their finite slope; their gain is already 0."""
    d_direct = torch.linalg.norm(source[..., None, :] - mic_positions,
                                 dim=-1)
    s_direct = acoustics.attenuation_freq_slope(d_direct, AIR_ID, freq_table)
    if images.positions.shape[-2] == 0:
        return s_direct[..., None]
    d_img = torch.linalg.norm(images.positions[..., None, :, :]
                              - mic_positions[..., :, None, :], dim=-1)
    s_img = acoustics.attenuation_freq_slope(d_img, images.material_ids,
                                             freq_table)
    return torch.cat([s_direct[..., None], s_img], -1)


def render_scene(base_signal: torch.Tensor, paths_delays: torch.Tensor,
                 paths_gains: torch.Tensor, fs: float, total_samples: int,
                 out_samples: int, pad_mode: str = "pow2",
                 finalize: bool = True,
                 snr_db: Optional[torch.Tensor] = None,
                 noise_seeds: Optional[torch.Tensor] = None,
                 freq_slopes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Render (..., M, out_samples) mic signals: pad base (..., N) to
    total_samples (main.py:102-103), delay-and-sum all paths, fade, trim
    (main.py:119-120), and normalize + compress per mic (main.py:121-122).
    ``pad_mode='pow2'``: circularly at next_pow2(total_samples), all in
    kernel K3; 'exact': at the reference's 2 * total_samples
    (``ops/delay.delay_and_sum``, plain PyTorch).  ``snr_db`` ((...,) dB)
    with ``noise_seeds`` ((..., 2) int32) adds white measurement noise at
    that per-mic SNR after finalization, drawn from the seeds' Philox
    streams (ops/noise.py).  ``freq_slopes`` ((..., M, P)) shapes each
    path's gain, referenced at f = 0, per rfft bin (per-bin absorption,
    ``ops/delay.delay_and_sum``): that render is plain PyTorch at either
    length, as the JAX package's XLA path."""
    if pad_mode not in ("pow2", "exact"):
        raise ValueError(f"render_scene pad_mode must be 'pow2' or "
                         f"'exact', got {pad_mode!r}")
    if snr_db is not None and noise_seeds is None:
        raise ValueError("snr_db requires noise_seeds")
    dt, dev = base_signal.dtype, base_signal.device
    lead = base_signal.shape[:-1]
    padded = torch.zeros(lead + (total_samples,), dtype=dt, device=dev)
    padded[..., :base_signal.shape[-1]] = base_signal
    if pad_mode == "exact" or freq_slopes is not None:
        sigs = delay_and_sum(
            padded, paths_delays, paths_gains, fs,
            pad_mode="exact" if pad_mode == "exact" else "pow2-circular",
            freq_slopes=freq_slopes)[..., :out_samples]
        if finalize:
            sigs = sig_ops.dynamic_range_compression(
                sig_ops.normalize_signal(sigs))
        if snr_db is not None:
            sigs = noise_ops.add_noise(
                sigs, torch.as_tensor(snr_db, dtype=dt, device=dev),
                noise_seeds)
        return sigs
    fade = fade_window(total_samples, dtype=dt, device=dev)[:out_samples]
    tau = (paths_delays * fs).to(dt).contiguous()
    if snr_db is not None:
        snr_db = torch.as_tensor(snr_db, dtype=dt, device=dev)
    return cuda_fft.delay_sum(padded, tau, paths_gains.to(dt).contiguous(),
                              next_pow2(total_samples), out_samples,
                              fade.contiguous(), finalize, snr_db,
                              noise_seeds)


def static_delay_budget(source_pos, mic_positions, plane_coeffs,
                        max_reflections: int, fs: float) -> float:
    """Conservative host-side bound on the longest path delay (s): scene
    diameter plus one plane-mirror "reach" per reflection order."""
    pts = np.vstack([np.asarray(mic_positions, float).reshape(-1, 3),
                     np.asarray(source_pos, float).reshape(1, 3)])
    diam = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    reach = 0.0
    coeffs = np.asarray(plane_coeffs, float).reshape(-1, 4)
    for row in coeffs:
        n = row[:3]
        nn = max(float(np.linalg.norm(n)), 1e-9)
        # Reach is measured from the scene to the plane, not from the origin.
        dist = float(np.max(np.abs(pts @ n + row[3]))) / nn
        reach = max(reach, 2.0 * dist + 2.0 * diam)
    return (diam + max_reflections * reach) / 300.0 + 1.0 / fs


def _check_per_bin_coefficients(freq_table, plane_material_ids,
                                fs: float) -> None:
    """Warn when per-bin rendering meets reference-scale frequency
    coefficients: the reference table's per-Hz values (air 0.1, wood 0.8;
    SURVEY.md Q2) give exp(-0.1 * f * d) ~ exp(-400) across an audio band,
    harmless as a carrier-mode scalar that the per-mic normalization
    rescales, but evaluated per bin they annihilate everything above
    near-DC.  Physically scaled coefficients are ~1e-6 (air) to ~1e-3
    (very absorbent walls) per Hz*m.  Only the materials the scene uses
    count: row 0 ('air', the direct path) and the planes'."""
    table = np.asarray(freq_table, float)
    if not table.size:
        return
    used = np.unique(np.concatenate(
        [[0], np.asarray(plane_material_ids, np.int64).ravel()]))
    worst = float(np.max(table[used])) * (fs / 2.0)
    if worst > 50.0:
        import warnings
        warnings.warn(
            "absorption_mode='per-bin' with frequency coefficients that "
            f"absorb the band ~exp(-{worst:.0f}) at Nyquist per metre: the "
            "default material table keeps the reference's per-Hz values "
            "(air 0.1, wood 0.8), which only make sense as carrier-mode "
            "scalars.  Per-bin rendering expects physically-scaled "
            "coefficients (~1e-6..1e-3 per Hz*m); most of the band will "
            "render as exact zeros otherwise.", stacklevel=3)


def _ids(plane_material_ids) -> np.ndarray:
    return (np.zeros(0, np.int64) if plane_material_ids is None
            else np.asarray(plane_material_ids, np.int64).reshape(-1))


def _scene_geometry(source_pos, mic_positions, c, freq, plane_coeffs,
                    plane_material_ids, absorption_table, freq_table,
                    max_reflections: int, absorption_threshold: float, dt,
                    device, per_bin: bool = False):
    """Image sources and the direct + image path delays and gains of one
    scene (main.py:93-118), as tensors of ``dt`` on ``device``.  Returns
    (paths, the images' acceptance mask (I,), the paths' frequency slopes
    or None).

    ``per_bin`` references the gains at f = 0 (spreading and the scalar
    absorption only) and returns the slopes: the render applies the
    absolute law exp(-slope * f) per bin, whose exponent is never positive,
    and the relative path weights at the carrier equal carrier mode's up to
    a per-mic scale that the normalization removes.  Image-source
    acceptance stays thresholded at the carrier either way (the reference's
    culling rule, utils.py:90-106)."""

    def put(a, kind=dt):
        return torch.as_tensor(np.asarray(a), dtype=kind, device=device)

    source = put(source_pos)
    mics = put(mic_positions)
    plane_np = (np.zeros((0, 4)) if plane_coeffs is None
                else np.asarray(plane_coeffs, float).reshape(-1, 4))
    ids_np = _ids(plane_material_ids)
    freq_t = put(freq)
    images = acoustics.image_sources(
        source, put(plane_np), put(ids_np, torch.long), mics, freq_t,
        put(absorption_table), put(freq_table), max_reflections,
        absorption_threshold)
    paths = scene_paths(source, mics, put(c),
                        torch.zeros_like(freq_t) if per_bin else freq_t,
                        images, put(absorption_table), put(freq_table))
    slopes = (scene_path_slopes(source, mics, images, put(freq_table))
              if per_bin else None)
    return paths, images.accepted, slopes


def simulate_signals(source_pos, mic_positions, fs: float, c: float,
                     duration: float = 1.0, signal_type: str = "sine",
                     freq: float = 1000.0, plane_coeffs=None,
                     plane_material_ids=None, absorption_table=None,
                     freq_table=None, max_reflections: int = 2,
                     absorption_threshold: float = 0.01,
                     trim_to_duration: bool = True,
                     generator: Optional[torch.Generator] = None,
                     dtype=None, device=None,
                     absorption_mode: str = "carrier") -> torch.Tensor:
    """Reference-parity scene simulation -> (M, samples) (the JAX
    package's ``simulate_signals``, models/simulator.py:268-340 there):
    the reference's concrete padding rule total = int((duration +
    max_delay) * fs), max_delay over the direct paths and the accepted
    image sources (main.py:93-103, one scalar read on the host), the exact
    2N render, trimmed to int(duration * fs) samples unless
    ``trim_to_duration`` is False.  The stochastic signal types draw from
    ``generator``.  ``absorption_mode='per-bin'`` evaluates the attenuation
    law at every rfft bin (``_scene_geometry``), and warns on
    reference-scale coefficients (``_check_per_bin_coefficients``)."""
    if absorption_mode not in ("carrier", "per-bin"):
        raise ValueError("absorption_mode must be 'carrier' or 'per-bin'")
    per_bin = absorption_mode == "per-bin"
    dt = dtype if dtype is not None else torch.get_default_dtype()
    if absorption_table is None:
        from ..utils.materials import default_table
        table = default_table()
        absorption_table, freq_table = table.absorption, table.freq
    if per_bin:
        _check_per_bin_coefficients(freq_table, _ids(plane_material_ids), fs)
    paths, accepted, slopes = _scene_geometry(
        source_pos, mic_positions, c, freq, plane_coeffs, plane_material_ids,
        absorption_table, freq_table, max_reflections, absorption_threshold,
        dt, device, per_bin)
    base = sig_ops.generate_signal(
        signal_type, fs, duration,
        torch.as_tensor(freq, dtype=dt, device=device), generator=generator,
        dtype=dt, device=device)
    m = paths.delays.shape[-2]
    active = torch.cat([torch.ones((m, 1), dtype=torch.bool,
                                   device=paths.delays.device),
                        accepted[None, :].expand(m, -1)], 1)
    max_delay = float(torch.amax(torch.where(
        active, paths.delays, torch.zeros_like(paths.delays))))
    total_samples = int((duration + max_delay) * fs)
    out_samples = int(duration * fs) if trim_to_duration else total_samples
    return render_scene(base, paths.delays, paths.gains, fs, total_samples,
                        out_samples, pad_mode="exact", freq_slopes=slopes)


def simulate_signals_fast(source_pos, mic_positions, fs: float, c: float,
                          duration: float, signal_type: str, freq: float,
                          plane_coeffs, plane_material_ids, absorption_table,
                          freq_table, max_reflections: int,
                          absorption_threshold: float,
                          generator: Optional[torch.Generator] = None,
                          dtype=None, device=None,
                          absorption_mode: str = "carrier") -> torch.Tensor:
    """Physical-mode scene simulation -> (M, int(duration*fs)): the
    geometry and paths of the reference, rendered at a static power-of-two
    length from a conservative host-side delay budget: through K3, or for
    ``absorption_mode='per-bin'`` in plain PyTorch (``render_scene``)."""
    if absorption_mode not in ("carrier", "per-bin"):
        raise ValueError("absorption_mode must be 'carrier' or 'per-bin'")
    per_bin = absorption_mode == "per-bin"
    if per_bin:
        _check_per_bin_coefficients(freq_table, _ids(plane_material_ids), fs)
    dt = dtype if dtype is not None else torch.get_default_dtype()
    paths, _, slopes = _scene_geometry(
        source_pos, mic_positions, c, freq, plane_coeffs, plane_material_ids,
        absorption_table, freq_table, max_reflections, absorption_threshold,
        dt, device, per_bin)
    base = sig_ops.generate_signal(
        signal_type, fs, duration,
        torch.as_tensor(freq, dtype=dt, device=device), generator=generator,
        dtype=dt, device=device)
    plane_np = (np.zeros((0, 4)) if plane_coeffs is None
                else np.asarray(plane_coeffs, float).reshape(-1, 4))
    budget = static_delay_budget(np.asarray(source_pos), mic_positions,
                                 plane_np, max_reflections, fs)
    out_samples = int(duration * fs)
    total_samples = out_samples + int(np.ceil(budget * fs))
    return render_scene(base, paths.delays, paths.gains, fs, total_samples,
                        out_samples, pad_mode="pow2", finalize=True,
                        freq_slopes=slopes)


def _moving_margins(start_pos, velocity, mic_positions, fs: float, c: float,
                    duration: float, frame: int):
    """(budget, lead) of the moving render, in samples, on the host: the
    longest propagation delay over the capture padded by one second of
    travel either side (|p(t) - mic| is convex in t, so its maximum is at
    an end), and the lead/tail margin ``frame + budget`` that the WOLA sum
    needs to reach its steady state with the delay absorbed."""
    if frame < 64 or frame % 2:
        raise ValueError("frame must be an even length >= 64")
    s0 = np.asarray(start_pos, float)
    v0 = np.asarray(velocity, float)
    mics = np.asarray(mic_positions, float)
    d_ends = [np.linalg.norm(s0 + tt * v0 - mics, axis=-1)
              for tt in (-1.0, float(duration) + 1.0)]
    budget = int(np.ceil(float(np.max(d_ends)) / float(c) * fs)) + 2
    lead = frame + budget
    if lead > int(fs):
        raise ValueError("scene too distant for the moving render: the "
                         "propagation delay budget exceeds 1 s")
    return budget, lead


def _moving_base(signal_type: str, freq, fs: float, duration: float,
                 lead: int, generator: Optional[torch.Generator], dtype,
                 device) -> torch.Tensor:
    """The moving render's base signal, ``duration`` plus both margins
    long (the JAX package's ``_base_signal``, models/simulator.py:262
    there)."""
    return sig_ops.generate_signal(
        signal_type, fs, duration + 2.0 * lead / fs,
        torch.as_tensor(freq, dtype=dtype, device=device),
        generator=generator, dtype=dtype, device=device)


def _render_moving(base: torch.Tensor, start_pos, velocity, mic_positions,
                   fs: float, c: float, frame: int, budget: int, lead: int,
                   freq, absorption: float, freq_slope: float
                   ) -> torch.Tensor:
    """WOLA render of ``base`` (the margins included) -> (M, len(base) -
    2 * lead): periodic-Hann frames every frame / 2, each delayed and
    scaled per mic at the source's position at the frame's centre (all
    frames in one ``delay_and_sum`` over a scene axis), overlap-added,
    divided by the window sum and trimmed to the steady-state interior."""
    dt, dev = base.dtype, base.device
    hop = frame // 2
    start = torch.as_tensor(np.asarray(start_pos), dtype=dt, device=dev)
    vel = torch.as_tensor(np.asarray(velocity), dtype=dt, device=dev)
    mics = torch.as_tensor(np.asarray(mic_positions), dtype=dt, device=dev)
    t_gen = base.shape[-1]
    t_out = t_gen - 2 * lead
    num_frames = max(1, -(-t_gen // hop))
    pad_base = torch.nn.functional.pad(base,
                                       (0, num_frames * hop + frame - t_gen))
    # Periodic Hann: at 50 % overlap the interior window sum is exactly 1.
    n_idx = torch.arange(frame, dtype=dt, device=dev)
    win = 0.5 * (1.0 - torch.cos(2.0 * np.pi * n_idx / frame))
    frames = pad_base.unfold(-1, frame, hop)[:num_frames] * win  # (K, frame)
    # The source at each frame's centre (the generated time starts
    # ``lead`` samples before the first output sample).
    starts = np.arange(num_frames) * hop
    t_c = torch.as_tensor((starts + frame / 2.0 - lead) / fs, dtype=dt,
                          device=dev)
    pos_k = start[None, :] + t_c[:, None] * vel[None, :]          # (K, 3)
    d_k = torch.linalg.norm(pos_k[:, None, :] - mics[None, :, :],
                            dim=-1)                               # (K, M)
    la = acoustics.log_attenuation(
        d_k, AIR_ID, torch.as_tensor(freq, dtype=dt, device=dev),
        torch.as_tensor([absorption], dtype=dt, device=dev),
        torch.as_tensor([freq_slope], dtype=dt, device=dev))
    gains = torch.exp(la - torch.amax(la))
    total = frame + budget
    rendered = delay_and_sum(
        torch.nn.functional.pad(frames, (0, total - frame)),
        (d_k / c)[..., None], gains[..., None], fs,
        pad_mode="pow2-circular")                                 # (K, M, T)
    m = mics.shape[0]
    t_full = int(starts[-1]) + total
    out = torch.nn.functional.fold(
        rendered.permute(1, 2, 0).reshape(1, m * total, num_frames),
        (1, t_full), (1, total), stride=(1, hop))[0, :, 0]       # (M, T)
    wsum = torch.nn.functional.fold(
        win[None, :, None].expand(1, frame, num_frames),
        (1, t_full - total + frame), (1, frame), stride=(1, hop))[0, 0, 0]
    return (out[:, lead:lead + t_out]
            / torch.clamp(wsum[lead:lead + t_out], min=1e-3))


def simulate_moving_source(start_pos, velocity, mic_positions, fs: float,
                           c: float, duration: float = 1.0,
                           signal_type: str = "noise", freq: float = 1000.0,
                           frame: int = 1024,
                           generator: Optional[torch.Generator] = None,
                           snr_db=None, finalize: bool = True,
                           absorption: float = 0.01,
                           freq_slope: float = 1e-6, dtype=None,
                           device=None) -> torch.Tensor:
    """(M, int(duration * fs)) mic signals of a source moving at constant
    ``velocity`` from ``start_pos`` (its position at the first output
    sample), the JAX package's ``simulate_moving_source``
    (models/simulator.py:341 there): the WOLA render of ``_render_moving``
    with frames of ``frame`` samples, direct path only, per-mic gains by
    the carrier-frequency log-attenuation law with physical air defaults
    (``absorption`` per metre, ``freq_slope`` per Hz and metre), referenced
    to the strongest (mic, frame); then per-mic normalize and compression
    (``finalize``) and white noise at ``snr_db`` from ``generator``.  The
    stochastic signal types draw the base from ``generator`` too.  Runs on
    ``device`` (``utils.device.resolve_device``: the card unless named)."""
    dev = resolve_device(device)
    dt = dtype if dtype is not None else torch.get_default_dtype()
    budget, lead = _moving_margins(start_pos, velocity, mic_positions, fs,
                                   c, duration, frame)
    if snr_db is not None and generator is None:
        raise ValueError("snr_db requires a torch.Generator")
    base = _moving_base(signal_type, freq, fs, duration, lead, generator,
                        dt, dev)
    out = _render_moving(base, start_pos, velocity, mic_positions, fs, c,
                         frame, budget, lead, freq, absorption, freq_slope)
    if finalize:
        out = sig_ops.dynamic_range_compression(sig_ops.normalize_signal(out))
    if snr_db is not None:
        rms = torch.sqrt(torch.mean(out * out, -1, keepdim=True))
        sigma = rms * 10.0 ** (-torch.as_tensor(snr_db, dtype=dt,
                                                device=dev) / 20.0)
        out = out + sigma * torch.randn(out.shape, generator=generator,
                                        dtype=dt, device=dev)
    return out
