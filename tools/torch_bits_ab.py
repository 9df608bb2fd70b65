"""Which kernel outputs of the port computed other float32 bits than
another tree's (a parent commit's checkout) on the same inputs.

    python tools/torch_bits_ab.py OTHER_TREE [THIS_TREE]

Needs an NVIDIA card.  For each tree in turn (its own process, its
kernels built from its own ``csrc/`` at first use) every wrapper at
chip_smoke.py's phase-3 lengths from 2^16 to 2^27 runs on inputs made
from one seed on the card: K4a (``fft_real``), K4b
(``bootstrap_peaks``), K6 (``noise_bootstrap_peaks``), K9
(``whitened_corr``), K1 (``gcc_all_pairs``), K2 (``gcc_windowed``), K3
(``delay_sum``), K5 (``scene_windowed``) and K7 (``whiten``).  Each
output's bits go into a fingerprint (two int64 sums over its float32
words, computed on the card), and its largest distance from its plain
twin, the tree's own, is kept.  Then one line a case: "same" where the
fingerprints agree, "moved" where they differ, with both trees' errors
against the twin.  ``--worker TREE OUT`` is one tree's half, written to
OUT as JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 30
# (kernel, rows or draws, samples, nfft): K4a's one and two rows, K4b's
# and K6's draws, K9's row pairs.
K4A = [(1, 44100, 1 << 16), (2, 44100, 1 << 16), (1, 44100, 1 << 17),
       (1, 200000, 1 << 18), (2, 1046019, 1 << 21), (1, 1046019, 1 << 21),
       (1, 2000000, 1 << 22), (1, 4200000, 1 << 23), (2, 4200000, 1 << 23),
       (1, 8400000, 1 << 24), (2, 8400000, 1 << 24),
       (1, 16800000, 1 << 25), (2, 16800000, 1 << 25),
       (1, 67000000, 1 << 27)]
BOOT = [(1000, 44100, 1 << 16), (64, 1046019, 1 << 21),
        (3, 4200000, 1 << 23), (3, 8400000, 1 << 24),
        (3, 16800000, 1 << 25), (3, 67000000, 1 << 27)]
CORR = [(1, 44100, 1 << 16), (1, 1046019, 1 << 21), (1, 8400000, 1 << 24),
        (1, 16800000, 1 << 25), (1, 33000000, 1 << 26),
        (1, 67000000, 1 << 27)]
# K1 (scenes, mics, samples, nfft); K3, K2 and K5 (mics, padded length,
# samples, nfft) of the fast path's one scene.
GCC = [(1, 4, 44100, 1 << 16), (1, 4, 1046019, 1 << 21),
       (1, 4, 8400000, 1 << 24), (1, 4, 16800000, 1 << 25),
       (1, 4, 67000000, 1 << 27)]
SCENES = [(4, 900000, 800000, 1 << 20), (4, 6200000, 6000000, 1 << 23),
          (4, 12400000, 12000000, 1 << 24), (4, 24800000, 24000000, 1 << 25),
          (4, 99200000, 96000000, 1 << 27)]


def fingerprint(torch, t):
    """Two int64 sums over t's float32 words (the second weighted by a
    multiplicative hash of the word's index), as a string."""
    bits = t.contiguous().view(torch.int32).reshape(-1).to(torch.int64)
    idx = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64)
    weight = (idx * 2654435761) % 2147483647 + 1
    return f"{int(bits.sum())}:{int((bits * weight).sum())}"


def worker(tree: str, out: str) -> None:
    sys.path.insert(0, tree)
    import torch
    from pyaudiolocalization_tpu_torch.ops import cuda_fft as cf
    from pyaudiolocalization_tpu_torch.ops.delay import fade_window
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    res = {}

    def case(name, call, twin, view=lambda v: v):
        got = view(call())
        want = view(twin())
        res[name] = {"bits": fingerprint(torch, got),
                     "err": float((got - want).abs().max())}
        print(f"{name}: {res[name]['err']:.3e}", flush=True)
        del got, want
        torch.cuda.empty_cache()

    def pairs(m):
        p = [(i, j) for i in range(m) for j in range(i + 1, m)]
        return [a for a, _ in p], [b for _, b in p]

    for rows, n, nfft in K4A:
        x = torch.randn((rows, n), generator=gen, device=dev)
        case(f"K4a {rows} x {n} -> {nfft}", lambda: cf.fft_real(x, nfft),
             lambda: cf.fft_real_plain(x, nfft))
    del x
    for rows, n, nfft in BOOT:
        sig = torch.randn((1, n), generator=gen, device=dev)
        s1 = cf.fft_real_plain(sig, nfft)[0].contiguous()
        perm = torch.stack([torch.randperm(n, generator=gen, device=dev)
                            for _ in range(min(rows, 8))])
        x = sig[0][perm[torch.arange(rows, device=dev) % len(perm)]]
        case(f"K4b {rows} x {n} -> {nfft}",
             lambda: cf.bootstrap_peaks(s1, x, nfft),
             lambda: cf.bootstrap_peaks_plain(s1, x, nfft))
        del x
        seeds = torch.randint(-2 ** 31, 2 ** 31, (rows, 2), generator=gen,
                              dtype=torch.int32, device=dev)
        case(f"K6 {rows} x {n} -> {nfft}",
             lambda: cf.noise_bootstrap_peaks(s1, seeds, n, nfft),
             lambda: cf.noise_bootstrap_peaks_plain(s1, seeds, n, nfft))
        del sig, s1
    for rows, n, nfft in CORR:
        spec = cf.fft_real_plain(torch.randn((2 * rows, n), generator=gen,
                                             device=dev), nfft)
        a, b = spec[:rows].contiguous(), spec[rows:].contiguous()
        del spec
        mask = cf.band_mask(nfft, None, None, device=dev)
        case(f"K9 {rows} pair x {n} -> {nfft}",
             lambda: cf.whitened_corr(a, b, mask, nfft),
             lambda: cf.whitened_corr_plain(a, b, mask, nfft))
        del a, b
    z = torch.randn((4, 44100), generator=gen, device=dev).to(
        torch.complex64) * (1 + 1j)
    case("K7 4 x 44100", lambda: cf.whiten(z), lambda: cf.whiten_plain(z),
         torch.view_as_real)
    for scenes, m, n, nfft in GCC:
        sig = torch.randn((scenes, m, n), generator=gen, device=dev)
        pi, pj = pairs(m)
        mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=dev)
        case(f"K1 {scenes} x {m} mics x {n} -> {nfft}",
             lambda: cf.gcc_all_pairs(sig, pi, pj, nfft, mask),
             lambda: cf.gcc_all_pairs_plain(sig, pi, pj, nfft, mask))
        del sig
    for m, total, n, nfft in SCENES:
        base = torch.zeros((1, total), device=dev)
        base[:, :n] = torch.randn((1, n), generator=gen, device=dev)
        tau = (torch.rand((1, m, 1), generator=gen, device=dev)
               * (total - n)).contiguous()
        gains = torch.ones((1, m, 1), device=dev)
        snr = 20.0 + 20.0 * torch.rand(1, generator=gen, device=dev)
        seeds = torch.randint(-2 ** 31, 2 ** 31, (1, 2), generator=gen,
                              dtype=torch.int32, device=dev)
        fade = fade_window(total, dtype=torch.float32,
                           device=dev)[:n].contiguous()
        pi, pj = pairs(m)
        mask = cf.band_mask(nfft, (300.0, 3400.0), 44100.0, device=dev)
        render = (base, tau, gains, nfft, n, fade, True, snr, seeds)
        fused = (base, tau, gains, pi, pj, nfft, n, 21, fade, mask, snr,
                 seeds)
        tag = f"1 x {m} mics x {n} -> {nfft}"
        case(f"K3 {tag}", lambda: cf.delay_sum(*render),
             lambda: cf.delay_sum_plain(*render))
        sigs = cf.delay_sum_plain(*render)
        case(f"K2 {tag}", lambda: cf.gcc_windowed(sigs, pi, pj, nfft, 21,
                                                  mask)[0],
             lambda: cf.gcc_windowed_plain(sigs, pi, pj, nfft, 21, mask)[0])
        del sigs
        case(f"K5 {tag}", lambda: cf.scene_windowed(*fused)[0],
             lambda: cf.scene_windowed_plain(*fused)[0])
        del base
    Path(out).write_text(json.dumps(res))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in
             (sys.argv[1], sys.argv[2] if len(sys.argv) == 3 else REPO)]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            out = Path(tmp) / f"{i}.json"
            proc = subprocess.run([sys.executable, __file__, "--worker", tree,
                                   str(out)], cwd=tree)
            if proc.returncode:
                print(f"torch_bits_ab: {tree} failed ({proc.returncode})",
                      file=sys.stderr)
                return 1
            runs.append(json.loads(out.read_text()))
    other, this = runs
    moved = 0
    print(f"case: bits; max |kernel - twin| in {trees[0]}, in {trees[1]}")
    for name, r in this.items():
        o = other.get(name)
        if o is None:
            print(f"{name}: only in {trees[1]}")
            continue
        same = o["bits"] == r["bits"]
        moved += not same
        print(f"{name}: {'same' if same else 'moved'}; {o['err']:.3e}, "
              f"{r['err']:.3e}")
    print(f"{moved} of {len(this)} outputs moved")
    return 0


if __name__ == "__main__":
    sys.exit(main())
