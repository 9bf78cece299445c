"""Offline analysis (the reference's sandbox.py and mel_spectrogram.py).

Counterpart of dl_speech_enhancement_tpu/cli/analyze.py. Model mode mixes
one clean / noise pair at an SNR, runs it through a checkpoint's offline
forward on the device, writes the wavs and prints the metric battery (STOI
/ ESTOI / SI-SDR / SDR / SNR / Mel-L1, sandbox.py:101-115); ``--eval-wavs``
scores saved wavs against ``--clean`` instead:

    python -m dl_speech_enhancement_tpu_torch.cli.analyze \\
        --checkpoint job_out/<task>checkpoint-<steps> --without-pqc \\
        --clean clean1.wav --noise noise1.wav --snr 15 [--plots] [--device cpu]
    python -m dl_speech_enhancement_tpu_torch.cli.analyze --clean clean.wav \\
        --eval-wavs a.wav b.wav

``--plots`` saves spectrogram and waveform plots (sandbox.py:194-252); it
needs matplotlib, which nothing else of the port does.
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.data import add_noise, load_audio, read_wav, write_wav
from dl_speech_enhancement_tpu_torch.eval.metrics import (
    mel_l1,
    scale_invariant_sdr,
    sdr,
    signal_noise_ratio,
    stoi,
)
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint
from dl_speech_enhancement_tpu_torch.utils.device import resolve_device

# decimals each metric is printed with, as the JAX package rounds them
DIGITS = {"STOI": 4, "ESTOI": 4, "SI-SDR": 3, "SDR": 3, "SNR": 3, "Mel-L1": 4}


def metric_battery(pred: np.ndarray, clean: np.ndarray, sr: int, device="cuda") -> dict:
    """The battery of ``pred`` against ``clean`` (1-D): STOI, ESTOI and SDR
    in float64 numpy, SI-SDR, SNR and Mel-L1 in float32 torch on ``device``
    (the card unless ``"cpu"`` is given)."""
    device = resolve_device(device)
    p = torch.as_tensor(np.asarray(pred, np.float32).reshape(1, -1), device=device)
    c = torch.as_tensor(np.asarray(clean, np.float32).reshape(1, -1), device=device)
    return {
        "STOI": stoi(clean, pred, sr),
        "ESTOI": stoi(clean, pred, sr, extended=True),
        "SI-SDR": float(scale_invariant_sdr(p, c)),
        "SDR": sdr(pred, clean),
        "SNR": float(signal_noise_ratio(p, c)),
        "Mel-L1": mel_l1(p, c, sr),
    }


def rounded(battery: dict) -> dict:
    """A battery to the decimals the CLI prints (the JAX package's)."""
    return {k: round(v, DIGITS[k]) for k, v in battery.items()}


def save_plots(out_dir: str, sr: int, signals: dict) -> str:
    """Waveform and log-mel of each signal into ``out_dir/analysis.png``.
    Raises ImportError where matplotlib is absent."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--plots needs matplotlib, which is not installed; the metric "
                          "battery runs without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from dl_speech_enhancement_tpu_torch.dsp.mel import MelSpectrogram

    mel = MelSpectrogram(fs=sr, fft_size=2048, hop_size=300, num_mels=80, fmin=0,
                         fmax=sr // 2, log_base=None, backend="eager", device="cpu")
    os.makedirs(out_dir, exist_ok=True)
    fig, axes = plt.subplots(len(signals), 2, figsize=(12, 3 * len(signals)))
    if len(signals) == 1:
        axes = axes[None, :]
    for row, (name, x) in enumerate(signals.items()):
        axes[row, 0].plot(np.arange(len(x)) / sr, x, linewidth=0.3)
        axes[row, 0].set_title(f"{name} waveform")
        m = mel(torch.as_tensor(np.asarray(x, np.float32).reshape(1, -1)))[0].numpy().T
        axes[row, 1].imshow(m, origin="lower", aspect="auto")
        axes[row, 1].set_title(f"{name} log-mel")
    fig.tight_layout()
    path = os.path.join(out_dir, "analysis.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def eval_wavs(clean_path: str, wav_paths: list, sr: int | None = None,
              plots_dir: str | None = None, device="cuda") -> dict:
    """The battery of saved wavs against a clean reference (the reference's
    mel_spectrogram.py workflow), each cut to the shorter of the two, on
    ``device`` (the card unless ``"cpu"`` is given)."""
    device = resolve_device(device)
    sr = sr or read_wav(clean_path)[1]
    clean = load_audio(clean_path, sr)[:, 0]
    results, signals = {}, {"clean": clean}
    for path in wav_paths:
        x = load_audio(path, sr)[:, 0]
        t = min(len(x), len(clean))
        results[path] = metric_battery(x[:t], clean[:t], sr, device)
        signals[os.path.basename(path)] = x[:t]
    if plots_dir:
        save_plots(plots_dir, sr, signals)
    return results


def main(argv=None) -> dict:
    parser = ArgumentParser()
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--without-pqc", action="store_true")
    parser.add_argument("--clean", required=True)
    parser.add_argument("--noise", default=None)
    parser.add_argument("--eval-wavs", nargs="*", default=None,
                        help="score saved wavs against --clean instead of running a model "
                             "(mel_spectrogram.py mode)")
    parser.add_argument("--snr", type=float, default=15.0)
    parser.add_argument("--out-dir", default="analysis_out")
    parser.add_argument("--plots", action="store_true", help="needs matplotlib")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (the card, the default) or 'cpu' (the plain modules)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.eval_wavs is not None:
        results = {path: rounded(b) for path, b in eval_wavs(
            args.clean, args.eval_wavs, plots_dir=args.out_dir if args.plots else None,
            device=device).items()}
        print(json.dumps(results, indent=2))
        return results
    if not (args.checkpoint and args.noise):
        raise SystemExit("model mode needs --checkpoint and --noise")

    gen, vq_state, config = load_generator_from_checkpoint(
        args.checkpoint, use_pqc=not args.without_pqc, device=device)
    sr = config.get("sampling_rate", config.get("sample_rate", 48000))
    clean = load_audio(args.clean, sr)[:, :1]
    noise = load_audio(args.noise, sr)[:, :1]
    t = (min(len(clean), len(noise)) // gen.hop) * gen.hop
    clean, noise = clean[:t], noise[:t]
    mixed = add_noise(clean, noise, args.snr)  # float64, scored as it is
    x = torch.as_tensor(np.asarray(mixed[None], np.float32), device=device)
    with torch.no_grad():
        pred = gen(x, vq_state, train=False)[0][0].cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for name, x in (("clean", clean), ("mixed", mixed), ("denoised", pred)):
        write_wav(os.path.join(args.out_dir, f"{name}.wav"), x[:, 0], sr)
    results = {
        "mixed_vs_clean": rounded(metric_battery(mixed[:, 0], clean[:, 0], sr, device)),
        "denoised_vs_clean": rounded(metric_battery(pred[:, 0], clean[:, 0], sr, device)),
    }
    print(json.dumps(results, indent=2))
    if args.plots:
        print("plots:", save_plots(args.out_dir, sr, {
            "clean": clean[:, 0], "mixed": mixed[:, 0], "denoised": pred[:, 0]}))
    return results


if __name__ == "__main__":
    main()
