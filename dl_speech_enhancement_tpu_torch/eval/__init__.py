"""Evaluation of the port: the metric battery, the ONNX interpreter and
DNSMOS."""

from dl_speech_enhancement_tpu_torch.eval.dnsmos import ComputeScore
from dl_speech_enhancement_tpu_torch.eval.metrics import (
    mean_absolute_error,
    mel_l1,
    scale_invariant_sdr,
    sdr,
    si_sdr_best_lag,
    signal_noise_ratio,
    stoi,
)
