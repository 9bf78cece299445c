"""Without-PQC AudioDec facade (reference utils/audiodec_without_PQC.py).

Counterpart of dl_speech_enhancement_tpu/utils/audiodec_without_pqc.py: the
denoiser variant of the codec facade, projector and quantizer removed, raw
encoder features crossing tx -> rx (audiodec_without_PQC.py:85-92). Thin
aliases over utils.audiodec with ``use_pqc=False``.
"""

from __future__ import annotations

from dl_speech_enhancement_tpu_torch.utils.audiodec import AudioDec as _AudioDec
from dl_speech_enhancement_tpu_torch.utils.audiodec import load_generator_from_checkpoint


class AudioDec(_AudioDec):
    def __init__(self, checkpoint: str, batch: int = 1, device="cuda"):
        super().__init__(checkpoint, use_pqc=False, batch=batch, device=device)


def load_without_pqc(checkpoint: str, device="cuda"):
    """(gen, None, config) for a without-PQC checkpoint."""
    return load_generator_from_checkpoint(checkpoint, use_pqc=False, device=device)
