"""Training losses of the port (counterparts of dl_speech_enhancement_tpu/losses)."""

from dl_speech_enhancement_tpu_torch.losses.adversarial_loss import (
    DiscriminatorAdversarialLoss,
    GeneratorAdversarialLoss,
)
from dl_speech_enhancement_tpu_torch.losses.feat_match_loss import FeatureMatchLoss
from dl_speech_enhancement_tpu_torch.losses.mel_loss import MultiMelSpectrogramLoss
from dl_speech_enhancement_tpu_torch.losses.metrics import (
    mean_absolute_error,
    scale_invariant_sdr,
    signal_noise_ratio,
)
from dl_speech_enhancement_tpu_torch.losses.stft_loss import MultiResolutionSTFTLoss
from dl_speech_enhancement_tpu_torch.losses.waveform_loss import MultiWindowShapeLoss
