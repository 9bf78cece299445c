from dl_speech_enhancement_tpu_torch.models.autoencoder import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANGenerator

__all__ = ["AudioDecGenerator", "HiFiGANGenerator"]
