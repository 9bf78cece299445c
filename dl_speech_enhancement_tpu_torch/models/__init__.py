from dl_speech_enhancement_tpu_torch.models.autoencoder import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANDiscriminator, HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.models.univnet import UnivNetDiscriminator

__all__ = ["AudioDecGenerator", "HiFiGANGenerator", "HiFiGANDiscriminator",
           "UnivNetDiscriminator"]
