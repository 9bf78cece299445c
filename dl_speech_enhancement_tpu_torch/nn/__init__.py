from dl_speech_enhancement_tpu_torch.nn.conv import (
    CausalConv1d,
    CausalConvTranspose1d,
    Conv1d,
    Conv1d1x1,
    Conv2d,
    ConvTranspose1d,
)
from dl_speech_enhancement_tpu_torch.nn.vq import (
    Quantizer,
    ResidualVQ,
    VectorQuantizeEMA,
    VQState,
)

__all__ = ["Conv1d", "Conv1d1x1", "Conv2d", "CausalConv1d", "ConvTranspose1d",
           "CausalConvTranspose1d", "VQState", "VectorQuantizeEMA", "ResidualVQ",
           "Quantizer"]
