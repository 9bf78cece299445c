"""Host-side data helpers of the port."""

from dl_speech_enhancement_tpu_torch.data.audio_io import (
    load_audio,
    read_wav,
    resample,
    write_wav,
)
