"""Host-side data pipeline of the port: wav I/O, datasets, collaters,
loaders and the course's noise mixing."""

from dl_speech_enhancement_tpu_torch.data.audio_io import (
    load_audio,
    read_wav,
    resample,
    write_wav,
)
from dl_speech_enhancement_tpu_torch.data.collate import CollaterAudio, CollaterAudioPair
from dl_speech_enhancement_tpu_torch.data.dataset import (
    AudioDataset,
    MultiDataset,
    SingleDataset,
    find_files,
    random_split,
)
from dl_speech_enhancement_tpu_torch.data.loader import (
    DataLoader,
    create_dataloader,
    get_dataloaders,
)
from dl_speech_enhancement_tpu_torch.data.mixing import add_noise, noise_dropout
