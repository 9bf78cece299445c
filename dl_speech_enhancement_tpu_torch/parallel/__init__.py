"""Serving many streams at once, on one device or split over several, long
audio in parallel chunks, data-parallel training over ``torch.distributed``
ranks and time-sharded (sequence-parallel) training."""

from dl_speech_enhancement_tpu_torch.parallel.long_audio import (
    parallel_denoise,
    parallel_forward,
)
from dl_speech_enhancement_tpu_torch.parallel.mesh import (
    device_mesh,
    launch,
    make_mesh,
    mesh_from_config,
    replicate,
    shard_batch,
    shard_train_state,
)
from dl_speech_enhancement_tpu_torch.parallel.serve import make_sharded_stream
from dl_speech_enhancement_tpu_torch.parallel.time_shard import (
    make_time_sharded_steps,
    time_sharded_forward,
)

__all__ = ["device_mesh", "launch", "make_mesh", "make_sharded_stream", "make_time_sharded_steps",
           "mesh_from_config", "parallel_denoise", "parallel_forward", "replicate",
           "shard_batch", "shard_train_state", "time_sharded_forward"]
