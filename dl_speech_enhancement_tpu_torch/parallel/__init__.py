"""Serving many streams at once, on one device or split over several, and
long audio in parallel chunks. Data-parallel training is ROADMAP.md §1
"Parallel"."""

from dl_speech_enhancement_tpu_torch.parallel.long_audio import (
    parallel_denoise,
    parallel_forward,
)
from dl_speech_enhancement_tpu_torch.parallel.mesh import make_mesh
from dl_speech_enhancement_tpu_torch.parallel.serve import make_sharded_stream

__all__ = ["make_mesh", "make_sharded_stream", "parallel_denoise", "parallel_forward"]
