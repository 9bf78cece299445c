"""Serving many streams at once. Sharding over several cards is ROADMAP.md
§1 "Parallel"."""

from dl_speech_enhancement_tpu_torch.parallel.serve import make_sharded_stream

__all__ = ["make_sharded_stream"]
