"""Multi-stream whole-model streaming, the counterpart of
dl_speech_enhancement_tpu/ops/mega_stacked.py::make_mega_stream_stacked (K3b).

On the TPU, K3b stacks B streams along the rows of one (B * ctx, lanes)
region and packs the pipeline's stages into kernels under a VMEM budget,
because K3a's (B, time, C) layout did not compile past B = 4 there. Both
designs work around VMEM and Mosaic. On Hopper one batch-axis design covers
both: each layer is one launch over all B streams (ops/mega_kernel.py::
make_mega_stream_batched), so this module builds exactly that, with the same
math and API as K3a.

Not carried over: ``vmem_budget`` (VMEM segment packing; a launch here is
one layer whatever the budget) and ``boundary_dtype`` (bf16 activations
between segments, which ROADMAP.md queues as bf16 activations at launch
boundaries).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.ops.mega_kernel import make_mega_stream_batched


def make_mega_stream_stacked(gen, chunk: int, batch: int, weight_dtype=torch.bfloat16,
                             vq_state=None):
    """``(init_cache, run)`` for ``batch`` streams, as
    :func:`~dl_speech_enhancement_tpu_torch.ops.mega_kernel.make_mega_stream_batched`:
    ``init_cache() -> {name: (B, ctx, C)}``, ``run(cache, frames (N, B,
    chunk)) -> (out (N, B, chunk), new_cache)``, and with PQC (pass
    ``vq_state``) also ``codes (N, B, chunk / hop, L)`` int32."""
    return make_mega_stream_batched(gen, chunk, batch, weight_dtype, vq_state)
