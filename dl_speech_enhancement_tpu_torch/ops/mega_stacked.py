"""Multi-stream whole-model streaming, the counterpart of
dl_speech_enhancement_tpu/ops/mega_stacked.py::make_mega_stream_stacked (K3b).

On the TPU, K3b stacks B streams along the rows of one (B * ctx, lanes)
region and packs the pipeline's stages into kernels under a VMEM budget,
because K3a's (B, time, C) layout did not compile past B = 4 there. Both
designs work around VMEM and Mosaic. On Hopper one batch-axis design covers
both: each layer is one launch over all B streams (ops/mega_kernel.py::
make_mega_stream_batched), so this module builds exactly that, with the same
math and API as K3a.

``boundary_dtype`` is the dtype of the dense activations between segments
(JAX ``_assemble``, ops/mega_stacked.py:173-180). Here every layer is its own
launch, so "between segments" is "between launches": the JAX kernel with
``vmem_budget=1``, every stage its own segment. With bf16 each kernel loads
and stores its activations in bf16 itself and computes in f32; the int32
wire codes, the final audio and the caches stay as they are. The rounding
points differ from JAX's stages in two places: a residual chain is one
launch (JAX rounds after each of its three units), and the PQC projector's z
and the lookup's zq cross a launch (JAX keeps them inside its stage).

Not carried over: ``vmem_budget`` (VMEM segment packing; a launch here is
one layer whatever the budget).
"""

from __future__ import annotations

import torch

from dl_speech_enhancement_tpu_torch.ops.mega_kernel import make_mega_stream_batched


def make_mega_stream_stacked(gen, chunk: int, batch: int, weight_dtype=torch.bfloat16,
                             vq_state=None, boundary_dtype=torch.float32):
    """``(init_cache, run)`` for ``batch`` streams, as
    :func:`~dl_speech_enhancement_tpu_torch.ops.mega_kernel.make_mega_stream_batched`:
    ``init_cache() -> {name: (B, ctx, C)}``, ``run(cache, frames (N, B,
    chunk)) -> (out (N, B, chunk), new_cache)``, and with PQC (pass
    ``vq_state``) also ``codes (N, B, chunk / hop, L)`` int32.
    ``boundary_dtype`` (float32 or bfloat16) is the activations' dtype
    between launches."""
    return make_mega_stream_batched(gen, chunk, batch, weight_dtype, vq_state, boundary_dtype)
