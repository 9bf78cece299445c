"""Multi-stream HiFiGAN vocoder receiver, the counterpart of
dl_speech_enhancement_tpu/ops/vocoder_stacked.py::make_stacked_vocoder (K5).

On the TPU, K5 stacks B streams along the rows of one region and packs the
pipeline's stages into kernels under a VMEM budget, reusing K3b's machinery
(ops/mega_stacked.py::_assemble), because Mosaic's limits ruled out a (B,
time, C) layout there. On Hopper each layer of the receiver is one launch
over all B streams already, so K5 is the batch axis of the receiver's
builder, ops/vocoder_kernel.py::make_stacked_vocoder, which this module
re-exports under the JAX package's module path.

Not carried over: ``vmem_budget`` (VMEM segment packing; a launch here is
one layer whatever the budget) and ``boundary_dtype`` (bf16 activations
between segments, which ROADMAP.md queues as bf16 activations at launch
boundaries for the codec and the vocoder alike).
"""

from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import make_stacked_vocoder

__all__ = ["make_stacked_vocoder"]
