"""Multi-stream HiFiGAN vocoder receiver, the counterpart of
dl_speech_enhancement_tpu/ops/vocoder_stacked.py::make_stacked_vocoder (K5).

On the TPU, K5 stacks B streams along the rows of one region and packs the
pipeline's stages into kernels under a VMEM budget, reusing K3b's machinery
(ops/mega_stacked.py::_assemble), because Mosaic's limits ruled out a (B,
time, C) layout there. On Hopper each layer of the receiver is one launch
over all B streams already, so K5 is the batch axis of the receiver's
builder, ops/vocoder_kernel.py::make_stacked_vocoder, which this module
re-exports under the JAX package's module path. Its ``boundary_dtype`` (JAX
:120, passed to ``_assemble`` at :434) is the dtype of the activations
between launches, as in ops/mega_stacked.py: with bf16 the kernels load and
store them in bf16 themselves (the units' running sum too), the codes and
the audio stay as they are.

Not carried over: ``vmem_budget`` (VMEM segment packing; a launch here is
one layer whatever the budget).
"""

from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import make_stacked_vocoder

__all__ = ["make_stacked_vocoder"]
