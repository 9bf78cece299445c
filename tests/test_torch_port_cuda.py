"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (the
CPU test runs) and run on a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerance: atol 1e-4, the same products summed in another order in f32.
The residual-VQ search is held to its plain version's codes up to near ties
(``utils/checks.py::rvq_near_ties``: distances within 1e-5 of the
smallest); the codebook lookup sums the same codewords in the same order,
atol 1e-6. chip_smoke.py makes the same checks at the flagship's shapes.
"""

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv,
    causal_conv_plain,
    causal_conv_transpose,
    causal_conv_transpose_plain,
    codebook_lookup,
    codebook_lookup_plain,
    rvq_assign,
    rvq_assign_plain,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    residual_chain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.stream.runtime import make_scan_stream
from dl_speech_enhancement_tpu_torch.utils.checks import rvq_near_ties

pytestmark = pytest.mark.cuda
ATOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda") * 0.3


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,rows", [(8, 5), (32, 333), (48, 100), (256, 40)])
def test_residual_chain_kernel(card, channels, rows, wd):
    cache, x = _randn(card, 78, channels), _randn(card, rows, channels)
    w1 = (_randn(card, 3, 7, channels, channels) / channels ** 0.5).to(wd)
    w2 = (_randn(card, 3, channels, channels) / channels ** 0.5).to(wd)
    before = residual_chain.launches
    got = residual_chain(cache, x, w1, w2)
    assert residual_chain.launches == before + 1
    ref = residual_chain_plain(cache, x, w1, w2)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= ATOL


@pytest.mark.parametrize("cin,cout,k,stride,dilation,bias", [
    (1, 32, 7, 1, 1, False), (32, 64, 6, 3, 1, True), (20, 70, 10, 5, 1, True),
    (32, 1, 7, 1, 1, False), (16, 16, 7, 1, 9, False),
])
def test_causal_conv_kernel(card, cin, cout, k, stride, dilation, bias):
    cache, x = _randn(card, (k - 1) * dilation, cin), _randn(card, stride * 77, cin)
    w = _randn(card, k, cin, cout)
    b = _randn(card, cout) if bias else None
    got = causal_conv(cache, x, w, b, stride, dilation)
    ref = causal_conv_plain(cache, x, w, b, stride, dilation)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= ATOL


@pytest.mark.parametrize("cin,cout,stride", [(64, 32, 3), (100, 36, 4), (512, 256, 5)])
def test_causal_conv_transpose_kernel(card, cin, cout, stride):
    cache, x = _randn(card, 1, cin), _randn(card, 37, cin)
    w, b = _randn(card, 2 * stride, cin, cout) / cin ** 0.5, _randn(card, cout)
    got = causal_conv_transpose(cache, x, w, b, stride)
    ref = causal_conv_transpose_plain(cache, x, w, b, stride)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= ATOL


def test_cuda_route_matches_eager_on_the_card(card):
    gen = AudioDecGenerator(encode_channels=8, decode_channels=8, enc_ratios=(2, 4),
                            dec_ratios=(4, 2), enc_strides=(3, 4), dec_strides=(4, 3),
                            use_pqc=False, device="cuda")
    frames = _randn(card, 6, 1, 120, 1)
    ref_run = make_scan_stream(gen, backend="eager")
    ref, _ = ref_run(ref_run.init_cache(), frames)
    for backend, kw in (("auto", {"weight_dtype": torch.float32}), ("cuda_chain", {})):
        run = make_scan_stream(gen, backend=backend, frame_size=120, **kw)
        first, cache = run(run.init_cache(), frames[:2])
        second, _ = run(cache, frames[2:])
        torch.cuda.synchronize()
        got = torch.cat([first, second])
        assert float((got - ref).abs().max()) <= 2e-5, backend
    assert np.isfinite(ref.cpu().numpy()).all()


@pytest.mark.parametrize("rows,dim,book_k,n_books", [
    (1, 64, 1024, 8), (4, 64, 1024, 8), (400, 64, 1024, 8), (1601, 64, 1024, 8),
    (37, 16, 32, 3), (9, 20, 1000, 2),
])
def test_rvq_assign_kernel(card, rows, dim, book_k, n_books):
    books = torch.randn(n_books, dim, book_k, generator=card, device="cuda")
    sqnorm = (books * books).sum(1)
    z = _randn(card, rows, dim) * 4
    before = rvq_assign.launches
    got = rvq_assign(z, books, sqnorm)
    assert rvq_assign.launches == before + 1
    ref = rvq_assign_plain(z, books, sqnorm)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert rvq_near_ties(z, books, sqnorm, got, ref)["mismatches"] == 0


def test_codebook_lookup_kernel(card):
    n_books, book_k, dim = 8, 1024, 64
    books_t = torch.randn(n_books, book_k, dim, generator=card, device="cuda")
    codes = (torch.randint(0, book_k, (400, n_books), generator=card, device="cuda")
             + torch.arange(n_books, device="cuda") * book_k).to(torch.int32)
    got = codebook_lookup(codes, books_t)
    ref = codebook_lookup_plain(codes, books_t)
    assert float((got - ref).abs().max()) <= 1e-6
    codes[3, 2] = 1  # book 2's range starts at 2048
    with pytest.raises(ValueError, match="outside its book"):
        codebook_lookup(codes, books_t)


def test_pqc_cuda_route_matches_eager_on_the_card(card):
    gen = AudioDecGenerator(encode_channels=8, decode_channels=8, code_dim=16,
                            codebook_num=3, codebook_size=32, enc_ratios=(2, 4),
                            dec_ratios=(4, 2), enc_strides=(3, 4), dec_strides=(4, 3),
                            device="cuda")
    vq = gen.quantizer.init(seed=0, device="cuda")
    frames = _randn(card, 6, 1, 120, 1)
    eager = make_scan_stream(gen, vq, backend="eager")
    ref, _, ref_codes = eager.run_with_codes(eager.init_cache(), frames)
    run = make_scan_stream(gen, vq, frame_size=120, weight_dtype=torch.float32)
    assert run.backend == "cuda"
    first, cache, c1 = run.run_with_codes(run.init_cache(), frames[:2])
    second, _, c2 = run.run_with_codes(cache, frames[2:])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([c1, c2]), ref_codes)
    assert float((torch.cat([first, second]) - ref).abs().max()) <= 2e-5
    # no frame_size: 'auto' takes the kernel route on the card, which raises
    with pytest.raises(ValueError, match="no frame_size given"):
        make_scan_stream(gen, vq)
