"""The kernels' bf16-activation arms on the card (the streams' boundary dtype,
ops/mega_stacked.py).

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false and
run on a machine with an H100:

    python -m pytest --noconftest tests/test_torch_port_cuda_boundary.py -q

Each arm widens its bf16 input to f32 as it loads it, computes as the f32
arm does and rounds what it stores, so:

- on the same bf16-valued input, the bf16 arm's output equals the f32 arm's
  output rounded to bf16 bit for bit (the same f32 sums, one rounding);
- against its plain version (the same rounding with ``.to(torch.bfloat16)``)
  it is within the f32 arm's tolerance plus one bf16 step of the value
  (2^-7 of its magnitude: where the f32 sums differ by their last bits, a
  value at a rounding boundary may round either way);
- the wire codes of the residual-VQ search on bf16 z are the plain search's
  on the same z, up to near ties (``utils/checks.py::rvq_near_ties``);
- the whole-model streams at bf16 boundaries launch the same kernels as at
  f32, keep f32 caches, f32 audio and int32 codes.
"""

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
    make_mega_stream_batched,
    rvq_assign,
    rvq_assign_plain,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    residual_chain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    hifigan_unit,
    hifigan_unit_plain,
)
from dl_speech_enhancement_tpu_torch.utils.checks import rvq_near_ties

pytestmark = pytest.mark.cuda
ATOL = 1e-4
CHAIN_ATOL = 2e-6
BF16 = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(*shape, generator=gen, device="cuda") * 0.3


def _tail_view(gen, batch, rows, channels):
    """A (B, rows, C) cache whose streams lie 5 rows further apart."""
    return _randn(gen, batch, rows + 5, channels)[:, 5:]


def _held(got, ref, atol):
    """``got`` (bf16) against the plain version's ``ref``: within ``atol``
    plus one bf16 step of the value."""
    assert got.dtype == ref.dtype
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + 2.0 ** -7 * ref.float().abs()).all()), float(err.max())


@pytest.mark.parametrize("wd", [torch.float32, BF16])
@pytest.mark.parametrize("batch,channels,rows", [(1, 32, 333), (3, 64, 100), (16, 256, 20)])
def test_residual_chain_bf16_arm(card, batch, channels, rows, wd):
    cache = _tail_view(card, batch, 78, channels)
    x = _randn(card, batch, rows, channels).to(BF16)
    w1 = (_randn(card, 3, 7, channels, channels) / (7 * channels) ** 0.5).to(wd)
    w2 = (_randn(card, 3, channels, channels) / channels ** 0.5).to(wd)
    got = residual_chain(cache, x, w1, w2)
    assert got.dtype == BF16
    assert torch.equal(got, residual_chain(cache, x.float(), w1, w2).to(BF16))
    _held(got, residual_chain_plain(cache, x, w1, w2), CHAIN_ATOL)


# (Cin, Cout, k, stride, rows): the input conv (cin1), a downsample and the
# projector (gemm), the output conv (cout1)
CONV_SITES = [(1, 32, 7, 1, 1200), (64, 128, 8, 4, 400), (512, 64, 3, 1, 4),
              (32, 1, 7, 1, 1200)]


@pytest.mark.parametrize("wd", [torch.float32, BF16])
@pytest.mark.parametrize("x_dtype,out_dtype", [(BF16, BF16), (torch.float32, BF16),
                                               (BF16, torch.float32)])
@pytest.mark.parametrize("cin,cout,k,stride,rows", CONV_SITES)
def test_causal_conv_bf16_arms(card, cin, cout, k, stride, rows, x_dtype, out_dtype, wd):
    if cin > 1 and cout > 1 and x_dtype == BF16 and out_dtype == torch.float32:
        with pytest.raises(ValueError, match="GEMM arm"):
            causal_conv(_tail_view(card, 2, k - 1, cin), _randn(card, 2, rows, cin).to(BF16),
                        _randn(card, k, cin, cout).to(wd), out_dtype=torch.float32)
        return
    cache = _tail_view(card, 2, k - 1, cin)
    x = _randn(card, 2, rows, cin).to(x_dtype)
    w = (_randn(card, k, cin, cout) / (k * cin) ** 0.5).to(wd)
    b = _randn(card, cout)
    got = causal_conv(cache, x, w, b, stride, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    f32 = causal_conv(cache, x.float(), w, b, stride)
    assert torch.equal(got, f32.to(out_dtype))
    _held(got, causal_conv_plain(cache, x, w, b, stride, out_dtype=out_dtype), ATOL)


@pytest.mark.parametrize("wd", [torch.float32, BF16])
@pytest.mark.parametrize("cin,cout,stride,rows", [(512, 256, 5, 4), (128, 64, 4, 100),
                                                  (64, 32, 3, 400)])
def test_causal_conv_transpose_bf16_arm(card, cin, cout, stride, rows, wd):
    cache, x = _tail_view(card, 3, 1, cin), _randn(card, 3, rows, cin).to(BF16)
    w = (_randn(card, 2 * stride, cin, cout) / cin ** 0.5).to(wd)
    b = _randn(card, cout)
    got = causal_conv_transpose(cache, x, w, b, stride, leaky=0.1)
    assert got.dtype == BF16
    assert torch.equal(got, causal_conv_transpose(cache, x.float(), w, b, stride,
                                                  leaky=0.1).to(BF16))
    _held(got, causal_conv_transpose_plain(cache, x, w, b, stride, leaky=0.1), ATOL)


@pytest.mark.parametrize("wd", [torch.float32, BF16])
@pytest.mark.parametrize("acc", [False, True])
@pytest.mark.parametrize("rows,c,groups,tiled", [(20, 256, 2, False), (20, 256, 2, True),
                                                 (300, 64, 1, False)])
def test_hifigan_unit_bf16_arm(card, rows, c, groups, tiled, acc, wd):
    batch, k, dilation = 2, 3, 3
    cin = c if tiled else groups * c
    cache1 = _tail_view(card, batch, (k - 1) * dilation, cin)
    cache2 = _tail_view(card, batch, k - 1, groups * c)
    x = _randn(card, batch, rows, cin).to(BF16)
    w1 = (_randn(card, k, c, groups * c) / (k * c) ** 0.5).to(wd)
    w2 = (_randn(card, k, c, groups * c) / (k * c) ** 0.5).to(wd)
    b1, b2 = _randn(card, groups * c), _randn(card, groups * c)
    total = _randn(card, batch, rows, groups * c).to(BF16) if acc else None
    scale = 1.0 / 3 if acc else 1.0
    got, new2 = hifigan_unit(cache1, cache2, x, w1, b1, w2, b2, dilation, groups, 0.1, total,
                             scale)
    assert got.dtype == BF16 and new2.dtype == torch.float32
    f32, f32_2 = hifigan_unit(cache1, cache2, x.float(), w1, b1, w2, b2, dilation, groups, 0.1,
                              None if total is None else total.float(), scale)
    assert torch.equal(got, f32.to(BF16)) and torch.equal(new2, f32_2)
    ref, ref2 = hifigan_unit_plain(cache1, cache2, x, w1, b1, w2, b2, dilation, groups, 0.1,
                                   total, scale)
    _held(got, ref, ATOL)
    assert float((new2 - ref2).abs().max()) <= ATOL


@pytest.mark.parametrize("rows", [4, 64, 1600])
def test_rvq_assign_bf16_z(card, rows):
    n_books, dim, book_k = 8, 64, 1024
    books = torch.randn(n_books, dim, book_k, generator=card, device="cuda")
    sqnorm = (books * books).sum(1).contiguous()
    books_t = books.transpose(1, 2).contiguous()
    z = (torch.randn(rows, dim, generator=card, device="cuda") * 2).to(BF16)
    got = rvq_assign(z, books, sqnorm, books_t)
    assert got.dtype == torch.int32
    assert torch.equal(got, rvq_assign(z.float(), books, sqnorm, books_t))
    ref = rvq_assign_plain(z, books, sqnorm)
    assert rvq_near_ties(z.float(), books, sqnorm, got, ref)["mismatches"] == 0


def test_codebook_lookup_bf16_out(card):
    n_books, dim, book_k, rows = 8, 64, 1024, 640
    books_t = torch.randn(n_books, book_k, dim, generator=card, device="cuda")
    codes = (torch.randint(0, book_k, (rows, n_books), generator=card, device="cuda")
             + torch.arange(n_books, device="cuda") * book_k).to(torch.int32)
    got = codebook_lookup(codes, books_t, out_dtype=BF16)
    assert got.dtype == BF16
    assert torch.equal(got, codebook_lookup(codes, books_t).to(BF16))
    assert torch.equal(got, codebook_lookup_plain(codes, books_t, BF16))


@pytest.mark.parametrize("use_pqc", [False, True])
def test_stream_at_bf16_boundaries(card, use_pqc):
    """The small codec at bf16 boundaries: the same 18 (22) launches a
    dispatch, f32 audio and caches, int32 codes, within 5e-2 of the largest
    sample of the f32 stream (the JAX package's bound)."""
    gen = AudioDecGenerator(use_pqc=use_pqc, seed=0, device="cuda", input_channels=1,
                            output_channels=1, encode_channels=8, decode_channels=8,
                            code_dim=32, codebook_num=3, codebook_size=64, bias=True,
                            enc_ratios=(2, 4), dec_ratios=(4, 2), enc_strides=(3, 4),
                            dec_strides=(4, 3))
    vq = gen.quantizer.init(seed=0, device="cuda") if use_pqc else None
    chunk, batch = gen.hop * 2, 3
    frames = _randn(card, 4, batch, chunk)
    outs = {}
    for bd in (torch.float32, BF16):
        init, run = make_mega_stream_batched(gen, chunk, batch, torch.float32, vq, bd)
        out, cache, *codes = run(init(), frames)
        assert out.dtype == torch.float32
        assert all(t.dtype == torch.float32 for t in cache.values())
        assert all(c.dtype == torch.int32 for c in codes)
        outs[bd] = out
    scale = float(outs[torch.float32].abs().max())
    assert float((outs[BF16] - outs[torch.float32]).abs().max()) <= 0.05 * scale
