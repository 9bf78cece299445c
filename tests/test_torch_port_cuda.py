"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: they skip where ``torch.cuda.is_available()`` is false (the
CPU test runs) and run on a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -q

Tolerance: atol 1e-4, the same products summed in another order in f32.
The layer kernels are also run on B streams at once, with a cache that is a
strided view (the tail of a longer activation, as on the main path): each
stream must match the plain version, and perturbing stream 0 must leave
every other stream's output bit for bit as it was.
The HiFiGAN unit kernel and the activated boundary convs (LeakyReLU on
load, tanh out) are held the same way, at the v1 receiver's widths and at
small ones, with caches at a stream stride, and the unit's next conv2 cache
too. The residual-VQ search is held to its plain version's codes up to near ties
(``utils/checks.py::rvq_near_ties``: distances within 1e-5 of the
smallest); the codebook lookup sums the same codewords in the same order,
atol 1e-6. The DFT kernels (K6 log-mel, K7 STFT magnitude) are held to
their plain versions (the same two f32 matmuls, summed in another order over
up to 2048 terms): log-mel atol 1e-4, magnitudes 1e-5 of the largest, the
autograd.Functions' gradients (the JAX package's analytic VJP) against
autograd through the plain versions 1e-5 of the largest; two calls, and a
batch against its examples' own calls, are equal bit for bit. The unit's
accumulate epilogue (the MultiReceptiveField arm) is held at the v0
receiver's widths, and passes a unit's output through bit for bit without a
running sum; the codec endpoints' kernel routes equal their plain modules;
K1f (the residual_chain kernel behind the folded chain's
contract) equals K1 bit for bit; T1's fold_copy equals numpy's reshape
exactly; ``cli.stream.main --model vctk_v0`` runs on the card from a small
checkpoint tree. The unit kernel is also held at every cluster size its
planner can pick (each equal bit for bit to the planned run), its
shared-memory formula against the Python one the planner uses, and one
stream's output alone, among 16 streams (another plan) and across two
runs, bit for bit. causal_conv_transpose (each phase on causal_conv's GEMM
arm) likewise: every plan its planner can pick equal bit for bit, one
stream's bits independent of the batch, its shared-memory formula the
library's; causal_conv's outputs at the codec's and the v1 receiver's sites
hash to the digest of the kernel before the GEMM arm moved into
csrc/conv_gemm.cuh. codebook_lookup returns while the card is still busy
(it waits for nothing), and a bad code raises at the documented point: a
direct call at ``check_codes`` or the next call after a synchronisation, an
endpoint at once for codes from the host and at its next ``decode`` for
codes on the card. The residual chain kernel is held at every chain site
of the paths within CHAIN_ATOL (2e-6: its split-TF32 products, emulated in
tests/test_torch_port_chain_plan.py); with bf16 weights, where the chain
and the unit round intermediate sums to bf16 as the reference does and two
sum orders may round one step apart, also on exact-sum weights at the same
tolerance, and on dense weights by utils/checks.py::rounding_held
(_bf16_held); every plan of a site equal bit for bit, its
shared-memory and scratch formulas against the library's, and its SASS for
tensor-core products (bf16 HMMA with bf16 weights, TF32 with f32; the
unit's too). The course's and the symADuniv config's
discriminators at their widths equal their CPU twins (every map within 1e-4
of its largest), and one adversarial course step on the kernel route (K6)
equals its plain route (fragments rtol 1e-5, every gradient of both
networks 1e-4 of its largest). chip_smoke.py makes the same checks at
the flagship's shapes.
"""

import hashlib
import os
import re
import subprocess
import time

import numpy as np
import pytest
import torch

from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    causal_conv,
    causal_conv_plain,
    causal_conv_transpose,
    causal_conv_transpose_plain,
    check_codes,
    codebook_lookup,
    codebook_lookup_plain,
    rvq_assign,
    rvq_assign_plain,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    _chain_plan,
    fused_residual_chain,
    fused_residual_chain_folded,
    fused_residual_chain_folded_plain,
    residual_chain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.dsp.mel import MelSpectrogram
from dl_speech_enhancement_tpu_torch.losses import (
    MultiMelSpectrogramLoss,
    MultiResolutionSTFTLoss,
)
from dl_speech_enhancement_tpu_torch.models.autoencoder import ResidualUnit
from dl_speech_enhancement_tpu_torch.models.hifigan import HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.ops import _cuda, mega_kernel, mel_kernel, stream_kernel
from dl_speech_enhancement_tpu_torch.ops import vocoder_kernel
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    _unit_plan,
    hifigan_unit,
    hifigan_unit_plain,
    unit_smem_bytes,
)
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    StreamingReceiver,
    StreamingTransmitter,
    VocoderReceiver,
    make_scan_stream,
    make_vocoder_scan_stream,
)
from dl_speech_enhancement_tpu_torch.tools import reshape_probe
from dl_speech_enhancement_tpu_torch.train.denoise_course import make_course_steps
from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer
from dl_speech_enhancement_tpu_torch.utils.checks import (
    ROUNDING_GAP,
    exact_sum_weights,
    rounding_held,
    rvq_near_ties,
)
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_discriminator

pytestmark = pytest.mark.cuda
ATOL = 1e-4


def _held(fn, plain, args, weights, limit_of, got, ref, pick=lambda out: out, no_taps=()):
    """A chain or unit output ``got`` against its plain version ``ref`` on
    ``args``, whose weights lie at the positions ``weights`` (those in
    ``no_taps`` without a tap axis): within ``limit_of(ref)`` with f32
    weights. With bf16 weights, where the kernel rounds intermediate sums
    (utils/checks.py), ``got`` holds ``ref`` by rounding_held, and the
    kernel on exact-sum weights holds its plain version within
    ``limit_of``, with the plain version on unrounded operands at least
    ROUNDING_GAP times that away."""
    if args[weights[0]].dtype == torch.float32:
        assert float((got - ref).abs().max()) <= limit_of(ref)
        return

    def swap(a, make):
        return tuple(make(i, t) if i in weights else t for i, t in enumerate(a))

    held = rounding_held(got, ref, pick(plain(*swap(args, lambda i, w: w.float()))))
    assert held["held"], held
    exact = swap(args, lambda i, w: exact_sum_weights(w[:, None], i)[:, 0] if i in no_taps
                 else exact_sum_weights(w, i))
    got, ref = pick(fn(*exact)), pick(plain(*exact))
    loose = pick(plain(*swap(exact, lambda i, w: w.float())))
    torch.cuda.synchronize()
    limit = limit_of(ref)
    assert float((got - ref).abs().max()) <= limit
    assert float((loose - ref).abs().max()) >= ROUNDING_GAP * limit


def _chain_held(args, limit, got, ref):
    """_held for residual_chain(cache, x, w1, w2) within ``limit``."""
    _held(residual_chain, residual_chain_plain, args, (2, 3), lambda r: limit, got, ref,
          no_taps=(3,))


def _unit_held(args, got, ref):
    """_held for hifigan_unit's output within ATOL (f32 weights) or 1e-4 of
    the largest (bf16)."""
    _held(hifigan_unit, hifigan_unit_plain, args, (3, 5),
          lambda r: ATOL if args[3].dtype == torch.float32 else 1e-4 * float(r.abs().max()),
          got, ref, lambda out: out[0])


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
    _chain_held((cache, x, w1, w2), ATOL, got, ref)


# (C, rows a frame) of the eight chains of a denoiser / codec dispatch
# (e0ch-e3ch; d0ch-d3ch mirror them)
CHAIN_SITES = [(32, 1200), (64, 400), (128, 100), (256, 20)]
CHAIN_ATOL = 2e-6  # split-TF32 products at O(1) activations (test_torch_port_chain_plan.py)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,frames", [(1, 1), (1, 16), (16, 1)])
@pytest.mark.parametrize("channels,rows", CHAIN_SITES)
def test_residual_chain_kernel_at_every_chain_site(card, channels, rows, batch, frames, wd):
    """Every chain site of the paths at one stream of 1 and 16 frames and 16
    streams of one, each cache a strided view: within CHAIN_ATOL of the
    plain version (with bf16 weights, _held's two checks)."""
    cache = _tail_view(card, batch, 78, channels)
    x = _randn(card, batch, rows * frames, channels)
    w1 = (_randn(card, 3, 7, channels, channels) / (7 * channels) ** 0.5).to(wd)
    w2 = (_randn(card, 3, channels, channels) / channels ** 0.5).to(wd)
    got = residual_chain(cache, x, w1, w2)
    ref = residual_chain_plain(cache, x, w1, w2)
    torch.cuda.synchronize()
    _chain_held((cache, x, w1, w2), CHAIN_ATOL, got, ref)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,rows", CHAIN_SITES)
def test_residual_chain_every_plan_gives_the_same_bits(card, monkeypatch, channels, rows, wd):
    """Every plan the kernel takes at a chain site (each tile with each
    cluster size, ops/stream_kernel.py::chain_plans) gives the bits of the
    planner's plan, at 3 streams of one frame."""
    cache, x = _tail_view(card, 3, 78, channels), _randn(card, 3, rows, channels)
    w1 = (_randn(card, 3, 7, channels, channels) / (7 * channels) ** 0.5).to(wd)
    w2 = (_randn(card, 3, channels, channels) / channels ** 0.5).to(wd)
    planned = residual_chain(cache, x, w1, w2)
    ref = residual_chain_plain(cache, x, w1, w2)
    plans = stream_kernel.chain_plans(rows, channels, (1, 3, 9), wd == torch.bfloat16)
    assert len({cluster for _, cluster, _ in plans}) > 1
    for tile, cluster, _ in plans:
        monkeypatch.setattr(stream_kernel, "_chain_plan", lambda *a, p=(tile, cluster): p)
        got = residual_chain(cache, x, w1, w2)
        torch.cuda.synchronize()
        _chain_held((cache, x, w1, w2), CHAIN_ATOL, got, ref)
        assert torch.equal(got, planned), (tile, cluster)


def test_residual_chain_smem_formula_matches_the_library(card):
    """ops/stream_kernel.py::chain_smem_bytes, which the planner asks, equals
    the library's dse_residual_chain_smem, and chain_scratch_floats, which
    sizes the wrapper's scratch, its dse_residual_chain_scratch."""
    lib = _cuda.load("residual_chain")
    for tile in (1, 4, 20, 97, 384, 1200):
        for c, cluster in ((8, 1), (32, 1), (32, 8), (48, 1), (64, 4), (128, 16), (256, 16),
                           (256, 4)):
            for dilations in ((1, 3, 9), (1, 2, 4)):
                for bf16 in (False, True):
                    assert lib.dse_residual_chain_smem(tile, c, cluster, *dilations,
                                                       int(bf16)) == stream_kernel.\
                        chain_smem_bytes(tile, c, cluster, dilations, bf16)
                    assert lib.dse_residual_chain_scratch(tile, c, cluster, *dilations,
                                                          int(bf16)) == (
                        stream_kernel.chain_scratch_floats(tile, c, dilations, bf16)
                        if cluster > 1 else 0)


def _kernel_sass(name: str, kernel: str) -> dict:
    """``{mangled name: SASS}`` of every instantiation of ``kernel`` in the
    library of ``csrc/<name>.cu``."""
    lib_path = _cuda._lib_path(name)
    _cuda.load(name)
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    return {f.splitlines()[0].strip(): f for f in sass.split("Function : ")[1:]
            if kernel in f.splitlines()[0]}


def _weights_bf16(mangled: str, kernel: str) -> bool:
    """Whether an instantiation's weight type (its first type argument,
    after the int ones) is bf16."""
    return re.search(kernel + r"I(?:Li\d+E)+(13__nv_bfloat16|f)", mangled).group(1) != "f"


def test_residual_chain_runs_on_the_tensor_cores(card):
    """The library's SASS: every residual_chain_kernel instantiation issues
    tensor-core products, bf16 ones with bf16 weights (HMMA.16816.F32.BF16,
    no TF32) and split-TF32 ones with f32 weights (HMMA.1688.F32.TF32)."""
    functions = _kernel_sass("residual_chain", "residual_chain_kernel")
    # 1, 2, 4 and 8 fragments a block, f32 and bf16 weights, f32 and bf16 activations
    assert len(functions) == 16
    bf16 = [f for name, f in functions.items()
            if _weights_bf16(name, "residual_chain_kernel")]
    assert len(bf16) == 8
    for name, f in functions.items():
        if f in bf16:
            assert "HMMA.16816.F32.BF16" in f and "TF32" not in f, name
        else:
            assert "HMMA.1688.F32.TF32" in f, name


def test_hifigan_unit_runs_on_the_tensor_cores(card):
    """As test_residual_chain_runs_on_the_tensor_cores, for every
    hifigan_unit_kernel instantiation (8 tiles, 12 with bf16 weights, whose
    warps may take 4 row fragments; two activation dtypes)."""
    functions = _kernel_sass("hifigan_unit", "hifigan_unit_kernel")
    assert len(functions) == 40
    bf16 = [f for name, f in functions.items() if _weights_bf16(name, "hifigan_unit_kernel")]
    assert len(bf16) == 24
    for name, f in functions.items():
        if f in bf16:
            assert "HMMA.16816.F32.BF16" in f and "TF32" not in f, name
        else:
            assert "HMMA.1688.F32.TF32" in f, name


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k,stride,dilation,bias,rows", [
    (1, 32, 7, 1, 1, False, 77), (32, 64, 6, 3, 1, True, 77), (20, 70, 10, 5, 1, True, 77),
    (32, 1, 7, 1, 1, False, 77), (16, 16, 7, 1, 9, False, 77), (1, 32, 7, 1, 1, True, 1200),
    (1, 30, 5, 2, 3, True, 9), (32, 1, 7, 1, 1, True, 1200), (40, 1, 4, 3, 2, True, 300),
    (256, 512, 10, 5, 1, True, 4), (512, 64, 3, 1, 1, False, 4), (64, 512, 7, 1, 1, True, 4),
    (128, 256, 10, 5, 1, True, 20), (768, 256, 1, 1, 1, False, 20),
])
def test_causal_conv_kernel(card, cin, cout, k, stride, dilation, bias, rows, wd):
    """Every arm (Cin = 1, Cout = 1, the GEMM) at the paths' shapes, the
    deep sites at one frame's few rows (e3d, prj, v_in at 4 rows, e2d at
    20, a 1x1 fuse) and odd widths, against the plain version."""
    cache, x = _randn(card, (k - 1) * dilation, cin), _randn(card, stride * rows, cin)
    w = _randn(card, k, cin, cout).to(wd)
    b = _randn(card, cout) if bias else None
    before = causal_conv.launches
    got = causal_conv(cache, x, w, b, stride, dilation)
    assert causal_conv.launches == before + 1
    ref = causal_conv_plain(cache, x, w, b, stride, dilation)
    torch.cuda.synchronize()
    limit = ATOL if wd == torch.float32 else 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= limit


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
    (1, 64, 1024, 8), (4, 64, 1024, 8), (256, 64, 1024, 8), (400, 64, 1024, 8),
    (1601, 64, 1024, 8), (4096, 64, 1024, 8), (37, 16, 32, 3), (9, 20, 1000, 2),
    (5, 3, 7, 2), (300, 128, 1024, 8), (100, 256, 1024, 8),
])
def test_rvq_assign_kernel(card, rows, dim, book_k, n_books):
    books = torch.randn(n_books, dim, book_k, generator=card, device="cuda")
    sqnorm = (books * books).sum(1)
    books_t = books.transpose(1, 2).contiguous()
    z = _randn(card, rows, dim) * 4
    before = rvq_assign.launches
    got = rvq_assign(z, books, sqnorm, books_t)
    assert rvq_assign.launches == before + 1
    ref = rvq_assign_plain(z, books, sqnorm)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert rvq_near_ties(z, books, sqnorm, got, ref)["mismatches"] == 0


def _rvq_plans(rows, dim, book_k, n_books):
    """The planner's plan at ``rows`` and others the kernel takes: clusters
    of 16 with every book resident or a 3-slot ring, clusters of 8 on a ring
    of 3 or 6, each at the planner's tile and half of it."""
    plan = mega_kernel._rvq_plan(rows, dim, book_k, n_books)
    plans = [plan]
    for cluster, stages in ((16, n_books), (16, 3), (8, 3), (8, 6)):
        for tile in (plan.tile, -(-plan.tile // 2)):
            other = mega_kernel.RvqPlan(cluster, tile, min(
                -(-rows // tile), mega_kernel._rvq_max_clusters(cluster)), stages)
            if (other not in plans and mega_kernel.rvq_smem_bytes(
                    tile, dim, book_k, cluster, stages) <= 232448
                    and mega_kernel.rvq_block_threads(tile, book_k, cluster)[0] <= 512):
                plans.append(other)
    return plans


@pytest.mark.parametrize("rows", [4, 64, 400, 1024])
def test_rvq_assign_codes_do_not_depend_on_the_plan(card, monkeypatch, rows):
    """A row's codes are the same bits whatever the plan, the rows beside it
    or their number: every plan of _rvq_plans at ``rows`` rows, and each row
    searched alone and in a batch of 3."""
    books = torch.randn(8, 64, 1024, generator=card, device="cuda") * 0.3
    sqnorm = (books * books).sum(1)
    tables = (books, sqnorm, books.transpose(1, 2).contiguous())
    z = _randn(card, rows, 64) * 4
    planned = rvq_assign(z, *tables)
    for plan in _rvq_plans(rows, 64, 1024, 8):
        monkeypatch.setattr(mega_kernel, "_rvq_plan", lambda *a, p=plan: p)
        assert torch.equal(rvq_assign(z, *tables), planned), plan
    monkeypatch.undo()
    for i in range(0, rows, max(1, rows // 5)):
        assert torch.equal(rvq_assign(z[i:i + 1].contiguous(), *tables), planned[i:i + 1])
        assert torch.equal(rvq_assign(z[i:i + 3].contiguous(), *tables), planned[i:i + 3])
    torch.cuda.synchronize()


def test_rvq_assign_smem_formula_matches_the_library(card):
    """ops/mega_kernel.py::rvq_smem_bytes and rvq_block_threads, which the
    planner asks, equal the library's dse_rvq_assign_smem and
    dse_rvq_assign_threads."""
    lib = _cuda.load("rvq_assign")
    for tile in range(1, 257):
        for book_k, cluster in ((1024, 16), (1024, 8), (32, 8), (1000, 16), (7, 2)):
            if mega_kernel.rvq_groups(book_k, cluster) <= 32:
                assert lib.dse_rvq_assign_threads(tile, book_k, cluster) == \
                    mega_kernel.rvq_block_threads(tile, book_k, cluster)[0]
    for tile in (1, 4, 37, 100, 128, 256):
        for dim, book_k in ((64, 1024), (3, 7), (20, 1000), (128, 1024), (1024, 32)):
            for cluster in (1, 2, 8, 16):
                for stages in (2, 3, 8):
                    assert lib.dse_rvq_assign_smem(tile, dim, book_k, cluster, stages) == \
                        mega_kernel.rvq_smem_bytes(tile, dim, book_k, cluster, stages)


def _books_and_codes(card, rows=400, n_books=8, book_k=1024, dim=64):
    books_t = torch.randn(n_books, book_k, dim, generator=card, device="cuda")
    codes = (torch.randint(0, book_k, (rows, n_books), generator=card, device="cuda")
             + torch.arange(n_books, device="cuda") * book_k).to(torch.int32)
    return books_t, codes


def test_codebook_lookup_kernel(card):
    """Against the plain version; a bad code is never read (its term is
    zero), the call does not raise, and check_codes raises once after a
    synchronisation (so does the next call instead, when nothing checked)."""
    books_t, codes = _books_and_codes(card)
    got = codebook_lookup(codes, books_t)
    ref = codebook_lookup_plain(codes, books_t)
    assert float((got - ref).abs().max()) <= 1e-6
    check_codes()
    bad = codes.clone()
    bad[3, 2] = 1  # book 2's range starts at 2048
    got = codebook_lookup(bad, books_t)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="outside its book"):
        check_codes()
    check_codes()  # reported once
    want = torch.zeros_like(got[3])
    for book in range(8):  # the kernel's order: f32 adds, book after book
        if book != 2:
            want = want + books_t[book, int(codes[3, book]) - book * 1024]
    assert torch.equal(got[3], want)  # the bad term is zero, the others in order
    assert torch.equal(got[4:], codebook_lookup(codes, books_t)[4:])
    codebook_lookup(bad, books_t)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="outside its book"):
        codebook_lookup(codes, books_t)  # the next call reports it
    codebook_lookup(codes, books_t)
    torch.cuda.synchronize()
    check_codes()


def test_codebook_lookup_does_not_wait_for_the_card(card):
    """Enqueued behind a ~1 s sleep of the card, the lookup returns to the
    host while the sleep still runs: no host read, no synchronisation. A bad
    code behind the sleep is reported only once the card has reached it."""
    books_t, codes = _books_and_codes(card)
    codebook_lookup(codes, books_t)
    torch.cuda.synchronize()
    bad = codes.clone()
    bad[0, 0] = 1024
    torch.cuda._sleep(2_000_000_000)
    t0 = time.perf_counter()
    codebook_lookup(bad, books_t)
    host = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    check_codes()  # the card has not reached the bad code yet
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    assert busy and host < 0.05 * total, (host, total)
    with pytest.raises(ValueError, match="outside its book"):
        check_codes()


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


def _held_per_stream(kernel, plain, cache, x, *args):
    """Run ``kernel`` on B streams against ``plain``; then perturb stream 0's
    cache and input and require the other streams' outputs unchanged."""
    got = kernel(cache, x, *args)
    ref = plain(cache, x, *args)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= ATOL
    cache2, x2 = cache.clone(), x.clone()
    cache2[0] += 1.0
    x2[0] -= 1.0
    again = kernel(cache2, x2, *args)
    torch.cuda.synchronize()
    assert not torch.equal(again[0], got[0])
    assert torch.equal(again[1:], got[1:])


def _tail_view(card, batch, rows, channels):
    """A (batch, rows, channels) cache whose streams lie 5 rows further apart
    than its own rows: the tail of a longer activation."""
    return _randn(card, batch, rows + 5, channels)[:, 5:]


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("channels,rows", [(32, 333), (256, 20)])
def test_residual_chain_kernel_batched(card, batch, channels, rows):
    cache, x = _tail_view(card, batch, 78, channels), _randn(card, batch, rows, channels)
    w1 = _randn(card, 3, 7, channels, channels) / channels ** 0.5
    w2 = _randn(card, 3, channels, channels) / channels ** 0.5
    _held_per_stream(residual_chain, residual_chain_plain, cache, x, w1, w2)


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("cin,cout,k,stride", [(1, 32, 7, 1), (256, 512, 10, 5), (32, 1, 7, 1),
                                               (512, 64, 3, 1), (64, 512, 7, 1), (32, 64, 6, 3)])
def test_causal_conv_kernel_batched(card, batch, cin, cout, k, stride):
    cache, x = _tail_view(card, batch, k - 1, cin), _randn(card, batch, stride * 4, cin)
    w, b = _randn(card, k, cin, cout) / cin ** 0.5, _randn(card, cout)
    _held_per_stream(causal_conv, causal_conv_plain, cache, x, w, b, stride)


# (Cin, Cout, taps, stride, output rows a frame): e3d, prj, e2d, e0d, v_in, a
# v1 fuse, the decoder output conv, the input conv
CONV_LAYERS = [(256, 512, 10, 5, 4), (512, 64, 3, 1, 4), (128, 256, 10, 5, 20),
               (32, 64, 6, 3, 400), (64, 512, 7, 1, 4), (384, 128, 1, 1, 100),
               (32, 1, 7, 1, 1200), (1, 32, 7, 1, 1200)]


def _conv_operands(card, batch, cin, cout, k, stride, rows, wd):
    cache = _tail_view(card, batch, k - 1, cin)
    x = _randn(card, batch, stride * rows, cin)
    w = _randn(card, k, cin, cout).to(wd)
    return cache, x, w, _randn(card, cout)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k,stride,rows", CONV_LAYERS)
def test_causal_conv_stream_bits_do_not_depend_on_the_batch(card, cin, cout, k, stride, rows,
                                                            wd):
    """A stream's output bits depend on the layer alone: one stream alone,
    the same stream among 16 (another plan) and its first frame's rows
    within a 16-frame dispatch (another plan again) are equal bit for bit,
    and so are two runs."""
    cache, x, w, b = _conv_operands(card, 16, cin, cout, k, stride, 16 * rows, wd)
    one = stride * rows
    fleet = causal_conv(cache, x[:, :one].contiguous(), w, b, stride)
    again = causal_conv(cache, x[:, :one].contiguous(), w, b, stride)
    long = causal_conv(cache, x, w, b, stride)
    torch.cuda.synchronize()
    assert torch.equal(fleet, again)
    assert torch.equal(long[:, :rows], fleet)
    for s in (0, 9, 15):
        alone = causal_conv(cache[s:s + 1], x[s:s + 1, :one].contiguous(), w, b, stride)
        torch.cuda.synchronize()
        assert torch.equal(alone, fleet[s:s + 1])


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k,stride,rows", CONV_LAYERS)
def test_causal_conv_every_plan_gives_the_same_bits(card, monkeypatch, cin, cout, k, stride,
                                                    rows, wd):
    """Every plan the kernel takes for the layer (each GEMM tile with each
    cluster split of the steps; each Cout = 1 block length) gives the bits
    of the planner's plan, within ATOL of the plain version, at 3 streams."""
    cache, x, w, b = _conv_operands(card, 3, cin, cout, k, stride, rows, wd)
    bf16 = wd == torch.bfloat16
    planned = causal_conv(cache, x, w, b, stride)
    ref = causal_conv_plain(cache, x, w, b, stride)
    limit = ATOL if wd == torch.float32 else 1e-4 * float(ref.abs().max())
    arm = mega_kernel._conv_plan(3, rows, cin, cout, k, stride, 1, bf16)[0]
    if arm == "gemm":
        plans = [("gemm", tile, q)
                 for tile, q, _ in mega_kernel.conv_gemm_plans(cin, cout, k, stride, 1, bf16)]
    elif arm == "cout1":
        plans = [("cout1", r, 1) for r in (1, 7, 32, 100, 256)]
    else:
        plans = [("cin1", 0, 1)]
    assert len(plans) > 1 or arm == "cin1"
    for plan in plans:
        monkeypatch.setattr(mega_kernel, "_conv_plan", lambda *a, p=plan: p)
        got = causal_conv(cache, x, w, b, stride)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= limit, plan
        assert torch.equal(got, planned), plan


def test_causal_conv_smem_formula_matches_the_library(card):
    """ops/mega_kernel.py::conv_smem_bytes, which the planner asks, equals the
    library's dse_causal_conv_smem for every arm, f32 and bf16 x (whose GEMM
    stage counts the side rows of the streams' first rows at T_out)."""
    lib = _cuda.load("causal_conv")
    arms = {name: i for i, name in enumerate(mega_kernel.CONV_ARMS)}
    for cin, cout, taps, stride, dil in ((1, 32, 7, 1, 1), (32, 1, 7, 1, 1), (40, 1, 4, 3, 2),
                                         (256, 512, 10, 5, 1), (512, 64, 3, 1, 1),
                                         (20, 70, 10, 5, 1), (768, 256, 1, 1, 1)):
        for bf16 in (False, True):
            for x_bf16 in (False, True):
                tiles = len(mega_kernel._CONV_TILES if x_bf16 and bf16 else
                            mega_kernel._CONV_TILES[:mega_kernel._CONV_TILES_F32X])
                cases = [("cin1", 0, 1)] + [("cout1", r, 1) for r in (1, 5, 256)] + [
                    ("gemm", tile, q) for tile in range(tiles)
                    for q in (1, 3, len(mega_kernel.conv_chunks(taps, cin)))]
                for t_out in (1, 4, 64, 6400):
                    for arm, tile, q in cases:
                        assert lib.dse_causal_conv_smem(
                            arms[arm], tile, cin, cout, taps, stride, dil, q,
                            int(bf16) | int(x_bf16) << 1, t_out) == mega_kernel.conv_smem_bytes(
                            arm, tile, cin, cout, taps, stride, dil, q, bf16, x_bf16, t_out)


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("cin,cout,stride", [(512, 256, 5), (64, 32, 3)])
def test_causal_conv_transpose_kernel_batched(card, batch, cin, cout, stride):
    cache, x = _tail_view(card, batch, 1, cin), _randn(card, batch, 4, cin)
    w, b = _randn(card, 2 * stride, cin, cout) / cin ** 0.5, _randn(card, cout)
    _held_per_stream(causal_conv_transpose, causal_conv_transpose_plain, cache, x, w, b,
                     stride)


# (Cin, Cout, stride, input rows a stream): d0u-d3u (v0u-v3u) at one frame,
# d0u at 100 frames, and odd widths
UPSAMPLE_LAYERS = [(512, 256, 5, 4), (256, 128, 5, 20), (128, 64, 4, 100), (64, 32, 3, 400),
                   (512, 256, 5, 400), (100, 36, 4, 7), (20, 70, 2, 9)]


def _upsample_operands(card, batch, cin, cout, stride, rows, wd):
    cache = _tail_view(card, batch, 1, cin)
    x = _randn(card, batch, rows, cin)
    w = (_randn(card, 2 * stride, cin, cout) / (2 * cin) ** 0.5).to(wd)
    return cache, x, w, _randn(card, cout)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("cin,cout,stride,rows", UPSAMPLE_LAYERS)
def test_causal_conv_transpose_every_plan_gives_the_same_bits(card, monkeypatch, batch, cin,
                                                              cout, stride, rows, wd):
    """Every plan the GEMM arm can take for the layer's phases (each tile
    with each cluster split of the 2 * Cin terms' chunks) gives the bits of
    the planner's plan, within ATOL of the plain version (1e-4 of the
    largest output with bf16 weights), for one stream and for 3."""
    cache, x, w, b = _upsample_operands(card, batch, cin, cout, stride, rows, wd)
    bf16 = wd == torch.bfloat16
    before = causal_conv_transpose.launches
    planned = causal_conv_transpose(cache, x, w, b, stride)
    assert causal_conv_transpose.launches == before + 1
    ref = causal_conv_transpose_plain(cache, x, w, b, stride)
    limit = ATOL if wd == torch.float32 else 1e-4 * float(ref.abs().max())
    plans = [p[:2] for p in mega_kernel.conv_gemm_plans(cin, cout, 2, 1, 1, bf16)]
    assert mega_kernel._upsample_plan(batch, rows, cin, cout, stride, bf16) in plans
    assert len(plans) > 1
    for plan in plans:
        monkeypatch.setattr(mega_kernel, "_upsample_plan", lambda *a, p=plan: p)
        got = causal_conv_transpose(cache, x, w, b, stride)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= limit, plan
        assert torch.equal(got, planned), plan


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,stride,rows", UPSAMPLE_LAYERS[:4])
def test_causal_conv_transpose_stream_bits_do_not_depend_on_the_batch(card, cin, cout, stride,
                                                                      rows, wd):
    """One stream alone, the same stream among 16 (another plan), its first
    frame within a 16-frame dispatch (another plan again) and two runs are
    equal bit for bit; with the vocoder's LeakyReLU on load too."""
    cache, x, w, b = _upsample_operands(card, 16, cin, cout, stride, 16 * rows, wd)
    for leaky in (None, 0.1):
        fleet = causal_conv_transpose(cache, x[:, :rows].contiguous(), w, b, stride, leaky)
        again = causal_conv_transpose(cache, x[:, :rows].contiguous(), w, b, stride, leaky)
        long = causal_conv_transpose(cache, x, w, b, stride, leaky)
        torch.cuda.synchronize()
        assert torch.equal(fleet, again)
        assert torch.equal(long[:, :rows * stride], fleet)
        for s in (0, 9, 15):
            alone = causal_conv_transpose(cache[s:s + 1], x[s:s + 1, :rows].contiguous(), w, b,
                                          stride, leaky)
            torch.cuda.synchronize()
            assert torch.equal(alone, fleet[s:s + 1])


def test_causal_conv_transpose_smem_formula_matches_the_library(card):
    """The GEMM arm's shared-memory formula at 2 taps
    (ops/mega_kernel.py::conv_smem_bytes), which the upsample planner asks,
    equals the library's dse_causal_conv_transpose_smem."""
    lib = _cuda.load("causal_conv_transpose")
    for cin, cout in ((512, 256), (256, 128), (64, 32), (100, 36), (20, 70)):
        steps = len(mega_kernel.conv_chunks(2, cin))
        for bf16, x_bf16, t_in in ((False, False, 4), (True, False, 4), (False, True, 1),
                                   (True, True, 4), (True, True, 6400)):
            tiles = len(mega_kernel._CONV_TILES if x_bf16 and bf16 else
                        mega_kernel._CONV_TILES[:mega_kernel._CONV_TILES_F32X])
            for tile in range(tiles):
                for q in sorted({1, 3, steps}):
                    assert lib.dse_causal_conv_transpose_smem(
                        tile, cin, cout, q, int(bf16) | int(x_bf16) << 1,
                        t_in) == mega_kernel.conv_smem_bytes(
                        "gemm", tile, cin, cout, 2, 1, 1, q, bf16, x_bf16, t_in)


# (Cin, Cout, taps, stride, output rows a frame, leaky, tanh): every
# causal_conv site of the codec and the v1 receiver (conv_sites)
DIGEST_CONV_SITES = [(1, 32, 7, 1, 1200, None, False), (32, 64, 6, 3, 400, None, False),
                     (64, 128, 8, 4, 100, None, False), (128, 256, 10, 5, 20, None, False),
                     (256, 512, 10, 5, 4, None, False), (512, 64, 3, 1, 4, None, False),
                     (64, 512, 7, 1, 4, None, False), (32, 1, 7, 1, 1200, None, False),
                     (64, 512, 7, 1, 4, None, False), (768, 256, 1, 1, 20, None, False),
                     (384, 128, 1, 1, 100, None, False), (192, 64, 1, 1, 400, None, False),
                     (96, 32, 1, 1, 1200, None, False), (32, 1, 7, 1, 1200, 0.01, True)]
# SHA-256 of causal_conv's outputs at DIGEST_CONV_SITES (_conv_digest), on
# an H100: with f32 weights from the kernel whose GEMM arm was still inside
# csrc/causal_conv.cu (its f32 arm's bits have not changed since); with bf16
# weights from the kernel that rounds its input to bf16 as the reference does
CONV_DIGEST = {torch.float32: "0caae3c9099cbaf6acf70ad88653f1cd7206d4a29f6575af04d410191b3f7df1",
               torch.bfloat16: "1f86b9a555b600a7975e2aff4396f3fd15599be9039eb9ff219c821ae68d6ecd"}


def _conv_digest(wd) -> str:
    """SHA-256 of causal_conv's outputs at every DIGEST_CONV_SITES site with
    ``wd`` weights, for one stream of 1 and 100 frames and 16 streams of 1,
    on inputs drawn with numpy (seed 8)."""
    rng = np.random.default_rng(8)
    digest = hashlib.sha256()

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.3).cuda()

    for batch, frames in ((1, 1), (1, 100), (16, 1)):
        for cin, cout, taps, stride, rows, leaky, tanh in DIGEST_CONV_SITES:
            x = draw(batch, stride * rows * frames, cin)
            cache = draw(batch, taps - 1, cin) if taps > 1 else x[:, :0]  # as a 1x1 fuse's
            w, b = draw(taps, cin, cout) / (taps * cin) ** 0.5, draw(cout)
            y = causal_conv(cache, x, w.to(wd), b, stride, 1, leaky, tanh)
            digest.update(y.cpu().numpy().tobytes())
    return digest.hexdigest()


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_causal_conv_bits_equal_the_kernel_before_the_shared_gemm_arm(card, wd):
    assert _conv_digest(wd) == CONV_DIGEST[wd]


@pytest.mark.parametrize("batch", [4, 16, 64])
@pytest.mark.parametrize("use_pqc", [False, True])
def test_cuda_route_batched_matches_eager_on_the_card(card, batch, use_pqc):
    """B streams through make_scan_stream's 'cuda' route: 2 + 2 per block
    launches per dispatch (10 here, 18 at the flagship's 4 + 4 blocks; 4
    more with PQC), and the eager route's codes up to near ties and audio
    (on the streams whose codes are all equal)."""
    gen = AudioDecGenerator(encode_channels=8, decode_channels=8, code_dim=16,
                            codebook_num=3, codebook_size=32, enc_ratios=(2, 4),
                            dec_ratios=(4, 2), enc_strides=(3, 4), dec_strides=(4, 3),
                            use_pqc=use_pqc, device="cuda")
    vq = gen.quantizer.init(seed=0, device="cuda") if use_pqc else None
    frames = _randn(card, 3, batch, 120, 1)
    eager = make_scan_stream(gen, vq, batch=batch, backend="eager")
    run = make_scan_stream(gen, vq, batch=batch, frame_size=120, weight_dtype=torch.float32)
    assert run.backend == "cuda"
    counters = (residual_chain, causal_conv, causal_conv_transpose, rvq_assign,
                codebook_lookup)
    before = sum(k.launches for k in counters)
    got, _ = run(run.init_cache(), frames)
    torch.cuda.synchronize()
    assert sum(k.launches for k in counters) - before == 10 + 4 * use_pqc
    ref, _ = eager(eager.init_cache(), frames)
    same = torch.ones(batch, dtype=torch.bool, device="cuda")
    if use_pqc:
        _, _, codes = run.run_with_codes(run.init_cache(), frames)
        _, _, ref_codes = eager.run_with_codes(eager.init_cache(), frames)
        cache, zs = gen.init_cache(batch), []
        with torch.no_grad():
            for f in frames:
                z, enc_cache = gen.encode_step(cache, f)
                cache.update(enc_cache)
                zs.append(z)
        books, sqnorm, _ = vq_tables(vq, "cuda")
        held = rvq_near_ties(torch.stack(zs).reshape(-1, 16), books, sqnorm,
                             codes.reshape(-1, 3), ref_codes.reshape(-1, 3))
        assert held["mismatches"] == 0
        same = (codes == ref_codes).flatten(2).all(-1).all(0)
    assert float((got - ref)[:, same].abs().max()) <= 2e-5
    with pytest.raises(ValueError, match="no frame_size given"):
        make_scan_stream(gen, vq, batch=batch)


def test_chain_plan_sees_the_whole_grid(card):
    """On the real-time path's deepest chain (20 rows at C = 256) one stream
    spreads over at least 16 SMs in clusters of more than one block; 16
    streams take at least 64 SMs; at B = 64 the plan stops spreading each
    tile over as many blocks as at B = 1. Each holds its plain version
    (bf16 weights: _held's two checks at CHAIN_ATOL). (The planner is pure
    Python; the kernel takes every plan it gives.)"""
    plans = {b: _chain_plan(b, 20, 256, (1, 3, 9)) for b in (1, 16, 64)}
    tile, cluster = plans[1]
    assert cluster > 1 and -(-20 // tile) * cluster >= 16
    assert 16 * -(-20 // plans[16][0]) * plans[16][1] >= 64
    assert plans[64][1] < plans[1][1]
    cache, x = _tail_view(card, 64, 78, 256), _randn(card, 64, 20, 256)
    w1 = (_randn(card, 3, 7, 256, 256) / (7 * 256) ** 0.5).bfloat16()
    w2 = (_randn(card, 3, 256, 256) / 256 ** 0.5).bfloat16()
    for b in (1, 16, 64):
        got = residual_chain(cache[:b], x[:b], w1, w2)
        ref = residual_chain_plain(cache[:b], x[:b], w1, w2)
        torch.cuda.synchronize()
        _chain_held((cache[:b], x[:b], w1, w2), CHAIN_ATOL, got, ref)


# ---------------------------------------------------------------- vocoder


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("cin,cout,k,leaky,tanh", [
    (64, 512, 7, None, False), (768, 256, 1, None, False), (32, 1, 7, 0.01, True),
    (48, 20, 5, 0.1, False), (16, 1, 7, 0.01, True), (48, 16, 1, None, False),
    (512, 64, 3, 0.1, True), (1, 8, 3, 0.1, True),
])
def test_causal_conv_kernel_activated(card, batch, cin, cout, k, leaky, tanh):
    cache, x = _tail_view(card, batch, k - 1, cin), _randn(card, batch, 40, cin) * 3
    w, b = _randn(card, k, cin, cout) / cin ** 0.5, _randn(card, cout)
    _held_per_stream(lambda c, v: causal_conv(c, v, w, b, 1, 1, leaky, tanh),
                     lambda c, v: causal_conv_plain(c, v, w, b, 1, 1, leaky, tanh), cache, x)


@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("cin,cout,stride", [(512, 256, 5), (64, 32, 3)])
def test_causal_conv_transpose_kernel_activated(card, batch, cin, cout, stride):
    cache, x = _tail_view(card, batch, 1, cin), _randn(card, batch, 4, cin) * 3
    w, b = _randn(card, 2 * stride, cin, cout) / cin ** 0.5, _randn(card, cout)
    _held_per_stream(lambda c, v: causal_conv_transpose(c, v, w, b, stride, 0.1),
                     lambda c, v: causal_conv_transpose_plain(c, v, w, b, stride, 0.1), cache, x)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,rows,c,groups,k,dilation,tiled", [
    (1, 20, 256, 3, 11, 1, True), (1, 20, 256, 3, 11, 5, False), (3, 100, 128, 3, 11, 3, False),
    (16, 25, 64, 3, 11, 5, False), (2, 1200, 32, 3, 11, 1, True), (3, 7, 8, 2, 3, 2, True),
    (2, 33, 16, 1, 7, 3, False), (4, 3, 16, 2, 5, 1, False),
    (1, 20, 256, 1, 3, 1, False), (1, 20, 256, 1, 7, 3, False), (1, 20, 256, 1, 11, 5, False),
    (1, 1200, 32, 1, 11, 5, False),
])
def test_hifigan_unit_kernel(card, batch, rows, c, groups, k, dilation, tiled, wd):
    """Every unit of the v1 receiver's stages and the v0 receiver's
    MultiReceptiveField stage shapes (groups 1, k = 3/7/11 at stage 0, and
    stage 3), and small ones (groups 1, a dispatch shorter than the conv2
    window): output and next conv2 cache against the plain version, caches
    at a stream stride, and no stream reaching another."""
    cin = c if tiled else groups * c
    cache1 = _tail_view(card, batch, (k - 1) * dilation, cin)
    cache2 = _tail_view(card, batch, k - 1, groups * c)
    x = _randn(card, batch, rows, cin) * 3
    w1 = (_randn(card, k, c, groups * c) / (k * c) ** 0.5).to(wd)
    w2 = (_randn(card, k, c, groups * c) / (k * c) ** 0.5).to(wd)
    b1, b2 = _randn(card, groups * c), _randn(card, groups * c)
    before = hifigan_unit.launches
    got, got2 = hifigan_unit(cache1, cache2, x, w1, b1, w2, b2, dilation, groups)
    assert hifigan_unit.launches == before + 1
    ref, ref2 = hifigan_unit_plain(cache1, cache2, x, w1, b1, w2, b2, dilation, groups)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (batch, rows, groups * c)
    limit = ATOL if wd == torch.float32 else 1e-4 * float(ref.abs().max())
    _unit_held((cache1, cache2, x, w1, b1, w2, b2, dilation, groups), got, ref)
    assert float((got2 - ref2).abs().max()) <= limit
    c1, c2, x2 = cache1.clone(), cache2.clone(), x.clone()
    c1[0] += 1.0
    c2[0] -= 1.0
    x2[0] += 1.0
    again, again2 = hifigan_unit(c1, c2, x2, w1, b1, w2, b2, dilation, groups)
    torch.cuda.synchronize()
    assert not torch.equal(again[0], got[0])
    assert torch.equal(again[1:], got[1:]) and torch.equal(again2[1:], got2[1:])


def _unit_operands(card, batch, rows, c, groups, k, dilation, wd=torch.float32):
    cache1 = _tail_view(card, batch, (k - 1) * dilation, groups * c)
    cache2 = _tail_view(card, batch, k - 1, groups * c)
    x = _randn(card, batch, rows, groups * c) * 3
    w1 = (_randn(card, k, c, groups * c) / (k * c) ** 0.5).to(wd)
    w2 = (_randn(card, k, c, groups * c) / (k * c) ** 0.5).to(wd)
    return cache1, cache2, x, w1, _randn(card, groups * c), w2, _randn(card, groups * c)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_hifigan_unit_kernel_every_cluster(card, monkeypatch, cluster, wd):
    """Every cluster size the planner can pick (64 columns a group: 64, 32,
    16 and 8 columns a block), at a short tile and a long one (one and two
    16-row fragments a warp): each within ATOL of the plain version and
    equal bit for bit to the planner's own plan."""
    args = _unit_operands(card, 2, 150, 64, 2, 7, 3, wd)
    ref, ref2 = hifigan_unit_plain(*args, 3, 2, 0.1)
    planned, planned2 = hifigan_unit(*args, 3, 2, 0.1)
    limit = ATOL if wd == torch.float32 else 1e-4 * float(ref.abs().max())
    for tile in (10, 150):
        monkeypatch.setattr(vocoder_kernel, "_unit_plan", lambda *a: (tile, cluster))
        got, got2 = hifigan_unit(*args, 3, 2, 0.1)
        torch.cuda.synchronize()
        _unit_held((*args, 3, 2, 0.1), got, ref)
        assert float((got2 - ref2).abs().max()) <= limit
        assert torch.equal(got, planned) and torch.equal(got2, planned2)


def test_hifigan_unit_smem_formula_matches_the_library(card):
    """ops/vocoder_kernel.py::unit_smem_bytes, which the planner and
    vocoder_topology_error ask, equals the library's dse_hifigan_unit_smem,
    for each weight and activation dtype."""
    lib = _cuda.load("hifigan_unit")
    for tile in (1, 4, 20, 54, 118, 510):
        for c, cluster in ((4, 1), (8, 2), (16, 1), (32, 4), (48, 1), (64, 2), (128, 2),
                           (256, 4), (256, 8)):
            for taps, dilation in ((3, 1), (7, 3), (11, 5)):
                for bf16 in (False, True):
                    for x_bf16 in (False, True):
                        assert lib.dse_hifigan_unit_smem(
                            tile, c, taps, dilation, cluster, int(bf16) | int(x_bf16) << 1
                        ) == unit_smem_bytes(tile, c, taps, dilation, cluster, bf16, x_bf16)


@pytest.mark.parametrize("wd", [torch.float32, torch.bfloat16])
def test_hifigan_unit_stream_bits_do_not_depend_on_the_batch(card, wd):
    """At the v0 receiver's stage 0 (20 rows a stream, c = 256, k = 3) one
    stream alone and the same stream among 16 take different plans (8-row
    and 20-row tiles), yet give the same bits, and so do two runs of
    either."""
    batch, rows, c, k, d = 16, 20, 256, 3, 5
    assert _unit_plan(1, rows, c, 1, k, d, wd == torch.bfloat16) != _unit_plan(
        batch, rows, c, 1, k, d, wd == torch.bfloat16)
    cache1, cache2, x, w1, b1, w2, b2 = _unit_operands(card, batch, rows, c, 1, k, d, wd)
    acc = _randn(card, batch, rows, c)
    fleet = hifigan_unit(cache1, cache2, x, w1, b1, w2, b2, d, 1, 0.1, acc, 1 / 3)
    again = hifigan_unit(cache1, cache2, x, w1, b1, w2, b2, d, 1, 0.1, acc, 1 / 3)
    for b in (0, 7, 15):
        alone = hifigan_unit(cache1[b:b + 1], cache2[b:b + 1], x[b:b + 1].contiguous(), w1, b1,
                             w2, b2, d, 1, 0.1, acc[b:b + 1].contiguous(), 1 / 3)
        twice = hifigan_unit(cache1[b:b + 1], cache2[b:b + 1], x[b:b + 1].contiguous(), w1, b1,
                             w2, b2, d, 1, 0.1, acc[b:b + 1].contiguous(), 1 / 3)
        torch.cuda.synchronize()
        for one, other in ((alone, twice), (alone, (fleet[0][b:b + 1], fleet[1][b:b + 1]))):
            assert torch.equal(one[0], other[0]) and torch.equal(one[1], other[1])
    assert torch.equal(fleet[0], again[0]) and torch.equal(fleet[1], again[1])


@pytest.mark.parametrize("batch,rows,c,k,dilation", [
    (1, 20, 256, 11, 5), (1, 100, 128, 7, 3), (3, 400, 64, 3, 1), (16, 1200, 32, 11, 1),
    (2, 3, 16, 5, 2),
])
def test_hifigan_unit_kernel_accumulates(card, batch, rows, c, k, dilation):
    """The accumulate epilogue at the v0 receiver's MRF sites (groups 1):
    ``(acc + unit) * scale`` against the plain version; without a running
    sum at scale 1 the output equals the unit's bit for bit, as the MGC
    sites call it."""
    cache1 = _tail_view(card, batch, (k - 1) * dilation, c)
    cache2 = _tail_view(card, batch, k - 1, c)
    x, acc = _randn(card, batch, rows, c) * 3, _randn(card, batch, rows, c) * 3
    w1, w2 = ((_randn(card, k, c, c) / (k * c) ** 0.5) for _ in range(2))
    b1, b2 = _randn(card, c), _randn(card, c)
    args = (cache1, cache2, x, w1, b1, w2, b2, dilation, 1)
    for total, scale in ((acc, 1.0), (acc, 1 / 3), (None, 1 / 3)):
        got, got2 = hifigan_unit(*args, 0.1, total, scale)
        ref, ref2 = hifigan_unit_plain(*args, 0.1, total, scale)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= ATOL
        assert float((got2 - ref2).abs().max()) <= ATOL
    unit, unit2 = hifigan_unit(*args)
    zero_sum, _ = hifigan_unit(*args, 0.1, torch.zeros_like(acc), 1.0)
    again, again2 = hifigan_unit(*args, 0.1, None, 1.0)
    torch.cuda.synchronize()
    assert torch.equal(again, unit) and torch.equal(again2, unit2)
    assert torch.equal(zero_sum, unit)


def _mrf_vocoder():
    voc = HiFiGANGenerator(in_channels=16, channels=16, upsample_scales=(4, 3),
                           upsample_kernel_sizes=(8, 6), resblock_kernel_sizes=(3, 5, 7),
                           resblock_dilations=((1, 2),) * 3, groups=1, device="cuda")
    with torch.no_grad():
        for m in voc.modules():
            if isinstance(getattr(m, "g", None), torch.nn.Parameter):
                m.g.fill_(1.0)
    return voc


def test_mrf_vocoder_route_matches_eager_on_the_card(card):
    """K4's MultiReceptiveField arm: make_vocoder_scan_stream's 'auto' route
    (11 + 17 launches a dispatch at this topology: 2 stages of an upsample
    and 3 blocks of 2 units, 12 unit launches; 11 + 43 at the v0 preset) and
    VocoderReceiver at 3 streams against 'eager'."""
    codec, vq, _ = _vocoder_pair()
    voc = _mrf_vocoder()
    frames = _randn(card, 6, 120)
    eager = make_vocoder_scan_stream(codec, vq, voc, 120, backend="eager")
    ref, _ = eager(eager.init_cache(), frames)
    run = make_vocoder_scan_stream(codec, vq, voc, 120, weight_dtype=torch.float32)
    assert run.backend == "cuda"
    before = hifigan_unit.launches
    first, cache = run(run.init_cache(), frames[:2])
    second, _ = run(cache, frames[2:])
    torch.cuda.synchronize()
    assert hifigan_unit.launches - before == 2 * 12
    assert float((torch.cat([first, second]) - ref).abs().max()) <= 2e-5
    assert float(ref.std()) > 1e-3
    codes = (torch.randint(0, 32, (3, 3, 5), generator=card, device="cuda")
             + torch.arange(3, device="cuda")[:, None, None] * 32).to(torch.int32)
    rx = VocoderReceiver(codec, voc, vq, batch=3, weight_dtype=torch.float32)
    want = VocoderReceiver(codec, voc, vq, batch=3, backend="eager").decode(codes)
    assert rx.backend == "cuda"
    assert float((rx.decode(codes) - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("channels,fold", [(32, 1), (32, 2), (32, 3), (64, 2)])
def test_folded_chain_kernel(card, channels, fold):
    """K1f on the card: the residual_chain kernel, equal to K1 bit for bit
    and within ATOL of its folded plain version."""
    units = [ResidualUnit(channels, dilation=d, device="cuda") for d in (1, 3, 9)]
    x = _randn(card, 78 + 240, channels) * 3
    before = residual_chain.launches
    got = fused_residual_chain_folded(units, x, fold)
    assert residual_chain.launches == before + 1
    ref = fused_residual_chain_folded_plain(units, x, fold)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_residual_chain(units, x))
    assert float((got - ref).abs().max()) <= ATOL


@pytest.mark.parametrize("shape,s,mode", reshape_probe.SHAPES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_fold_copy_kernel(card, shape, s, mode):
    """T1: the fold_copy kernel equals numpy's reshape exactly, or refuses
    what numpy refuses, at the JAX probe's six shapes."""
    before = reshape_probe.fold_copy.launches
    res = reshape_probe.probe(shape, s, mode)
    assert res["ok"], res
    launched = reshape_probe.fold_copy.launches - before
    assert launched == (0 if res["result"].startswith("REFUSED") else 1)


@pytest.mark.parametrize("shape,s,mode", [((64, 200), 64, "fold"), ((3, 40000), 8, "unfold"),
                                          ((9, 7), 3, "fold"), ((5, 3), 3, "unfold"),
                                          ((1, 1), 1, "fold")])
def test_fold_copy_kernel_any_group_and_tail(card, shape, s, mode):
    """T1 past the probe's shapes: groups above 8,192 floats (a fold of 64
    rows of 200, an unfold of rows of 40,000) and sizes whose bytes are not a
    multiple of 16 (63, 15 and 1 floats), exact and one launch each."""
    x = _randn(card, *shape)
    before = reshape_probe.fold_copy.launches
    got = reshape_probe.fold_copy(x, s, mode)
    assert reshape_probe.fold_copy.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, x.reshape(reshape_probe.folded_shape(shape, s, mode)))
    assert np.array_equal(got.cpu().numpy(), x.cpu().numpy().reshape(got.shape))


def test_cli_stream_on_the_card(card, tmp_path, monkeypatch):
    """cli.stream.main --model vctk_v0 on the card from a small exp/ tree:
    the receiver runs its kernels ('auto'), every frame comes out, and the
    produced frames equal an 'eager' run of the same CLI within bf16
    weights' rounding."""
    from dl_speech_enhancement_tpu_torch.cli import stream as cli
    from dl_speech_enhancement_tpu_torch.data import read_wav, write_wav
    from dl_speech_enhancement_tpu_torch.train.checkpoint import save_checkpoint

    codec, vq, _ = _vocoder_pair()
    voc = _mrf_vocoder()
    exp = tmp_path / "exp"
    topology = {"encode_channels": 8, "decode_channels": 8, "code_dim": 16,
                "codebook_num": 3, "codebook_size": 32, "enc_ratios": [2, 4],
                "dec_ratios": [4, 2], "enc_strides": [3, 4], "dec_strides": [4, 3]}
    save_checkpoint(str(exp / "autoencoder" / "symAD_vctk_48000_hop300" /
                        "checkpoint-200000steps"),
                    {"params_generator": codec.state_dict(), "vq_state": vq},
                    {"model_type": "symAudioDec", "generator_params": topology})
    vgp = {"in_channels": 16, "channels": 16, "upsample_scales": [4, 3],
           "upsample_kernel_sizes": [8, 6], "resblock_kernel_sizes": [3, 5, 7],
           "resblock_dilations": [[1, 2]] * 3, "groups": 1}
    save_checkpoint(str(exp / "vocoder" / "AudioDec_v0_symAD_vctk_48000_hop300_clean" /
                        "checkpoint-500000steps"),
                    {"params_generator": voc.state_dict()},
                    {"model_type": "HiFiGAN", "train_mode": "vocoder",
                     "generator_params": vgp})
    monkeypatch.chdir(tmp_path)
    write_wav("in.wav", (0.3 * np.random.default_rng(0).standard_normal(24 * 40)), 48000)
    outs = {}
    for backend in ("auto", "eager"):
        before = hifigan_unit.launches, rvq_assign.launches
        stats = cli.main(["--model", "vctk_v0", "-i", "in.wav", "-o", f"{backend}.wav",
                          "--frame-size", "24", "--max-latency", "1000",
                          "--rx-backend", backend])
        assert stats["frames"] == 40 and stats["frame_drops"] == 0
        assert (hifigan_unit.launches > before[0]) == (backend == "auto")
        assert rvq_assign.launches > before[1]  # the transmitter's kernels, either way
        y = read_wav(f"{backend}.wav")[0][:, 0].reshape(-1, 24)
        outs[backend] = y[np.abs(y).max(axis=1) > 0]
        assert len(outs[backend]) == 40
    scale = float(np.abs(outs["eager"]).max())
    assert np.abs(outs["auto"] - outs["eager"]).max() <= 5e-2 * scale + 1.0 / 32768


@pytest.mark.parametrize("batch", [1, 3])
def test_codec_endpoints_kernel_route_on_the_card(card, batch):
    """StreamingTransmitter / StreamingReceiver take the whole-model
    stream's halves on the card ('auto'): priming then four chunks with
    carried caches, codes equal to the plain modules' and audio within
    ATOL at f32 weights."""
    codec, vq, _ = _vocoder_pair()
    tx = StreamingTransmitter(codec, vq, batch)
    rx = StreamingReceiver(codec, vq, batch, weight_dtype=torch.float32)
    assert (tx.backend, rx.backend) == ("cuda", "cuda")
    etx = StreamingTransmitter(codec, vq, batch, backend="eager")
    erx = StreamingReceiver(codec, vq, batch, backend="eager")
    chunks = [torch.zeros((batch, 600, 1), device="cuda")]  # the priming call's length
    chunks += [_randn(card, batch, 24, 1) for _ in range(4)]
    for chunk in chunks:
        before = rvq_assign.launches, codebook_lookup.launches
        idx = tx.encode(chunk)
        assert (rvq_assign.launches, codebook_lookup.launches) == (before[0] + 1, before[1])
        want = etx.encode(chunk)
        assert idx.dtype == torch.int32 and torch.equal(idx, want)
        y = rx.decode(idx)
        assert codebook_lookup.launches == before[1] + 1
        assert float((y - erx.decode(want)).abs().max()) <= ATOL


def _vocoder_pair():
    codec = AudioDecGenerator(encode_channels=8, decode_channels=8, code_dim=16,
                              codebook_num=3, codebook_size=32, enc_ratios=(2, 4),
                              dec_ratios=(4, 2), enc_strides=(3, 4), dec_strides=(4, 3),
                              device="cuda")
    vq = codec.quantizer.init(seed=0, device="cuda")
    voc = HiFiGANGenerator(in_channels=16, channels=16, upsample_scales=(4, 3),
                           upsample_kernel_sizes=(8, 6), resblock_kernel_sizes=(3,),
                           resblock_dilations=((1, 2),), groups=2, device="cuda")
    with torch.no_grad():  # unit gain, so a broken layer shows in the audio
        for m in voc.modules():
            if isinstance(getattr(m, "g", None), torch.nn.Parameter):
                m.g.fill_(1.0)
    return codec, vq, voc


def test_vocoder_route_matches_eager_on_the_card(card):
    """make_vocoder_scan_stream's 'cuda' route (7 + 11 launches per dispatch
    at this topology; 11 + 23 at the v1 preset) against 'eager'."""
    codec, vq, voc = _vocoder_pair()
    frames = _randn(card, 6, 120)
    eager = make_vocoder_scan_stream(codec, vq, voc, 120, backend="eager")
    ref, _ = eager(eager.init_cache(), frames)
    run = make_vocoder_scan_stream(codec, vq, voc, 120, weight_dtype=torch.float32)
    assert run.backend == "cuda"
    counters = (residual_chain, causal_conv, causal_conv_transpose, rvq_assign,
                codebook_lookup, hifigan_unit)
    before = sum(k.launches for k in counters)
    first, cache = run(run.init_cache(), frames[:2])
    second, _ = run(cache, frames[2:])
    torch.cuda.synchronize()
    assert sum(k.launches for k in counters) - before == 2 * 18
    assert float((torch.cat([first, second]) - ref).abs().max()) <= 2e-5
    assert float(ref.std()) > 1e-3


@pytest.mark.parametrize("batch", [1, 4])
def test_vocoder_receiver_matches_eager_on_the_card(card, batch):
    codec, vq, voc = _vocoder_pair()
    codes = (torch.randint(0, 32, (3, batch, 5), generator=card, device="cuda")
             + torch.arange(3, device="cuda")[:, None, None] * 32).to(torch.int32)
    rx = VocoderReceiver(codec, voc, vq, batch=batch, weight_dtype=torch.float32)
    ref = VocoderReceiver(codec, voc, vq, batch=batch, backend="eager")
    assert rx.backend == "cuda" and ref.backend == "eager"
    for chunk in (codes, codes[..., :2], codes[..., 2:]):
        got, want = rx.decode(chunk), ref.decode(chunk)
        torch.cuda.synchronize()
        assert got.shape == want.shape == (batch, chunk.shape[-1] * 12, 1)
        assert float((got - want).abs().max()) <= 2e-5
    with pytest.raises(ValueError, match="outside its book"):
        rx.decode((codes * 0).cpu())  # from the host: checked before the upload


def test_receivers_raise_on_a_bad_code_at_the_documented_point(card):
    """A StreamingReceiver and a VocoderReceiver on the kernel route: codes
    from the host raise at once; codes on the card are decoded without a
    wait, and the next decode after a synchronising read raises, once."""
    codec, vq, voc = _vocoder_pair()
    good = (torch.randint(0, 32, (3, 1, 5), generator=card, device="cuda")
            + torch.arange(3, device="cuda")[:, None, None] * 32).to(torch.int32)
    bad = good.clone()
    bad[1, 0, 2] = 0  # book 1's range starts at 32
    for rx in (StreamingReceiver(codec, vq, 1, weight_dtype=torch.float32),
               VocoderReceiver(codec, voc, vq, weight_dtype=torch.float32)):
        assert rx.backend == "cuda"
        rx.decode(good)
        with pytest.raises(ValueError, match="outside its book"):
            rx.decode(bad.cpu())
        y = rx.decode(bad)
        assert y.cpu().shape[0] == 1  # a synchronising read
        with pytest.raises(ValueError, match="outside its book"):
            rx.decode(good)
        rx.decode(good).cpu()
        rx.decode(good).cpu()


LOG_MEL_CASES = [  # (B, T, sr, n_fft, hop, win, n_mels, fmax, log_base, arm)
    (2, 9600, 48000, 2048, 300, None, 80, 24000, None, "fft"),
    (3, 4800, 24000, 512, 120, 240, 40, 12000, 10.0, "fft"),
    (2, 999, 4800, 256, 60, 200, 20, 2400, 2.0, "fft"),
    (1, 3000, 22050, 1024, 256, None, 128, 7600, 10.0, "fft"),
    (2, 9600, 48000, 4096, 300, None, 80, 24000, None, "fft"),  # the FFT arm's largest n_fft
    (2, 4800, 24000, 600, 150, 600, 40, 12000, 10.0, "gemm"),  # not a power of two
]
STFT_CASES = [(1024, 120, 600, "fft"), (2048, 240, 1200, "fft"), (512, 50, 240, "fft"),
              (256, 64, 100, "fft"), (4096, 1024, 4096, "fft"), (128, 32, 100, "fft"),
              (64, 16, 64, "fft"), (600, 150, 600, "gemm")]


def _kernel_and_plain(card, fn, plain, batch, t, arm):
    """Forward of both on the same audio, gradients of both for one upstream
    gradient, the arm the call took, and the kernel's determinism checks."""
    x = _randn(card, batch, t)
    before, arms = fn_launches(), arm_launches()
    got = fn(x)
    assert fn_launches() == before + 1
    assert fn.arm == arm and arm_launches()[arm] == arms[arm] + 1
    ref = plain(x)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert torch.equal(fn(x), got)
    assert torch.equal(torch.cat([fn(x[i:i + 1]) for i in range(batch)]), got)
    g = torch.randn(got.shape, generator=card, device="cuda")
    xk, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    fn(xk).backward(g)
    plain(xp).backward(g)
    assert (xk.grad - xp.grad).abs().max() <= 1e-5 * xp.grad.abs().max()
    return got, ref


def fn_launches():
    return mel_kernel.log_mel.launches + mel_kernel.stft_magnitude.launches


def arm_launches():
    return {arm: mel_kernel.log_mel.arm_launches[arm]
            + mel_kernel.stft_magnitude.arm_launches[arm] for arm in mel_kernel.ARMS}


@pytest.mark.parametrize("case", LOG_MEL_CASES, ids=lambda c: f"{c[3]}-{c[4]}-{c[6]}")
def test_log_mel_kernel(card, case):
    b, t, sr, n_fft, hop, win, n_mels, fmax, base, arm = case
    kw = dict(sr=sr, n_fft=n_fft, hop=hop, win_length=win, n_mels=n_mels, fmin=0,
              fmax=fmax, log_base=base, device="cuda")
    got, ref = _kernel_and_plain(card, mel_kernel.make_fused_log_mel(**kw),
                                 mel_kernel.make_fused_log_mel(**kw, plain=True), b, t, arm)
    assert (got - ref).abs().max() <= 1e-4


@pytest.mark.parametrize("case", STFT_CASES, ids=lambda c: "-".join(map(str, c[:3])))
def test_stft_magnitude_kernel(card, case):
    n_fft, hop, win, arm = case
    got, ref = _kernel_and_plain(
        card, mel_kernel.make_fused_stft_magnitude(n_fft, hop, win, device="cuda"),
        mel_kernel.make_fused_stft_magnitude(n_fft, hop, win, device="cuda", plain=True),
        3, 4000, arm)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_fft_arm_needs_its_tables(card):
    """The planner sends a power-of-two n_fft to the FFT arm by shape alone:
    called without the builder's tables, the wrapper raises rather than take
    the other arm, and it refuses tables derived with other operands."""
    fn = mel_kernel.make_fused_stft_magnitude(512, 50, 240, device="cuda")
    frames = fn.frames_of(_randn(card, 2, 2000))
    with pytest.raises(ValueError, match="fn.fft_tables"):
        mel_kernel.stft_magnitude(frames, *fn.bases, 257, 1e-7)
    mel = mel_kernel.make_fused_log_mel(24000, 512, 120, 240, 40, fmax=12000, device="cuda")
    with pytest.raises(ValueError, match="derived with other operands"):
        mel_kernel.log_mel(frames, *mel.bases, mel.mel_m, 1e-10, None, fn.fft_tables)
    got = mel_kernel.log_mel(frames, *mel.bases, mel.mel_m, 1e-10, None, mel.fft_tables)
    assert got.shape == (frames.shape[0] * frames.shape[1], 40)


def test_spectral_losses_auto_launch_the_kernels(card):
    """'auto' on the card is the kernel route: the mel loss launches K6 twice
    per resolution, the STFT loss K7 twice per resolution."""
    assert MelSpectrogram(fs=48000, fft_size=2048, hop_size=300, device="cuda").backend == "cuda"
    x, y = _randn(card, 2, 4800, 1), _randn(card, 2, 4800, 1)
    mel = MultiMelSpectrogramLoss(fs=48000, fft_sizes=[2048, 512], hop_sizes=[300, 120],
                                  win_lengths=[None, 240], fmax=24000, device="cuda")
    before = mel_kernel.log_mel.launches
    mel(x, y)
    assert mel_kernel.log_mel.launches == before + 4
    stft = MultiResolutionSTFTLoss(device="cuda")
    before = mel_kernel.stft_magnitude.launches
    stft(x, y)
    assert mel_kernel.stft_magnitude.launches == before + 6


# ---------------------------------------------------------------- discriminators

DISC_RTOL = 1e-4  # chip_smoke.py's: f32 convs summed in other orders, cuDNN vs the CPU
COURSE_CONFIG = "configs/denoise/symAD_48MelWaveL1.yaml"
UNIV_CONFIG = "configs/autoencoder/symADuniv_vctk_48000_hop300.yaml"


def _flat_maps(outs):
    return [f for o in outs for f in (o if isinstance(o, (list, tuple)) else [o])]


@pytest.mark.parametrize("config", [COURSE_CONFIG, UNIV_CONFIG], ids=["course", "symADuniv"])
def test_discriminator_matches_its_cpu_twin(card, config):
    """A config's discriminator at its widths on the card against the same
    seeded weights on the CPU, one clip of 24000 samples: every map within
    DISC_RTOL of its largest |value|."""
    cfg = load_config(config)
    kind = cfg.get("model_type", "symAudioDec")
    x = _randn(card, 1, 24000, 1)
    on_card = build_discriminator(kind, cfg["discriminator_params"], device="cuda", seed=3)
    twin = build_discriminator(kind, cfg["discriminator_params"], device="cpu", seed=3)
    with torch.no_grad():
        got, want = _flat_maps(on_card(x)), _flat_maps(twin(x.cpu()))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=DISC_RTOL * float(w.abs().max()))


def test_adversarial_step_kernel_route_matches_plain(card):
    """One ``train_disc`` step of the course's generator and discriminator at
    their widths (2 x 24000 samples) with the mel loss on the kernel route
    (K6 launched) and on its plain version, from the same weights:
    fragments rtol 1e-5, every gradient of both networks 1e-4 of its
    tensor's largest, every parameter moved."""
    cfg = load_config(COURSE_CONFIG)
    x, t = _randn(card, 2, 24000, 1), _randn(card, 2, 24000, 1)
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for route in ("auto", "plain"):
            gen = AudioDecGenerator(**cfg["generator_params"], use_pqc=False, seed=1,
                                    device="cuda")
            disc = build_discriminator("symAudioDec", cfg["discriminator_params"],
                                       device="cuda", seed=2)
            nets = (gen, disc)
            before = [p.detach().clone() for m in nets for p in m.parameters()]
            opt_g = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"])
            opt_d = build_optimizer(disc.parameters(), "Adam",
                                    cfg["discriminator_optimizer_params"])
            rcfg = dict(cfg, mel_loss_params=dict(cfg["mel_loss_params"], backend=route))
            launched = mel_kernel.log_mel.launches
            _, d_loss, frags, _ = make_course_steps(gen, disc, rcfg, opt_g, opt_d)["train_disc"](
                x, t)
            assert (mel_kernel.log_mel.launches > launched) == (route == "auto")
            assert all(not torch.equal(a, p) for a, p in
                       zip(before, (p for m in nets for p in m.parameters())))
            runs[route] = ({"d_loss": float(d_loss), **{k: float(v) for k, v in frags.items()}},
                           [p.grad.detach().clone() for m in nets for p in m.parameters()])
    finally:
        torch.backends.cudnn.deterministic = False
    (fa, ga), (fp, gp) = runs["auto"], runs["plain"]
    assert sorted(fa) == sorted(fp) and {"adv_loss", "feat_loss"} <= set(fa)
    for k, v in fp.items():
        assert np.isfinite(fa[k])
        np.testing.assert_allclose(fa[k], v, rtol=1e-5, err_msg=k)
    for a, p in zip(ga, gp):
        torch.testing.assert_close(a, p, rtol=0, atol=1e-4 * float(p.abs().max()))


# ---------------------------------------------------------------- AudioDec workloads

CODEC_CONFIG = "configs/autoencoder/symAD_vctk_48000_hop300.yaml"
VOCODER_CONFIG = "configs/vocoder/AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml"
LOG_MAG_GRAD_RTOL = 1e-2  # chip_smoke.py's: the log-STFT-magnitude term's f32 limit (ROADMAP §3)


def _unit_gains(voc):
    """Each weight-norm gain of ``voc`` at about its conv's unit gain, as
    chip_smoke.py's build_vocoder sets them: at the official N(0, 0.01) init
    the output is almost all bias, and the log-magnitude's gradient has no
    signal to hold."""
    from dl_speech_enhancement_tpu_torch.nn.conv import ConvTranspose1d

    rng = np.random.default_rng(4)
    with torch.no_grad():
        for m in voc.modules():
            if getattr(m, "weight_norm", False):
                gain = 0.5 if m is voc.output_conv else 1.0
                if isinstance(m, ConvTranspose1d):
                    gain = (m.kernel_size * m.out_channels / (2.0 * m.in_channels)) ** 0.5
                m.g.copy_(torch.from_numpy(gain * rng.uniform(0.8, 1.25, tuple(m.g.shape))))


def _workload_step(route, workload, x):
    """One step of ``workload`` at the configs' widths from seeded weights
    with the spectral losses on ``route``: (fragments, generator gradients
    without the log-STFT-magnitude term's, that term's gradients (empty for
    the codec, whose loss has none), K6 and K7 launches)."""
    from dl_speech_enhancement_tpu_torch.train.criterion import metric_loss
    from dl_speech_enhancement_tpu_torch.train.workloads import autoencoder, vocoder
    from dl_speech_enhancement_tpu_torch.utils.model_factory import build_generator

    codec_cfg = load_config(CODEC_CONFIG)
    codec = AudioDecGenerator(**codec_cfg["generator_params"], seed=1, device="cuda")
    vq = codec.quantizer.init(seed=2, device="cuda")
    cfg = load_config(CODEC_CONFIG if workload == "autoencoder" else VOCODER_CONFIG)
    cfg = dict(cfg, mel_loss_params=dict(cfg["mel_loss_params"], backend=route),
               stft_loss_params=dict(cfg["stft_loss_params"], backend=route))
    launched = (mel_kernel.log_mel.launches, mel_kernel.stft_magnitude.launches)
    g_mag = []
    if workload == "autoencoder":
        opt = build_optimizer(codec.parameters(), "Adam", cfg["generator_optimizer_params"])
        steps = autoencoder.make_autoencoder_steps(codec, None, cfg, opt, None)
        _, frags, _ = steps["gen_stage1"](vq, x)
        gen = codec
    else:
        params = {k: v for k, v in cfg["generator_params"].items() if k != "stats"}
        gen = build_generator("HiFiGAN", params, device="cuda", seed=3)
        _unit_gains(gen)
        opt = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"])

        def spied(crit, config, y, target):  # the log-magnitude term's gradient alone
            total, fr = metric_loss(crit, config, y, target)
            g_mag.extend(torch.autograd.grad(fr["log_stft_magnitude_loss"],
                                             list(gen.parameters()), retain_graph=True))
            return total, fr

        vocoder.metric_loss = spied
        try:
            frags = vocoder.make_vocoder_steps(codec, vq, gen, None, cfg, opt, None)["gen"](x)
        finally:
            vocoder.metric_loss = metric_loss
    counts = (mel_kernel.log_mel.launches - launched[0],
              mel_kernel.stft_magnitude.launches - launched[1])
    if g_mag:
        rest = [p.grad.detach() - m for p, m in zip(gen.parameters(), g_mag)]
    else:
        rest = [p.grad.detach().clone() for p in gen.parameters() if p.grad is not None]
    return {k: float(v) for k, v in frags.items()}, rest, g_mag, counts


@pytest.mark.parametrize("workload,launches", [("autoencoder", (2, 0)), ("vocoder", (2, 6))])
def test_workload_step_kernel_route_matches_plain(card, workload, launches):
    """The codec's stage-1 generator step (mel loss: K6) and the v1
    vocoder's generator step (mel and three STFT resolutions: K6 and K7) at
    the configs' widths, 2 x 9600 samples, on the kernel route against the
    plain one from the same weights: the kernels launched as counted,
    fragments rtol 1e-5, every gradient without the log-STFT-magnitude
    term's within 1e-4 of its tensor's largest, and that term's gradient
    alone within LOG_MAG_GRAD_RTOL (its f32 limit)."""
    x = _randn(card, 2, 9600, 1)
    fa, ga, ma, na = _workload_step("auto", workload, x)
    fp, gp, mp, n_plain = _workload_step("plain", workload, x)
    assert na == launches and n_plain == (0, 0)
    assert sorted(fa) == sorted(fp)
    for k, v in fp.items():
        assert np.isfinite(fa[k])
        np.testing.assert_allclose(fa[k], v, rtol=1e-5, err_msg=k)
    assert len(ga) == len(gp) > 0 and len(ma) == len(mp) == (len(gp) if launches[1] else 0)
    for got, ref, rtol in ((ga, gp, 1e-4), (ma, mp, LOG_MAG_GRAD_RTOL)):
        for a, p in zip(got, ref):
            torch.testing.assert_close(a, p, rtol=0, atol=rtol * float(p.abs().max()))


# ---------------------------------------------------------------- the upload to the card


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_to_device_keeps_each_batch_while_the_card_is_busy(card, size):
    """``prefetch_to_device`` with a long kernel ahead of every copy on the
    stream, the source refilling one host buffer in place for each batch:
    the copies do not wait for the card (the stream is still busy when a
    batch is handed on), and every device batch, single arrays and
    (input, target) pairs, equals its host array bit for bit, also those
    handed on before the generator is closed early."""
    from dl_speech_enhancement_tpu_torch.data.loader import prefetch_to_device

    rng = np.random.default_rng(size)
    want = [rng.standard_normal((16, 9600, 1)).astype(np.float32) for _ in range(6)]
    buf = np.empty_like(want[0])

    def source(pair):
        for a in want:
            torch.cuda._sleep(20_000_000)
            buf[...] = a
            yield (buf, 2.0 * buf) if pair else buf

    def held(got, pair):
        torch.cuda.synchronize()
        for g, a in zip(got, want):
            for t, v in zip(g if pair else (g,), (a, 2.0 * a) if pair else (a,)):
                assert t.device.type == "cuda" and torch.equal(t.cpu(), torch.from_numpy(v))

    for pair in (False, True):
        it = prefetch_to_device(source(pair), size=size, device="cuda")
        got = [next(it)]
        assert not torch.cuda.current_stream().query()
        got += list(it)
        assert len(got) == len(want)
        held(got, pair)
        it = prefetch_to_device(source(pair), size=size, device="cuda")
        got = [next(it), next(it)]
        it.close()
        held(got, pair)


# ---------------------------------------------------------------- evaluation


def test_onnx_interpreter_on_the_card_matches_the_cpu(card, tmp_path):
    """The DNSMOS stand-ins and the DNSMOS scorer on the card against the
    CPU: the interpreter's outputs within 1e-5, the scores within 1e-4."""
    from chip_smoke import dnsmos_standins
    from dl_speech_enhancement_tpu_torch.eval.dnsmos import ComputeScore
    from dl_speech_enhancement_tpu_torch.eval.onnx_torch import OnnxModel

    rng = np.random.default_rng(0)
    primary, p808 = dnsmos_standins(str(tmp_path))
    for path, x in ((primary, 0.1 * rng.standard_normal((3, 144160))),
                    (p808, rng.uniform(-1.0, 1.0, (3, 900, 120)))):
        x = x.astype(np.float32)
        on_card = OnnxModel(path, device="cuda")(x)[0]
        assert on_card.device.type == "cuda"
        want = OnnxModel(path, device="cpu")(x)[0]
        torch.testing.assert_close(on_card.cpu(), want, rtol=0, atol=1e-5)
    audio = (0.2 * rng.standard_normal(16000 * 11)).astype(np.float32)
    got = ComputeScore(primary, p808, device="cuda")(audio)
    want = ComputeScore(primary, p808, device="cpu")(audio)
    for k in ("OVRL", "SIG", "BAK", "P808_MOS"):
        assert abs(got[k] - want[k]) <= 1e-4, k


def test_native_loader_under_prefetch_to_device(card, tmp_path):
    """The native reader and crop (data/native.py, built at first use)
    behind the loader thread and ``prefetch_to_device``: every device batch
    equals, bit for bit, the plain versions' batch of the same seed."""
    from dl_speech_enhancement_tpu_torch.data import (
        AudioDataset,
        get_dataloaders,
        native,
        write_wav,
    )
    from dl_speech_enhancement_tpu_torch.data.loader import prefetch_to_device

    assert native.available()
    rng = np.random.default_rng(1)
    for i in range(24):
        write_wav(str(tmp_path / "c" / f"u{i:02d}.wav"),
                  (0.3 * rng.standard_normal(int(48000 * rng.uniform(2.5, 4.0))))
                  .astype(np.float32), 48000)
    ds = AudioDataset(str(tmp_path / "c"), "c", 48000)
    loader = get_dataloaders(ds, [0.7, 0.15, 0.15], 4, 96000, 0)[0]
    got = [t.cpu() for t in prefetch_to_device(iter(loader), size=2, device="cuda")]
    saved = (native._LIB, native._TRIED)
    native._LIB, native._TRIED = None, True
    try:
        want = list(get_dataloaders(ds, [0.7, 0.15, 0.15], 4, 96000, 0)[0])
    finally:
        native._LIB, native._TRIED = saved
    assert len(got) == len(want) == 4
    assert all(torch.equal(g, torch.from_numpy(w)) for g, w in zip(got, want))


# ---------------------------------------------------------------- parallel training
# Data-parallel and time-sharded training with two gloo ranks on the one card
# (chip_smoke.py phase 10 at a small size), the ranks' cases those of the CPU
# tests (tests/torch_port_ranks.py) with their networks seeded in the port,
# each held to the same case in this process on the card: losses rtol 2e-4
# (time shards 1e-4), the codebooks atol 1e-5, the parameters atol 5e-5 (time
# shards 1e-5) where their gradient is above 1e-4 of its tensor's largest and
# within 2 lr elsewhere (Adam's first step at a gradient near its rounding
# floor). K6 / K7 must launch in every rank.

DP_SMALL = dict(encode_channels=8, decode_channels=8, code_dim=16, codebook_num=2,
                codebook_size=32, enc_ratios=(2, 4), dec_ratios=(4, 2), enc_strides=(3, 4),
                dec_strides=(4, 3))
DP_DISC = dict(scales=2, scale_discriminator_params={
    "kernel_sizes": [15, 41, 5, 3], "channels": 8, "max_downsample_channels": 32,
    "max_groups": 4, "downsample_scales": [2, 2, 1]}, periods=(2, 3), period_discriminator_params={
    "kernel_sizes": [5, 3], "channels": 4, "downsample_scales": [3, 3, 1],
    "max_downsample_channels": 16})
DP_MEL = dict(fs=4800, fft_sizes=[256], hop_sizes=[60], win_lengths=[256], num_mels=20, fmin=0,
              fmax=2400, log_base=None)
DP_COURSE = dict(mel_loss_params=DP_MEL, lambda_mel_loss=45.0, lambda_snr_loss=1.0,
                 lambda_vq_loss=1.0, lambda_adv=1.0, lambda_feat_match=2.0,
                 generator_adv_loss_params={"average_by_discriminators": False},
                 discriminator_adv_loss_params={"average_by_discriminators": False})
ONE_CARD = ["cuda:0", "cuda:0"]



def _deterministic(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


def test_course_step_over_two_ranks_on_one_card(card, tmp_path, monkeypatch):
    from torch_port_ranks import held_by_gradient, run_here, run_ranks

    _deterministic(monkeypatch)
    rng = np.random.default_rng(0)
    kw = {"gen_kw": DP_SMALL, "gen_params": None, "disc_kw": DP_DISC, "disc_params": None,
          "config": DP_COURSE, "arm": "train_disc",
          "mixed": (0.3 * rng.standard_normal((8, 240, 1))).astype(np.float32),
          "clean": (0.3 * rng.standard_normal((8, 240, 1))).astype(np.float32)}
    ranks = run_ranks(2, {"step": ("course_step", kw)}, tmp_path, devices=ONE_CARD)
    one = run_here("course_step", device="cuda:0", **kw)
    for got in (r["step"] for r in ranks):
        assert got["launches"]["log_mel"] > 0
        np.testing.assert_allclose(got["g"], one["g"], rtol=2e-4)
        np.testing.assert_allclose(got["d"], one["d"], rtol=2e-4)
        for k in one["frags"]:
            np.testing.assert_allclose(got["frags"][k], one["frags"][k], rtol=2e-4, err_msg=k)
        held_by_gradient(got["gen"], one["gen"], one["grads"], 5e-5)


def test_codec_and_vocoder_steps_over_two_ranks_on_one_card(card, tmp_path, monkeypatch):
    """The codec's stage-1 step (EMA codebooks over the ranks) and the
    vocoder workload's generator step (spectral convergence, K7)."""
    from torch_port_ranks import held_by_gradient, run_here, run_ranks

    _deterministic(monkeypatch)
    rng = np.random.default_rng(1)
    codec = AudioDecGenerator(**DP_SMALL, use_pqc=True, seed=0, device="cpu")
    t = np.arange(1200)[None, :, None] / 48.0
    x = (0.5 * np.sin(2 * np.pi * t + rng.uniform(0, np.pi, (4, 1, 1)))
         + 0.05 * rng.standard_normal((4, 1200, 1))).astype(np.float32)
    with torch.no_grad():
        scale = float(codec.projector(codec.encoder(torch.from_numpy(x))).std())
    books = scale * rng.standard_normal((2, 16, 32)).astype(np.float32)
    vq = (books, np.zeros((2, 32), np.float32), books.copy())
    voc_kw = dict(in_channels=16, out_channels=1, channels=32, kernel_size=7,
                  upsample_scales=(4, 3), upsample_kernel_sizes=(8, 6),
                  resblock_kernel_sizes=(3,), resblock_dilations=((1, 3),))
    voc_params = None  # seeded in the port
    config = dict(DP_COURSE, use_mel_loss=True, use_stft_loss=True, lambda_stft_loss=45.0,
                  stft_loss_params={"fft_sizes": [128, 256], "hop_sizes": [30, 60],
                                    "win_lengths": [120, 240]})
    cases = {"stage1": ("autoencoder_stage1", {
        "gen_kw": DP_SMALL, "gen_params": None, "vq": vq, "disc_kw": DP_DISC,
        "disc_params": None, "config": config, "x": x}),
        "vocoder": ("vocoder_step", {
            "an_kw": DP_SMALL, "an_params": None, "vq": vq, "voc_kw": voc_kw,
            "voc_params": voc_params, "disc_kw": DP_DISC, "disc_params": None,
            "config": config, "x": x})}
    ranks = run_ranks(2, cases, tmp_path, devices=ONE_CARD)
    for key, (name, kw) in cases.items():
        one = run_here(name, device="cuda:0", **kw)
        for got in (r[key] for r in ranks):
            assert got["launches"]["log_mel"] > 0, key
            for k in one["frags"]:
                np.testing.assert_allclose(got["frags"][k], one["frags"][k], rtol=2e-4,
                                           err_msg=f"{key}.{k}")
            if key == "stage1":
                for f in one["vq"]:
                    np.testing.assert_allclose(got["vq"][f], one["vq"][f], atol=1e-5,
                                               rtol=1e-6, err_msg=f)
                np.testing.assert_allclose(got["ppl"], one["ppl"], rtol=1e-5)
            else:
                assert got["launches"]["stft_magnitude"] > 0
        if key == "vocoder":
            # the log-STFT-magnitude term's gradient (1 / |S| at bins near
            # f32's floor) moves with the output's last bits, which cuDNN
            # changes with the batch: gradients within 1e-2 of each tensor's
            # largest, as chip_smoke.py holds that term across routes, and
            # the parameters within 2 lr
            got = ranks[0][key]
            for k, g in one["grads"].items():
                assert np.abs(got["grads"][k] - g).max() <= 1e-2 * np.abs(g).max(), k
                assert np.abs(got["voc"][k] - one["voc"][k]).max() <= 2e-3 * 1.001, k


def test_time_sharded_step_over_two_ranks_on_one_card(card, tmp_path, monkeypatch):
    """The PQC codec on 2 time shards, both ranks on the card: the blocked
    objective's step in this process."""
    from dl_speech_enhancement_tpu_torch.nn.vq import VQState
    from dl_speech_enhancement_tpu_torch.parallel.time_shard import (
        blocked_reference_step,
        decoder_receptive_frames,
    )
    from torch_port_ranks import held_by_gradient, run_ranks

    _deterministic(monkeypatch)
    rng = np.random.default_rng(2)
    gen = AudioDecGenerator(**DP_SMALL, use_pqc=True, seed=0, device="cuda:0")
    frames = max(-(-gen.receptive_length // gen.hop), decoder_receptive_frames(gen.decoder)) + 6
    x = (0.3 * rng.standard_normal((2, 2 * frames * gen.hop, 1))).astype(np.float32)
    target = x + (0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    books = rng.standard_normal((2, 16, 32)).astype(np.float32)
    vq = (books, np.zeros((2, 32), np.float32), books.copy())
    kw = {"gen_kw": DP_SMALL, "gen_params": None, "vq": vq, "use_pqc": True, "shape": (2,),
          "config": DP_COURSE, "clips": [(x, target)], "opt": {"kind": "adam"}}
    got = run_ranks(2, {"shard": ("time_train", kw)}, tmp_path, devices=ONE_CARD)[0]["shard"]
    opt = build_optimizer(gen.parameters(), "Adam", {"lr": 1e-3, "betas": [0.5, 0.9]})
    state = VQState(*(torch.from_numpy(a).cuda() for a in vq))
    new, loss = blocked_reference_step(gen, DP_COURSE, opt, 2)(
        state, torch.from_numpy(x).cuda(), torch.from_numpy(target).cuda())
    assert got["launches"]["log_mel"] > 0
    np.testing.assert_allclose(got["losses"][0], float(loss), rtol=1e-4)
    ref = {k: v.detach().cpu().numpy() for k, v in gen.state_dict().items()}
    held_by_gradient(got["params"][0], ref,
                      {n: p.grad.cpu().numpy() for n, p in gen.named_parameters()}, 1e-5)
    for f in ("embed", "cluster_size"):
        np.testing.assert_allclose(got["vq"][0][f], getattr(new, f).cpu().numpy(), atol=1e-5)
