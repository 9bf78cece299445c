"""On-card smoke run of the PyTorch/CUDA port (dl_speech_enhancement_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Three models serve, each at the full width of its configuration with seeded
random weights (no trained checkpoint is in the repository): the denoiser
(the without-PQC generator of configs/denoise/symAD_vctk_48000_hop300.yaml),
the symAD codec (the PQC generator of configs/autoencoder/
symAD_vctk_48000_hop300.yaml, whose codebooks are drawn as a k-means init
draws them, from the residuals of a seeded warm-up stream), and the
``vctk_v1`` pairing of that codec's transmitter with the AudioDec v1 HiFiGAN
receiver (configs/vocoder/AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml;
seeded statistics, since the statistics file is not in the repository, and
every weight-norm gain set to about unit gain, since at the official
N(0, 0.01) init the receiver's output is almost all bias). Each runs as one
stream and as 16 streams per dispatch. The ``vctk_v0`` pairing (the same
transmitter and the AudioDec v0 receiver, configs/vocoder/
AudioDec_v0_symAD_vctk_48000_hop300_clean.yaml: MultiReceptiveField blocks of
kernel 3/7/11, K4's MRF arm, seeded the same way) runs as one stream and 16,
and through the normal entry point, ``cli/stream.py --model vctk_v0`` and
``--model vctk_univ`` (v3 is v0's network), from seeded checkpoints under a
temporary exp/ tree. The AudioDec v2 receiver (MultiGroupConv1d at 256
channels) runs its kernel route once. Then the training stack: the course
denoise trainer's generator phase (configs/denoise/symAD_48MelWaveL1.yaml,
16 x 48000 samples a batch), the vocoder config's metric loss on the
``vctk_v1`` receiver, the course's adversarial phase, and the AudioDec
recipe (codec, statistics, vocoder, denoise) through its CLIs. Phases (any
failure exits non-zero before the result line):

1. build the eight CUDA kernel sources from
   ``dl_speech_enhancement_tpu_torch/csrc`` (one ``nvcc`` each, all at once)
   and the models on the card; log every ``hifigan_unit`` site's (tile,
   cluster) plan at one stream of one frame, where each stage-0 unit must
   run on a cluster of more than one block, and every ``causal_conv``
   site's (arm, tile, steps per block) plan of each path (the times of
   phase 4 log each site's plan too);
2. hold every kernel against its plain PyTorch version at every site of the
   three models (``residual_chain`` within CHAIN_ATOL, 2e-6; with bf16
   weights a kernel that rounds an intermediate sum, the chain, the unit and
   a vocoder upsample, also on exact-sum weights at that tolerance, and on
   the models' weights by ``utils/checks.py::rounding_held``), for one stream
   at 1, 100 (the single-stream paths'
   dispatch) and 400 frames per dispatch (the receiver at 1 and 100) with f32
   and bf16 weights, and with f32 weights at every (streams, frames per
   dispatch) a multi-stream path below dispatches (``BATCH_CHECKS``: 16
   streams at 1, 8 and 16 frames; 1, 4 and 64 streams at 1 and 16; the
   receiver's ``VOCODER_BATCH_CHECKS``), where perturbing stream 0 of a layer
   kernel must leave every other stream bit for bit as it was; the
   residual-VQ search up to near ties (``utils/checks.py::rvq_near_ties``);
   every site of the v0 receiver (36 unit sites at k =
   3/7/11, the last unit of each block with the accumulate epilogue) at 1,
   100 and 400 frames and at 16 streams of 1, 8 and 16 frames;
3. drive the main paths, each with every launch counter set to 0 just before
   and read just after:
   - one stream, ``make_scan_stream(batch=1, frame_size=1200)`` with
     ``backend='auto'`` (which must resolve to the ``'cuda'`` kernel route),
     200 frames in two dispatches. The denoiser is held against the
     ``'eager'`` route on the same card and weights and its first frames
     against the CPU, and its ``'cuda_chain'`` route against ``'eager'``.
     The codec runs through ``run_with_codes`` with f32 weights: its wire
     codes and audio are held against the ``'eager'`` route, the first
     frames against the CPU, and the kernel routes of ``StreamingTransmitter``
     / ``StreamingReceiver`` against the route; every book must use at least
     32 codes; the bf16 route's agreement with it is printed;
   - the receiver, ``make_vocoder_scan_stream(codec, books, vocoder,
     1200)`` with ``'auto'`` (which must resolve to ``'cuda'``), f32
     weights, 200 frames in two dispatches of 34 launches: its wire codes
     equal the codec path's, its audio the ``'eager'`` route's where the
     codes agree, the receiver half with bf16 weights the eager receiver on
     the same codes, ``VocoderReceiver`` the route on the route's codes;
   - 16 streams, ``make_scan_stream(batch=16, frame_size=1200)`` and the
     single-card ``make_sharded_stream``, f32 weights, 16 frames in two
     dispatches: each stream is held against its own single-stream
     ``'cuda'`` run and against the batched ``'eager'`` route (codes up to
     near ties, audio where the codes agree), the fleet against the scan
     stream bit for bit, and the codec's asymmetric receiver (a second
     codec's decoder and books) against its eager composition; the
     receiver's fleet ``make_sharded_stream(vocoder=)`` against each
     stream's own single-stream run, bit for bit (the unit kernel's plans
     differ between 16 streams and one);
   - the v0 receiver as the v1 one above, at 54 launches a dispatch (and
     its fleet at 16 streams); the v2 receiver's kernel route against eager
     on one stream, 1 frame then 100;
   - K1f (``fused_residual_chain_folded``) at the denoiser's chains of 32
     and 64 channels, fold 1/2/3 and 1/2: equal to K1, within 1e-4 of its
     folded plain version; T1 (``tools/reshape_probe.py``): its six shapes
     through ``fold_copy`` equal to numpy's reshape, or refused as numpy
     refuses them;
   - the normal entry point: ``cli.stream.main --model vctk_v0`` and
     ``vctk_univ`` (the transmitter's and the receiver's kernels, 54
     launches a frame, priming and warm-up included) held to
     ``make_vocoder_scan_stream`` on the same audio, ``--model vctk_sym``
     (22 a frame) and ``--checkpoint`` (the fused streamer, 22 a frame) to
     ``make_scan_stream``, 0 frames dropped;
   - at every B and N that phase 4 times, one f32-weight dispatch of
     ``make_scan_stream(batch=B)`` (of the receiver's fleet) held per stream
     against the batched ``'eager'`` route on the frames phase 4 times;
4. time per-frame latency at 1 frame per dispatch, the device's busy share
   of it (``torch.profiler``), throughput at 400, and every kernel site at 1,
   100 and 400 frames against its plain version, its bound and its one-call
   PyTorch equivalent (``F.conv1d`` / ``F.conv_transpose1d`` /
   ``F.embedding_bag``, and two grouped ``F.conv1d`` calls for a HiFiGAN
   unit: yardsticks the port never calls), with CUDA events (a unit's and a
   GEMM-arm causal_conv's bound at the rate of its weights' products: dense
   bf16 with bf16 weights, split TF32 with f32, the f32-core
   bound beside it), ``rvq_assign`` and ``codebook_lookup`` (and
   ``F.embedding_bag``) also as device time, CUDA events around a CUDA graph
   of the calls, since a wrapper call's host work floors their event time
   (T1's four shapes and ``torch.clone`` too); then the same
   sites at 16 streams of 1 and 16 frames, and per-stream-frame time and
   busy share of B = 1, 4, 16 and 64 streams (the receiver's fleet: 16 and
   64) at 1 and 16 frames per dispatch, through the kernel route, the
   batched eager route and (the codecs) B single-stream kernel dispatches,
   with the launches of one dispatch counted at every B and the card memory
   the returned cache keeps; the v0 receiver as the v1 one at 16 streams;
5. training, with TF32 off: the log-mel (K6) and STFT-magnitude (K7) DFT
   kernels, both arms (the shared-memory real FFT for power-of-two n_fft,
   the DFT-as-GEMM for any other), against their plain versions at every
   call shape of the paths below and at an n_fft of 600 (forward, the
   autograd.Function's gradient, the arm taken, two calls and a batch
   against its examples' calls bit for bit); one course train step with the
   mel loss on the kernel route (``backend='auto'``, which must launch K6),
   its plain version and the FFT, from the same params and batch, the
   kernel route held to the plain one (fragments and every gradient) and
   its log-mels to the FFT's; ``train_denoise_course`` for one LAPTOP epoch
   (3 train and 3 validation batches of seeded clean and noise clips mixed by
   the port's ``add_noise``), then 10 steps on one fixed batch whose loss
   must fall, with the step's median wall time, peak memory and profiled
   busy share; the vocoder config's metric loss (mel + three STFT
   resolutions) on the receiver's offline forward of the codec's quantized
   codes, forward and backward, kernel route against plain route; the
   kernels' times (CUDA events and profiled device time) against their
   plain versions, bounds, ``torch.stft().abs()`` (K7), the FFT route's
   log-mel (K6) and the GEMM arm at the same shapes, and the mel loss's
   forward and backward, each alone, on both routes.

6. adversarial training at the course config's widths: the course's HiFiGAN
   and the symADuniv UnivNet discriminators on the card against their CPU
   twins; one ``train_disc`` step at 16 x 48000 on the kernel route against
   the plain route and with ``discriminator_remat``; two LAPTOP epochs into
   the discriminator epoch and an HPC epoch writing its checkpoint; timed
   steps with and without remat;
7. the AudioDec recipe through its own CLIs, at each config's full widths
   and batch on a seeded wav corpus written into a temporary directory
   under the configs' subset names (no corpus is in the repository; only
   step counts, intervals and paths cut, ``RECIPE_CUTS``), each run counted
   (K6 / K7 launches a step, ``RecipeProbe``):
   - 7a ``cli.train`` on the codec config: 3 stage-1 steps at 16 x 96000,
     the adversarial phase 2 at 16 x 9600 to step 6, one eval pass, the
     checkpoint; over stage 2 the encoder, the projector and the codebooks
     must stay bit for bit and the decoder and the discriminator move; a
     bare ``--resume`` must load ``checkpoint-6steps`` at step 6;
   - 7b ``cli.statistic`` on 7a's checkpoint: a finite (2, 64) array, every
     scale above 0 (audio-seconds a second logged);
   - 7c ``cli.train`` on the v1 vocoder config over 7a's analyzer with 7b's
     statistics, 16 x 9600, 5 steps: the analyzer bit for bit, the
     generator's first update (K6 and K7 launched) at step 2;
   - 7d ``cli.train`` on the denoise config from 7a's checkpoint, 16 x
     96000, 3 steps: the decoder and the codebooks bit for bit, the encoder
     moved;
   - 7e ``cli.train_denoise -e LAPTOP`` on a seeded clean / noise tree;
   - 7f one step of each workload (codec stage 1, stage 2 then its
     discriminator, the vocoder's generator then its discriminator, denoise)
     on the kernel route against the plain route from the same state and
     batch: fragments ROUTE_FRAG_RTOL, gradients ROUTE_GRAD_RTOL (the
     vocoder generator's without its log-STFT-magnitude term too; that
     term's gradient alone LOG_MAG_GRAD_RTOL);
   - 7g ``prefetch_to_device`` at the recipe's pair batches with the stream
     busy: every device batch bit for bit its host arrays;
   per workload the median step time, the busy share of one profiled step,
   peak memory and the loader's share of the loop's wall time.
8. evaluation and the reference's checkpoints, through their CLIs on the
   card, each held against its CPU run (phase 7's corpus written anew into a
   temporary directory; the eval path launches none of the port's kernels,
   as the JAX package's runs none of its Pallas kernels: cuDNN convs and the
   FFT route, each run counted to show it):
   - 8a the full-width codec (phase 1's warm-up codebooks, a seeded
     discriminator) out through ``cli.export_checkpoint`` in the reference's
     framework format and the v1 vocoder with its statistics in the course
     format, both back through ``cli.import_checkpoint``: each state bit for
     bit; CLI_SECONDS through ``cli.stream --checkpoint`` (the kernel route,
     22 launches a frame) from the original and from the imported codec,
     and through ``make_scan_stream(...).run_with_codes``: audio and codes bit
     for bit;
   - 8b ``cli.test`` on the imported codec over TEST_CLIPS clips: the
     projector output within EVAL_ATOL of the CPU's, the codes up to near
     ties, the audio within EVAL_ATOL of the largest sample where the codes
     agree; the RTF per clip and the mean;
   - 8c ``cli.testing_denoise -e LAPTOP`` with a seeded full-width flagship
     (configs/denoise/symAD_custom.yaml, without PQC) and the ``AD``
     composite of 8a's imported codec and vocoder: every wav within
     EVAL_ATOL of its CPU twin's largest sample; the wall time per clip;
   - 8d ``cli.analyze --eval-wavs`` on 8c's output: the battery within the
     metric tolerances of the CPU's (METRIC_EXACT, METRIC_DB,
     METRIC_MEL_RTOL);
   - 8e ``cli.dnsmos`` on 8c's output with two seeded stand-in graphs at the
     real graphs' interfaces (``dnsmos_standins``; the real ones are not in
     the repository): every score within DNSMOS_ATOL of the CPU's;
   - 8f the native library (``data/native.py``, built with ``g++`` at first
     use) must load; phase 7d's denoise loader's read and crop per batch
     through it and through the plain versions, and 7d's loader wait share.
9. slice 10: K3b's and K5's bf16 launch boundaries, the fleets, long audio
   and the streamer's device split:
   - 9a-9b four paths at bf16 weights, each with f32 and with bf16
     boundaries, counted and every launch recorded (``Recorder``): the
     denoiser and the codec through ``make_mega_stream_stacked`` at
     BOUNDARY_BATCH streams of BOUNDARY_FRAMES frames, the v1 and v0
     receivers through ``make_stacked_vocoder`` at BOUNDARY_VOC_BATCH
     streams of the codec's wire codes. At bf16 boundaries every launch
     must store bf16 (the audio f32, the codes int32), every cache stay f32,
     and each call equal the f32 arm on its widened inputs rounded, bit for
     bit, and its plain version within the f32 arm's tolerance plus one bf16
     step of the value (codes up to near ties); the audio within
     BOUNDARY_RTOL of the f32 run's largest sample (the codec's codes up to
     near ties of the rounded z); each dispatch's device time (CUDA events
     around a CUDA graph) and its activations' bytes between launches, and
     one line with every path's device time a dispatch at both boundaries.
     The kernels line gets each arm as ``<kernel>.bf16``: launches in the
     bf16-boundary runs, times summed over its calls in one dispatch of the
     first path that runs it; ``causal_conv.bf16`` and
     ``causal_conv_transpose.bf16`` also print a line a site (its plan, its
     time, cuDNN's in bf16, its bound);
   - 9c ``cli.serve`` on seeded checkpoints (the denoiser's with
     ``--without-pqc``, and ``--model vctk_v1``) at ``--streams
     FLEET_CLI_STREAMS --devices 1``: its stats, 18 / 34 launches a block,
     stream 0 the one-device fleet's to one PCM16 step;
   - 9d ``make_sharded_stream`` of the codec over [cuda:0, cuda:0] bit for
     bit the one-device fleet;
   - 9e ``parallel_denoise`` on LONG_SECONDS of audio in LONG_CHUNKS chunks
     against one long ``gen.forward`` within MAIN_ATOL_F32, both timed;
   - 9f ``AudioCodecStreamer`` with the transmitter on the card and the
     receiver on the CPU: its codes the all-card streamer's, up to near ties
     the all-CPU one's, its audio within MAIN_ATOL_F32 of the all-CPU
     one's; the fused streamer's ``calibrate_split`` stats.
10. slice 11: training over ranks (``parallel_phase``), two gloo ranks on
    the one card (DP_DEVICES, parallel/mesh.py::launch; one spawn for all
    three), each held to the same work in this process, cuDNN
    deterministic, TF32 off:
   - 10a the course's ``train_disc`` step (configs/denoise/
     symAD_48MelWaveL1.yaml, 16 x 48000): losses DP_LOSS_RTOL, parameters
     DP_PARAM_ATOL where the one-process gradient is above DP_GRAD_FLOOR of
     its tensor's largest and within 2 lr elsewhere (Adam's first step at a
     gradient near its rounding floor), both ranks' parameters equal;
   - 10b CODEC_DP_STEPS stage-1 steps of the codec through ``TrainerGAN``
     (16 x 96000; the codebooks after the first step DP_VQ_ATOL of their
     largest, its parameters as 10a's, the last step's within 2 lr an
     update) and one generator step of the ``vctk_v1`` vocoder workload
     (spectral convergence, K7; its log-magnitude term's gradient, 1 / |S|
     near f32's floor, moves with the output's last bits: the gradients
     within LOG_MAG_GRAD_RTOL of each tensor's largest, the parameters
     within 2 lr);
   - 10c the full PQC codec on (data 1, time 2), SHARD_BATCH x SHARD_LENGTH:
     ``time_sharded_forward`` beyond the warm-up within SHARD_FWD_ATOL /
     SHARD_FWD_RTOL of the offline forward, one step against
     ``blocked_reference_step`` (loss SHARD_LOSS_RTOL, parameters
     SHARD_PARAM_ATOL as 10a's, codebooks DP_VQ_ATOL).
   Each step's wall time, its gradient reduction timed alone and its share,
   and each rank's peak memory; K6 / K7 counted in every rank.

Prints the per-kernel JSON line (times summed over the kernel's sites in one
100-frame dispatch of the single-stream path that first runs it, the codec's
and the receiver's causal conv sites beside them, and at 16 streams of 1
and 16 frames; K6 at the course's mel loss and K7 summed over the three STFT
resolutions; launches summed over every main path), the card's name and
power limit, and last ``{"ok": true, "device": {...}}``. The full report
goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
import yaml

from dl_speech_enhancement_tpu_torch.cli import analyze as analyze_cli
from dl_speech_enhancement_tpu_torch.cli import dnsmos as dnsmos_cli
from dl_speech_enhancement_tpu_torch.cli import export_checkpoint as export_cli
from dl_speech_enhancement_tpu_torch.cli import import_checkpoint as import_cli
from dl_speech_enhancement_tpu_torch.cli import serve as serve_cli
from dl_speech_enhancement_tpu_torch.cli import statistic as stat_cli
from dl_speech_enhancement_tpu_torch.cli import stream as stream_cli
from dl_speech_enhancement_tpu_torch.cli import test as codec_test_cli
from dl_speech_enhancement_tpu_torch.cli import testing_denoise as testing_cli
from dl_speech_enhancement_tpu_torch.cli import train as train_cli
from dl_speech_enhancement_tpu_torch.cli import train_denoise as course_cli
from dl_speech_enhancement_tpu_torch.data import native, read_wav, write_wav
from dl_speech_enhancement_tpu_torch.data.loader import prefetch_to_device
from dl_speech_enhancement_tpu_torch.data.mixing import add_noise
from dl_speech_enhancement_tpu_torch.dsp.mel import MelSpectrogram
from dl_speech_enhancement_tpu_torch.losses import MultiMelSpectrogramLoss
from dl_speech_enhancement_tpu_torch.losses.mel_loss import _flat as flat_waves
from dl_speech_enhancement_tpu_torch.models import AudioDecGenerator, HiFiGANGenerator
from dl_speech_enhancement_tpu_torch.models.hifigan import MultiReceptiveField
from dl_speech_enhancement_tpu_torch.nn.conv import Conv2d, ConvTranspose1d
from dl_speech_enhancement_tpu_torch.nn.vq import VQState
from dl_speech_enhancement_tpu_torch.ops import _cuda, mega_kernel, vocoder_kernel
from dl_speech_enhancement_tpu_torch.ops.mega_kernel import (
    _conv_plan,
    _upsample_plan,
    causal_conv,
    causal_conv_plain,
    causal_conv_transpose,
    causal_conv_transpose_plain,
    check_codes,
    codebook_lookup,
    codebook_lookup_plain,
    conv_transpose_weight,
    conv_weight,
    join_halves,
    mega_decoder,
    mega_encoder,
    rvq_assign,
    rvq_assign_plain,
    vq_tables,
)
from dl_speech_enhancement_tpu_torch.ops.mega_stacked import make_mega_stream_stacked
from dl_speech_enhancement_tpu_torch.ops.mel_kernel import (
    _LOG_KIND,
    ARMS,
    _launch,
    log_mel,
    log_mel_plain,
    make_fused_log_mel,
    make_fused_stft_magnitude,
    stft_magnitude,
    stft_magnitude_plain,
)
from dl_speech_enhancement_tpu_torch.ops.stream_kernel import (
    DILATIONS,
    KERNEL_SIZE,
    _chain_plan,
    chain_halo,
    chain_weights,
    fused_residual_chain,
    fused_residual_chain_folded,
    fused_residual_chain_folded_plain,
    residual_chain,
    residual_chain_plain,
)
from dl_speech_enhancement_tpu_torch.ops.vocoder_kernel import (
    _unit_plan,
    conv_sites,
    hifigan_unit,
    hifigan_unit_plain,
    make_stacked_vocoder,
    vocoder_half,
    vocoder_topology_error,
)
from dl_speech_enhancement_tpu_torch.parallel import make_sharded_stream, parallel_denoise
from dl_speech_enhancement_tpu_torch.parallel.mesh import (
    backend_for,
    device_mesh,
    launch,
    mesh_from_config,
    shard_batch,
)
from dl_speech_enhancement_tpu_torch.parallel.time_shard import (
    blocked_reference_step,
    decoder_receptive_frames,
    local_shard,
    make_time_sharded_steps,
    time_sharded_forward,
)
from dl_speech_enhancement_tpu_torch.stream.runtime import (
    AudioCodecStreamer,
    StreamingReceiver,
    StreamingTransmitter,
    VocoderReceiver,
    make_scan_stream,
    make_vocoder_scan_stream,
)
from dl_speech_enhancement_tpu_torch.train.criterion import build_criterion, metric_loss
from dl_speech_enhancement_tpu_torch.train.denoise_course import (
    make_course_steps,
    train_denoise_course,
)
from dl_speech_enhancement_tpu_torch.train.checkpoint import (
    is_rank0,
    load_checkpoint,
    save_checkpoint,
)
from dl_speech_enhancement_tpu_torch.train.gan_trainer import TrainerGAN
from dl_speech_enhancement_tpu_torch.train.optim import build_optimizer, build_optimizer_from_config
from dl_speech_enhancement_tpu_torch.train.workloads import autoencoder as ae_workload
from dl_speech_enhancement_tpu_torch.train.workloads import denoise as dn_workload
from dl_speech_enhancement_tpu_torch.train.workloads import vocoder as voc_workload
from dl_speech_enhancement_tpu_torch.tools import reshape_probe
from dl_speech_enhancement_tpu_torch.utils.audiodec import (
    assign_model,
    load_generator_from_checkpoint,
)
from dl_speech_enhancement_tpu_torch.utils.checks import (
    FLIP_RTOL,
    ROUNDING_GAP,
    exact_sum_weights,
    moved_near_ties,
    rounding_held,
    rvq_near_ties,
)
from dl_speech_enhancement_tpu_torch.utils.collectives import average_gradients, pmean_values
from dl_speech_enhancement_tpu_torch.utils.config import load_config
from dl_speech_enhancement_tpu_torch.utils.model_factory import build_discriminator

DEVICE = "cuda"  # the card; the port's entry points run there by default
REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "configs", "denoise", "symAD_vctk_48000_hop300.yaml")
CODEC_CONFIG = os.path.join(REPO, "configs", "autoencoder", "symAD_vctk_48000_hop300.yaml")
VOCODER_CONFIG = os.path.join(REPO, "configs", "vocoder",
                              "AudioDec_v1_symAD_vctk_48000_hop300_clean.yaml")
V0_CONFIG = os.path.join(REPO, "configs", "vocoder",
                         "AudioDec_v0_symAD_vctk_48000_hop300_clean.yaml")
V2_CONFIG = os.path.join(REPO, "configs", "vocoder",
                         "AudioDec_v2_symAD_vctk_48000_hop300_clean.yaml")
V3_CONFIG = os.path.join(REPO, "configs", "vocoder",
                         "AudioDec_v3_symADuniv_vctk_48000_hop300_clean.yaml")
UNIV_CODEC_CONFIG = os.path.join(REPO, "configs", "autoencoder",
                                 "symADuniv_vctk_48000_hop300.yaml")
SEED = 0
FRAME = 1200
SAMPLE_RATE = 48000
DISPATCH = 100
MAIN_FRAMES = (DISPATCH, DISPATCH)   # the main path: 200 frames in two dispatches
THROUGHPUT_FRAMES = 400
SIZES = (1, DISPATCH, THROUGHPUT_FRAMES)   # frames per dispatch of the kernel checks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_FLOPS = 67e12          # H100 SXM f32 rate outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM dense TF32 tensor-core rate
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core rate
# The tensor-core kernels' products (residual_chain, hifigan_unit, causal_conv
# on its GEMM arm, causal_conv_transpose on each phase): with f32 weights
# split-TF32 passes, 3 of them; with bf16 weights the reference multiplies
# bf16 by bf16 (its operands rounded to bf16), so the least time for that
# work is at the dense bf16 rate (gemm_rate), whatever the kernel issues.
TF32_PASSES = {torch.float32: 3}


def gemm_rate(wd) -> float:
    """The peak rate of the products of a tensor-core kernel with ``wd``
    weights: dense bf16 for bf16 weights, split TF32 for f32."""
    return BF16_FLOPS if wd == torch.bfloat16 else TF32_FLOPS / TF32_PASSES[torch.float32]



# Tolerances. Kernel vs plain: the same products summed in another order, up
# to 2816 terms of O(1) values (a HiFiGAN unit at stage 0: 11 taps x 256
# channels, two such sums chained, the second over rows of the first's
# output) -> atol 1e-4 (f32 weights; measured at most 2.3e-6 on the codec's
# 2560-term sums), and 1e-4 of the largest output (bf16 weights, the inputs
# rounded to bf16 identically on both sides). hifigan_unit's tensor-core
# products hold the same tolerances with f32 weights: emulated at a stage-0
# unit they stay within ~1e-6 of f64 (tests/test_torch_port_unit_plan.py).
# Main path in f32 vs eager (cuDNN, TF32 off) and vs the CPU: 2e-4, the JAX
# package's flagship tolerance. bf16-weight main path vs f32 eager: weight
# rounding (2^-9 relative) through 34 layers -> 5e-2 of the largest output.
KERNEL_ATOL_F32 = 1e-4
KERNEL_RTOL_BF16 = 1e-4
# With bf16 weights a kernel that rounds an intermediate sum to bf16 (a
# chain's ELU(conv1) and each later unit's ELU(x), a unit's leaky(h), a
# vocoder upsample's product) computes a function that jumps where that sum
# crosses a bf16 rounding midpoint, so two sum orders can round one step
# apart and the step spreads: measured on the card (tools/flip_spread.py)
# the plain version there and on the CPU differ by up to 1.5e-3 of the
# largest output at the chain sites, as much as the kernel does, and as much
# as a kernel that does not round at all. Those kernels keep the tolerances
# above on exact-sum weights, where every sum is exact in any order, with the
# unrounded plain version at least ROUNDING_GAP times that away; on the
# models' weights they are held by rounding_held (utils/checks.py: within
# FLIP_RTOL, 2^-8, of the largest output, and at most 3/4 as far from the
# plain version as from the unrounded one in RMS).
# residual_chain's split-TF32 products (f32 weights) leave ~2^-22 of each
# activation, so that arm is held tighter, at every site: 2e-6 (emulated at
# e3ch within 1e-6 of f64, tests/test_torch_port_chain_plan.py).
CHAIN_ATOL = 2e-6
MAIN_ATOL_F32 = 2e-4
MAIN_RTOL_BF16 = 5e-2
# Codec. Wire codes: equal to the reference's except at near ties, where the
# two searches' distances differ by at most 1e-5 * max(1, |min distance|)
# (the same r.E products summed in another order, or z moved by ~1e-6
# between routes). Lookup kernel vs plain: a sum of 8 f32 codewords, 1e-5.
# The codec's audio is held only with f32 weights: a code changed by bf16
# weights moves a frame's audio far more than 5e-2.
CODE_RTOL = 1e-5
LOOKUP_ATOL = 1e-5
MIN_DISTINCT_CODES = 32
WARMUP_FRAMES = 2400  # 9600 code rows: 8 books of 1024 codewords drawn from distinct rows
DENOISER_KERNELS = ("residual_chain", "causal_conv", "causal_conv_transpose")
CODEC_KERNELS = DENOISER_KERNELS + ("rvq_assign", "codebook_lookup")
# the receivers' paths: the codec's transmitter (11 launches) and the v1
# receiver (23: MultiGroupConv1d) or the v0 receiver (43: MultiReceptiveField,
# 4 stages of an upsample and 3 blocks of 3 units)
LAUNCHES_PER_DISPATCH = {"denoiser": 18, "codec": 22, "vocoder": 34, "vocoder_v0": 54}
BATCH = 16  # streams of the multi-stream main paths and kernel checks
MULTI_FRAMES = (8, 8)  # the multi-stream main paths: 16 frames in two dispatches
BATCH_SIZES = (1, 16)  # frames per dispatch of the multi-stream times
TIME_BATCHES = (1, 4, 16, 64)  # streams per dispatch of the multi-stream times
# B single-stream dispatches as a yardstick, timed at these B only: from B = 16
# on they cost B times the one-stream dispatch (PERF.md, the codecs' B-stream table)
SINGLE_STREAM_BATCHES = (1, 4)
# (streams, frames per dispatch) of the batch-axis kernel checks: every shape
# a multi-stream path of this script dispatches (one stream at one frame is
# among the single-stream checks)
BATCH_CHECKS = tuple(sorted({(BATCH, n) for n in MULTI_FRAMES}
                            | {(b, n) for b in TIME_BATCHES for n in BATCH_SIZES}
                            - {(1, 1)}))
# projector rows drawn for the search's checks: enough for the largest shape
Z_FRAMES = max(THROUGHPUT_FRAMES, *(b * n for b, n in BATCH_CHECKS))
VOCODER_TIME_BATCHES = (16, 64)  # streams per dispatch of the receiver fleet's times
# (streams, frames per dispatch) of the receiver's batch-axis kernel checks:
# its fleet's main path and every timed shape
VOCODER_BATCH_CHECKS = tuple(sorted({(BATCH, n) for n in MULTI_FRAMES}
                                    | {(b, n) for b in VOCODER_TIME_BATCHES
                                       for n in (1, 16)}))
V0_TIME_BATCHES = (16,)  # streams per dispatch of the v0 receiver fleet's times
V0_BATCH_CHECKS = tuple(sorted({(BATCH, n) for n in MULTI_FRAMES}
                               | {(b, n) for b in V0_TIME_BATCHES for n in (1, 16)}))
V2_FRAMES = (1, DISPATCH)  # the v2 receiver's kernel route vs eager: N = 1 then 100
# The normal entry point (cli/stream.py): seconds of seeded 48 kHz audio, and a
# --max-latency no frame reaches (file-driven frames queue up behind each other)
CLI_SECONDS = 4
CLI_MAX_LATENCY = 1000.0
PCM16_STEP = 1.0 / 32768  # the output wav's rounding
# K1f at the denoiser's narrow chains: (encoder block, fold) at C = 32 and 64
FOLDED_SITES = ((0, 1), (0, 2), (0, 3), (1, 1), (1, 2))
MIN_AUDIO_STD = 1e-2  # the receiver's audio must not be a near constant ...
MAX_SATURATED_SHARE = 0.05  # ... nor sit at tanh's saturation (|y| > 0.99)
# Training (phase 5): the course denoise trainer's generator phase at the
# configuration's own batch (16 x 48000 samples, batch_length = sample_rate as
# cli/train_denoise.py sets it) and the vocoder config's metric loss at 16 x
# 9600 samples.
COURSE_CONFIG = os.path.join(REPO, "configs", "denoise", "symAD_48MelWaveL1.yaml")
COURSE_BATCH = 16
COURSE_LENGTH = SAMPLE_RATE
VOCODER_METRIC_LENGTH = 9600
FIXED_STEPS = 10
SPECTRUM_KERNELS = ("log_mel", "stft_magnitude")
# Tolerances. K6 / K7 kernel vs plain: the same f32 DFT as two matmuls summed
# in another order over up to 2048 terms -> log-mel atol 1e-4 (JAX's
# interpret-mode K6 and its plain version agree to 1.05e-5 at n_fft 512 on the CPU),
# magnitudes 1e-5 of the largest; the autograd.Function's gradient (the JAX
# VJP in torch ops) vs autograd through the plain version 1e-5 of the largest
# (3e-6 measured on the CPU). Course step and vocoder metric loss, kernel
# route vs plain route (TF32 off): fragments rtol 1e-5, gradients 1e-4 of each
# tensor's largest (the mel loss's sign(delta) and 1/mel factors amplify the
# forward's 1e-6 differences). Kernel vs FFT route: the JAX package's own
# kernel-vs-FFT tolerance in log-mel, 5e-3 (tests/test_ops.py:24). The
# log-STFT-magnitude term's gradient is X / |X|^2 per bin: the bins nearest
# the 1e-7 power clamp dominate it and carry the f32 rounding of their whole
# frame, so two f32 transforms summed in other orders differ there by ~1e-3
# of the largest gradient (1.7e-3 measured kernel vs plain on the H100; FFT
# against FFT 9.3e-4 on the CPU, tests/test_torch_port_losses.py) -> 1e-2,
# which the FFT route's own distance from the plain route must meet too: the
# bound is f32's on that term, not the kernel's.
LOG_MEL_ATOL = 1e-4
STFT_RTOL = 1e-5
SPECTRUM_GRAD_RTOL = 1e-5
ROUTE_FRAG_RTOL = 1e-5
ROUTE_GRAD_RTOL = 1e-4
EAGER_LOG_MEL_ATOL = 5e-3
LOG_MAG_GRAD_RTOL = 1e-2
# Adversarial training (phase 6), TF32 off: the course's discriminator on the
# card against its CPU twin on DISC_LENGTH samples, every map within DISC_RTOL
# of its largest |value| (f32 convs summed in other orders, cuDNN against the
# CPU's); remat against plain, cuDNN's deterministic algorithms on: losses
# REMAT_LOSS_RTOL, parameters REMAT_PARAM_RTOL (tests/test_train.py's bounds
# for the JAX package's remat). A step's discriminator work in
# forward-equivalents of its convs: the generator's update runs D(y) and
# D(target) forward and D(y)'s input gradient (3), the discriminator's both
# forwards and both weight and input gradients (6); remat recomputes each
# sub-discriminator's two forwards in each backward (+4).
DISC_LENGTH = 24000
DISC_RTOL = 1e-4
REMAT_LOSS_RTOL = 1e-6
REMAT_PARAM_RTOL = 1e-5
ADV_PASSES = 9
ADV_PASSES_REMAT = 13
# The AudioDec recipe (phase 7) through its CLIs, on a seeded corpus written
# into a temporary directory under the configs' subset names (no wav corpus
# is in the repository): every config at its full widths and batch, only its
# step counts, intervals and paths cut (RECIPE_CUTS).
STATISTIC_CONFIG = os.path.join(REPO, "configs", "statistic",
                                "symAD_vctk_48000_hop300_clean.yaml")
RECIPE_CLIPS = {"train": 32, "valid": 16}  # 16 valid clips: one full batch for the eval pass
RECIPE_SECONDS = (2.5, 4.0)
RECIPE_LENGTH = 96000  # the codec's and the denoise fine-tune's batch_length
RECIPE_CUTS = [
    "corpus: 32 seeded clips of 2.5-4 s per train subset and 16 per valid subset (tones over "
    "a noise floor; noisy = clean + white noise), written under the configs' subset names",
    "codec: start_steps.discriminator 200000 -> 3, train_max_steps 200000 -> 3, "
    "adv_train_max_steps 500000 -> 6, eval_interval_steps 1000 -> 6, log_interval_steps "
    "100 -> 3; data.path and the expdir in a temporary directory",
    "statistic: analyzer -> the codec's checkpoint-6steps, stats -> a temporary path",
    "vocoder: analyzer and generator_params.stats -> the two above, train_max_steps 500000 "
    "-> 5, eval_interval_steps 1000 -> 5, log_interval_steps 100 -> 5",
    "denoise: initial -> the codec's checkpoint-6steps, train_max_steps 200000 -> 3, "
    "adv_train_max_steps 500000 -> 3 (the config keeps the codec's phase 2, which cli.train "
    "runs for any mode, as the JAX package's does), eval_interval_steps 1000 -> 3, "
    "log_interval_steps 100 -> 3",
    "course CLI: epochs 500 -> 1 (LAPTOP: 3 batches of 4 an epoch, as the CLI sets it)",
]
# phase 8: evaluation and the reference's checkpoints
FLAGSHIP_CONFIG = os.path.join(REPO, "configs", "denoise", "symAD_custom.yaml")
TEST_CLIPS = 4  # cli.test's clips
EVAL_ATOL = 2e-4  # 8b / 8c: card against CPU, of the largest sample (plus one PCM16 step)
METRIC_EXACT = 1e-10  # STOI, ESTOI, SDR: the same float64 numpy on both
METRIC_DB = 1e-4  # SNR, SI-SDR (f32)
METRIC_MEL_RTOL = 1e-5
DNSMOS_ATOL = 1e-4
LOADER_BATCHES = 2  # 8f: the denoise loader's batches timed per reader and pass
# phase 9: K3b's and K5's bf16 launch boundaries (9a-9b), the fleet CLI (9c),
# the fleet split (9d), long audio (9e), the streamer's device split (9f).
# bf16 arms against plain: the f32 arm's tolerance plus one bf16 step of the
# value (2^-7 of it: the two sides' f32 sums differ in their last bits, so a
# value at a rounding boundary may round either way); against the f32 arm
# on the widened inputs, rounded: bit for bit. bf16 boundaries against f32:
# the JAX package's 5e-2 of the largest sample (tests/test_mega_stacked.py:163).
BOUNDARY_BATCH, BOUNDARY_FRAMES = 64, 16  # make_mega_stream_stacked's streams and frames
BOUNDARY_VOC_BATCH = 16  # make_stacked_vocoder's streams (the v1 and v0 receivers)
BOUNDARY_RTOL = 5e-2
BF16_STEP = 2.0 ** -7
FLEET_CLI_STREAMS, FLEET_CLI_SECONDS, FLEET_CLI_BLOCK = 64, 4, 16
LONG_SECONDS, LONG_CHUNKS = 60, 16
SPLIT_FRAMES = 80  # the streamer split's frames (2 s)

KERNELS = {
    "residual_chain": {
        "fn": residual_chain,
        "source": "dl_speech_enhancement_tpu_torch/csrc/residual_chain.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/stream_kernel.py:38 (K1; and the "
                    "chains of K2, ops/mega_kernel.py:324,522)",
    },
    "causal_conv": {
        "fn": causal_conv,
        "source": "dl_speech_enhancement_tpu_torch/csrc/causal_conv.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:324 (K2e input conv "
                    "and downsamples, PQC projector :412-417; K2d output conv, :522, "
                    "PQC input conv :561-565; K4 input conv, 1x1 fuses and tanh output "
                    "conv, ops/vocoder_kernel.py:263-292, 577-586, 720-746)",
    },
    "causal_conv_transpose": {
        "fn": causal_conv_transpose,
        "source": "dl_speech_enhancement_tpu_torch/csrc/causal_conv_transpose.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:522 (K2d upsamples; K4 "
                    "LeakyReLU + upsamples, ops/vocoder_kernel.py:295-337)",
    },
    "rvq_assign": {
        "fn": rvq_assign,
        "source": "dl_speech_enhancement_tpu_torch/csrc/rvq_assign.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:418 (K2e PQC arm: "
                    "residual-VQ search and int32 wire codes, :418-432)",
    },
    "codebook_lookup": {
        "fn": codebook_lookup,
        "source": "dl_speech_enhancement_tpu_torch/csrc/codebook_lookup.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mega_kernel.py:552 (K2d PQC arm: "
                    "codebook lookup, :552-560; K4's lookup, ops/vocoder_kernel.py:229-256)",
    },
    "hifigan_unit": {
        "fn": hifigan_unit,
        "source": "dl_speech_enhancement_tpu_torch/csrc/hifigan_unit.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/vocoder_kernel.py:378 (K4 unit bodies "
                    ":378-390, :443-452, :521-533, and the MultiReceptiveField arm add_mrf "
                    ":667-714 through the accumulate epilogue; K5's, "
                    "ops/vocoder_stacked.py:334-391)",
    },
    "log_mel": {
        "fn": log_mel,
        "source": "dl_speech_enhancement_tpu_torch/csrc/dft_spectrum.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mel_kernel.py:152 (K6 make_fused_log_mel: "
                    "_kernel :119, call :177)",
        "design": "FFT arm (power-of-two n_fft 64-4096; the paths' every call): a "
                  "shared-memory radix-8 Stockham real FFT of each frame, the window "
                  "applied as the samples load, the magnitude, the sparse mel projection "
                  "over each band's contiguous bins, clamp and log fused in one launch "
                  "(fft_log_mel_kernel); GEMM arm (any other n_fft): the DFT as two f32 "
                  "GEMMs (log_mel_kernel)",
    },
    "stft_magnitude": {
        "fn": stft_magnitude,
        "source": "dl_speech_enhancement_tpu_torch/csrc/dft_spectrum.cu",
        "replaces": "dl_speech_enhancement_tpu/ops/mel_kernel.py:256 (K7 "
                    "make_fused_stft_magnitude: _mag_kernel :247, call :270)",
        "design": "FFT arm (power-of-two n_fft 64-4096): K6's shared-memory real FFT, "
                  "the magnitudes stored bin by bin (fft_stft_magnitude_kernel); GEMM arm "
                  "(any other n_fft): the DFT as two f32 GEMMs (stft_magnitude_kernel)",
    },
}
KERNELS["fold_copy"] = {  # T1
    "fn": reshape_probe.fold_copy,
    "source": "dl_speech_enhancement_tpu_torch/csrc/fold_copy.cu",
    "replaces": "tools/reshape_probe.py:37 (T1 probe: fold / unfold reshapes inside a "
                "Pallas kernel, call :46)",
}
SERVING_KERNELS = ("residual_chain", "causal_conv", "causal_conv_transpose", "rvq_assign",
                   "codebook_lookup", "hifigan_unit")
VOCODER_KERNELS = SERVING_KERNELS  # the receiver's path (with its tx) runs all six
RECEIVER_KERNELS = ("causal_conv", "causal_conv_transpose", "codebook_lookup",
                    "hifigan_unit")  # a receiver behind an eager transmitter


class Failure(RuntimeError):
    pass


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_ms(fn, reps: int, groups: int = 5) -> float:
    """ms per call of ``fn``: CUDA events around ``reps`` calls launched back
    to back, after a warm-up call; the median over ``groups`` such runs.
    Where a call's host work outlasts its kernels this measures the host's
    launch rate; :func:`device_profile` gives the kernels' own time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(groups):
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    """The least time for ``flops`` operations at ``rate`` and ``nbytes``
    moved at the card's memory rate, and which of the two bounds it."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def chain_flops(channels: int, rows: int) -> float:
    """Operations of one residual chain that outputs ``rows`` rows. Unit u
    must also compute the rows that the later units' dilated taps reach back
    to (the cache holds inputs, not unit outputs)."""
    total = 0
    for u in range(len(DILATIONS)):
        needed = rows + sum((KERNEL_SIZE - 1) * d for d in DILATIONS[u + 1:])
        total += 2.0 * (KERNEL_SIZE + 1) * channels * channels * needed
    return total


# ---------------------------------------------------------------- sites


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


class Site(NamedTuple):
    """One kernel launch of a main-path dispatch: the kernel call, its plain
    version and its one-call PyTorch yardstick (or None) on the same
    inputs, the operations and bytes its bound counts, the (cache, x)
    inputs of a layer kernel (None for the codec's search and lookup), the
    operation rate of the arithmetic the kernel uses, and a causal_conv
    launch's (arm, tile, steps per block) plan."""

    kernel: str
    site: str
    run: Callable
    plain: Callable
    lib: Callable | None
    flops: float
    bytes: float
    inputs: tuple | None
    rate: float = F32_FLOPS
    plan: tuple | None = None
    step: Callable | None = None  # check_site's rounded-product step, if any
    unrounded: Callable | None = None  # rounding_checks' plain version on f32 operands
    exact: tuple | None = None  # rounding_checks' (run, plain, unrounded) on exact sums


def make_rand(rng, batch):
    """``rand(*shape, cache=False)``: N(0, 0.3^2) activations of one stream,
    or of ``batch`` streams, where a cache is a strided view whose streams
    lie 5 rows further apart than its own rows."""

    def rand(*shape, cache=False):
        if batch is None:
            return torch.randn(*shape, generator=rng, device=DEVICE) * 0.3
        pad = 5 if cache else 0
        t = torch.randn(batch, shape[0] + pad, *shape[1:], generator=rng, device=DEVICE)
        return (t * 0.3)[:, pad:]

    return rand


def lib_input(cache, x):
    """``[cache; x]`` as F.conv1d takes it, (B, C, time)."""
    h = torch.cat([cache, x], dim=-2)
    return (h if h.dim() == 3 else h[None]).transpose(1, 2).contiguous()


def conv_plan(layer, batch: int, t_out: int, wd) -> tuple:
    """causal_conv's (arm, tile, steps per block) for ``batch`` streams of
    ``t_out`` output rows of ``layer`` with ``wd`` weights."""
    return _conv_plan(batch, t_out, layer.in_channels, layer.out_channels, layer.kernel_size,
                      layer.stride, layer.dilation, wd == torch.bfloat16)


def conv_site(name, layer, rows, stride, bias, wd, rand, batch, leaky=None, tanh=False):
    """One causal_conv launch as a Site (``leaky`` / ``tanh`` as the
    receiver's output conv fuses them; the yardstick is the bare conv). Its
    bound counts the operations at the rate of its weights' products where
    the planner puts it on the GEMM arm, at the f32 rate on the Cin = 1 and
    Cout = 1 arms."""
    cin, cout, k = layer.in_channels, layer.out_channels, layer.kernel_size
    cache, x = rand((k - 1) * layer.dilation, cin, cache=True), rand(rows, cin)
    w = conv_weight(layer, wd)
    b = None if not bias else layer.bias.detach().float().contiguous()
    x_lib, w_lib = lib_input(cache, x), layer.weight.detach().float()
    t_out = rows // stride
    plan = conv_plan(layer, batch, t_out, wd)
    return Site("causal_conv", name,
                lambda: causal_conv(cache, x, w, b, stride, 1, leaky, tanh),
                lambda: causal_conv_plain(cache, x, w, b, stride, 1, leaky, tanh),
                lambda: F.conv1d(x_lib, w_lib, b, stride),
                2.0 * batch * t_out * k * cin * cout,
                nbytes(cache, x, w, b) + 4 * batch * t_out * cout, (cache, x),
                gemm_rate(wd) if plan[0] == "gemm" else F32_FLOPS, plan)


def upsample_site(name, layer, rows, wd, rand, batch, leaky=None, rounding=None):
    """One causal_conv_transpose launch as a Site (``leaky`` and
    ``rounding`` as the receiver's upsamples fuse them; the yardstick is the
    bare transposed conv). Its bound counts the operations at the rate of
    its weights' products (each phase runs on causal_conv's GEMM arm); its
    plan is the planner's (tile, steps per block)."""
    s, cin, cout = layer.stride, layer.in_channels, layer.out_channels
    cache, x = rand(1, cin, cache=True), rand(rows, cin)
    w, b = conv_transpose_weight(layer, wd), layer.bias.detach().float().contiguous()
    x_lib, w_lib = lib_input(cache, x), layer.weight.detach().float()
    args = (cache, x, w, b, s, leaky, rounding)
    checks = rounding_checks("causal_conv_transpose", causal_conv_transpose,
                             causal_conv_transpose_plain, args) \
        if rounding and wd == torch.bfloat16 else (None, None)
    return Site("causal_conv_transpose", name,
                lambda: causal_conv_transpose(*args),
                lambda: causal_conv_transpose_plain(*args),
                lambda: F.conv_transpose1d(x_lib, w_lib, b, s, s),
                2.0 * batch * rows * s * 2 * cin * cout,
                nbytes(cache, x, w, b) + 4 * batch * rows * s * cout, (cache, x),
                gemm_rate(wd), _upsample_plan(batch, rows, cin, cout, s, wd == torch.bfloat16),
                None if rounding != "product" else lambda ref: BF16_STEP * (ref - b).abs(),
                *checks)


def sites(gen, n_frames: int, wd, rng: torch.Generator, batch: int | None = None):
    """Every kernel launch of one main-path dispatch of ``n_frames`` frames,
    as Sites, on random activations of the site's shape and the generator's
    own weights in ``wd``. One stream in the 2-D layout, or ``batch``
    streams in the (B, time, C) layout with each cache a strided view (the
    tail of a longer activation, as on the main path)."""

    rand = make_rand(rng, batch)
    nb = 1 if batch is None else batch
    out = []
    t = n_frames * FRAME
    out.append(conv_site("enc_in", gen.encoder.conv, t, 1, False, wd, rand, nb))
    for bi, blk in enumerate(gen.encoder.blocks):
        out.append(chain_site(f"e{bi}ch", blk, blk.conv.in_channels, t, wd, rand, nb))
        out.append(conv_site(f"e{bi}d", blk.conv, t, blk.conv.stride, True, wd, rand, nb))
        t //= blk.conv.stride
    for bi, blk in enumerate(gen.decoder.blocks):
        out.append(upsample_site(f"d{bi}u", blk.conv, t, wd, rand, nb))
        t *= blk.conv.stride
        out.append(chain_site(f"d{bi}ch", blk, blk.conv.out_channels, t, wd, rand, nb))
    out.append(conv_site("dec_out", gen.decoder.conv2, t, 1, False, wd, rand, nb))
    return out


CONV_PLAN_SHAPES = ((1, 1), (1, DISPATCH), (1, THROUGHPUT_FRAMES), (BATCH, 1), (BATCH, 16),
                    (64, 1), (64, 16))


def upsample_layers(model) -> list:
    """``(site, layer, input rows a frame)`` of every causal_conv_transpose
    launch of one dispatch of a codec generator or a HiFiGAN receiver."""
    if isinstance(model, HiFiGANGenerator):
        prefix, layers, t = "v", list(model.upsamples), FRAME // model.total_upsample
    else:
        prefix, layers, t = "d", [blk.conv for blk in model.decoder.blocks], FRAME // model.hop
    out = []
    for i, layer in enumerate(layers):
        out.append((f"{prefix}{i}u", layer, t))
        t *= layer.stride
    return out


def conv_plans(models: dict) -> dict:
    """Phase 1: causal_conv's (arm, tile, steps per block) and
    causal_conv_transpose's (tile, steps per block) at every site of each
    path's models, bf16 weights, at one stream of 1, 100 and 400 frames and
    16 and 64 streams of 1 and 16; logged at one stream of one frame."""
    report = {}
    for path, model in models.items():
        report[path] = {f"B{b}_N{n}": {
            **{site: list(conv_plan(layer, b, rows * n, torch.bfloat16))
               for site, layer, rows in conv_sites(model, FRAME)},
            **{site: list(_upsample_plan(b, rows * n, layer.in_channels, layer.out_channels,
                                         layer.stride, True))
               for site, layer, rows in upsample_layers(model)}}
            for b, n in CONV_PLAN_SHAPES}
        log(f"{path} conv plans (causal_conv: arm, tile, steps per block; upsamples: tile, "
            f"steps per block) at one stream, one frame: {report[path]['B1_N1']}")
    return report


def chain_site(name, blk, c, t, wd, rand, batch):
    """One residual_chain launch as a Site (no one-call yardstick exists). Its
    bound counts the operations at the rate of its weights' products; its
    plan is the planner's (tile, cluster)."""
    cache, x = rand(chain_halo(), c, cache=True), rand(t, c)
    w1, w2 = chain_weights(blk.res_units, wd)
    args = (cache, x, w1, w2)
    checks = rounding_checks("residual_chain", residual_chain, residual_chain_plain, args) \
        if wd == torch.bfloat16 else (None, None)
    return Site("residual_chain", name,
                lambda: residual_chain(*args),
                lambda: residual_chain_plain(*args),
                None, batch * chain_flops(c, t), nbytes(cache, x, w1, w2) + 4 * batch * t * c,
                (cache, x), gemm_rate(wd),
                _chain_plan(batch, t, c, DILATIONS, wd == torch.bfloat16), None, *checks)


def codec_sites(gen, tables, z_real, n_frames: int, wd, rng: torch.Generator,
                batch: int | None = None):
    """The four launches the codec adds to a dispatch of ``n_frames`` frames
    of one stream, or of ``batch`` streams (projector, rvq_assign,
    codebook_lookup, decoder input conv), as Sites. The search runs on real
    projector outputs ``z_real`` of the codec and the lookup on their
    codes."""
    books, sqnorm, books_t = tables
    n_books, dim, book_k = books.shape
    nb = 1 if batch is None else batch
    rows = n_frames * FRAME // gen.hop
    require(z_real.shape[0] >= nb * rows, f"{z_real.shape[0]} projector rows for {nb * rows}")
    z = z_real[:nb * rows].contiguous()
    codes = rvq_assign_plain(z, books, sqnorm)
    codes_lib, flat_cb = codes.long(), books_t.reshape(n_books * book_k, dim)
    used = int(torch.unique(codes).numel())  # codewords this lookup reads

    rand = make_rand(rng, batch)
    return [
        conv_site("prj", gen.projector.conv, rows, 1, False, wd, rand, nb),
        Site("rvq_assign", "rvq", lambda: rvq_assign(z, books, sqnorm, books_t),
             lambda: rvq_assign_plain(z, books, sqnorm), None,
             nb * rows * n_books * (2.0 * dim * book_k + 3.0 * book_k),
             nbytes(z, books, sqnorm, codes), None),
        Site("codebook_lookup", "lookup", lambda: codebook_lookup(codes, books_t),
             lambda: codebook_lookup_plain(codes, books_t),
             lambda: F.embedding_bag(codes_lib, flat_cb, mode="sum"),
             float(nb * rows * n_books * dim),
             nbytes(codes) + used * dim * 4 + nb * rows * dim * 4, None),
        conv_site("dec_in", gen.decoder.conv1, rows, 1, False, wd, rand, nb),
    ]


def kernel_limit(kernel, wd, scale) -> float:
    """A kernel's tolerance against its plain version, at weights ``wd`` and
    the largest |output| ``scale``: with bf16 weights, for the kernels that
    round an intermediate sum, on exact-sum weights (rounding_checks)."""
    limit = KERNEL_ATOL_F32 if wd == torch.float32 else KERNEL_RTOL_BF16 * scale
    return min(limit, CHAIN_ATOL) if kernel == "residual_chain" else limit


# the argument positions of a rounding kernel's weights
WEIGHT_ARGS = {"residual_chain": (2, 3), "hifigan_unit": (3, 5), "causal_conv_transpose": (2,)}


def exact_weights(name, args, kwargs=None):
    """``args`` with a rounding kernel's weights replaced by
    utils/checks.py::exact_sum_weights of theirs (an upsample's phases each
    reading one term of their own tap pair)."""
    args = list(args)
    for i in WEIGHT_ARGS[name]:
        w = args[i]
        if name == "residual_chain" and i == 3:  # w2 (3, C, C): one tap
            args[i] = exact_sum_weights(w[:, None], i)[:, 0]
        elif name == "causal_conv_transpose":
            s = args[4] if len(args) > 4 else (kwargs or {}).get("stride", 1)
            args[i] = exact_sum_weights(w, i, [(s - 1 - p, 2 * s - 1 - p) for p in range(s)])
        else:
            args[i] = exact_sum_weights(w, i)
    return tuple(args)


def unrounded_weights(name, args):
    """``args`` with a rounding kernel's weights cast to f32: its plain
    version then multiplies unrounded operands, as the port did before it
    rounded them."""
    return tuple(a.float() if i in WEIGHT_ARGS[name] else a for i, a in enumerate(args))


def rounding_checks(name, fn, plain, args, kwargs=None, wrap=lambda out: out):
    """(unrounded, exact) of a bf16-weight launch of a kernel that rounds an
    intermediate sum: its plain version on unrounded operands, and (kernel,
    plain, unrounded plain) on exact-sum weights, each a thunk of
    ``wrap(output)``."""
    kwargs = kwargs or {}
    exact = exact_weights(name, args, kwargs)
    loose, exact_loose = unrounded_weights(name, args), unrounded_weights(name, exact)
    return (lambda: wrap(plain(*loose, **kwargs)),
            (lambda: wrap(fn(*exact, **kwargs)), lambda: wrap(plain(*exact, **kwargs)),
             lambda: wrap(plain(*exact_loose, **kwargs))))


def check_exact(what, kernel, exact, limit_of) -> tuple[float, float]:
    """A rounding kernel on exact-sum weights: within ``limit_of(ref)`` of
    its plain version, with the unrounded plain version at least
    ROUNDING_GAP times that away; returns (max |err|, that distance over
    the tolerance)."""
    got, ref, loose = (f().float() for f in exact)
    torch.cuda.synchronize()
    limit = limit_of(ref)
    err, gap = float((got - ref).abs().max()), float((loose - ref).abs().max())
    require(err <= limit, f"{what}: on exact-sum weights max|err| {err} > {limit}")
    require(gap >= ROUNDING_GAP * limit, f"{what}: on exact-sum weights the unrounded "
            f"operands are only {gap} away ({ROUNDING_GAP} x {limit} wanted)")
    return err, gap / limit


def check_site(st, n_frames, wd, site=None) -> float:
    """A conv or chain Site's kernel against its plain version; max |err|.
    A kernel that rounds an intermediate sum (``st.exact`` set, bf16
    weights) is held by rounding_held on these weights (a rounded product's
    one bf16 step, ``st.step(ref)``, added to its bound element by element)
    and within its tolerance on exact-sum weights (check_exact)."""
    kernel, site = st.kernel, site or st.site
    got, ref = st.run(), st.plain()
    torch.cuda.synchronize()
    require(got.shape == ref.shape, f"{kernel} {site}: shape {tuple(got.shape)} "
            f"vs plain {tuple(ref.shape)}")
    what = f"{kernel} {site} n={n_frames} {wd}"
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    limit = kernel_limit(kernel, wd, scale)
    extra = ""
    if st.exact is not None:
        bound = None if st.step is None else limit + st.step(ref)
        held = rounding_held(got, ref, st.unrounded(), bound)
        require(held["held"], f"{what}: {held}")
        exact_err, gap = check_exact(what, kernel, st.exact,
                                     lambda r: kernel_limit(kernel, wd, float(r.abs().max())))
        extra = (f" rms share {held['rms_share']:.3f}; exact sums: max|err|={exact_err:.3e}, "
                 f"unrounded {gap:.0f}x the tolerance away")
    else:
        require(err <= limit, f"{what}: max|err| {err} > {limit}")
    log(f"check {kernel:22s} {site:7s} frames={n_frames:<4d} {str(wd):14s} "
        f"max|err|={err:.3e} max|ref|={scale:.3e}{extra}")
    return err


def check_kernels(gen, rng):
    """Phase 2, denoiser: every site's kernel against its plain version."""
    worst = {name: 0.0 for name in DENOISER_KERNELS}
    for n_frames in SIZES:
        for wd in (torch.float32, torch.bfloat16):
            for st in sites(gen, n_frames, wd, rng):
                err = check_site(st, n_frames, wd)
                worst[st.kernel] = max(worst[st.kernel], err)
    return worst


def check_search(what, z, tables, n_frames):
    """rvq_assign on ``z`` up to near ties and codebook_lookup on the plain
    codes, against their plain versions. A bad code must not be read (its
    row is the sum of the other books' codewords) and must raise where the
    lookup documents it: at ``check_codes`` after a synchronisation, not
    before the card has run the call. Returns (near-tie rows, largest
    distance excess, lookup max |err|)."""
    books, sqnorm, books_t = tables
    got, ref = rvq_assign(z, books, sqnorm, books_t), rvq_assign_plain(z, books, sqnorm)
    torch.cuda.synchronize()
    require(got.shape == ref.shape and got.dtype == torch.int32,
            f"rvq_assign: codes {tuple(got.shape)} {got.dtype} vs plain {tuple(ref.shape)}")
    held = rvq_near_ties(z, books, sqnorm, got, ref, CODE_RTOL)
    require(held["mismatches"] == 0, f"rvq_assign {what}: {held}")
    zq, zq_ref = codebook_lookup(ref, books_t), codebook_lookup_plain(ref, books_t)
    torch.cuda.synchronize()
    err = float((zq - zq_ref).abs().max())
    require(err <= LOOKUP_ATOL, f"codebook_lookup {what}: max|err| {err}")
    bad = ref.clone()
    bad[-1, -1] = 0  # the last book's range starts at (L-1)*K
    check_codes(DEVICE)
    zq_bad = codebook_lookup(bad, books_t)
    torch.cuda.synchronize()
    try:
        check_codes(DEVICE)
        raise Failure("codebook_lookup took a code outside its book")
    except ValueError:
        pass
    kept = codebook_lookup_plain(ref[-1:, :-1].contiguous(), books_t[:-1].contiguous())
    require(torch.equal(zq_bad[-1:], kept) and torch.equal(zq_bad[:-1], zq[:-1]),
            f"codebook_lookup {what}: a bad code's term is not zero")
    log(f"check rvq_assign / codebook_lookup {what} frames={n_frames:<4d} rows={z.shape[0]}: "
        f"near-tie rows {held['ties']}, mismatches 0; lookup max|err|={err:.3e}")
    return held["ties"], held["max_excess"], err


def check_codec_kernels(gen, tables, z_real, rng):
    """Phase 2, codec: the search up to near ties, the lookup to
    LOOKUP_ATOL, the projector and input conv as the other convs. Returns
    the worst error per kernel (for the search: the largest distance excess
    of a near-tie pick) and the near-tie rows."""
    worst = {"causal_conv": 0.0, "rvq_assign": 0.0, "codebook_lookup": 0.0}
    ties = 0
    for n_frames in SIZES:
        rows = n_frames * FRAME // gen.hop
        n_ties, excess, err = check_search("one stream", z_real[:rows].contiguous(), tables,
                                           n_frames)
        ties += n_ties
        worst["rvq_assign"] = max(worst["rvq_assign"], excess)
        worst["codebook_lookup"] = max(worst["codebook_lookup"], err)
        for wd in (torch.float32, torch.bfloat16):
            for st in codec_sites(gen, tables, z_real, n_frames, wd, rng):
                if st.kernel == "causal_conv":
                    err = check_site(st, n_frames, wd)
                    worst[st.kernel] = max(worst[st.kernel], err)
    return worst, ties


def check_no_leak(st) -> None:
    """Perturb stream 0 of a layer site's cache and input: its output must
    change and every other stream's must stay bit for bit as it was."""
    cache, x = st.inputs
    before = st.run()
    cache[0] += 1.0
    x[0] -= 1.0
    after = st.run()
    torch.cuda.synchronize()
    require(not torch.equal(after[0], before[0]), f"{st.kernel} {st.site}: stream 0 "
            "did not change")
    require(torch.equal(after[1:], before[1:]), f"{st.kernel} {st.site}: stream 0 "
            "leaked into the others")


def check_batched_kernels(gen, codec, tables, z_real, rng):
    """Phase 2, batch axis: every site of both models at each (streams,
    frames) of BATCH_CHECKS with f32 weights against its plain version, and
    no layer kernel lets one stream reach another. Returns the worst error
    per kernel and the search's near-tie rows."""
    worst = {name: 0.0 for name in KERNELS}
    ties = 0
    for batch, n_frames in BATCH_CHECKS:
        rows = batch * n_frames * FRAME // codec.hop
        n_ties, excess, err = check_search(f"{batch} streams", z_real[:rows].contiguous(),
                                           tables, n_frames)
        ties += n_ties
        worst["rvq_assign"] = max(worst["rvq_assign"], excess)
        worst["codebook_lookup"] = max(worst["codebook_lookup"], err)
        layer_sites = (sites(gen, n_frames, torch.float32, rng, batch)
                       + [st for st in codec_sites(codec, tables, z_real, n_frames,
                                                   torch.float32, rng, batch)
                          if st.inputs is not None])
        for st in layer_sites:
            err = check_site(st, n_frames, torch.float32, f"{st.site}x{batch}")
            worst[st.kernel] = max(worst[st.kernel], err)
            check_no_leak(st)
        log(f"check batch axis streams={batch} frames={n_frames}: {len(layer_sites)} layer "
            f"sites hold their plain versions; no stream leaks; chain (tile, cluster) "
            f"{chain_plans(gen, batch, n_frames)}")
        del layer_sites
    return worst, ties


# ---------------------------------------------------------------- main path


def frames_for(n: int, seed: int) -> torch.Tensor:
    """Noisy harmonic test audio, (n, 1, FRAME, 1) on the card."""
    return frames_for_streams(n, 1, seed)


def frames_for_streams(n: int, batch: int, seed: int) -> torch.Tensor:
    """Noisy harmonic test audio of ``batch`` streams, each at its own
    pitch: (n, batch, FRAME, 1) on the card."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * FRAME) / SAMPLE_RATE
    pitch = 220.0 * (1.0 + 0.05 * np.arange(batch))[:, None]
    audio = 0.3 * np.sin(2 * np.pi * pitch * t) + 0.1 * rng.standard_normal((batch, t.size))
    audio = torch.from_numpy(audio.astype(np.float32)).reshape(batch, n, FRAME, 1)
    return audio.transpose(0, 1).contiguous().to(DEVICE)


def stream(run, frames, split):
    cache, outs, i = run.init_cache(), [], 0
    for n in split:
        y, cache = run(cache, frames[i:i + n])
        outs.append(y)
        i += n
    return torch.cat(outs)


def stream_codes(run, frames, split):
    """As :func:`stream` through ``run.run_with_codes``: (audio, codes (N,
    T_code, L), or (N, B, T_code, L) for B > 1 streams)."""
    cache, outs, codes, i = run.init_cache(), [], [], 0
    for n in split:
        y, cache, c = run.run_with_codes(cache, frames[i:i + n])
        outs.append(y)
        codes.append(c)
        i += n
    return torch.cat(outs), torch.cat(codes)


def counted(path: str, per_dispatch: int, dispatches: int, kernels, drive):
    """Run ``drive()`` with every launch counter set to 0 just before and
    read just after; require each of ``kernels`` launched and
    ``per_dispatch`` launches in each of ``dispatches`` dispatches. Returns
    (drive's result, counts)."""
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    result = drive()
    torch.cuda.synchronize()
    launches = {name: spec["fn"].launches for name, spec in KERNELS.items()}
    log(f"{path} path launches", json.dumps(launches))
    for name in kernels:
        require(launches[name] > 0, f"the {path} path never launched {name}")
    want = per_dispatch * dispatches
    total = sum(launches.values())
    require(total == want, f"the {path} path made {total} launches, not {want}")
    return result, launches


def main_path(gen):
    """Phase 3, denoiser. Returns the launch counts of the main path's run."""
    frames = frames_for(sum(MAIN_FRAMES), SEED)
    run = make_scan_stream(gen, frame_size=FRAME)
    require(run.backend == "cuda", f"'auto' resolved to {run.backend!r}, not 'cuda'")
    out, launches = counted("denoiser", LAUNCHES_PER_DISPATCH["denoiser"], len(MAIN_FRAMES),
                            DENOISER_KERNELS, lambda: stream(run, frames, MAIN_FRAMES))

    eager = make_scan_stream(gen, frame_size=FRAME, backend="eager")
    ref = stream(eager, frames, MAIN_FRAMES)
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"main path output {tuple(out.shape)} not finite or not the frames' shape")
    scale = float(ref.abs().max())
    err_bf16 = float((out - ref).abs().max())
    log(f"main path bf16 weights vs eager: max|err|={err_bf16:.3e} max|ref|={scale:.3e}")
    require(err_bf16 <= MAIN_RTOL_BF16 * scale, "bf16 main path disagrees with eager")

    run_f32 = make_scan_stream(gen, frame_size=FRAME, weight_dtype=torch.float32)
    out_f32 = stream(run_f32, frames, MAIN_FRAMES)
    err_f32 = float((out_f32 - ref).abs().max())
    log(f"main path f32 weights vs eager: max|err|={err_f32:.3e}")
    require(err_f32 <= MAIN_ATOL_F32, "f32 main path disagrees with eager")

    n_cpu = 3
    gen_cpu = copy.deepcopy(gen).to("cpu")
    cpu = make_scan_stream(gen_cpu, frame_size=FRAME, device="cpu")
    ref_cpu = stream(cpu, frames[:n_cpu].cpu(), (n_cpu,))
    err_cpu = float((out_f32[:n_cpu].cpu() - ref_cpu).abs().max())
    log(f"main path f32 weights vs CPU eager ({n_cpu} frames): max|err|={err_cpu:.3e}")
    require(err_cpu <= MAIN_ATOL_F32, "main path disagrees with the CPU")

    chain = make_scan_stream(gen, frame_size=FRAME, backend="cuda_chain")
    require(chain.backend == "cuda_chain", "cuda_chain route not taken")
    n_chain = 20
    out_chain = stream(chain, frames[:n_chain], (n_chain,))
    err_chain = float((out_chain - ref[:n_chain]).abs().max())
    log(f"cuda_chain vs eager ({n_chain} frames): max|err|={err_chain:.3e}")
    require(err_chain <= MAIN_ATOL_F32, "cuda_chain route disagrees with eager")
    return launches, {"bf16_vs_eager": err_bf16, "f32_vs_eager": err_f32,
                      "f32_vs_cpu": err_cpu, "cuda_chain_vs_eager": err_chain,
                      "eager_max_abs": scale}


# ---------------------------------------------------------------- codec


def streamed_z(gen, frames):
    """The projector output of each frame of frames (N, B, F, 1) as the
    eager route computes it (per-frame ``encode_step`` with carried caches):
    (N, B, T_code, D)."""
    cache, zs = gen.init_cache(frames.shape[1]), []
    with torch.no_grad():
        for frame in frames:
            z, enc_cache = gen.encode_step(cache, frame)
            cache.update(enc_cache)
            zs.append(z)
    return torch.stack(zs)


def codec_vq_state(gen) -> VQState:
    """Codebooks as a k-means init draws them: book by book, K rows sampled
    from the residuals of a seeded warm-up stream (not the stream under
    test), which then move on by their nearest codeword. A drawn row's
    residual becomes zero, so each book draws from rows no earlier book drew.
    (Seeded N(0, 1) books under an untrained encoder would give most rows the
    same few codes, and the code checks would prove little.)"""
    q = gen.quantizer
    audio = frames_for(WARMUP_FRAMES, SEED + 10).reshape(1, -1, 1)
    with torch.no_grad():
        z, _ = gen.encode_step(gen.init_cache(1), audio)
    r = z.reshape(-1, q.code_dim)
    require(r.shape[0] >= (q.codebook_num + 1) * q.codebook_size,
            "warm-up stream too short to draw every book from rows of its own")
    pick = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    books = []
    for _ in range(q.codebook_num):
        order = torch.randperm(r.shape[0], generator=pick, device=DEVICE)
        book = r[order[:q.codebook_size]].t().contiguous()
        r = r[order[q.codebook_size:]]
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ book) + (book * book).sum(0)
        r = r - book.t()[torch.argmin(dist, 1)]
        books.append(book)
    embed = torch.stack(books)
    return VQState(embed, torch.zeros(embed.shape[0], embed.shape[2], device=DEVICE),
                   embed.clone())


def held_codes(what, z, tables, codes, ref):
    """Require ``codes`` equal to ``ref`` up to near ties; the number of
    frames before the first differing one (the audio is compared there)."""
    n_frames, z_rows, n_books = ref.shape
    books, sqnorm, _ = tables
    held = rvq_near_ties(z.reshape(-1, z.shape[-1]), books, sqnorm,
                         codes.reshape(-1, n_books), ref.reshape(-1, n_books), CODE_RTOL)
    require(held["mismatches"] == 0, f"{what}: codes disagree beyond near ties: {held}")
    differ = (codes != ref).reshape(n_frames, -1).any(1).nonzero()
    agree = int(differ[0, 0]) if differ.numel() else n_frames
    log(f"{what}: codes equal but {held['ties']} near-tie rows (max distance excess "
        f"{held['max_excess']:.3e}); audio compared over the first {agree} frames")
    require(agree > 0, f"{what}: the first frame already differs at a near tie")
    return held, agree


def codec_path(gen, vq, tables):
    """Phase 3, codec. Returns the launch counts of the main path's run, its
    checks, and (the route's f32 wire codes, the eager route's, the eager
    projector outputs) of its frames."""
    frames = frames_for(sum(MAIN_FRAMES), SEED)
    n_books = vq.embed.shape[0]
    try:
        make_scan_stream(gen, vq)
        raise Failure("the codec's 'auto' route without frame_size did not raise")
    except ValueError:
        pass  # it does not give way to the plain modules on the card
    run = make_scan_stream(gen, vq, frame_size=FRAME, weight_dtype=torch.float32)
    require(run.backend == "cuda", f"'auto' resolved to {run.backend!r}, not 'cuda'")
    (out, codes), launches = counted("codec", LAUNCHES_PER_DISPATCH["codec"],
                                     len(MAIN_FRAMES), CODEC_KERNELS,
                                     lambda: stream_codes(run, frames, MAIN_FRAMES))
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"codec output {tuple(out.shape)} not finite or not the frames' shape")
    require(codes.dtype == torch.int32 and tuple(codes.shape) == (
        sum(MAIN_FRAMES), FRAME // gen.hop, n_books), f"codes {tuple(codes.shape)}")
    distinct = [int(torch.unique(codes[..., l]).numel()) for l in range(n_books)]
    log(f"codec distinct codes per book over {sum(MAIN_FRAMES)} frames: {distinct}")
    require(min(distinct) >= MIN_DISTINCT_CODES,
            f"a book used fewer than {MIN_DISTINCT_CODES} codes: {distinct}")

    eager = make_scan_stream(gen, vq, frame_size=FRAME, backend="eager")
    require(eager.backend == "eager", "eager route not taken")
    ref, ref_codes = stream_codes(eager, frames, MAIN_FRAMES)
    z_eager = streamed_z(gen, frames)
    held, agree = held_codes("codec f32 route vs eager", z_eager, tables, codes, ref_codes)
    err_f32 = float((out[:agree] - ref[:agree]).abs().max())
    log(f"codec f32 route vs eager ({agree} frames): max|err|={err_f32:.3e} "
        f"max|ref|={float(ref.abs().max()):.3e}")
    require(err_f32 <= MAIN_ATOL_F32, "codec f32 route disagrees with eager")

    n_cpu = 3
    gen_cpu = copy.deepcopy(gen).to("cpu")
    vq_cpu = VQState(*(t.cpu() for t in vq))
    tables_cpu = tuple(t.cpu() for t in tables)
    cpu = make_scan_stream(gen_cpu, vq_cpu, frame_size=FRAME, device="cpu")
    frames_cpu = frames[:n_cpu].cpu()
    ref_cpu, codes_cpu = stream_codes(cpu, frames_cpu, (n_cpu,))
    _, agree_cpu = held_codes("codec f32 route vs CPU eager",
                              streamed_z(gen_cpu, frames_cpu), tables_cpu,
                              codes[:n_cpu].cpu(), codes_cpu)
    err_cpu = float((out[:agree_cpu].cpu() - ref_cpu[:agree_cpu]).abs().max())
    log(f"codec f32 route vs CPU eager ({agree_cpu} frames): max|err|={err_cpu:.3e}")
    require(err_cpu <= MAIN_ATOL_F32, "codec route disagrees with the CPU")

    # the endpoints' kernel routes at f32 weights: the transmitter's codes
    # against the route's; the receiver decodes the route's own codes, so its
    # audio is held over every frame, near ties or not
    tx = StreamingTransmitter(gen, vq)
    rx = StreamingReceiver(gen, vq, weight_dtype=torch.float32)
    require((tx.backend, rx.backend) == ("cuda", "cuda"),
            f"the codec's endpoints took {tx.backend!r} / {rx.backend!r}, not 'cuda'")
    tx_codes = torch.stack([tx.encode(frame)[:, 0].t() for frame in frames])
    rx_out = torch.stack([rx.decode(c.t()[:, None]) for c in codes])
    held_tx, _ = held_codes("StreamingTransmitter vs the codec route", z_eager, tables,
                            codes, tx_codes)
    err_txrx = float((rx_out - out).abs().max())
    log(f"StreamingReceiver on the route's codes vs the route ({len(frames)} frames): "
        f"max|err|={err_txrx:.3e}")
    require(err_txrx <= MAIN_ATOL_F32, "the receiver disagrees with the codec route")

    run16 = make_scan_stream(gen, vq, frame_size=FRAME)
    out16, codes16 = stream_codes(run16, frames, MAIN_FRAMES)
    share16 = float((codes16 == codes).float().mean())
    err16 = float((out16 - out).abs().max())
    log(f"codec bf16 weights vs f32 route (no bound): {share16:.4f} of codes equal, "
        f"audio max|err|={err16:.3e}")
    return launches, {"f32_vs_eager": err_f32, "f32_vs_eager_frames": agree,
                      "near_tie_rows_vs_eager": held["ties"], "f32_vs_cpu": err_cpu,
                      "rx_vs_route": err_txrx, "near_tie_rows_tx_vs_route": held_tx["ties"],
                      "distinct_codes": distinct,
                      "bf16_code_share_equal_f32": share16, "bf16_vs_f32_audio": err16,
                      "eager_max_abs": float(ref.abs().max())}, (codes, ref_codes, z_eager)


# ---------------------------------------------------------------- many streams


def eager_asymmetric(tx, vq, rx, rx_vq, frames):
    """The asymmetric codec receiver composed of plain modules, frame by
    frame on B streams: ``tx`` encodes and quantizes with ``vq``, ``rx``
    looks the codes up in ``rx_vq`` and decodes. (audio, codes (N, B,
    T_code, L))."""
    batch = frames.shape[1]
    tx_cache, rx_cache = tx.init_cache(batch), rx.init_cache(batch)
    flat_cb, outs, codes = rx.flat_codebook(rx_vq), [], []
    with torch.no_grad():
        for frame in frames:
            z, enc_cache = tx.encode_step(tx_cache, frame)
            tx_cache.update(enc_cache)
            idx = tx.quantize(vq, z)
            codes.append(idx.permute(1, 2, 0))
            y, dec_cache = rx.decode_step(rx_cache, rx.lookup(flat_cb, idx))
            rx_cache.update(dec_cache)
            outs.append(y)
    return torch.stack(outs), torch.stack(codes)


def per_stream(what, z, tables, out, codes, ref, ref_codes):
    """Hold each stream of ``out`` (N, B, F, 1) against ``ref``: with PQC
    the codes (N, B, T_code, L) up to near ties along the reference's ``z``,
    and the audio at MAIN_ATOL_F32 over the frames before a stream's first
    differing code (a near tie changes the audio after it). At least half
    of all stream-frames must be compared."""
    n, batch = out.shape[:2]
    err, ties, compared = 0.0, 0, 0
    for b in range(batch):
        agree = n
        if codes is not None:
            books, sqnorm, _ = tables
            held = rvq_near_ties(z[:, b].reshape(-1, z.shape[-1]), books, sqnorm,
                                 codes[:, b].reshape(-1, codes.shape[-1]),
                                 ref_codes[:, b].reshape(-1, codes.shape[-1]), CODE_RTOL)
            require(held["mismatches"] == 0, f"{what} stream {b}: codes disagree beyond "
                    f"near ties: {held}")
            ties += held["ties"]
            differ = (codes[:, b] != ref_codes[:, b]).reshape(n, -1).any(1).nonzero()
            agree = int(differ[0, 0]) if differ.numel() else n
        if agree:
            err = max(err, float((out[:agree, b] - ref[:agree, b]).abs().max()))
        compared += agree
    log(f"{what}: {batch} streams, max|err|={err:.3e} over {compared} of {n * batch} "
        f"stream-frames" + (f", {ties} near-tie code rows" if codes is not None else ""))
    require(err <= MAIN_ATOL_F32, f"{what}: max|err| {err} > {MAIN_ATOL_F32}")
    require(2 * compared >= n * batch, f"{what}: near ties left {compared} stream-frames")
    return {"max_abs_err": err, "near_tie_rows": ties, "stream_frames_compared": compared}


def multi_stream_path(path, gen, vq, tables, rx=None):
    """Phase 3, BATCH streams of ``path`` ('denoiser' or 'codec') with f32
    weights through ``make_scan_stream(batch=BATCH)`` and the one-card
    ``make_sharded_stream``, each run with the launch counts set to 0
    before and read after. ``rx`` is the asymmetric receiver's (codec,
    books). Returns the launch counts of both runs and the checks."""
    use_pqc = vq is not None
    kernels = CODEC_KERNELS if use_pqc else DENOISER_KERNELS
    per_dispatch = LAUNCHES_PER_DISPATCH[path]
    frames = frames_for_streams(sum(MULTI_FRAMES), BATCH, SEED + 20)
    n = frames.shape[0]
    run = make_scan_stream(gen, vq, batch=BATCH, frame_size=FRAME,
                           weight_dtype=torch.float32)
    require(run.backend == "cuda", f"'auto' resolved to {run.backend!r} for {BATCH} "
            "streams, not 'cuda'")

    def drive(r, x):
        return stream_codes(r, x, MULTI_FRAMES) if use_pqc else (
            stream(r, x, MULTI_FRAMES), None)

    (out, codes), launches = counted(f"{path} x{BATCH}", per_dispatch, len(MULTI_FRAMES),
                                     kernels, lambda: drive(run, frames))
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"{path} x{BATCH}: output {tuple(out.shape)} not finite or not the frames' shape")
    if use_pqc:
        require(codes.dtype == torch.int32 and tuple(codes.shape) == (
            n, BATCH, FRAME // gen.hop, vq.embed.shape[0]), f"codes {tuple(codes.shape)}")
    z = streamed_z(gen, frames) if use_pqc else None
    checks = {}

    single = make_scan_stream(gen, vq, frame_size=FRAME, weight_dtype=torch.float32)
    singles = [drive(single, frames[:, b:b + 1]) for b in range(BATCH)]
    ref = torch.cat([o for o, _ in singles], 1)
    ref_codes = torch.stack([c for _, c in singles], 1) if use_pqc else None
    checks["vs_single_stream_cuda"] = per_stream(
        f"{path} x{BATCH} vs {BATCH} single-stream 'cuda' runs", z, tables, out, codes,
        ref, ref_codes)

    eager = make_scan_stream(gen, vq, batch=BATCH, backend="eager")
    require(eager.backend == "eager", "eager route not taken")
    ref, ref_codes = drive(eager, frames)
    checks["vs_batched_eager"] = per_stream(
        f"{path} x{BATCH} vs the batched eager route", z, tables, out, codes, ref, ref_codes)

    fleet = make_sharded_stream(gen, vq, batch=BATCH)
    out_fleet, fleet_launches = counted(f"{path} fleet x{BATCH}", per_dispatch,
                                        len(MULTI_FRAMES), kernels,
                                        lambda: stream(fleet, frames, MULTI_FRAMES))
    require(torch.equal(out_fleet, out), f"{path}: make_sharded_stream differs from "
            f"make_scan_stream(batch={BATCH})")
    log(f"{path} make_sharded_stream x{BATCH} equals make_scan_stream(batch={BATCH}) "
        "bit for bit")

    if rx is not None:
        rx_gen, rx_vq = rx
        asym = make_sharded_stream(gen, vq, batch=BATCH, rx_gen=rx_gen, rx_vq_state=rx_vq)
        out_asym = stream(asym, frames, MULTI_FRAMES)
        ref, ref_codes = eager_asymmetric(gen, vq, rx_gen, rx_vq, frames)
        # the fleet's encoder half is the scan stream's: its codes are `codes`
        checks["asymmetric_rx_vs_eager"] = per_stream(
            f"{path} asymmetric receiver x{BATCH} vs its eager composition", z, tables,
            out_asym, codes, ref, ref_codes)
    return {"scan": launches, "fleet": fleet_launches}, checks


def timed_shapes_held(path, gen, vq, tables):
    """Phase 3, every (B, N) that phase 4c times: one dispatch of B streams
    of N frames from zero caches through ``make_scan_stream(batch=B)`` with
    f32 weights, held per stream against the batched eager route on the same
    frames (the frames phase 4c times)."""
    use_pqc = vq is not None
    checks = {}
    for batch in TIME_BATCHES:
        run = make_scan_stream(gen, vq, batch=batch, frame_size=FRAME,
                               weight_dtype=torch.float32)
        require(run.backend == "cuda", f"{path} x{batch}: 'auto' took {run.backend!r}")
        eager = make_scan_stream(gen, vq, batch=batch, backend="eager")
        for n in BATCH_SIZES:
            frames = frames_for_streams(n, batch, SEED + 30)
            if use_pqc:
                (out, codes), (ref, ref_codes) = (stream_codes(r, frames, (n,))
                                                  for r in (run, eager))
                if batch == 1:  # one stream's codes come as (N, T_code, L)
                    codes, ref_codes = codes[:, None], ref_codes[:, None]
            else:
                out, ref = (stream(r, frames, (n,)) for r in (run, eager))
                codes = ref_codes = None
            require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
                    f"{path} x{batch} N={n}: output {tuple(out.shape)}")
            z = streamed_z(gen, frames) if use_pqc else None
            checks[f"B{batch}_N{n}"] = per_stream(
                f"{path} x{batch} N={n} vs the batched eager route", z, tables, out, codes,
                ref, ref_codes)
    return checks


# ---------------------------------------------------------------- vocoder


def build_vocoder(config: str = VOCODER_CONFIG) -> HiFiGANGenerator:
    """The HiFiGAN receiver of ``config`` (by default the AudioDec v1 one) on
    the card, seeded. The statistics file is not in the repository: mean
    N(0, 1) and scale
    U(0.5, 2) of the code dim take its place. Every weight-norm gain g is set
    to the conv's unit gain times U(0.8, 1.25) (1 per output channel of a
    conv; sqrt(k * out / (2 * in)) per input channel of a k = 2s transposed
    conv, whose outputs each sum 2 taps of every input channel), so no layer
    fades to its bias as at the official N(0, 0.01) init; the output conv at
    half that, as the residual blocks' sums grow the signal and the audio
    must stay below tanh's saturation."""
    gp = dict(load_config(config)["generator_params"])
    act = gp.pop("nonlinear_activation")
    require(act == "LeakyReLU", f"{config}: activation {act}")
    gp["negative_slope"] = gp.pop("nonlinear_activation_params")["negative_slope"]
    for key in ("use_weight_norm", "stats"):
        gp.pop(key)
    rng = np.random.default_rng(SEED + 40)
    dim = gp["in_channels"]
    stats = np.stack([rng.standard_normal(dim), rng.uniform(0.5, 2.0, dim)]).astype(np.float32)
    voc = HiFiGANGenerator(**gp, stats=stats, seed=SEED, device=DEVICE)
    with torch.no_grad():
        for m in voc.modules():
            if not getattr(m, "weight_norm", False):
                continue
            gain = 0.5 if m is voc.output_conv else 1.0
            if isinstance(m, ConvTranspose1d):
                gain = (m.kernel_size * m.out_channels / (2.0 * m.in_channels)) ** 0.5
            m.g.copy_(torch.from_numpy(gain * rng.uniform(0.8, 1.25, tuple(m.g.shape))))
    return voc


def unit_site(name, rb, ui, groups, rows, wd, rand, batch, slope, acc=False, scale=1.0):
    """One hifigan_unit launch (unit ``ui`` of the residual block ``rb``) as
    a Site: its output and next conv2 cache along the time axis. With
    ``acc`` it adds a running sum of the unit's output width and scales by
    ``scale`` (a MultiReceptiveField block's last unit). The yardstick is
    the unit's two dilated ``F.conv1d`` calls (grouped as the unit) on
    inputs made ready for them. Its bound counts the operations at the
    rate of its weights' products (``gemm_rate``)."""
    c1, c2 = rb.convs1[ui], rb.convs2[ui]
    gc, k, d = c1.out_channels, c1.kernel_size, c1.dilation
    c = gc // groups
    cin = c if ui == 0 else gc
    cache1, cache2 = rand(c1.pad_length, cin, cache=True), rand(k - 1, gc, cache=True)
    x = rand(rows, cin)
    total = rand(rows, gc) if acc else None
    w1, b1 = conv_weight(c1, wd), c1.bias.detach().float().contiguous()
    w2, b2 = conv_weight(c2, wd), c2.bias.detach().float().contiguous()

    def both(pair):
        return torch.cat(pair, dim=-2)

    a = F.leaky_relu(torch.cat([cache1, x], dim=-2), slope)
    a = a.repeat(*([1] * (a.dim() - 1)), groups) if cin != gc else a
    x1_lib = (a if a.dim() == 3 else a[None]).transpose(1, 2).contiguous()
    h_lib = lib_input(cache2, rand(rows, gc))
    w1_lib, w2_lib = c1.weight.detach().float(), c2.weight.detach().float()
    args = (cache1, cache2, x, w1, b1, w2, b2, d, groups, slope, total, scale)
    checks = rounding_checks("hifigan_unit", hifigan_unit, hifigan_unit_plain, args,
                             wrap=both) if wd == torch.bfloat16 else (None, None)
    return Site("hifigan_unit", name,
                lambda: both(hifigan_unit(*args)),
                lambda: both(hifigan_unit_plain(*args)),
                lambda: (F.conv1d(x1_lib, w1_lib, b1, dilation=d, groups=groups),
                         F.conv1d(h_lib, w2_lib, b2, groups=groups)),
                2 * 2.0 * batch * rows * k * c * gc,
                nbytes(cache1, cache2, x, w1, b1, w2, b2, total)
                + 4 * batch * (rows + k - 1) * gc, (cache1, x), gemm_rate(wd), None, None,
                *checks)


def fusion_units(blk):
    """A fusion block's unit launches as the kernel route makes them:
    ``(site suffix, residual block, unit, groups, adds a running sum, output
    scale)``. MultiGroupConv1d: one grouped block; MultiReceptiveField: per
    block three units, the last adding to the blocks' sum (from block 1 on)
    and the last block's scaling by 1 / blocks."""
    if not isinstance(blk, MultiReceptiveField):
        return [(f"r{ui}", blk.block, ui, blk.groups, False, 1.0)
                for ui in range(len(blk.block.convs1))]
    n, units = len(blk.blocks), []
    for bi, rb in enumerate(blk.blocks):
        for ui in range(len(rb.convs1)):
            last = ui == len(rb.convs1) - 1
            units.append((f"b{bi}r{ui}", rb, ui, 1, last and bi > 0,
                          1.0 / n if last and bi == n - 1 else 1.0))
    return units


def vocoder_sites(voc, n_frames: int, wd, rng: torch.Generator, batch: int | None = None):
    """Every layer-kernel launch of one dispatch of the receiver, as Sites
    (its codebook lookup is the codec's lookup site): the input conv, per
    stage the activated upsample, the fusion block's units (and a
    MultiGroupConv1d's 1x1 fuse), and the activated tanh output conv."""
    rand = make_rand(rng, batch)
    nb = 1 if batch is None else batch
    slope, t = voc.negative_slope, n_frames * FRAME // voc.total_upsample
    out = [conv_site("v_in", voc.input_conv, t, 1, True, wd, rand, nb)]
    for si, (up, blk) in enumerate(zip(voc.upsamples, voc.blocks)):
        out.append(upsample_site(f"v{si}u", up, t, wd, rand, nb, slope, "product"))
        t *= up.stride
        for suffix, rb, ui, groups, acc, scale in fusion_units(blk):
            out.append(unit_site(f"v{si}{suffix}", rb, ui, groups, t, wd, rand, nb, slope,
                                 acc, scale))
        if not isinstance(blk, MultiReceptiveField):
            out.append(conv_site(f"v{si}f", blk.conv_out, t, 1, False, wd, rand, nb))
    out.append(conv_site("v_out", voc.output_conv, t, 1, True, wd, rand, nb, 0.01, True))
    return out


def unit_plans(voc, batch: int, n_frames: int, wd=torch.float32) -> dict:
    """The unit kernel's (tile, cluster) at each unit site for ``batch``
    streams of ``n_frames`` frames with ``wd`` weights."""
    plans, t = {}, n_frames * FRAME // voc.total_upsample
    for si, (up, blk) in enumerate(zip(voc.upsamples, voc.blocks)):
        t *= up.stride
        for suffix, rb, ui, groups, _, _ in fusion_units(blk):
            conv = rb.convs1[ui]
            plans[f"v{si}{suffix}"] = _unit_plan(batch, t, up.out_channels, groups,
                                                 conv.kernel_size, conv.dilation,
                                                 wd == torch.bfloat16)
    return plans


def check_stage0_clusters(voc, what: str) -> dict:
    """One stream of one frame, bf16 weights (the real-time path): every
    stage-0 unit must spread over a cluster of more than one block."""
    plans = unit_plans(voc, 1, 1, torch.bfloat16)
    stage0 = {site: plan for site, plan in plans.items() if site.startswith("v0")}
    require(all(cluster > 1 for _, cluster in stage0.values()),
            f"{what}: a stage-0 unit runs on one block at one stream: {stage0}")
    log(f"{what} unit plans (tile, cluster) at one stream, one frame: {plans}")
    return plans


def check_vocoder_kernels(voc, rng, batch_checks=VOCODER_BATCH_CHECKS):
    """Phase 2, a receiver: every layer site against its plain version for
    one stream (SIZES: 1, 100 and the 400 frames of the throughput dispatch,
    f32 and bf16 weights) and at every (streams, frames) of ``batch_checks``
    (f32, with the stream-leak check)."""
    worst = {"causal_conv": 0.0, "causal_conv_transpose": 0.0, "hifigan_unit": 0.0}
    for n_frames in SIZES:
        for wd in (torch.float32, torch.bfloat16):
            for st in vocoder_sites(voc, n_frames, wd, rng):
                err = check_site(st, n_frames, wd)
                worst[st.kernel] = max(worst[st.kernel], err)
    for batch, n_frames in batch_checks:
        layer_sites = vocoder_sites(voc, n_frames, torch.float32, rng, batch)
        for st in layer_sites:
            err = check_site(st, n_frames, torch.float32, f"{st.site}x{batch}")
            worst[st.kernel] = max(worst[st.kernel], err)
            check_no_leak(st)
        log(f"check receiver batch axis streams={batch} frames={n_frames}: "
            f"{len(layer_sites)} layer sites hold their plain versions; no stream leaks; "
            f"unit plans (tile, cluster) {unit_plans(voc, batch, n_frames)}")
        del layer_sites
    return worst


def joined(codec, vq, voc, batch: int, wd):
    """The receiver's kernel route as ``run(cache, frames (N, B, F, 1))``
    with ``run_with_codes``: the codec's encoder half joined to the vocoder
    half, what ``make_vocoder_scan_stream``'s 'cuda' route (B = 1) and the
    fleet (f32) run."""
    init, fleet = join_halves(mega_encoder(codec, wd, vq), vocoder_half(voc, wd, vq), batch,
                              DEVICE, FRAME)

    def run_with_codes(cache, frames):
        out, new, codes = fleet(cache, frames[..., 0])
        return out[..., None], new, codes

    def run(cache, frames):
        return run_with_codes(cache, frames)[:2]

    run.run_with_codes, run.init_cache = run_with_codes, init
    return run


def eager_vocoder_fleet(codec, vq, voc, batch: int):
    """The receiver's fleet composed of plain modules, frame by frame on B
    streams: encode, quantize, look up in the codec's books, ``voc.step``.
    ``run(cache, frames (N, B, F, 1))`` with ``run_with_codes``."""
    flat_cb = codec.flat_codebook(vq)

    @torch.no_grad()
    def run_with_codes(cache, frames):
        outs, codes = [], []
        for frame in frames:
            z, enc_cache = codec.encode_step(cache["tx"], frame)
            idx = codec.quantize(vq, z)
            y, rx = voc.step(cache["rx"], codec.lookup(flat_cb, idx))
            cache = {"tx": {**cache["tx"], **enc_cache}, "rx": rx}
            outs.append(y)
            codes.append(idx.permute(1, 2, 0))
        return torch.stack(outs), cache, torch.stack(codes)

    def run(cache, frames):
        return run_with_codes(cache, frames)[:2]

    run.run_with_codes = run_with_codes
    run.init_cache = lambda: {"tx": codec.init_cache(batch), "rx": voc.init_cache(batch)}
    return run


def audio_stats(y) -> dict:
    """std of the audio, of its pre-tanh values (atanh of the audio) and the
    share of samples at tanh's saturation."""
    pre = torch.atanh(y.clamp(-1 + 1e-6, 1 - 1e-6))
    return {"audio_std": float(y.std()), "pre_tanh_std": float(pre.std()),
            "saturated_share": float((y.abs() > 0.99).float().mean())}


def vocoder_path(codec, vq, tables, voc, codec_wire, path="vocoder"):
    """Phase 3, a receiver (``path``: 'vocoder' for v1, 'vocoder_v0'):
    ``make_vocoder_scan_stream`` on the card with f32 weights, 200 frames in
    two dispatches of 34 (v1) or 54 (v0) launches. Returns the launch counts
    of that run and the checks."""
    codec_codes, codec_ref_codes, z_eager = codec_wire
    frames4 = frames_for(sum(MAIN_FRAMES), SEED)  # the codec path's frames
    frames = frames4[:, 0, :, 0]
    run = make_vocoder_scan_stream(codec, vq, voc, FRAME, weight_dtype=torch.float32)
    require(run.backend == "cuda", f"'auto' resolved to {run.backend!r}, not 'cuda'")
    out, launches = counted(path, LAUNCHES_PER_DISPATCH[path], len(MAIN_FRAMES),
                            VOCODER_KERNELS, lambda: stream(run, frames, MAIN_FRAMES))
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"receiver output {tuple(out.shape)} not finite or not the frames' shape")
    out_j, codes = stream_codes(joined(codec, vq, voc, 1, torch.float32), frames4, MAIN_FRAMES)
    require(torch.equal(out_j[:, 0, :, 0], out), "the route differs from its joined halves")
    codes = codes[:, 0]
    require(torch.equal(codes, codec_codes), "the receiver path's wire codes differ from "
            "the codec path's")
    log(f"{path} path: wire codes equal the codec path's")
    stats = audio_stats(out)
    log(f"{path} path audio: {json.dumps(stats)}")
    require(stats["audio_std"] >= MIN_AUDIO_STD, f"receiver audio std {stats['audio_std']}")
    require(stats["saturated_share"] <= MAX_SATURATED_SHARE,
            f"{stats['saturated_share']} of the receiver's samples saturate tanh")

    eager = make_vocoder_scan_stream(codec, vq, voc, FRAME, backend="eager")
    require(eager.backend == "eager", "eager route not taken")
    ref = stream(eager, frames, MAIN_FRAMES)
    held, agree = held_codes(f"{path} route codes vs eager", z_eager, tables, codes,
                             codec_ref_codes)
    err_f32 = float((out[:agree] - ref[:agree]).abs().max())
    log(f"{path} f32 route vs eager ({agree} frames): max|err|={err_f32:.3e} "
        f"max|ref|={float(ref.abs().max()):.3e}")
    require(err_f32 <= MAIN_ATOL_F32, f"{path} f32 route disagrees with eager")

    # the route and the receiver half alone with bf16 weights, on the route's
    # codes, against the eager receiver on the same codes (one call over all
    # frames), so every frame is held whatever near ties the eager codes had
    rx_eager = VocoderReceiver(codec, voc, vq, backend="eager")
    wire = codes.reshape(-1, codes.shape[-1]).t()[:, None].contiguous()  # (L, 1, N * T)
    ref_rx = rx_eager.decode(wire).reshape(frames.shape)
    err_rx_f32 = float((out - ref_rx).abs().max())
    log(f"{path} f32 route vs the eager receiver on the route's codes ({len(frames)} "
        f"frames): max|err|={err_rx_f32:.3e}")
    require(err_rx_f32 <= MAIN_ATOL_F32, f"{path} f32 route disagrees with the eager "
            "receiver on its own codes")
    init16, run16 = make_stacked_vocoder(voc, FRAME, 1, torch.bfloat16, vq)
    out16 = run16(init16(), codes[:, None])[0][:, 0]
    scale = float(ref_rx.abs().max())
    err16 = float((out16 - ref_rx).abs().max())
    log(f"{path} receiver bf16 weights vs eager on the route's codes: max|err|={err16:.3e} "
        f"max|ref|={scale:.3e}")
    require(err16 <= MAIN_RTOL_BF16 * scale, f"{path}: bf16 receiver disagrees with eager")

    # VocoderReceiver (kernel route) on a StreamingTransmitter's codes, frame
    # by frame, against the eager receiver on the same codes
    n_rx = 40
    tx = StreamingTransmitter(codec, vq)
    rx = VocoderReceiver(codec, voc, vq, weight_dtype=torch.float32)
    require(rx.backend == "cuda", f"VocoderReceiver took {rx.backend!r}")
    tx_codes = [tx.encode(frame[None, :, None]) for frame in frames[:n_rx]]
    rx_out = torch.cat([rx.decode(c) for c in tx_codes], dim=1)
    rx_ref = VocoderReceiver(codec, voc, vq, backend="eager").decode(torch.cat(tx_codes, -1))
    err_rx = float((rx_out - rx_ref).abs().max())
    log(f"VocoderReceiver on StreamingTransmitter codes vs eager ({n_rx} frames): "
        f"max|err|={err_rx:.3e}")
    require(err_rx <= MAIN_ATOL_F32, f"{path}: VocoderReceiver disagrees with eager")

    run_bf16 = make_vocoder_scan_stream(codec, vq, voc, FRAME)
    err_path16 = float((stream(run_bf16, frames, MAIN_FRAMES) - out).abs().max())
    log(f"{path} path bf16 weights vs f32 route (no bound; codes may differ): "
        f"max|err|={err_path16:.3e}")
    return launches, {"f32_vs_eager": err_f32, "f32_vs_eager_frames": agree,
                      "near_tie_rows_vs_eager": held["ties"], "f32_vs_eager_rx": err_rx_f32,
                      "rx_bf16_vs_eager": err16, "rx_eager_max_abs": scale,
                      "vocoder_receiver_vs_eager": err_rx, "path_bf16_vs_f32": err_path16,
                      "eager_max_abs": float(ref.abs().max()), **stats}


def vocoder_fleet_path(codec, vq, voc, path="vocoder"):
    """Phase 3, a receiver's fleet: ``make_sharded_stream(vocoder=)`` at
    BATCH streams, 16 frames in two dispatches, each stream against its own
    single-stream ``make_vocoder_scan_stream`` run (f32 both)."""
    frames = frames_for_streams(sum(MULTI_FRAMES), BATCH, SEED + 20)
    fleet = make_sharded_stream(codec, vq, batch=BATCH, vocoder=voc)
    out, launches = counted(f"{path} fleet x{BATCH}", LAUNCHES_PER_DISPATCH[path],
                            len(MULTI_FRAMES), VOCODER_KERNELS,
                            lambda: stream(fleet, frames, MULTI_FRAMES))
    require(out.shape == frames.shape and bool(torch.isfinite(out).all()),
            f"{path} fleet output {tuple(out.shape)}")
    single = make_vocoder_scan_stream(codec, vq, voc, FRAME, weight_dtype=torch.float32)
    ref = torch.stack([stream(single, frames[:, b, :, 0], MULTI_FRAMES)
                       for b in range(BATCH)], 1)[..., None]
    checks = per_stream(f"{path} fleet x{BATCH} vs {BATCH} single-stream 'cuda' runs",
                        None, None, out, None, ref, None)
    checks["bit_for_bit"] = torch.equal(out, ref)
    require(checks["bit_for_bit"], f"{path} fleet x{BATCH}: a stream differs from its "
            "single-stream run (the unit kernel's sums must not depend on its plan)")
    log(f"{path} fleet x{BATCH} equals the single-stream runs bit for bit")
    return launches, checks


def vocoder_timed_shapes_held(codec, vq, tables, voc, batches=VOCODER_TIME_BATCHES,
                              path="vocoder"):
    """Phase 3, every (B, N) that phase 4 times for a receiver's fleet: one
    f32 dispatch of the joined halves (the fleet's launches) from zero caches,
    held per stream against the batched eager composition."""
    checks = {}
    for batch in batches:
        run, eager = joined(codec, vq, voc, batch, torch.float32), eager_vocoder_fleet(
            codec, vq, voc, batch)
        for n in (1, 16):
            frames = frames_for_streams(n, batch, SEED + 30)
            (out, codes), (ref, ref_codes) = (stream_codes(r, frames, (n,))
                                              for r in (run, eager))
            checks[f"B{batch}_N{n}"] = per_stream(
                f"{path} x{batch} N={n} vs the batched eager route",
                streamed_z(codec, frames), tables, out, codes, ref, ref_codes)
    return checks


def vocoder_times(codec, vq, voc, rng, batches=VOCODER_TIME_BATCHES, path="vocoder"):
    """Phase 4, a receiver: latency at N = 1 (bf16 weights) and its busy
    share, throughput at N = 400, per-stream-frame time of the fleet (f32)
    against the batched eager route at ``batches`` x N = 1, 16 with busy
    share, launches and cache memory, and the kernel sites."""
    run = make_vocoder_scan_stream(codec, vq, voc, FRAME)
    eager1 = make_vocoder_scan_stream(codec, vq, voc, FRAME, backend="eager")

    def as_batch(r):  # (N, 1, F, 1) frames, as latency() and throughput() give them
        def wrapped(cache, frames):
            return r(cache, frames[:, 0, :, 0])

        wrapped.init_cache = r.init_cache
        return wrapped

    times = {"latency_n1": latency(as_batch(run), 200),
             "latency_n1_eager": latency(as_batch(eager1), 30),
             "throughput": throughput(as_batch(run), THROUGHPUT_FRAMES, 5)}
    times["device_n1"] = device_profile(as_batch(run), frames_for(1, SEED + 3),
                                        times["latency_n1"]["median_ms"])
    for key, val in times.items():
        log(f"{path} {key}", json.dumps(val) if val else "not measured")
    fleet_times = {}
    for batch in batches:
        fleet = make_sharded_stream(codec, vq, batch=batch, vocoder=voc)
        eager = eager_vocoder_fleet(codec, vq, voc, batch)
        for n in (1, 16):
            frames = frames_for_streams(n, batch, SEED + 30)
            counted(f"{path} fleet x{batch} N={n} (one timing dispatch)",
                    LAUNCHES_PER_DISPATCH[path], 1, VOCODER_KERNELS,
                    lambda: fleet(fleet.init_cache(), frames))
            k_ms = dispatch_ms(fleet, frames, 30 if n == 1 else 10)
            e_ms = dispatch_ms(eager, frames, 5 if n == 1 else 2)
            prof = device_profile(fleet, frames, k_ms, 20 if n == 1 else 5)
            mem = cache_memory(fleet, frames)
            per = 1e3 / (batch * n)
            fleet_times[f"B{batch}_N{n}"] = {
                "streams": batch, "frames": n, "kernel_ms": k_ms, "eager_ms": e_ms,
                "us_per_stream_frame": {"kernel": k_ms * per, "eager": e_ms * per},
                "busy_share": prof["busy_share"] if prof else None, "device": prof,
                "memory": mem, "unit_plans": unit_plans(voc, batch, n)}
            log(f"{path} fleet B={batch:<3d} N={n:<3d} us per stream-frame: kernel "
                f"{k_ms * per:.2f}, eager {e_ms * per:.2f}; busy share "
                + (f"{prof['busy_share']:.3f}" if prof else "not measured")
                + f"; cache holds {mem['cache_held_bytes']} B for its own "
                f"{mem['cache_own_bytes']} B, dispatch peak {mem['dispatch_peak_bytes']} B")
    times["fleet"] = fleet_times
    names = ("causal_conv", "causal_conv_transpose", "hifigan_unit")
    ktimes = time_kernels(lambda n, wd: vocoder_sites(voc, n, wd, rng), names,
                          ((1, 30), (DISPATCH, 10), (THROUGHPUT_FRAMES, 3)))
    ktimes_b = time_kernels(lambda n, wd: vocoder_sites(voc, n, wd, rng, BATCH), names,
                            ((1, 20), (BATCH_SIZES[1], 10)))
    return times, ktimes, ktimes_b


def v2_path(codec, vq, tables, v2):
    """The AudioDec v2 receiver (MultiGroupConv1d at 256 channels), first
    run on the card: ``make_vocoder_scan_stream``'s 'auto' route must take
    the kernels; its joined halves (f32) against the eager composition on
    one stream, a dispatch of 1 frame then one of 100, the cache carried."""
    require(make_vocoder_scan_stream(codec, vq, v2, FRAME).backend == "cuda",
            "vctk_v2: 'auto' did not take the kernel route")
    frames = frames_for(sum(V2_FRAMES), SEED + 70)
    run = joined(codec, vq, v2, 1, torch.float32)
    (out, codes), launches = counted("vocoder_v2", LAUNCHES_PER_DISPATCH["vocoder"],
                                     len(V2_FRAMES), VOCODER_KERNELS,
                                     lambda: stream_codes(run, frames, V2_FRAMES))
    ref, ref_codes = stream_codes(eager_vocoder_fleet(codec, vq, v2, 1), frames, V2_FRAMES)
    stats = audio_stats(out)
    log(f"vctk_v2 audio: {json.dumps(stats)}")
    require(stats["audio_std"] >= MIN_AUDIO_STD and
            stats["saturated_share"] <= MAX_SATURATED_SHARE, f"vctk_v2 audio {stats}")
    checks = per_stream("vctk_v2 kernel route vs eager (N = 1, then 100)",
                        streamed_z(codec, frames), tables, out, codes, ref, ref_codes)
    return launches, {**checks, **stats}


def folded_phase(gen, rng):
    """K1f at the denoiser's narrow chains (FOLDED_SITES: C = 32 at fold 1, 2,
    3 and C = 64 at fold 1, 2) on one frame's rows: the counted run of its
    wrapper, then each output against K1 on the same input (equal) and the
    folded plain version (KERNEL_ATOL_F32); times at 1 and 100 frames."""
    sites = []
    for n_frames in (1, DISPATCH):
        for bi, fold in FOLDED_SITES:
            blk = gen.encoder.blocks[bi]
            rows = n_frames * FRAME // math.prod(b.conv.stride for b in gen.encoder.blocks[:bi])
            x = torch.randn(chain_halo() + rows, blk.conv.in_channels, generator=rng,
                            device=DEVICE) * 0.3
            sites.append((n_frames, f"e{bi}ch/fold{fold}", blk.res_units, x, fold))
    one = [st for st in sites if st[0] == 1]
    outs, launches = counted("K1f", 1, len(one), ("residual_chain",),
                             lambda: [fused_residual_chain_folded(u, x, f)
                                      for _, _, u, x, f in one])
    worst, times = 0.0, {}
    for (_, name, units, x, fold), got in zip(one, outs):
        plain = fused_residual_chain_folded_plain(units, x, fold)
        k1 = fused_residual_chain(units, x)
        torch.cuda.synchronize()
        require(torch.equal(got, k1), f"K1f {name}: differs from K1 on the same input")
        err = float((got - plain).abs().max())
        require(err <= KERNEL_ATOL_F32, f"K1f {name}: max|err| {err} vs its plain version")
        worst = max(worst, err)
        log(f"check K1f {name}: equals K1; vs folded plain "
            f"max|err|={err:.3e}")
    for n_frames, name, units, x, fold in sites:
        c, rows = x.shape[1], x.shape[0] - chain_halo()
        ops = chain_flops(c, rows)
        nb = 4.0 * (x.numel() + rows * c) + 4.0 * 3 * (KERNEL_SIZE + 1) * c * c
        b_ms, b_by = bound_ms(ops, nb, TF32_FLOPS / TF32_PASSES[torch.float32])
        reps = 30 if n_frames == 1 else 5
        times[f"{name} frames={n_frames}"] = entry = {
            "ms": gpu_ms(lambda: fused_residual_chain_folded(units, x, fold), reps),
            "plain_ms": gpu_ms(lambda: fused_residual_chain_folded_plain(units, x, fold),
                               reps),
            "bound_ms": b_ms, "bound_by": b_by, "bound_ms_f32_cores": bound_ms(ops, nb)[0],
            "library_ms": None, "ops": ops, "bytes": nb}
        log(f"time K1f {name} frames={n_frames}: {json.dumps(entry)}")
    return launches, worst, times


def probe_phase():
    """T1: the relayout probe's ``main`` (its six shapes through the
    fold_copy kernel, held to numpy's reshape; the two numpy refuses must be
    refused), counted; then each defined shape's kernel output against its
    plain version (``reshape().clone()``) bit for bit, and times by CUDA
    events and as device time (:func:`graph_ms`), the library call's too
    (``torch.clone`` of the reshaped view, the whole function)."""
    rc, launches = counted("T1", 1, 4, ("fold_copy",), reshape_probe.main)
    require(rc == 0, "reshape_probe: a shape disagrees with numpy")
    times = {}
    for shape, s, mode in reshape_probe.SHAPES:
        x = torch.arange(shape[0] * shape[1], dtype=torch.float32,
                         device=DEVICE).reshape(shape)
        try:
            reshape_probe.folded_shape(shape, s, mode)
        except ValueError:
            continue
        got = reshape_probe.fold_copy(x, s, mode)
        view = x.reshape(reshape_probe.folded_shape(shape, s, mode))
        require(torch.equal(got, reshape_probe.fold_copy_plain(x, s, mode)),
                f"fold_copy {mode} {shape}: differs from its plain version")
        nb = 2.0 * x.numel() * 4
        b_ms, b_by = bound_ms(0.0, nb)
        times[f"{mode} {shape} s={s}"] = entry = {
            "ms": gpu_ms(lambda: reshape_probe.fold_copy(x, s, mode), 200),
            "device_ms": graph_ms(lambda: reshape_probe.fold_copy(x, s, mode)),
            "plain_ms": gpu_ms(lambda: reshape_probe.fold_copy_plain(x, s, mode), 200),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": gpu_ms(view.clone, 200),
            "library_device_ms": graph_ms(view.clone), "ops": 0.0, "bytes": nb}
        log(f"time fold_copy {mode} {shape} s={s}: {json.dumps(entry)}")
    return launches, times


def write_exp_tree(root, codec, vq, presets):
    """The seeded models as checkpoints under ``root/exp`` where
    ``assign_model`` looks for each of ``presets`` ({name: (codec config,
    vocoder config, vocoder)}, the vocoder None for a symmetric preset), each
    with its configuration file's contents beside it, and the statistics the
    vocoder configs name under ``root``."""
    for model, (codec_config, voc_config, voc) in presets.items():
        _, tx_ckpt, rx_ckpt = assign_model(model, os.path.join(root, "exp"))
        save_checkpoint(tx_ckpt, {"params_generator": codec.state_dict(), "vq_state": vq},
                        load_config(codec_config))
        if voc is None:
            continue
        cfg = load_config(voc_config)
        stats_path = os.path.join(root, cfg["generator_params"]["stats"])
        os.makedirs(os.path.dirname(stats_path), exist_ok=True)
        np.save(stats_path, torch.stack([voc.mean, voc.scale]).cpu().numpy())
        save_checkpoint(rx_ckpt, {"params_generator": voc.state_dict()}, cfg)


def produced(y, n_frames: int) -> np.ndarray:
    """The frames a streamer produced, in order: its mono output cut in
    frames, the all-zero frames (the pipeline's underflow) left out; there
    must be ``n_frames``."""
    frames = y.reshape(-1, FRAME)
    got = frames[np.abs(frames).max(axis=1) > 0]
    require(len(got) == n_frames, f"{len(got)} frames produced of {n_frames}")
    return got


def cli_phase(codec, vq, v0):
    """The normal entry point: seeded checkpoints under a temporary exp/
    tree, a seeded 48 kHz wav of CLI_SECONDS, and ``cli.stream.main`` on the
    card from that directory:

    - ``--model vctk_v0`` and ``--model vctk_univ`` (the transmitter's
      kernels with f32 weights, the v0 receiver's with bf16: 54 launches a
      frame, the priming call and the warm-up frame), each wav held at
      MAIN_RTOL_BF16 plus one PCM16 step to the direct stream on the same
      audio: the halves that ``make_vocoder_scan_stream`` joins, at f32
      weights, primed as the two-thread streamer primes (one chunk of the
      codec's receptive length, which leaves the receiver's caches short of
      their steady state); every frame out and none dropped;
    - ``--model vctk_sym`` (both codec endpoints' kernels, 22 launches a
      frame) held to the codec's halves the same way;
    - ``--checkpoint`` of the codec (the fused streamer: ``make_scan_stream``,
      22 launches a frame) held to ``make_scan_stream`` primed as that
      streamer primes, with whole frames of zeros."""
    n = CLI_SECONDS * SAMPLE_RATE // FRAME
    primed_len = -(-codec.receptive_length // codec.hop) * codec.hop
    audio = frames_for(n, SEED + 80)[:, 0, :, 0]  # (n, FRAME)
    cwd, report, by_path = os.getcwd(), {}, {}
    with tempfile.TemporaryDirectory() as root:
        # v3's receiver is v0's network: the v0 receiver stands for both
        write_exp_tree(root, codec, vq, {"vctk_v0": (CODEC_CONFIG, V0_CONFIG, v0),
                                         "vctk_univ": (UNIV_CODEC_CONFIG, V3_CONFIG, v0),
                                         "vctk_sym": (CODEC_CONFIG, None, None)})
        write_wav(os.path.join(root, "in.wav"), audio.reshape(-1).cpu().numpy(), SAMPLE_RATE)
        pcm = torch.from_numpy(read_wav(os.path.join(root, "in.wav"))[0][:, 0]).to(DEVICE)
        frames = pcm.reshape(n, FRAME)  # the audio as the CLI reads it
        refs, f32 = {}, torch.float32
        for model, rx_half in (("vctk_v0", vocoder_half(v0, f32, vq)),
                               ("vctk_sym", mega_decoder(codec, f32, vq))):
            init, direct = join_halves(mega_encoder(codec, f32, vq), rx_half, 1, DEVICE)
            cache = direct(init(), torch.zeros((1, 1, primed_len), device=DEVICE))[1]
            refs[model] = direct(cache, frames[:, None])[0][:, 0].cpu().numpy()
        refs["vctk_univ"] = refs["vctk_v0"]
        os.chdir(root)
        try:
            for model, per_frame, kernels in (
                    ("vctk_v0", LAUNCHES_PER_DISPATCH["vocoder_v0"], VOCODER_KERNELS),
                    ("vctk_univ", LAUNCHES_PER_DISPATCH["vocoder_v0"], VOCODER_KERNELS),
                    ("vctk_sym", LAUNCHES_PER_DISPATCH["codec"], CODEC_KERNELS)):
                out = f"{model}.wav"
                stats, launches = counted(
                    f"cli --model {model}", per_frame, n + 2, kernels,
                    lambda: stream_cli.main(["--model", model, "-i", "in.wav", "-o", out,
                                             "--max-latency", str(CLI_MAX_LATENCY)]))
                got = produced(read_wav(out)[0][:, 0], n)
                ref = refs[model]
                scale = float(np.abs(ref).max())
                err = float(np.abs(got - ref).max())
                log(f"cli --model {model}: {n} frames, drops {stats['frame_drops']}, max|err| "
                    f"vs the direct stream {err:.3e} (max|ref| {scale:.3e}); latency "
                    f"{stats['latency_ms_mean']:.1f} ms mean, encoder "
                    f"{stats['encoder_ms_mean']:.2f} ms mean, decoder "
                    f"{stats['decoder_ms_mean']:.2f} ms mean")
                require(stats["frames"] == n and stats["frame_drops"] == 0,
                        f"cli --model {model}: {stats}")
                require(err <= MAIN_RTOL_BF16 * scale + PCM16_STEP,
                        f"cli --model {model} disagrees with the direct stream")
                report[model] = {"max_abs_err": err, "max_abs_ref": scale, "stats": stats}
                by_path[f"cli {model}"] = launches
            ckpt = "exp/autoencoder/symAD_vctk_48000_hop300/checkpoint-200000steps"
            stats, launches = counted(
                "cli --checkpoint (fused)", LAUNCHES_PER_DISPATCH["codec"], n + 2,
                CODEC_KERNELS,
                lambda: stream_cli.main(["--checkpoint", ckpt, "-i", "in.wav", "-o",
                                         "fused.wav", "--max-latency", str(CLI_MAX_LATENCY)]))
            got = produced(read_wav("fused.wav")[0][:, 0], n)
        finally:
            os.chdir(cwd)
        direct = make_scan_stream(codec, vq, frame_size=FRAME)
        zeros = torch.zeros((-(-codec.receptive_length // FRAME), 1, FRAME, 1), device=DEVICE)
        _, cache = direct(direct.init_cache(), zeros)
        ref = direct(cache, frames[:, None, :, None])[0][:, 0, :, 0].cpu().numpy()
        err = float(np.abs(got - ref).max())
        log(f"cli --checkpoint (fused): {n} frames, drops {stats['frame_drops']}, max|err| vs "
            f"make_scan_stream {err:.3e}; fused frame {stats['fused_ms_mean']:.2f} ms mean")
        require(stats["frames"] == n and stats["frame_drops"] == 0,
                f"cli --checkpoint: {stats}")
        require(err <= MAIN_ATOL_F32 + PCM16_STEP, "the fused streamer disagrees with "
                "make_scan_stream")
        report["checkpoint_fused"] = {"max_abs_err": err, "stats": stats}
        by_path["cli checkpoint (fused)"] = launches
    return by_path, report


# ---------------------------------------------------------------- training


def course_config() -> dict:
    """COURSE_CONFIG as cli/train_denoise.py runs it (batch_length =
    sample_rate), for one epoch."""
    cfg = load_config(COURSE_CONFIG)
    require(cfg["sample_rate"] == COURSE_LENGTH and cfg["batch_size"] == COURSE_BATCH,
            f"{COURSE_CONFIG}: sample rate {cfg['sample_rate']}, batch {cfg['batch_size']}")
    return dict(cfg, epochs=1)


def course_generator(cfg) -> AudioDecGenerator:
    """The course's without-PQC generator on the card, seeded: every call
    gives the same weights."""
    return AudioDecGenerator(**cfg["generator_params"], use_pqc=False, seed=SEED + 50,
                             device=DEVICE)


def course_clips(n: int, seed: int, length: int = COURSE_LENGTH):
    """``n`` seeded (clean, noise) pairs of numpy (16, length, 1) f32
    batches: four harmonics of a gliding pitch under a slow envelope over a
    recording's noise floor (white, 60 dB below the harmonics: without one,
    mel bands between the harmonics hold energy at f32's rounding floor of
    the frame, where even the FFT departs from an f64 log-mel by 4e-2), and
    white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) / SAMPLE_RATE
    pairs = []
    for _ in range(n):
        f0 = rng.uniform(100.0, 250.0, (COURSE_BATCH, 1)) * (1.0 + 0.1 * np.sin(np.pi * t))
        phase = 2.0 * np.pi * np.cumsum(f0, axis=1) / SAMPLE_RATE
        clean = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
        clean *= 0.2 + np.sin(2.0 * np.pi * rng.uniform(1.0, 4.0, (COURSE_BATCH, 1)) * t) ** 2
        clean += 3e-4 * rng.standard_normal(clean.shape)
        noise = 0.3 * rng.standard_normal((COURSE_BATCH, length))
        pairs.append((clean[..., None].astype(np.float32), noise[..., None].astype(np.float32)))
    return pairs


def course_batch(pair, snr=15):
    """(mixed, clean) of one clip pair on the card, mixed by the port's add_noise."""
    clean, noise = pair
    mixed = add_noise(clean, noise, snr).astype(np.float32)
    return torch.from_numpy(mixed).to(DEVICE), torch.from_numpy(clean).to(DEVICE)


def spectrum_builders(case):
    """(kernel fn, plain fn) of a K6 / K7 case: ("log_mel", sr, n_fft, hop,
    win, n_mels, fmax, log_base) or ("stft_magnitude", n_fft, hop, win)."""
    if case[0] == "log_mel":
        _, sr, n_fft, hop, win, n_mels, fmax, base = case
        kw = dict(sr=sr, n_fft=n_fft, hop=hop, win_length=win, n_mels=n_mels, fmin=0,
                  fmax=fmax, log_base=base, device=DEVICE)
        return make_fused_log_mel(**kw), make_fused_log_mel(**kw, plain=True)
    _, n_fft, hop, win = case
    return (make_fused_stft_magnitude(n_fft, hop, win, device=DEVICE),
            make_fused_stft_magnitude(n_fft, hop, win, device=DEVICE, plain=True))


def spectrum_cases(cfg, vcfg):
    """Every K6 / K7 call shape of phase 5's and phase 7's paths (16 signals
    each): the course's mel loss, the vocoder's mel loss and its three STFT
    resolutions (also the codec's stage 2 and the recipe's vocoder, 16 x
    9600), a log10 log-mel with a window shorter than its FFT, and the
    recipe's mel loss at the codec's and the denoise fine-tune's 16 x 96000;
    then a log-mel and an STFT at n_fft 600, which no path runs and the
    planner sends to the GEMM arm."""
    m, s = cfg["mel_loss_params"], vcfg["stft_loss_params"]
    vm = vcfg["mel_loss_params"]
    course = ("log_mel", m["fs"], m["fft_sizes"][0], m["hop_sizes"][0], m["win_lengths"][0],
              m["num_mels"], m["fmax"], m["log_base"])
    voc_mel = ("log_mel", vm["fs"], vm["fft_sizes"][0], vm["hop_sizes"][0],
               vm["win_lengths"][0], vm["num_mels"], vm["fmax"], vm["log_base"])
    cases = {"course mel": (course, COURSE_LENGTH),
             "vocoder mel": (voc_mel, VOCODER_METRIC_LENGTH),
             "24k log10 mel, win 240 < fft 512": (
                 ("log_mel", 24000, 512, 120, 240, 40, 12000, 10.0), VOCODER_METRIC_LENGTH)}
    for f, h, w in zip(s["fft_sizes"], s["hop_sizes"], s["win_lengths"]):
        cases[f"stft {f}/{h}/{w}"] = (("stft_magnitude", f, h, w), VOCODER_METRIC_LENGTH)
    cm = load_config(CODEC_CONFIG)["mel_loss_params"]
    cases["recipe mel (codec stage 1, denoise), 16 x 96000"] = (
        ("log_mel", cm["fs"], cm["fft_sizes"][0], cm["hop_sizes"][0], cm["win_lengths"][0],
         cm["num_mels"], cm["fmax"], cm["log_base"]), RECIPE_LENGTH)
    cases["GEMM arm: 24k log10 mel, n_fft 600"] = (
        ("log_mel", 24000, 600, 150, 600, 40, 12000, 10.0), VOCODER_METRIC_LENGTH)
    cases["GEMM arm: stft 600/150/600"] = (("stft_magnitude", 600, 150, 600),
                                           VOCODER_METRIC_LENGTH)
    return cases


def arm_launches() -> dict:
    """Launches of K6 and K7 by arm so far."""
    return {arm: log_mel.arm_launches[arm] + stft_magnitude.arm_launches[arm] for arm in ARMS}


def check_spectrum_kernels(cases, rng):
    """Phase 5a: K6 and K7 against their plain versions at every call shape:
    forward (log-mel atol LOG_MEL_ATOL; magnitudes STFT_RTOL of the largest),
    the autograd.Function's gradient against autograd through the plain
    version (SPECTRUM_GRAD_RTOL of the largest), the arm the planner picked
    launched, two calls bit-equal and a batch bit-equal to its examples' own
    calls."""
    worst, report = {name: 0.0 for name in SPECTRUM_KERNELS}, {}
    longest = max(length for _, length in cases.values())
    x = torch.randn(COURSE_BATCH, longest, generator=rng, device=DEVICE) * 0.3
    for what, (case, length) in cases.items():
        fn, plain = spectrum_builders(case)
        xs = x[:, :length]
        before = arm_launches()
        got = fn(xs)
        require(arm_launches() == dict(before, **{fn.arm: before[fn.arm] + 1}),
                f"{what}: one launch of the {fn.arm} arm expected")
        ref = plain(xs)
        require(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        limit = LOG_MEL_ATOL if case[0] == "log_mel" else STFT_RTOL * float(ref.abs().max())
        require(err <= limit, f"{what}: kernel vs plain max|err| {err} > {limit}")
        require(torch.equal(fn(xs), got), f"{what}: two calls differ")
        per = torch.cat([fn(xs[i:i + 1]) for i in range(COURSE_BATCH)])
        require(torch.equal(per, got), f"{what}: a batch differs from its examples' calls")
        g = torch.randn(got.shape, generator=rng, device=DEVICE)
        xk, xp = xs.clone().requires_grad_(), xs.clone().requires_grad_()
        fn(xk).backward(g)
        plain(xp).backward(g)
        err_g = float((xk.grad - xp.grad).abs().max())
        g_limit = SPECTRUM_GRAD_RTOL * float(xp.grad.abs().max())
        require(err_g <= g_limit, f"{what}: gradient max|err| {err_g} > {g_limit}")
        worst[case[0]] = max(worst[case[0]], err)
        report[what] = {"arm": fn.arm, "rows": got.shape[0] * got.shape[1],
                        "max_abs_err": err, "limit": limit, "grad_max_abs_err": err_g,
                        "grad_limit": g_limit, "deterministic": True}
        log(f"{case[0]:14s} {what:34s} {fn.arm} arm rows={report[what]['rows']:<5d} "
            f"max|err|={err:.3e} (limit {limit:.1e}) grad {err_g:.3e} (limit {g_limit:.1e}); "
            "bit-equal per example")
    return worst, report


def grad_rel_errs(got: dict, ref: dict) -> dict:
    """Each gradient's largest difference over its ``ref``'s largest."""
    return {n: float((got[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
            for n, g in ref.items()}


def held_routes(what, ref, got, frag_rtol, grad_rtol):
    """Loss fragments within ``frag_rtol`` and each parameter's gradient
    within ``grad_rtol`` of its largest, ``got`` against ``ref``; both
    (fragments, {name: grad})."""
    frag_err = {k: abs(float(got[0][k]) - float(v)) / abs(float(v)) for k, v in ref[0].items()}
    errs = grad_rel_errs(got[1], ref[1])
    worst = max(errs, key=errs.get)
    grad_err = errs[worst]
    log(f"{what}: fragment rel err {json.dumps(frag_err)}; worst gradient err "
        f"{grad_err:.3e} of its tensor's max ({worst})")
    require(sorted(got[0]) == sorted(ref[0]), f"{what}: fragments {sorted(got[0])}")
    require(max(frag_err.values()) <= frag_rtol, f"{what}: fragments differ beyond {frag_rtol}")
    require(grad_err <= grad_rtol, f"{what}: gradients differ beyond {grad_rtol}")
    return {"fragment_rel_err": frag_err, "grad_rel_err": grad_err, "grad_worst": worst}


def course_routes(cfg, pair):
    """Phase 5b: one course train step from the same params and batch with
    the mel loss on the kernel route ('auto', 2 K6 launches), on its plain
    version ('plain') and on the FFT ('eager'). The kernel route is held to
    the plain one (fragments ROUTE_FRAG_RTOL, gradients ROUTE_GRAD_RTOL of
    each tensor's largest); the FFT route, as the JAX package holds its
    kernel to the FFT, by the log-mels of the step's input and target
    (EAGER_LOG_MEL_ATOL). Returns (kernel route's launches, checks)."""
    x, t = course_batch(pair)
    routes, launches = {}, None
    for route in ("auto", "plain", "eager"):
        rcfg = dict(cfg, mel_loss_params=dict(cfg["mel_loss_params"], backend=route))
        gen = course_generator(cfg)
        opt = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"],
                              grad_norm=cfg.get("generator_grad_norm", -1))
        step = make_course_steps(gen, None, rcfg, opt, None)["train"]
        if route == "auto":
            (_, _, frags, _), launches = counted("course step, kernel route", 2, 1,
                                                 ("log_mel",), lambda: step(x, t))
        else:
            _, _, frags, _ = step(x, t)
        require(all(bool(torch.isfinite(v)) for v in frags.values()), f"{route}: {frags}")
        routes[route] = ({k: float(v.detach()) for k, v in frags.items()},
                         {n: p.grad.detach().clone() for n, p in gen.named_parameters()})
        del gen, opt, step
    checks = {"kernel_vs_plain": held_routes("course step, kernel vs plain route",
                                             routes["plain"], routes["auto"],
                                             ROUTE_FRAG_RTOL, ROUTE_GRAD_RTOL)}
    m = dict(cfg["mel_loss_params"])
    mel_kw = dict(fs=m["fs"], fft_size=m["fft_sizes"][0], hop_size=m["hop_sizes"][0],
                  win_length=m["win_lengths"][0], num_mels=m["num_mels"], fmin=m["fmin"],
                  fmax=m["fmax"], log_base=m["log_base"], device=DEVICE)
    kernel, eager = (MelSpectrogram(**mel_kw, backend=b) for b in ("cuda", "eager"))
    with torch.no_grad():
        err = max(float((kernel(a[..., 0]) - eager(a[..., 0])).abs().max()) for a in (x, t))
    log(f"course log-mel, kernel vs FFT route: max|err| {err:.3e} (limit {EAGER_LOG_MEL_ATOL}); "
        f"fragments kernel {json.dumps(routes['auto'][0])}, FFT {json.dumps(routes['eager'][0])}")
    require(err <= EAGER_LOG_MEL_ATOL, f"kernel vs FFT log-mel max|err| {err}")
    checks["log_mel_kernel_vs_fft"] = err
    checks["fragments"] = {r: v[0] for r, v in routes.items()}
    return launches, checks


def course_training(cfg, clips):
    """Phase 5c: ``train_denoise_course`` for one LAPTOP epoch (3 train
    batches, 3 validation batches; 2 K6 launches a step), then FIXED_STEPS
    steps on one fixed batch (wall time of each, synchronised), whose loss
    must fall, every loss finite; one more step for its peak memory and one
    under the profiler. Returns (launches by run, report)."""
    gen = course_generator(cfg)
    train = ([c for c, _ in clips[:3]], [n for _, n in clips[:3]])
    val = ([c for c, _ in clips[3:6]], [n for _, n in clips[3:6]])
    (state, history), epoch_launches = counted(
        "course epoch (LAPTOP)", 2, 6, ("log_mel",),
        lambda: train_denoise_course(cfg, gen, None, train, val, environment="LAPTOP"))
    require(state["steps"] == 3 and len(history) == 1, f"epoch: {state['steps']} steps")
    h = history[0]
    require(all(np.isfinite(v) for v in (h["train_gen"], h["val_gen"], *h["frags"].values())),
            f"epoch history not finite: {h}")
    log(f"course epoch: train {h['train_gen']:.4f}, validation {h['val_gen']:.4f}, "
        f"fragments {json.dumps(h['frags'])}")

    x, t = course_batch(clips[0])
    opt = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"],
                          grad_norm=cfg.get("generator_grad_norm", -1))
    step = make_course_steps(gen, None, cfg, opt, None)["train"]

    def fixed():
        losses, walls = [], []
        for _ in range(FIXED_STEPS):
            t0 = time.perf_counter()
            g_loss = float(step(x, t)[0])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            losses.append(g_loss)
        return losses, walls

    (losses, walls), fixed_launches = counted("course fixed-batch steps", 2, FIXED_STEPS,
                                              ("log_mel",), fixed)
    log(f"course fixed batch, {FIXED_STEPS} steps: losses {[round(v, 4) for v in losses]}")
    require(all(np.isfinite(losses)), "a fixed-batch loss is not finite")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> {losses[-1]}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(x, t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(walls)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(x, t)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    k6_ms = sum(e.self_device_time_total for e in device if "log_mel_kernel" in e.key) / 1e3
    report = {
        "epoch": h, "fixed_batch_losses": losses, "step_walls_ms": walls,
        "step_median_ms": step_ms, "step_peak_bytes": peak,
        "step_peak_above_resident_bytes": peak - before,
        "profiled_step": ({"device_ms": device_ms, "busy_share": device_ms / step_ms,
                           "log_mel_kernel_ms": k6_ms} if device_ms > 0 else None),
    }
    log(f"course step: median {step_ms:.2f} ms over {FIXED_STEPS} (min {min(walls):.2f}); "
        f"peak memory {peak / 2**30:.2f} GiB ({(peak - before) / 2**30:.2f} above resident); "
        + (f"device {device_ms:.2f} ms, busy share {device_ms / step_ms:.3f}, K6 {k6_ms:.3f} ms"
           if device_ms > 0 else "device time not measured (no device time in the trace)"))
    return {"course epoch": epoch_launches, "course fixed steps": fixed_launches}, report


def vocoder_metric_routes(codec, vq, voc, vcfg):
    """Phase 5d: the vocoder config's metric loss (mel + multi-resolution
    STFT) on the vctk_v1 receiver's offline forward of the codec's quantized
    codes, forward and backward into the receiver's weights, on the kernel
    route ('auto': 2 K6 + 6 K7 launches), the plain route and the FFT route.
    The kernel route is held to the plain one: fragments ROUTE_FRAG_RTOL,
    the gradient of the mel and spectral-convergence terms ROUTE_GRAD_RTOL
    of each tensor's largest, and that of the log-STFT-magnitude term
    LOG_MAG_GRAD_RTOL, which the FFT route must meet against the plain route
    as well (that term's f32 conditioning, not the kernel, sets the bound).
    Returns (launches, checks)."""
    require(vcfg["use_mel_loss"] and vcfg["use_stft_loss"], f"{VOCODER_CONFIG}: metric losses")
    clean, _ = course_clips(1, SEED + 61, VOCODER_METRIC_LENGTH)[0]
    x = torch.from_numpy(clean).to(DEVICE)
    with torch.no_grad():
        zq, _ = codec.quantizer.inference(vq, codec.projector(codec.encoder(x)))
    names, params = zip(*voc.named_parameters())
    routes, launches = {}, None
    for route in ("auto", "plain", "eager"):
        rcfg = dict(vcfg, mel_loss_params=dict(vcfg["mel_loss_params"], backend=route),
                    stft_loss_params=dict(vcfg["stft_loss_params"], backend=route))
        crit = build_criterion(rcfg, device=DEVICE)

        def drive():
            _, frags = metric_loss(crit, vcfg, voc(zq), x)
            rest = frags["mel_loss"] + frags["spectral_convergence_loss"]
            g_rest = torch.autograd.grad(rest, params, retain_graph=True)
            g_mag = torch.autograd.grad(frags["log_stft_magnitude_loss"], params)
            return frags, g_rest, g_mag

        if route == "auto":
            (frags, g_rest, g_mag), launches = counted(
                "vocoder metric loss, kernel route", 8, 1, SPECTRUM_KERNELS, drive)
        else:
            frags, g_rest, g_mag = drive()
        routes[route] = ({k: float(v.detach()) for k, v in frags.items()},
                         dict(zip(names, g_rest)), dict(zip(names, g_mag)))

    def grad_err(route, part):
        return max(grad_rel_errs(routes[route][part], routes["plain"][part]).values())

    checks = held_routes("vocoder metric loss (mel + spectral convergence), kernel vs plain "
                         "route", routes["plain"][:2], routes["auto"][:2], ROUTE_FRAG_RTOL,
                         ROUTE_GRAD_RTOL)
    checks["log_mag_grad_rel_err"] = grad_err("auto", 2)
    checks["fft_route_vs_plain"] = {"grad_rel_err": grad_err("eager", 1),
                                    "log_mag_grad_rel_err": grad_err("eager", 2),
                                    "fragments": routes["eager"][0]}
    log(f"vocoder metric loss, log-STFT-magnitude gradient: kernel vs plain route "
        f"{checks['log_mag_grad_rel_err']:.3e} of its tensor's max (limit {LOG_MAG_GRAD_RTOL}); "
        f"the FFT route vs plain: {json.dumps(checks['fft_route_vs_plain'])}")
    for what, err in (("kernel", checks["log_mag_grad_rel_err"]),
                      ("FFT", checks["fft_route_vs_plain"]["log_mag_grad_rel_err"])):
        require(err <= LOG_MAG_GRAD_RTOL, f"vocoder metric loss: the {what} route's "
                f"log-magnitude gradients differ from the plain route's beyond "
                f"{LOG_MAG_GRAD_RTOL}: {err}")
    checks["fragments"] = routes["auto"][0]
    return launches, checks


def spectrum_ops(n_fft: int, win: int, rows: int, mel_nnz: int = 0, n_mels: int = 0) -> float:
    """Operations the spectral function needs for ``rows`` frames, as an FFT
    computes it: the window (``win`` products), a real FFT of ``n_fft``
    samples (5/2 n log2 n, half a complex FFT's 5 n log2 n), power, clamp
    and sqrt (4 a frequency) and, for a log-mel, the mel projection over the
    filterbank's nonzeros (2 each; the product is sparse) with clamp and log
    (2 a mel)."""
    n_freq = n_fft // 2 + 1
    return rows * (win + 2.5 * n_fft * math.log2(n_fft) + 4 * n_freq
                   + 2 * mel_nnz + 2 * n_mels)


def spectrum_site(case, fn, x):
    """(kernel call, plain call, library call or None, GEMM-arm call,
    operations, bytes, GEMM-form operations) of one K6 / K7 case on audio
    ``x`` (B, T): the wrappers on the frames view and operands of the
    builder ``fn`` (its FFT tables too), and the library's GEMM-arm entry
    called directly on the same operands (the arm the planner gives every
    other n_fft, and every n_fft before the FFT arm; a time, not a launch
    of the path). The operations and bytes are what the function needs
    (spectrum_ops; the audio and, for a log-mel, the filterbank's nonzeros
    read once, the output written once: the bases are computed, not
    needed); the GEMM form's are what that arm does, 4 n_fft a frame and
    frequency."""
    n_fft, hop, win = case[2:5] if case[0] == "log_mel" else case[1:4]
    win = win or n_fft
    frames = fn.frames_of(x)
    rows = frames.shape[0] * frames.shape[1]
    cos_b, sin_b = fn.bases
    n_freq = n_fft // 2 + 1
    gemm = 4.0 * rows * n_fft * n_freq
    if case[0] == "log_mel":
        _, _, _, _, _, n_mels, _, base = case
        nnz = int((fn.mel_m != 0).sum())
        out = torch.empty(rows, n_mels, device=DEVICE)

        def gemm_arm():
            _launch("gemm", frames, out, fn.bases, 1e-10, mel=(fn.mel_m, _LOG_KIND[base]))
            return out

        return (lambda: log_mel(frames, cos_b, sin_b, fn.mel_m, 1e-10, base, fn.fft_tables),
                lambda: log_mel_plain(frames, cos_b, sin_b, fn.mel_m, 1e-10, base), None,
                gemm_arm, spectrum_ops(n_fft, win, rows, nnz, n_mels),
                4 * (x.numel() + nnz + rows * n_mels), gemm + 2.0 * rows * n_freq * n_mels)
    window = torch.hann_window(win, device=DEVICE)
    out = torch.empty(rows, n_freq, device=DEVICE)

    def gemm_arm():
        _launch("gemm", frames, out, fn.bases, 1e-7)
        return out

    return (lambda: stft_magnitude(frames, cos_b, sin_b, n_freq, 1e-7, fn.fft_tables),
            lambda: stft_magnitude_plain(frames, cos_b, sin_b, n_freq, 1e-7),
            lambda: torch.stft(x, n_fft, hop, win, window, center=True,
                               return_complex=True).abs(),
            gemm_arm, spectrum_ops(n_fft, win, rows), 4 * (x.numel() + rows * n_freq), gemm)


def graph_ms(fn, reps: int = 20, groups: int = 5, stream=None) -> float:
    """Device ms per call of ``fn``: CUDA events around the replay of a CUDA
    graph of ``reps`` calls (no host work between the launches), the median
    over ``groups`` replays, after warm-up calls on the capture stream
    (``stream``, else a new side stream; a backward must be captured on the
    stream its forward ran on). Where the calls' host work outlasts their
    kernels, :func:`gpu_ms` measures the host and the profiler has lost
    kernel records in this setting (a kernel's time read as 0.6-0.7 of its
    device-bound event time)."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(groups):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def training_times(cfg, cases, rng):
    """Phase 5e: each K6 / K7 call shape, with the arm it takes, against its
    plain version, its bound, the GEMM arm at the same shape (called
    directly) and (K7) ``torch.stft(...).abs()`` on cuFFT, a yardstick the
    port never calls; K6 has no one-call equivalent, so the FFT route's
    log-mel (``MelSpectrogram('eager')``) is timed beside it as
    ``eager_fft_ms``. Each as CUDA events around back-to-back calls (``ms``
    and the like: where a call's host work outlasts its kernels, the host's
    rate) and as device time (``*device_ms``, :func:`graph_ms`). Then the
    course's mel loss, forward and backward each alone and together, kernel
    route against the FFT route, device time by graph_ms for each: the
    forward without autograd, the backward of one kept graph (its forward
    run on the capture stream), and the two together."""
    longest = max(length for _, length in cases.values())
    x = torch.randn(COURSE_BATCH, longest, generator=rng, device=DEVICE) * 0.3
    sites = {}
    for what, (case, length) in cases.items():
        xs = x[:, :length].contiguous()
        fn = spectrum_builders(case)[0]
        run, plain, lib, gemm_arm, flops, nb, gemm = spectrum_site(case, fn, xs)
        b_ms, b_by = bound_ms(flops, nb)
        site = {"kernel": case[0], "arm": fn.arm, "ms": gpu_ms(run, 10),
                "device_ms": graph_ms(run), "plain_ms": gpu_ms(plain, 10),
                "plain_device_ms": graph_ms(plain),
                "library_ms": None if lib is None else gpu_ms(lib, 10),
                "library_device_ms": None if lib is None else graph_ms(lib),
                "bound_ms": b_ms, "bound_by": b_by, "flops": flops, "bytes": nb,
                "gemm_form_flops": gemm, "gemm_form_ops_ms": gemm / F32_FLOPS * 1e3}
        if fn.arm == "fft":
            site["gemm_arm_ms"] = gpu_ms(gemm_arm, 10)
            site["gemm_arm_device_ms"] = graph_ms(gemm_arm)
        if case[0] == "log_mel":
            _, sr, n_fft, hop, win, n_mels, fmax, base = case
            eager = MelSpectrogram(fs=sr, fft_size=n_fft, hop_size=hop, win_length=win,
                                   num_mels=n_mels, fmin=0, fmax=fmax, log_base=base,
                                   backend="eager", device=DEVICE)
            site["eager_fft_ms"] = gpu_ms(lambda: eager(xs), 10)
            site["eager_fft_device_ms"] = graph_ms(lambda: eager(xs))
        sites[what] = site
        log(f"time {case[0]:14s} {what:34s} {fn.arm} arm kernel={site['ms']:.4f} ms (device "
            f"{site['device_ms']}) plain={site['plain_ms']:.4f} library={site['library_ms']} "
            f"(device {site['library_device_ms']}) eager FFT route={site.get('eager_fft_ms')} "
            f"(device {site.get('eager_fft_device_ms')}) GEMM arm={site.get('gemm_arm_ms')} "
            f"(device {site.get('gemm_arm_device_ms')}) bound={b_ms:.5f} ms ({b_by}; the GEMM "
            f"form's operations alone {site['gemm_form_ops_ms']:.4f} ms)")
    y = (x[:, :COURSE_LENGTH, None] * 0.5).requires_grad_()
    t = x[:, :COURSE_LENGTH, None]
    loss_ms = {}
    for route, name in (("auto", "kernel"), ("eager", "eager_fft")):
        loss = MultiMelSpectrogramLoss(**dict(cfg["mel_loss_params"], backend=route),
                                       device=DEVICE)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kept = loss(y, t)  # a graph whose backward is timed alone (its saved tensors kept)
        with torch.no_grad():
            fwd_device = graph_ms(lambda: loss(y, t))
        loss_ms[name] = {
            "forward_ms": gpu_ms(lambda: loss(y, t), 10),
            "backward_ms": gpu_ms(lambda: kept.backward(retain_graph=True), 10),
            "fwd_bwd_ms": gpu_ms(lambda: loss(y, t).backward(), 10),
            "forward_device_ms": fwd_device,
            "backward_device_ms": graph_ms(lambda: kept.backward(retain_graph=True),
                                           stream=side),
            "fwd_bwd_device_ms": graph_ms(lambda: loss(y, t).backward())}
        del kept
        torch.cuda.synchronize()
    log(f"course mel loss (ms): {json.dumps(loss_ms)}")
    return sites, {"mel_loss_ms": loss_ms,
                   "mel_loss_fwd_bwd_ms": {k: v["fwd_bwd_ms"] for k, v in loss_ms.items()}}


# ---------------------------------------------------------------- adversarial training


def course_discriminator(cfg):
    """The course's own discriminator (MSD 3 scales at 128-1024 channels, MPD
    periods 2/3/5/7/11 at 32-1024) on the card, seeded: every call gives the
    same weights."""
    return build_discriminator("symAudioDec", cfg["discriminator_params"], device=DEVICE,
                               seed=SEED + 70)


def _flat_outputs(outs) -> list:
    return [f for o in outs for f in (o if isinstance(o, (list, tuple)) else [o])]


def check_discriminators(cfg):
    """Phase 6a: the course's HiFiGAN discriminator and the symADuniv
    config's UnivNet one (MRSD + MPD) on the card against their CPU twins
    (the same seeded weights) on one seeded clip of DISC_LENGTH samples:
    every feature map within DISC_RTOL of its largest |value|."""
    clean, _ = course_clips(1, SEED + 71, DISC_LENGTH)[0]
    x = torch.from_numpy(np.ascontiguousarray(clean[:1]))
    models = {"course HiFiGAN (MSD + MPD)": ("symAudioDec", cfg["discriminator_params"]),
              "symADuniv UnivNet (MRSD + MPD)": (
                  "symAudioDecUniv", load_config(UNIV_CODEC_CONFIG)["discriminator_params"])}
    checks = {}
    for what, (model_type, params) in models.items():
        card = build_discriminator(model_type, params, device=DEVICE, seed=SEED + 70)
        twin = build_discriminator(model_type, params, device="cpu", seed=SEED + 70)
        with torch.no_grad():
            got = _flat_outputs(card(x.to(DEVICE)))
            want = _flat_outputs(twin(x))
        require(len(got) == len(want), f"{what}: {len(got)} maps against {len(want)}")
        errs = []
        for g, w in zip(got, want):
            require(tuple(g.shape) == tuple(w.shape), f"{what}: {tuple(g.shape)} vs {tuple(w.shape)}")
            errs.append(float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30))
        worst = max(errs)
        n_params = sum(p.numel() for p in card.parameters())
        log(f"{what}: {n_params} params, {len(got)} maps, worst err {worst:.3e} of the map's "
            f"largest |value| (limit {DISC_RTOL})")
        require(worst <= DISC_RTOL, f"{what}: a map differs from the CPU's by {worst}")
        checks[what] = {"params": n_params, "maps": len(got), "worst_rel_err": worst}
        del card, twin
    return checks


def adversarial_step(cfg, x, t, route: str, remat: bool = False, count: bool = False):
    """One ``train_disc`` step of the course's generator and discriminator
    from their seeded weights, the mel loss on ``route``: (losses,
    {name: gradient}, {name: parameter before}, {name: parameter after},
    peak bytes above what was resident, launches or None)."""
    rcfg = dict(cfg, mel_loss_params=dict(cfg["mel_loss_params"], backend=route),
                discriminator_remat=remat)
    gen, disc = course_generator(cfg), course_discriminator(cfg)
    nets = {"generator": gen, "discriminator": disc}
    opt_g = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"],
                            grad_norm=cfg.get("generator_grad_norm", -1))
    opt_d = build_optimizer(disc.parameters(), "Adam", cfg["discriminator_optimizer_params"],
                            grad_norm=cfg.get("discriminator_grad_norm", -1))
    step = make_course_steps(gen, disc, rcfg, opt_g, opt_d)["train_disc"]
    before = {f"{k}.{n}": p.detach().clone() for k, m in nets.items()
              for n, p in m.named_parameters()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    launches = None
    if count:
        (g, d, frags, _), launches = counted("adversarial course step, kernel route", 2, 1,
                                             ("log_mel",), lambda: step(x, t))
    else:
        g, d, frags, _ = step(x, t)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - resident
    losses = {"g_loss": float(g), "d_loss": float(d),
              **{k: float(v) for k, v in frags.items()}}
    require(all(np.isfinite(v) for v in losses.values()), f"{route}: losses {losses}")
    grads = {f"{k}.{n}": p.grad.detach().clone() for k, m in nets.items()
             for n, p in m.named_parameters()}
    after = {f"{k}.{n}": p.detach().clone() for k, m in nets.items()
             for n, p in m.named_parameters()}
    return losses, grads, before, after, peak, launches


def adversarial_routes(cfg, pair):
    """Phases 6b and 6c, cuDNN's deterministic algorithms on: one
    ``train_disc`` step from the same weights and batch with the mel loss on
    the kernel route ('auto', 2 K6 launches) and on its plain version, held
    as phase 5b holds the generator step (fragments ROUTE_FRAG_RTOL, every
    gradient of both networks ROUTE_GRAD_RTOL of its tensor's largest), the
    adversarial and discriminator losses finite and every parameter of both
    networks moved; then the kernel route with ``discriminator_remat``:
    losses within REMAT_LOSS_RTOL, parameters within REMAT_PARAM_RTOL (atol
    1e-7) wherever the plain step's gradient is above 1e-4 of its tensor's
    largest and within 2 lr elsewhere (Adam's first step is about lr times
    the gradient's sign), the entries outside REMAT_PARAM_RTOL counted. Peak
    memory of each."""
    x, t = course_batch(pair)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        auto = adversarial_step(cfg, x, t, "auto", count=True)
        plain = adversarial_step(cfg, x, t, "plain")
        remat = adversarial_step(cfg, x, t, "auto", remat=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    frags = lambda run: {k: v for k, v in run[0].items() if k != "g_loss"}  # noqa: E731
    checks = {"kernel_vs_plain": held_routes("adversarial step, kernel vs plain route",
                                             (frags(plain), plain[1]), (frags(auto), auto[1]),
                                             ROUTE_FRAG_RTOL, ROUTE_GRAD_RTOL)}
    for k in ("adv_loss", "feat_loss", "d_loss"):
        require(k in auto[0], f"the adversarial step reports no {k}")
    unmoved = [n for n in auto[2] if torch.equal(auto[2][n], auto[3][n])]
    require(not unmoved, f"parameters the step left as they were: {unmoved[:8]}")
    loss_err = {k: abs(remat[0][k] - v) / max(abs(v), 1e-30) for k, v in auto[0].items()}
    lr = {"generator": cfg["generator_optimizer_params"]["lr"],
          "discriminator": cfg["discriminator_optimizer_params"]["lr"]}
    strict_misses, worst_big, bit_equal = 0, 0.0, 0
    for n, p in auto[3].items():
        q, g = remat[3][n], auto[1][n].abs()
        diff = (q - p).abs()
        bit_equal += int(torch.equal(p, q))
        strict_misses += int((diff > 1e-7 + REMAT_PARAM_RTOL * p.abs()).sum())
        require(float(diff.max()) <= 2 * lr[n.split(".")[0]], f"remat: {n} moved apart")
        big = g > 1e-4 * g.max()
        if bool(big.any()):
            excess = diff[big] - (1e-7 + REMAT_PARAM_RTOL * p.abs()[big])
            worst_big = max(worst_big, float(excess.max()))
    log(f"adversarial step, remat vs plain (kernel route): loss rel err {json.dumps(loss_err)}; "
        f"{bit_equal} of {len(auto[3])} parameter tensors equal bit for bit, "
        f"{strict_misses} entries outside rtol {REMAT_PARAM_RTOL}")
    require(max(loss_err.values()) <= REMAT_LOSS_RTOL, f"remat losses differ: {loss_err}")
    require(worst_big <= 0.0, f"remat parameters differ beyond rtol {REMAT_PARAM_RTOL}")
    checks["remat_vs_plain"] = {"loss_rel_err": loss_err, "bit_equal_tensors": bit_equal,
                                "tensors": len(auto[3]), "entries_outside_rtol": strict_misses}
    checks["losses"] = {"kernel": auto[0], "plain": plain[0], "remat": remat[0]}
    checks["peak_bytes_above_resident"] = {"plain": auto[4], "remat": remat[4]}
    log(f"adversarial step losses {json.dumps(auto[0])}; peak above resident "
        f"{auto[4] / 2**30:.2f} GiB, remat {remat[4] / 2**30:.2f} GiB")
    return auto[5], checks


def adversarial_loop(cfg, clips):
    """Phase 6d: ``train_denoise_course`` for two LAPTOP epochs with the
    discriminator enabled at epoch 1 (3 train and 3 validation batches an
    epoch), then one epoch outside LAPTOP mode (2 train batches, 1
    validation, adversarial from the start) into a temporary ``job_dir``,
    whose ``denoisecheckpoint-<steps>/state.pt`` must load back to the
    generator's state dict."""
    gen, disc = course_generator(cfg), course_discriminator(cfg)
    train = ([c for c, _ in clips[:3]], [n for _, n in clips[:3]])
    val = ([c for c, _ in clips[3:6]], [n for _, n in clips[3:6]])
    lcfg = dict(cfg, epochs=2, epoch_to_enable_discriminator=1)
    (state, history), loop_launches = counted(
        "adversarial course loop (LAPTOP)", 2, 12, ("log_mel",),
        lambda: train_denoise_course(lcfg, gen, disc, train, val, environment="LAPTOP"))
    require(state["steps"] == 6 and len(history) == 2, f"loop: {state['steps']} steps")
    h0, h1 = history
    require(h0["train_dis"] == 0.0 and np.isfinite(h1["train_dis"]) and h1["train_dis"] != 0.0,
            f"epoch 1's train_dis {h1['train_dis']}")
    require(all(np.isfinite(v) for h in history
                for v in (h["train_gen"], h["val_gen"], h["val_dis"], *h["frags"].values())),
            f"loop history not finite: {history}")
    log(f"adversarial loop: epoch 0 {json.dumps(h0)}; epoch 1 {json.dumps(h1)}")
    hcfg = dict(cfg, epochs=1, epoch_to_enable_discriminator=0)
    with tempfile.TemporaryDirectory() as job_dir:
        (state2, _), ckpt_launches = counted(
            "adversarial course epoch with checkpoint", 2, 3, ("log_mel",),
            lambda: train_denoise_course(hcfg, gen, disc, ([train[0][0], train[0][1]],
                                                           [train[1][0], train[1][1]]),
                                         ([val[0][0]], [val[1][0]]), environment="HPC",
                                         job_dir=job_dir))
        path = os.path.join(job_dir, f"denoisecheckpoint-{state2['steps']}")
        restored = load_checkpoint(path, {"params_generator": gen.state_dict()})
        same = all(torch.equal(restored["params_generator"][n], v)
                   for n, v in gen.state_dict().items())
        files = sorted(os.listdir(job_dir))
    require(same, f"{path}: the checkpoint does not load back to the generator's state")
    log(f"checkpoint {os.path.basename(path)}: state.pt loads back to the generator's "
        f"state dict; job_dir holds {files}")
    return ({"adversarial loop": loop_launches, "adversarial checkpoint epoch": ckpt_launches},
            {"history": history, "checkpoint": os.path.basename(path), "job_dir": files})


def device_breakdown(prof, n_top: int = 8):
    """From a ``torch.profiler`` trace: the device kernels' times summed
    (ms), the union of their intervals (ms: what the card was busy for,
    where kernels of several streams overlap) and the ``n_top`` kernels by
    summed time, their names cut to 80 characters (kernels whose names
    agree that far summed together)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == cuda:
            name = e.key[:80]
            by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return sum(by_name.values()), busy / 1e3, dict(top)


def discriminator_flops(disc, x) -> float:
    """Forward FLOPs of the course discriminator's convolutions on ``x`` (2 a
    multiply-add), from each conv's output shape: the MSD's from its feature
    maps (one a layer), the MPD's Conv2d layers through forward hooks."""
    total = 0.0

    def hook(mod, _, out):
        nonlocal total
        total += 2.0 * out.numel() * mod.in_channels * math.prod(mod.kernel_size)

    hooks = [m.register_forward_hook(hook) for m in disc.mpd.modules() if isinstance(m, Conv2d)]
    with torch.no_grad():
        outs = disc(x)
    for h in hooks:
        h.remove()
    for scale, feats in zip(disc.msd.discriminators, outs):
        for layer, f in zip(scale.layers, feats):
            total += 2.0 * f.numel() * layer.in_channels // layer.groups * layer.kernel_size
    return total


def adversarial_times(cfg, clips):
    """Phase 6e: FIXED_STEPS synchronised adversarial steps on one fixed
    batch on the kernel route (wall time of each; the median), one more for
    the peak memory and one under the profiler (device time, busy share),
    without and with ``discriminator_remat``; the step's discriminator-conv
    FLOPs from the shapes (ADV_PASSES forward-equivalents, remat
    ADV_PASSES_REMAT) and the rate they reach against F32_FLOPS."""
    x, t = course_batch(clips[0])
    report, launches = {}, {}
    for remat in (False, True):
        gen, disc = course_generator(cfg), course_discriminator(cfg)
        opt_g = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"],
                                grad_norm=cfg.get("generator_grad_norm", -1))
        opt_d = build_optimizer(disc.parameters(), "Adam",
                                cfg["discriminator_optimizer_params"],
                                grad_norm=cfg.get("discriminator_grad_norm", -1))
        step = make_course_steps(gen, disc, dict(cfg, discriminator_remat=remat), opt_g,
                                 opt_d)["train_disc"]
        name = "remat" if remat else "plain"

        def fixed():
            losses, walls = [], []
            for _ in range(FIXED_STEPS):
                t0 = time.perf_counter()
                g, d = step(x, t)[:2]
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                losses.append((float(g), float(d)))
            return losses, walls

        (losses, walls), launches[f"adversarial fixed steps ({name})"] = counted(
            f"adversarial fixed-batch steps ({name})", 2, FIXED_STEPS, ("log_mel",), fixed)
        require(all(np.isfinite(v) for pair in losses for v in pair), f"{name}: {losses}")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(x, t)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step(x, t)
            torch.cuda.synchronize()
        device_ms, busy_ms, top = device_breakdown(prof)
        step_ms = statistics.median(walls)
        passes = ADV_PASSES_REMAT if remat else ADV_PASSES
        if not remat:
            fwd_flops = discriminator_flops(disc, x)
        flops = passes * fwd_flops
        report[name] = {
            "losses": losses, "step_walls_ms": walls, "step_median_ms": step_ms,
            "step_peak_bytes": peak, "step_peak_above_resident_bytes": peak - resident,
            "profiled_step": ({"device_ms": device_ms, "busy_ms": busy_ms,
                               "busy_share": busy_ms / step_ms, "top_kernels_ms": top}
                              if device_ms > 0 else None),
            "discriminator_conv_flops": flops,
            "discriminator_forward_flops": fwd_flops, "forward_equivalents": passes,
            "tflops_per_s_wall": flops / step_ms / 1e9,
            "tflops_per_s_busy": flops / busy_ms / 1e9 if device_ms > 0 else None,
            "f32_peak_share_busy": (flops / (busy_ms / 1e3) / F32_FLOPS
                                    if device_ms > 0 else None),
        }
        log(f"adversarial step ({name}): median {step_ms:.2f} ms over {FIXED_STEPS} (min "
            f"{min(walls):.2f}); peak memory {peak / 2**30:.2f} GiB "
            f"({(peak - resident) / 2**30:.2f} above resident); "
            + (f"device {device_ms:.2f} ms (kernel times summed), busy {busy_ms:.2f} ms "
               f"(their union), busy share {busy_ms / step_ms:.3f}; "
               if device_ms > 0 else "device time not measured; ")
            + f"discriminator convs {flops / 1e12:.3f} TFLOP ({passes} forward-equivalents), "
            f"{flops / step_ms / 1e9:.1f} TFLOP/s on the wall clock"
            + (f", {flops / busy_ms / 1e9:.1f} on the busy time, "
               f"{flops / (busy_ms / 1e3) / F32_FLOPS:.3f} of the f32 peak; top kernels "
               f"{json.dumps(top)}" if device_ms > 0 else ""))
        del gen, disc, opt_g, opt_d, step
        torch.cuda.empty_cache()
    return launches, report


# ---------------------------------------------------------------- the AudioDec recipe (phase 7)


def recipe_clip(rng, seconds: float) -> np.ndarray:
    """One clip of ``seconds`` at 48 kHz: four harmonics of a gliding pitch
    under a slow envelope over a noise floor, as course_clips draws them."""
    t = np.arange(int(seconds * SAMPLE_RATE)) / SAMPLE_RATE
    f0 = rng.uniform(100.0, 250.0) * (1.0 + 0.1 * np.sin(np.pi * t))
    phase = 2.0 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    clean = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
    clean *= 0.2 + np.sin(2.0 * np.pi * rng.uniform(1.0, 4.0) * t) ** 2
    return (clean + 3e-4 * rng.standard_normal(t.shape)).astype(np.float32)


def write_recipe_corpus(root) -> dict:
    """The configs' subsets under ``root/corpus``: RECIPE_CLIPS clips of
    2.5-4 s per train and valid subset, each noisy clip its clean one plus
    seeded white noise; and the course CLI's tree, ``root/course/clean``
    (the clean train clips) and ``root/course/noise`` (seeded noise clips).
    Returns the audio seconds of each subset."""
    subsets = load_config(CODEC_CONFIG)["data"]["subset"]
    rng = np.random.default_rng(SEED + 80)
    seconds = {}
    for split in ("train", "valid"):
        clean_dir = os.path.join(root, "corpus", subsets[f"clean_{split}"])
        noisy_dir = os.path.join(root, "corpus", subsets[f"noisy_{split}"])
        for d in (clean_dir, noisy_dir):
            os.makedirs(d)
        seconds[split] = 0.0
        for i in range(RECIPE_CLIPS[split]):
            clean = recipe_clip(rng, rng.uniform(*RECIPE_SECONDS))
            noisy = clean + (0.05 * rng.standard_normal(clean.shape)).astype(np.float32)
            write_wav(os.path.join(clean_dir, f"utt{i:03d}.wav"), clean, SAMPLE_RATE)
            write_wav(os.path.join(noisy_dir, f"utt{i:03d}.wav"), noisy, SAMPLE_RATE)
            seconds[split] += len(clean) / SAMPLE_RATE
    os.makedirs(os.path.join(root, "course", "noise"))
    os.symlink(os.path.join(root, "corpus", subsets["clean_train"]),
               os.path.join(root, "course", "clean"))
    for i in range(RECIPE_CLIPS["train"]):
        noise = 0.3 * rng.standard_normal(int(rng.uniform(*RECIPE_SECONDS) * SAMPLE_RATE))
        write_wav(os.path.join(root, "course", "noise", f"noise{i:03d}.wav"),
                  noise.astype(np.float32), SAMPLE_RATE)
    return seconds


def recipe_config(root, path, **overrides) -> str:
    """``path``'s config with the corpus under ``root`` and ``overrides``
    (step counts, intervals and paths only; each is listed as a cut),
    written under ``root/configs``; returns the copy's path."""
    cfg = load_config(path)
    if "data" in cfg:
        cfg["data"] = dict(cfg["data"], path=os.path.join(root, "corpus"))
    cfg.update(overrides)
    out = os.path.join(root, "configs", os.path.basename(os.path.dirname(path)),
                       os.path.basename(path))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        yaml.safe_dump(cfg, f)
    return out


class RecipeProbe:
    """Instruments the GAN trainers for one CLI run: each training step's
    wall time (synchronised) and its K6 / K7 launches, the state of the
    networks before the step at ``snapshot_at``, the seconds in ``run()``,
    the scalars logged and the steps after each checkpoint load."""

    TRAINERS = (ae_workload.Trainer, voc_workload.Trainer, dn_workload.Trainer)

    def __init__(self, snapshot_at=None):
        self.snapshot_at = snapshot_at
        self.steps, self.logged, self.loads = [], [], []
        self.run_s, self.snapshot, self.waited = 0.0, None, 0.0

    def __enter__(self):
        probe = self
        self.saved = [(cls, "_train_step", cls.__dict__["_train_step"]) for cls in self.TRAINERS]
        self.saved += [(TrainerGAN, name, TrainerGAN.__dict__[name])
                       for name in ("run", "load_checkpoint", "_write_to_tensorboard")]

        def step(original):
            def timed(trainer, batch):
                at = trainer.steps
                if at == probe.snapshot_at:
                    probe.snapshot = {k: {n: v.detach().clone() for n, v in
                                          m.state_dict().items()}
                                      for k, m in trainer.modules.items()}
                    probe.snapshot["vq_state"] = [t.clone() for t in trainer.vq_state]
                torch.cuda.synchronize()
                k6, k7 = log_mel.launches, stft_magnitude.launches
                t0 = time.perf_counter()
                original(trainer, batch)
                torch.cuda.synchronize()
                probe.steps.append({"step": at, "ms": (time.perf_counter() - t0) * 1e3,
                                    "loader_wait_ms": (trainer.loader_wait - probe.waited) * 1e3,
                                    "log_mel": log_mel.launches - k6,
                                    "stft_magnitude": stft_magnitude.launches - k7})
                probe.waited = trainer.loader_wait
            return timed

        for cls, _, original in self.saved[:len(self.TRAINERS)]:
            cls._train_step = step(original)
        run, load = TrainerGAN.run, TrainerGAN.load_checkpoint

        def timed_run(trainer):
            t0 = time.perf_counter()
            try:
                run(trainer)
            finally:
                probe.run_s += time.perf_counter() - t0

        def spied_load(trainer, path, *args, **kwargs):
            load(trainer, path, *args, **kwargs)
            probe.loads.append((os.path.basename(path), trainer.steps))

        TrainerGAN.run, TrainerGAN.load_checkpoint = timed_run, spied_load
        TrainerGAN._write_to_tensorboard = (
            lambda trainer, losses: probe.logged.append((trainer.steps, dict(losses))))
        return self

    def __exit__(self, *exc):
        for cls, name, original in self.saved:
            setattr(cls, name, original)

    def report(self, trainer, peak_bytes: int, stages: dict) -> dict:
        """For each stage (name -> (its step counts, the busy time of one
        more step of it, profiled after the run)): its first step's wall ms
        (cuDNN plans the stage's convolutions there), the median of the
        others, and the busy share (the union of the profiled step's kernel
        intervals over that median); the peak memory; the loader's share of
        the loop's wall time, and of it the part spent on each stage's first
        batch (the loader's thread starts with the loop)."""
        out = {"steps": self.steps, "peak_bytes": peak_bytes, "run_seconds": self.run_s,
               "loader_wait_seconds": trainer.loader_wait,
               "loader_wait_share": trainer.loader_wait / self.run_s}
        for name, (at, (device_ms, busy_ms, top)) in stages.items():
            mine = [s for s in self.steps if s["step"] in at]
            median = statistics.median(s["ms"] for s in mine[1:])
            out[name] = {"first_step_ms": mine[0]["ms"], "step_median_ms": median,
                         "first_batch_wait_ms": mine[0]["loader_wait_ms"],
                         "profiled_step": (
                {"device_ms": device_ms, "busy_ms": busy_ms, "busy_share": busy_ms / median,
                 "top_kernels_ms": top} if device_ms > 0 else None)}
        return out


def profiled_step(trainer, at: int, batch):
    """One more training step of ``trainer`` as at step ``at`` (the step
    function that count selects) on ``batch``, under the profiler after the
    run; its steps counter is put back. Returns device_breakdown's (summed
    ms, busy ms, top kernels)."""
    steps = trainer.steps
    trainer.steps = at
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer._train_step(batch)
        torch.cuda.synchronize()
    trainer.steps = steps
    return device_breakdown(prof)


def first_batch(trainer, mode: str, batch_length: int):
    return next(iter(train_cli.build_data_loaders(trainer.config, mode,
                                                  batch_length)["train"]))


def recipe_run(what, cli_main, argv, per_step, n_steps, kernels, probe):
    """``cli_main(argv)`` under ``probe`` and counted(): ``per_step`` K6 + K7
    launches in each of ``n_steps`` metric-loss calls (training steps and
    eval batches). Returns (result, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with probe:
        result, launches = counted(what, per_step, n_steps, kernels, lambda: cli_main(argv))
    torch.cuda.synchronize()
    return result, launches, torch.cuda.max_memory_allocated()


def logged_finite(what, probe, want_eval: bool):
    values = {f"{step}:{k}": v for step, losses in probe.logged for k, v in losses.items()}
    require(values and all(np.isfinite(v) for v in values.values()),
            f"{what}: a logged loss is not finite: {values}")
    require(any(k.split(":")[1].startswith("eval/") for k in values) == want_eval,
            f"{what}: eval losses logged {sorted(values)}")
    return values


def same_tensors(a: dict, b: dict, prefix: str = "") -> bool:
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a if k.startswith(prefix))


def recipe_phase(root, seconds) -> tuple[dict, dict]:
    """Phases 7a-7e: the AudioDec recipe through its CLIs on the corpus under
    ``root``. Returns (launches by run, report)."""
    exp = os.path.join(root, "exp")
    launches, report = {}, {"cuts": RECIPE_CUTS, "corpus_seconds": seconds}

    # 7a: the codec, stage 1 at 16 x 96000, stage 2 at 16 x 9600, one eval pass
    ae_cfg = recipe_config(root, CODEC_CONFIG, start_steps={"generator": 0, "discriminator": 3},
                           train_max_steps=3, adv_train_max_steps=6, eval_interval_steps=6,
                           log_interval_steps=3)
    argv = ["-c", ae_cfg, "--exp-root", exp, "--tag", "symAD"]
    probe = RecipeProbe(snapshot_at=3)
    trainer, launches["recipe 7a codec"], peak = recipe_run(
        "recipe 7a (codec)", train_cli.main, argv, 2, 7, ("log_mel",), probe)
    ckpt = os.path.join(exp, "autoencoder", "symAD", "checkpoint-6steps")
    require(trainer.steps == 6 and os.path.isdir(ckpt), f"7a: {trainer.steps} steps")
    require([s["log_mel"] for s in probe.steps] == [2] * 6, f"7a: K6 by step {probe.steps}")
    before, after = probe.snapshot, trainer.state
    gen_before, gen_after = before["params_generator"], after["params_generator"]
    require(all(same_tensors(gen_before, gen_after, p) for p in ("encoder.", "projector.")),
            "7a: stage 2 moved the encoder or the projector")
    require(all(torch.equal(a, b) for a, b in zip(before["vq_state"], trainer.vq_state)),
            "7a: stage 2 moved the codebooks")
    require(not same_tensors(gen_before, gen_after, "decoder."), "7a: the decoder did not move")
    require(not same_tensors(before["params_discriminator"], after["params_discriminator"]),
            "7a: the discriminator did not move")
    stages = {"stage 1, 16 x 96000": (range(3), profiled_step(
                  trainer, 0, first_batch(trainer, "autoencoder", RECIPE_LENGTH))),
              "stage 2, 16 x 9600": (range(3, 6), profiled_step(
                  trainer, 5, first_batch(trainer, "autoencoder", VOCODER_METRIC_LENGTH)))}
    report["7a_codec"] = dict(probe.report(trainer, peak, stages),
                              logged=logged_finite("7a", probe, want_eval=True))
    log(f"7a codec: {json.dumps({k: v for k, v in report['7a_codec'].items() if k != 'logged'})}")
    del trainer, before, after

    probe = RecipeProbe()
    trainer, launches["recipe 7a resume"], _ = recipe_run(
        "recipe 7a (--resume)", train_cli.main, argv + ["--resume"], 2, 1, ("log_mel",), probe)
    require(probe.loads == [("checkpoint-6steps", 6)], f"7a --resume loaded {probe.loads}")
    report["7a_resume"] = {"loads": probe.loads, "steps_after": trainer.steps}
    log(f"7a --resume: loaded {probe.loads}, then {trainer.steps} steps")
    del trainer

    # 7b: the analyzer's statistics
    stats_path = os.path.join(root, "stats", "symAD_vctk_48000_hop300_clean.npy")
    stat_cfg = recipe_config(root, STATISTIC_CONFIG, analyzer=ckpt, stats=stats_path)
    compute, compute_s = stat_cli.compute_statistics, []

    def timed_compute(*args, **kwargs):
        t1 = time.perf_counter()
        out = compute(*args, **kwargs)  # ends in a read from the card
        compute_s.append(time.perf_counter() - t1)
        return out

    stat_cli.compute_statistics = timed_compute
    t0 = time.perf_counter()
    try:
        stats = stat_cli.main(["-c", stat_cfg])
    finally:
        stat_cli.compute_statistics = compute
    stat_s = time.perf_counter() - t0
    require(stats.shape == (2, 64) and np.all(np.isfinite(stats)) and np.all(stats[1] > 0),
            f"7b: statistics {stats.shape}, min scale {stats[1].min()}")
    report["7b_statistic"] = {"cli_seconds": stat_s, "compute_seconds": compute_s[0],
                              "audio_seconds": seconds["train"],
                              "audio_seconds_per_second": seconds["train"] / compute_s[0],
                              "scale_min": float(stats[1].min())}
    log(f"7b statistic: {json.dumps(report['7b_statistic'])}")

    # 7c: the v1 vocoder on the frozen analyzer, 16 x 9600
    vcfg = load_config(VOCODER_CONFIG)
    voc_cfg = recipe_config(root, VOCODER_CONFIG, analyzer=ckpt, train_max_steps=5,
                            eval_interval_steps=5, log_interval_steps=5,
                            generator_params=dict(vcfg["generator_params"], stats=stats_path))
    probe = RecipeProbe()
    trainer, launches["recipe 7c vocoder"], peak = recipe_run(
        "recipe 7c (vocoder)", train_cli.main, ["-c", voc_cfg, "--exp-root", exp], 8, 4,
        SPECTRUM_KERNELS, probe)
    by_step = [(s["step"], s["log_mel"], s["stft_magnitude"]) for s in probe.steps]
    require(by_step == [(0, 0, 0), (1, 0, 0), (2, 2, 6), (3, 2, 6), (4, 2, 6)],
            f"7c: (step, K6, K7) {by_step}: the generator's first update must be at step 2")
    require(same_tensors(load_checkpoint(ckpt)["params_generator"],
                         trainer.analyzer.state_dict()), "7c: the analyzer moved")
    stages = {"generator and discriminator, 16 x 9600": (range(2, 5), profiled_step(
        trainer, 4, first_batch(trainer, "vocoder", VOCODER_METRIC_LENGTH)))}
    report["7c_vocoder"] = dict(probe.report(trainer, peak, stages),
                                logged=logged_finite("7c", probe, want_eval=True))
    log(f"7c vocoder: {json.dumps({k: v for k, v in report['7c_vocoder'].items() if k != 'logged'})}")
    del trainer

    # 7d: denoise from the codec, 16 x 96000
    dn_cfg = recipe_config(root, CONFIG, initial=ckpt, train_max_steps=3,
                           adv_train_max_steps=3, eval_interval_steps=3, log_interval_steps=3)
    probe = RecipeProbe()
    trainer, launches["recipe 7d denoise"], peak = recipe_run(
        "recipe 7d (denoise)", train_cli.main, ["-c", dn_cfg, "--exp-root", exp], 2, 4,
        ("log_mel",), probe)
    initial = load_checkpoint(ckpt)
    state = trainer.state
    require(same_tensors(initial["params_generator"], state["params_generator"], "decoder."),
            "7d: the decoder moved")
    require(all(torch.equal(initial["vq_state"][f], getattr(trainer.vq_state, f).cpu())
                for f in VQState._fields), "7d: the codebooks moved")
    require(not same_tensors(initial["params_generator"], state["params_generator"],
                             "encoder."), "7d: the encoder did not move")
    stages = {"16 x 96000": (range(3), profiled_step(
        trainer, 2, first_batch(trainer, "denoise", RECIPE_LENGTH)))}
    report["7d_denoise"] = dict(probe.report(trainer, peak, stages),
                                logged=logged_finite("7d", probe, want_eval=True))
    log(f"7d denoise: {json.dumps({k: v for k, v in report['7d_denoise'].items() if k != 'logged'})}")
    del trainer, state, initial

    # 7e: the course CLI on AudioDataset / get_dataloaders, one LAPTOP epoch
    course_dir = os.path.dirname(recipe_config(root, COURSE_CONFIG, epochs=1))
    argv = ["-e", "LAPTOP", "-c", os.path.basename(COURSE_CONFIG), "--config-dir", course_dir,
            "--clean-path", os.path.join(root, "course", "clean"),
            "--noise-path", os.path.join(root, "course", "noise"),
            "--job-dir", os.path.join(root, "job_out")]
    t0 = time.perf_counter()
    (state, history), launches["recipe 7e course CLI"] = counted(
        "recipe 7e (course CLI, LAPTOP)", 2, 4, ("log_mel",), lambda: course_cli.main(argv))
    h = history[0]
    require(state["steps"] == 3 and len(history) == 1
            and all(np.isfinite(v) for v in (h["train_gen"], h["val_gen"])),
            f"7e: {state['steps']} steps, history {history}")
    report["7e_course_cli"] = {"seconds": time.perf_counter() - t0, "history": history}
    log(f"7e course CLI: {json.dumps(report['7e_course_cli'])}")
    return launches, report


def prefetch_check(n_batches: int = 6) -> dict:
    """Phase 7g: ``prefetch_to_device`` at the recipe's pair batches (16 x
    96000 x 1, two arrays) and the trainer's depth, with a long kernel
    ahead of every copy on the stream and the source refilling one host
    buffer in place: each device batch must equal its host arrays bit for
    bit, those handed on before the generator is closed early too, and the
    stream must still be busy when the first batch is handed on (the
    copies wait for nothing). Returns the batches held."""
    rng = np.random.default_rng(SEED + 95)
    want = [rng.standard_normal((COURSE_BATCH, RECIPE_LENGTH, 1)).astype(np.float32)
            for _ in range(n_batches)]
    buf = np.empty_like(want[0])

    def source():
        for a in want:
            torch.cuda._sleep(20_000_000)
            buf[...] = a
            yield buf, 2.0 * buf

    def held(got):
        torch.cuda.synchronize()
        for (u, v), a in zip(got, want):
            require(torch.equal(u.cpu(), torch.from_numpy(a))
                    and torch.equal(v.cpu(), torch.from_numpy(2.0 * a)),
                    "7g: a device batch differs from its host arrays")
        return len(got)

    it = prefetch_to_device(source(), device=DEVICE)
    got = [next(it)]
    busy = not torch.cuda.current_stream().query()
    got += list(it)
    require(busy and len(got) == n_batches, f"7g: busy {busy}, {len(got)} batches")
    out = {"batches_held": held(got), "stream_busy_at_first_batch": busy}
    it = prefetch_to_device(source(), device=DEVICE)
    got = [next(it), next(it)]
    it.close()
    out["batches_held_after_close"] = held(got)
    return out


class MelSigns:
    """Within it every MultiMelSpectrogramLoss computes its L1 as mean(s *
    d), d = log mel y^ - log mel y per resolution and s = sign(d) detached:
    the value and the gradient of mean(|d|) bit for bit (|d| = sign(d) d
    exactly, and abs's derivative is sign). It records each s in
    ``signs``; with ``fixed`` (a list of them) it uses those signs instead,
    so two routes can take the same signs."""

    def __init__(self, fixed=None):
        self.fixed, self.signs = fixed, []

    def __enter__(self):
        probe, self.saved = self, MultiMelSpectrogramLoss.__call__

        def call(loss, y_hat, y):
            total = 0.0
            for mel in loss.mels:
                d = mel(flat_waves(y_hat)) - mel(flat_waves(y))
                sign = torch.sign(d.detach())
                if probe.fixed is not None:
                    sign = probe.fixed[len(probe.signs)]
                probe.signs.append(torch.sign(d.detach()))
                total = total + torch.mean(sign * d)
            return total / len(loss.mels)

        MultiMelSpectrogramLoss.__call__ = call
        return self

    def __exit__(self, *exc):
        MultiMelSpectrogramLoss.__call__ = self.saved


def mel_sign_flips(codec, vq, clean):
    """Phase 7f's cause check on the tone-only signals (``clean``, no white
    noise): one codec stage-1 step (target: its input) and one denoise step
    (input: ``clean`` plus seeded white noise; target: ``clean``) on each
    route from the same state. For each: the bins where the routes'
    sign(log mel y^ - log mel y) differ, the gradient gap with each route's
    own signs, and the gap with the plain route's signs on both routes,
    which must be within ROUTE_GRAD_RTOL (the mel L1's signs being then the
    only difference). Returns the readings."""
    ccfg, dcfg = load_config(CODEC_CONFIG), load_config(CONFIG)
    rng = np.random.default_rng(SEED + 96)
    x = torch.from_numpy(clean).to(DEVICE)
    noisy = x + torch.from_numpy((0.05 * rng.standard_normal(clean.shape))
                                 .astype(np.float32)).to(DEVICE)
    out = {}
    for case in ("stage 1", "denoise"):
        def step(route, fixed=None):
            gen = copy.deepcopy(codec)
            cfg = routed(ccfg if case == "stage 1" else dcfg, route)
            opt_g = build_optimizer_from_config(cfg, "generator", gen.parameters())
            with MelSigns(fixed) as signs:
                if case == "stage 1":
                    ae_workload.make_autoencoder_steps(gen, None, cfg, opt_g, None)[
                        "gen_stage1"](vq, x)
                else:
                    dn_workload.make_denoise_steps(gen, cfg, opt_g)["train"](vq, noisy, x)
            g = grads({"generator": gen})
            del gen, opt_g
            return signs.signs, g

        s_plain, g_plain = step("plain")
        s_auto, g_auto = step("auto")
        _, g_plain_fixed = step("plain", s_plain)
        _, g_auto_fixed = step("auto", s_plain)
        out[case] = {
            "bins": sum(t.numel() for t in s_plain),
            "sign_flips": sum(int((a != p).sum()) for a, p in zip(s_auto, s_plain)),
            "grad_rel_err_own_signs": max(grad_rel_errs(g_auto, g_plain).values()),
            "grad_rel_err_plain_signs": max(grad_rel_errs(g_auto_fixed,
                                                          g_plain_fixed).values()),
            "plain_route_unchanged_by_fixing": same_tensors(g_plain_fixed, g_plain)}
        log(f"7f tone-only {case}: {json.dumps(out[case])}")
        require(out[case]["grad_rel_err_plain_signs"] <= ROUTE_GRAD_RTOL,
                f"7f tone-only {case}: with the plain route's mel signs on both routes the "
                f"gradients still differ beyond {ROUTE_GRAD_RTOL}")
        torch.cuda.empty_cache()
    return out


def with_log_mag_grad(voc, step):
    """``step()`` (one vocoder generator step) with the gradient of its
    loss's log-STFT-magnitude term alone taken into ``voc``'s parameters
    where the step's metric loss returns (the graph kept for the step's own
    backward). Returns (step's result, {"generator.<name>": gradient})."""
    named = list(voc.named_parameters())
    got = []

    def spied(crit, config, y, x):
        total, frags = metric_loss(crit, config, y, x)
        got.append(torch.autograd.grad(frags["log_stft_magnitude_loss"],
                                       [p for _, p in named], retain_graph=True))
        return total, frags

    voc_workload.metric_loss = spied
    try:
        out = step()
    finally:
        voc_workload.metric_loss = metric_loss
    return out, {f"generator.{n}": g for (n, _), g in zip(named, got[0])}


def route_step(route, what, per_step, kernels, fn):
    """``fn()``; on the kernel route counted (``per_step`` launches)."""
    if route != "auto":
        return fn(), None
    return counted(f"7f {what}, kernel route", per_step, 1, kernels, fn)


def grads(nets: dict) -> dict:
    return {f"{k}.{n}": p.grad.detach().clone() for k, m in nets.items()
            for n, p in m.named_parameters() if p.grad is not None}


def scalars(frags: dict) -> dict:
    return {k: float(v) for k, v in frags.items()}


def routed(cfg, route):
    return dict(cfg, mel_loss_params=dict(cfg["mel_loss_params"], backend=route),
                stft_loss_params=dict(cfg["stft_loss_params"], backend=route))


def recipe_routes(codec, vq):
    """Phase 7f, cuDNN's deterministic algorithms on: one step of each
    workload on the kernel route ('auto') and the plain route from the same
    state and batch (the served codec's weights and codebooks, copied; the
    vocoder's and the discriminators' seeded; tones with white noise, the
    denoise target another noise draw), held as phase 5b holds the
    course step: fragments ROUTE_FRAG_RTOL, every gradient ROUTE_GRAD_RTOL
    of its tensor's largest; the vocoder generator's split as phase 5d
    splits it, the rest of its loss (mel, spectral convergence,
    adversarial) at ROUTE_GRAD_RTOL and its log-STFT-magnitude term's at
    LOG_MAG_GRAD_RTOL. A discriminator step follows
    its generator step from the kernel route's updated generator on both
    routes. Returns (launches by step, checks)."""
    ccfg, vcfg, dcfg = (load_config(c) for c in (CODEC_CONFIG, VOCODER_CONFIG, CONFIG))
    rng = np.random.default_rng(SEED + 90)
    clean = np.stack([recipe_clip(rng, RECIPE_LENGTH / SAMPLE_RATE)
                      for _ in range(COURSE_BATCH)])[..., None]
    # each signal a loss reads carries white noise (at -26 dB of the tones):
    # against a tone target, the mel loss's sign(log mel y - log mel x)
    # flips between routes where the two nearly coincide, and the gradients
    # part by ~1e-3 of the largest while every fragment stays bit-equal
    # (mel_sign_flips shows it on these tones)
    x_n, x_t = (torch.from_numpy(clean + (0.05 * rng.standard_normal(clean.shape))
                                 .astype(np.float32)).to(DEVICE) for _ in range(2))
    x_short = x_n[:, :VOCODER_METRIC_LENGTH].contiguous()
    disc0 = build_discriminator("symAudioDec", ccfg["discriminator_params"], device=DEVICE,
                                seed=SEED + 91)
    voc0 = build_vocoder(VOCODER_CONFIG)
    vdisc0 = build_discriminator("HiFiGAN", vcfg["discriminator_params"], device=DEVICE,
                                 seed=SEED + 92)
    launches, checks, runs = {}, {}, {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for route in ("auto", "plain"):
            r = runs[route] = {}
            gen, disc = copy.deepcopy(codec), copy.deepcopy(disc0)
            opt_g = build_optimizer_from_config(ccfg, "generator", gen.parameters())
            opt_d = build_optimizer_from_config(ccfg, "discriminator", disc.parameters())
            steps = ae_workload.make_autoencoder_steps(gen, disc, routed(ccfg, route), opt_g,
                                                       opt_d)
            (new_vq, frags, _), launches[f"7f codec stage 1 ({route})"] = route_step(
                route, "codec stage 1", 2, ("log_mel",), lambda: steps["gen_stage1"](vq, x_n))
            r["stage 1"] = (scalars(frags), grads({"generator": gen}))
            r["stage 1 codebooks"] = new_vq
            r["stage 1 generator"] = copy.deepcopy(gen.state_dict())
            if route == "plain":  # stage 2 from the kernel route's stage-1 generator
                gen.load_state_dict(runs["auto"]["stage 1 generator"])
            (_, frags, _), launches[f"7f codec stage 2 ({route})"] = route_step(
                route, "codec stage 2", 2, ("log_mel",),
                lambda: steps["gen_stage2"](vq, x_short))
            r["stage 2"] = (scalars(frags), grads({"generator": gen}))
            r["stage 2 generator"] = copy.deepcopy(gen.state_dict())
            if route == "plain":  # the discriminator step from the same generator
                gen.load_state_dict(runs["auto"]["stage 2 generator"])
            frags, launches[f"7f codec discriminator ({route})"] = route_step(
                route, "codec discriminator", 0, (), lambda: steps["dis"](vq, x_short))
            r["stage 2 discriminator"] = (scalars(frags), grads({"discriminator": disc}))
            del gen, disc, opt_g, opt_d, steps

            voc, vdisc = copy.deepcopy(voc0), copy.deepcopy(vdisc0)
            opt_g = build_optimizer_from_config(vcfg, "generator", voc.parameters())
            opt_d = build_optimizer_from_config(vcfg, "discriminator", vdisc.parameters())
            steps = voc_workload.make_vocoder_steps(codec, vq, voc, vdisc, routed(vcfg, route),
                                                    opt_g, opt_d)
            (frags, g_mag), launches[f"7f vocoder generator ({route})"] = route_step(
                route, "vocoder generator", 8, SPECTRUM_KERNELS,
                lambda: with_log_mag_grad(voc, lambda: steps["gen_adv"](x_short)))
            whole = grads({"generator": voc})
            # the step's gradient without its log-STFT-magnitude term (mel,
            # spectral convergence, adversarial), and that term's alone
            r["vocoder generator"] = (scalars(frags),
                                      {k: g - g_mag[k] for k, g in whole.items()})
            r["vocoder log-magnitude"] = (
                {"log_stft_magnitude_loss": float(frags["log_stft_magnitude_loss"])}, g_mag)
            r["vocoder state"] = copy.deepcopy(voc.state_dict())
            if route == "plain":
                voc.load_state_dict(runs["auto"]["vocoder state"])
            frags, launches[f"7f vocoder discriminator ({route})"] = route_step(
                route, "vocoder discriminator", 0, (), lambda: steps["dis"](x_short))
            r["vocoder discriminator"] = (scalars(frags), grads({"discriminator": vdisc}))
            del voc, vdisc, opt_g, opt_d, steps

            gen = copy.deepcopy(codec)
            opt_g = build_optimizer_from_config(dcfg, "generator", gen.parameters())
            steps = dn_workload.make_denoise_steps(gen, routed(dcfg, route), opt_g)
            (frags, _), launches[f"7f denoise ({route})"] = route_step(
                route, "denoise", 2, ("log_mel",), lambda: steps["train"](vq, x_n, x_t))
            r["denoise"] = (scalars(frags), grads({"generator": gen}))
            del gen, opt_g, steps
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    failed = []
    for what in ("stage 1", "stage 2", "stage 2 discriminator", "vocoder generator",
                 "vocoder log-magnitude", "vocoder discriminator", "denoise"):
        rtol = LOG_MAG_GRAD_RTOL if what == "vocoder log-magnitude" else ROUTE_GRAD_RTOL
        require(all(np.isfinite(v) for v in runs["auto"][what][0].values()),
                f"7f {what}: {runs['auto'][what][0]}")
        try:  # every workload held and logged before a failure ends the run
            checks[what] = held_routes(f"7f {what}, kernel vs plain route",
                                       runs["plain"][what], runs["auto"][what],
                                       ROUTE_FRAG_RTOL, rtol)
        except Failure as e:
            failed.append(str(e))
    require(not failed, "; ".join(failed))
    require(all(torch.equal(a, b) for a, b in zip(runs["auto"]["stage 1 codebooks"],
                                                   runs["plain"]["stage 1 codebooks"])),
            "7f: the routes' stage-1 codebooks differ")
    require("vocoder generator" in checks and "log_stft_magnitude_loss" in
            runs["auto"]["vocoder generator"][0], "7f: the vocoder's loss has no STFT term")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        checks["tone-only sign flips"] = mel_sign_flips(codec, vq, clean)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return {k: v for k, v in launches.items() if v is not None}, checks


# ------------------------------------ evaluation and the reference's checkpoints


def onnx_writer():
    """tests/onnx_writer.py (numpy only; no part of the JAX package), the
    ONNX encoder the interpreter's checks build their graphs with."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "onnx_writer", os.path.join(REPO, "tests", "onnx_writer.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def dnsmos_standins(root: str, seed: int = SEED) -> tuple[str, str]:
    """Two seeded stand-ins for the DNSMOS graphs, which are not in the
    repository, at the real graphs' interfaces, written as ``root/DNSMOS/
    sig_bak_ovr.onnx`` and ``root/DNSMOS/model_v8.onnx`` (the layout
    ``eval/dnsmos.py::default_model_paths`` reads):

    - primary: (N, 144160) -> (N, 3): the audio as (N, 1, 901, 160), a
      strided 3 x 3 conv to 4 channels, ReLU, 2 x 2 max pool, global
      average pool, a dense layer, 1 + 4 sigmoid;
    - P.808: (N, 900, 120) -> (N, 1) (the mel front end's frames of a
      segment): unsqueezed to NCHW, a padded conv,
      ReLU, a max pool with asymmetric pads, a max over time and mels, a
      dense layer, 1 + 4 sigmoid.

    Returns the two paths."""
    ow = onnx_writer()
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.3):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    def head(x, dense, bias, out):
        return [ow.node("MatMul", [x, dense], ["hd"]), ow.node("Add", ["hd", bias], ["ha"]),
                ow.node("Sigmoid", ["ha"], ["hs"]), ow.node("Mul", ["hs", "four"], ["hm"]),
                ow.node("Add", ["hm", "one"], [out])]

    consts = {"four": np.full((1,), 4.0, np.float32), "one": np.ones((1,), np.float32)}
    d = os.path.join(root, "DNSMOS")
    os.makedirs(d, exist_ok=True)
    primary = ow.write_model(
        os.path.join(d, "sig_bak_ovr.onnx"),
        [ow.node("Reshape", ["input_1", "shape"], ["x4"]),
         ow.node("Conv", ["x4", "w1", "b1"], ["c1"], strides=[2, 2], auto_pad=b"VALID"),
         ow.node("Relu", ["c1"], ["r1"]),
         ow.node("MaxPool", ["r1"], ["p1"], kernel_shape=[2, 2], strides=[2, 2]),
         ow.node("GlobalAveragePool", ["p1"], ["g"]),
         ow.node("Flatten", ["g"], ["f"], axis=1), *head("f", "wd", "bd", "Identity_0")],
        {"shape": np.asarray([-1, 1, 901, 160], np.int64), "w1": w(4, 1, 3, 3, scale=1.0),
         "b1": w(4, scale=0.1), "wd": w(4, 3, scale=1.0), "bd": w(3, scale=0.1), **consts},
        ["input_1"], ["Identity_0"])
    p808 = ow.write_model(
        os.path.join(d, "model_v8.onnx"),
        [ow.node("Unsqueeze", ["input_1"], ["x4"], axes=[1]),
         ow.node("Conv", ["x4", "w1", "b1"], ["c1"], pads=[1, 1, 1, 1]),
         ow.node("Relu", ["c1"], ["r1"]),
         ow.node("MaxPool", ["r1"], ["p1"], kernel_shape=[3, 3], strides=[2, 2],
                 pads=[0, 0, 1, 1]),
         ow.node("ReduceMax", ["p1"], ["m"], axes=[2, 3], keepdims=0),
         *head("m", "wd", "bd", "Identity_0")],
        {"w1": w(4, 1, 3, 3), "b1": w(4, scale=0.1), "wd": w(4, 1, scale=2.0),
         "bd": w(1, scale=0.1), **consts},
        ["input_1"], ["Identity_0"])
    return primary, p808


def state_equal(a, b) -> bool:
    """Two loaded checkpoint states equal: the same keys, tensors bit for bit."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            state_equal(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def write_config(path: str, cfg: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def reference_checkpoints(root, codec, vq, voc):
    """8a: the full-width codec (with the warm-up codebooks and a seeded
    discriminator, framework format) and the v1 vocoder (with its
    statistics, course format) out through ``cli.export_checkpoint`` and
    back through ``cli.import_checkpoint`` on the card: each imported state
    bit for bit the exported one. Then CLI_SECONDS of audio streamed through
    ``cli.stream --checkpoint`` (the fused streamer, the kernel route) from
    the original and from the imported codec checkpoint, and through
    ``make_scan_stream(...).run_with_codes`` with each's modules: the audio
    and the wire codes bit for bit. Returns (launches by run, report,
    paths)."""
    report, launches, paths = {}, {}, {}
    cfg = load_config(CODEC_CONFIG)
    disc = build_discriminator(cfg["model_type"], cfg["discriminator_params"], device=DEVICE,
                               seed=SEED + 90)
    ckpt = os.path.join(root, "port", "codec", "checkpoint-1000steps")
    save_checkpoint(ckpt, {"params_generator": codec.state_dict(), "vq_state": vq,
                           "params_discriminator": disc.state_dict(), "steps": 1000,
                           "epochs": 3}, cfg)
    del disc
    vcfg = load_config(VOCODER_CONFIG)
    stats_path = os.path.join(root, "stats", "v1.npy")
    os.makedirs(os.path.dirname(stats_path))
    np.save(stats_path, torch.stack([voc.mean, voc.scale]).cpu().numpy())
    vckpt = os.path.join(root, "port", "vocoder", "checkpoint-500000steps")
    save_checkpoint(vckpt, {"params_generator": voc.state_dict()},
                    dict(vcfg, generator_params=dict(vcfg["generator_params"],
                                                     stats=stats_path)))
    imported = {"codec": os.path.join(root, "imported", "codec", "checkpoint-1000steps"),
                "vocoder": os.path.join(root, "imported", "vocoder", "checkpoint-500000steps")}
    imported_stats = os.path.join(os.path.dirname(imported["vocoder"]), "stats_imported.npy")
    configs = {"codec": CODEC_CONFIG, "vocoder": write_config(
        os.path.join(root, "configs", "v1.yaml"),
        dict(vcfg, generator_params=dict(vcfg["generator_params"], stats=imported_stats)))}
    for name, src, fmt in (("codec", ckpt, "framework"), ("vocoder", vckpt, "course")):
        pkl = os.path.join(root, "reference", f"{name}.pkl")
        t0 = time.perf_counter()
        export_cli.main(["--checkpoint", src, "--out", pkl, "--format", fmt])
        t1 = time.perf_counter()
        import_cli.main(["--checkpoint", pkl, "--config", configs[name], "--out",
                         imported[name]])
        t2 = time.perf_counter()
        saved = torch.load(pkl, map_location="cpu", weights_only=True)
        want, got = load_checkpoint(src), load_checkpoint(imported[name])
        require(state_equal(want, got), f"8a {name}: the imported state is not the exported "
                f"one (keys {sorted(want)} / {sorted(got)})")
        report[name] = {
            "format": fmt, "export_s": t1 - t0, "import_s": t2 - t1,
            "pickle_bytes": os.path.getsize(pkl),
            "generator_tensors": len(saved["model"]["generator"] if fmt == "framework"
                                     else saved),
            "state_keys": sorted(got)}
        log(f"8a {name}: {json.dumps(report[name])}")
    require(np.array_equal(np.load(imported_stats), np.load(stats_path)),
            "8a: the vocoder's imported statistics differ")

    n = CLI_SECONDS * SAMPLE_RATE // FRAME
    audio = frames_for(n, SEED + 81)[:, 0, :, 0]
    wav_in = os.path.join(root, "stream_in.wav")
    write_wav(wav_in, audio.reshape(-1).cpu().numpy(), SAMPLE_RATE)
    frames = torch.from_numpy(read_wav(wav_in)[0][:, 0]).to(DEVICE).reshape(n, 1, FRAME, 1)
    outs, streams = {}, {}
    for name, path in (("original", ckpt), ("imported", imported["codec"])):
        out = os.path.join(root, f"stream_{name}.wav")
        stats, launches[f"8a cli --checkpoint ({name})"] = counted(
            f"8a cli --checkpoint ({name})", LAUNCHES_PER_DISPATCH["codec"], n + 2,
            CODEC_KERNELS,
            lambda: stream_cli.main(["--checkpoint", path, "-i", wav_in, "-o", out,
                                     "--max-latency", str(CLI_MAX_LATENCY)]))
        require(stats["frames"] == n and stats["frame_drops"] == 0,
                f"8a cli --checkpoint ({name}): {stats}")
        outs[name] = produced(read_wav(out)[0][:, 0], n)
        gen, gen_vq, _ = load_generator_from_checkpoint(path, device=DEVICE)
        streams[name] = stream_codes(make_scan_stream(gen, gen_vq, frame_size=FRAME), frames,
                                     MAIN_FRAMES if sum(MAIN_FRAMES) == n else (n,))
        report[f"stream_{name}"] = {"fused_ms_mean": stats["fused_ms_mean"]}
        del gen, gen_vq
    require(np.array_equal(outs["original"], outs["imported"]),
            "8a: cli.stream of the imported codec differs from the original's")
    require(all(torch.equal(a, b) for a, b in zip(streams["original"], streams["imported"])),
            "8a: the imported codec's stream (audio or codes) differs from the original's")
    report["stream"] = {"frames": n, "cli_audio_bit_equal": True,
                        "scan_stream_audio_and_codes_bit_equal": True}
    log(f"8a streams: {n} frames, the imported codec's audio and codes bit for bit the "
        "original's")
    paths.update(codec=imported["codec"], vocoder=imported["vocoder"])
    return launches, report, paths


def offline_codes(gen, vq, x):
    """The analyzer's projector output (B, T, D) and flat codes (T, B, L)
    of ``x`` (B, T_audio, 1), as held_codes takes them; cli.test's and the
    composite's encode, project and quantize."""
    with torch.no_grad():
        z = gen.projector(gen.encoder(x))
        codes = gen.quantizer.inference(vq, z)[1]
    k = vq.embed.shape[2]
    flat = codes.permute(2, 1, 0) + torch.arange(codes.shape[0], device=codes.device) * k
    return z, flat.to(torch.int32)


def held_audio(what, got, ref, agree_samples=None) -> dict:
    """``got`` within EVAL_ATOL of ``ref``'s largest sample plus one PCM16
    step, over the first ``agree_samples`` (where the codes agree)."""
    got, ref = np.asarray(got)[:agree_samples], np.asarray(ref)[:agree_samples]
    require(got.shape == ref.shape, f"{what}: shapes {got.shape} / {ref.shape}")
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    require(err <= EVAL_ATOL * scale + PCM16_STEP, f"{what}: max|err| {err:.3e} against "
            f"{EVAL_ATOL} x {scale:.3e} + one PCM16 step")
    return {"max_abs_err": err, "max_abs_ref": scale, "samples": int(got.shape[0])}


def codec_test_phase(root, codec_ckpt, clip_dir):
    """8b: ``cli.test`` on the imported codec over TEST_CLIPS clips, on the
    card and on the CPU: the projector's output within EVAL_ATOL, the codes
    up to near ties (CODE_RTOL), the wavs within EVAL_ATOL of the largest
    sample where the codes agree; the RTF per clip and the mean."""
    outs = {d: os.path.join(root, f"codec_test_{d}") for d in ("cuda", "cpu")}
    runs = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[d], _ = counted(f"8b cli.test ({d})", 0, 0, (), lambda: codec_test_cli.main(
            ["--encoder", codec_ckpt, "--input", clip_dir, "--output", outs[d],
             "--subset-num", str(TEST_CLIPS), "--device", d]))
        runs[d]["wall_s"] = time.perf_counter() - t0
    require(sorted(runs["cuda"]["rtf"]) == sorted(runs["cpu"]["rtf"])
            and len(runs["cuda"]["rtf"]) == TEST_CLIPS, f"8b: clips {runs}")
    models = {d: load_generator_from_checkpoint(codec_ckpt, device=d)[:2]
              for d in ("cuda", "cpu")}
    tables = vq_tables(models["cuda"][1], DEVICE)
    checks = {}
    for utt in sorted(runs["cuda"]["rtf"]):
        audio = read_wav(os.path.join(clip_dir, f"{utt}.wav"))[0]
        hop = models["cpu"][0].hop
        t = (audio.shape[0] // hop) * hop
        x = torch.from_numpy(audio[None, :t, :1].copy())
        z, codes = offline_codes(*models["cuda"], x.to(DEVICE))
        z_cpu, codes_cpu = offline_codes(*models["cpu"], x)
        z_err = float((z.cpu() - z_cpu).abs().max())
        require(z_err <= EVAL_ATOL, f"8b {utt}: projector output max|err| {z_err:.3e}")
        held, agree = held_codes(f"8b {utt} codes", z.transpose(0, 1), tables, codes,
                                 codes_cpu.to(DEVICE))
        wav = f"{utt}_output.wav"
        checks[utt] = {
            "projector_max_abs_err": z_err, "max_abs_z": float(z_cpu.abs().max()),
            "near_tie_rows": held["ties"], "frames": int(codes.shape[0]),
            "audio": held_audio(f"8b {utt} audio", read_wav(os.path.join(outs["cuda"], wav))[0],
                                read_wav(os.path.join(outs["cpu"], wav))[0],
                                agree * hop),
            "rtf_cuda": runs["cuda"]["rtf"][utt], "rtf_cpu": runs["cpu"]["rtf"][utt]}
    report = {"clips": checks, "mean_rtf_cuda": runs["cuda"]["mean_rtf"],
              "mean_rtf_cpu": runs["cpu"]["mean_rtf"],
              "wall_s": {d: runs[d]["wall_s"] for d in runs}}
    log(f"8b cli.test: {json.dumps(report)}")
    return report


def denoise_test_phase(root, codec_ckpt, voc_ckpt):
    """8c: ``cli.testing_denoise -e LAPTOP`` with a seeded full-width flagship
    (FLAGSHIP_CONFIG, without PQC) and the ``AD`` composite of 8a's imported
    codec and vocoder, on the card and on the CPU: every wav within
    EVAL_ATOL of its CPU twin's largest sample (the composite's where its
    codes agree, up to near ties); the wall time per clip."""
    cfg = load_config(FLAGSHIP_CONFIG)
    flagship = AudioDecGenerator(**cfg["generator_params"], use_pqc=False, seed=SEED + 91,
                                 device=DEVICE)
    flag_ckpt = os.path.join(root, "port", "flagship", "checkpoint-1")
    save_checkpoint(flag_ckpt, {"params_generator": flagship.state_dict()}, cfg)
    del flagship
    course = os.path.join(root, "course")
    codes, original = {"cuda": [], "cpu": []}, testing_cli.ad_model
    run_on = []  # the device of the run in progress

    def recording(analyzer, vq, vocoder):
        """The composite, its codes (and projector output) kept per batch."""
        infer, hop = original(analyzer, vq, vocoder)

        def run(x):
            xs = torch.as_tensor(np.asarray(x, np.float32), device=analyzer.device)
            codes[run_on[-1]].append(offline_codes(analyzer, vq, xs))
            return infer(x)
        return run, hop

    outs, counts, wall = {}, {}, {}
    testing_cli.ad_model = recording
    try:
        for d in ("cuda", "cpu"):
            run_on.append(d)
            outs[d] = os.path.join(root, f"test_out_{d}")
            t0 = time.perf_counter()
            counts[d], _ = counted(f"8c cli.testing_denoise ({d})", 0, 0, (),
                                   lambda: testing_cli.main([
                "-e", "LAPTOP", "-c", os.path.basename(FLAGSHIP_CONFIG),
                "--config-dir", os.path.dirname(FLAGSHIP_CONFIG),
                "--clean-path", os.path.join(course, "clean"),
                "--noise-path", os.path.join(course, "noise"),
                "--flagship", f"flagship={flag_ckpt}", "--vocoder", f"{voc_ckpt}:{codec_ckpt}",
                "--out-dir", outs[d], "--device", d]))
            wall[d] = time.perf_counter() - t0
    finally:
        testing_cli.ad_model = original
    require(counts["cuda"] == counts["cpu"] and min(counts["cuda"].values()) > 0,
            f"8c: wavs written {counts}")
    analyzer, vq, _ = load_generator_from_checkpoint(codec_ckpt, device=DEVICE)
    tables, hop = vq_tables(vq, DEVICE), analyzer.hop
    del analyzer
    agree, ties = {}, 0
    for b, ((z, c), (_, c_cpu)) in enumerate(zip(codes["cuda"], codes["cpu"])):
        held, frames = held_codes(f"8c AD batch {b} codes", z.transpose(0, 1), tables, c,
                                  c_cpu.to(DEVICE))
        ties += held["ties"]
        per_clip = (c != c_cpu.to(DEVICE)).any(2)  # (T, B)
        for i in range(c.shape[1]):
            differ = per_clip[:, i].nonzero()
            agree[b * c.shape[1] + i] = int(differ[0, 0]) if differ.numel() else None
    checks = {}
    for name in sorted(os.listdir(outs["cuda"])):
        for wav in sorted(os.listdir(os.path.join(outs["cuda"], name))):
            n = int(wav.split("-")[1].split(".")[0])
            first = agree.get(n) if name == "AD" else None
            checks[f"{name}/{wav}"] = held_audio(
                f"8c {name}/{wav}", read_wav(os.path.join(outs["cuda"], name, wav))[0],
                read_wav(os.path.join(outs["cpu"], name, wav))[0],
                None if first is None else first * hop)
    n_clips = sum(counts["cuda"].values())
    report = {"written": counts["cuda"], "wavs": checks, "ad_near_tie_rows": ties,
              "wall_s": wall, "wall_s_per_clip": {d: wall[d] / n_clips for d in wall}}
    log(f"8c cli.testing_denoise: {json.dumps(report)}")
    return report, outs["cuda"]


def analyze_phase(test_out):
    """8d: ``cli.analyze --eval-wavs`` on 8c's card output, each model's clip
    against its clean one, on the card and on the CPU: STOI / ESTOI / SDR
    within METRIC_EXACT, SNR / SI-SDR within METRIC_DB, Mel-L1 within
    METRIC_MEL_RTOL."""
    clips = sorted(os.listdir(os.path.join(test_out, "clean")))
    printed = analyze_cli.main(["--clean", os.path.join(test_out, "clean", clips[0]),
                                "--eval-wavs", os.path.join(test_out, "flagship", clips[0])])
    require(all(np.isfinite(v) for b in printed.values() for v in b.values()),
            f"8d: {printed}")
    worst = {"exact": 0.0, "db": 0.0, "mel_rel": 0.0}
    batteries, secs = {}, {"cuda": 0.0, "cpu": 0.0}
    for clip in clips:
        wavs = [os.path.join(test_out, m, clip) for m in ("flagship", "AD", "noisy")]
        got = {}
        for d in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[d] = analyze_cli.eval_wavs(os.path.join(test_out, "clean", clip), wavs,
                                           device=d)
            secs[d] += time.perf_counter() - t0
        for path in wavs:
            a, b = got["cuda"][path], got["cpu"][path]
            worst["exact"] = max(worst["exact"], *(abs(a[k] - b[k])
                                                   for k in ("STOI", "ESTOI", "SDR")))
            worst["db"] = max(worst["db"], *(abs(a[k] - b[k]) for k in ("SI-SDR", "SNR")))
            worst["mel_rel"] = max(worst["mel_rel"], abs(a["Mel-L1"] - b["Mel-L1"])
                                   / abs(b["Mel-L1"]))
            batteries[os.path.relpath(path, test_out)] = a
    require(worst["exact"] <= METRIC_EXACT and worst["db"] <= METRIC_DB
            and worst["mel_rel"] <= METRIC_MEL_RTOL, f"8d: card against CPU {worst}")
    report = {"worst_card_vs_cpu": worst, "batteries": batteries,
              "seconds_per_wav": {d: secs[d] / len(batteries) for d in secs}}
    log(f"8d cli.analyze --eval-wavs: {json.dumps(report)}")
    return report


def dnsmos_phase(root, test_out):
    """8e: ``cli.dnsmos`` on 8c's output with the two stand-in graphs at the
    real interfaces, on the card and on the CPU: every score within
    DNSMOS_ATOL; the time per clip."""
    dnsmos_standins(root)
    rows, secs = {}, {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        rows[d], _ = counted(f"8e cli.dnsmos ({d})", 0, 0, (), lambda: dnsmos_cli.main(
            ["-t", test_out, "-o", os.path.join(root, f"dnsmos_{d}.csv"), "--model-dir", root,
             "--device", d]))
        secs[d] = time.perf_counter() - t0
    n = len(rows["cuda"])
    require(n == len(rows["cpu"]) and n > 0, f"8e: {n} / {len(rows['cpu'])} clips scored")
    keys = ("OVRL", "SIG", "BAK", "P808_MOS", "OVRL_raw", "SIG_raw", "BAK_raw")
    worst = max(abs(a[k] - b[k]) for a, b in zip(rows["cuda"], rows["cpu"]) for k in keys)
    require(all(a["filename"] == b["filename"] for a, b in zip(rows["cuda"], rows["cpu"])),
            "8e: the clips differ")
    require(worst <= DNSMOS_ATOL, f"8e: card against CPU max|err| {worst:.3e}")
    report = {"clips": n, "max_abs_err_card_vs_cpu": worst,
              "seconds_per_clip": {d: secs[d] / n for d in secs},
              "model_means": dnsmos_cli.model_means(rows["cuda"])}
    log(f"8e cli.dnsmos: {json.dumps(report)}")
    return report


def loader_costs(loader, n_batches: int) -> dict:
    """ms a batch of ``loader``'s reads (its dataset's items) and of its
    collater's crop, on this thread, for its first ``n_batches`` batches in
    order."""
    bs, reads, crops = loader.batch_size, 0.0, 0.0
    for b in range(n_batches):
        t0 = time.perf_counter()
        items = [loader.dataset[i] for i in range(b * bs, (b + 1) * bs)]
        t1 = time.perf_counter()
        loader.collate_fn(items)
        crops += time.perf_counter() - t1
        reads += t1 - t0
    return {"read_ms_per_batch": reads / n_batches * 1e3,
            "crop_ms_per_batch": crops / n_batches * 1e3}


def native_phase(root, recipe_report):
    """8f: the native library (data/native.py) is built and loaded; phase
    7d's denoise loader (16 pairs of 96000-sample crops a batch, each a
    clean and a noisy wav read) timed per batch through the native reader
    and crop and through the plain versions (the Python reader and numpy),
    two passes each in turn, over files just written (warm in the file
    cache); and the 7d run's loader wait share, read through the native
    library."""
    require(native.available(), "8f: the native library did not build or load")
    cfg = load_config(recipe_config(root, CONFIG))
    costs = {"native": [], "plain": []}
    saved = (native._LIB, native._TRIED)
    for _ in range(2):
        for reader in ("native", "plain"):
            if reader == "plain":
                native._LIB, native._TRIED = None, True
            try:
                loader = train_cli.build_data_loaders(cfg, "denoise", RECIPE_LENGTH)["train"]
                costs[reader].append(loader_costs(loader, LOADER_BATCHES))
            finally:
                native._LIB, native._TRIED = saved
    report = {"available": True, "library": str(native.library_path().name),
              "reader_in_phase_7": "native" if saved[0] is not None else "plain",
              "loader_costs": costs,
              "phase_7d_loader_wait_share": recipe_report["7d_denoise"]["loader_wait_share"],
              "phase_7d_step_median_ms": recipe_report["7d_denoise"]["16 x 96000"][
                  "step_median_ms"]}
    log(f"8f native: {json.dumps(report)}")
    return report


def evaluation_phase(codec, vq, voc, recipe_report):
    """Phase 8, 8a-8f, in a temporary directory: the corpus of phase 7
    written anew (write_recipe_corpus). Returns (launches by run, report)."""
    with tempfile.TemporaryDirectory() as root:
        write_recipe_corpus(root)
        launches, report = {}, {}
        runs, report["8a_reference_checkpoints"], paths = reference_checkpoints(
            root, codec, vq, voc)
        launches.update(runs)
        clip_dir = os.path.join(root, "corpus",
                                load_config(CODEC_CONFIG)["data"]["subset"]["clean_valid"])
        report["8b_cli_test"] = codec_test_phase(root, paths["codec"], clip_dir)
        report["8c_cli_testing_denoise"], test_out = denoise_test_phase(
            root, paths["codec"], paths["vocoder"])
        report["8d_cli_analyze"] = analyze_phase(test_out)
        report["8e_cli_dnsmos"] = dnsmos_phase(root, test_out)
        report["8f_native"] = native_phase(root, recipe_report)
    return launches, report


# ---------------------------------------------------------------- slice 10 (phase 9)


class Recorded:
    """A kernel wrapper that keeps each call's arguments and result in
    ``calls``; its ``launches`` is the wrapper's own count (the wrappers
    count through their module's name, which this object stands in for)."""

    def __init__(self, name, fn, calls):
        self.name, self.fn, self.calls = name, fn, calls

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((self.name, args, kwargs, out))
        return out

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


class Recorder:
    """Within a ``with`` block, every call the stream halves make to a
    layer kernel (ops/mega_kernel.py and ops/vocoder_kernel.py call them by
    their module names) is kept with its arguments and result, so that each
    bf16 arm is held to its plain version at exactly the shapes a path
    launched. The kernels count their launches as ever."""

    SITES = {mega_kernel: ("residual_chain", "causal_conv", "causal_conv_transpose",
                           "rvq_assign", "codebook_lookup"),
             vocoder_kernel: ("hifigan_unit", "causal_conv", "causal_conv_transpose",
                              "codebook_lookup")}

    def __enter__(self):
        self.calls, self.saved = [], []
        for mod, names in self.SITES.items():
            for name in names:
                fn = getattr(mod, name)
                self.saved.append((mod, name, fn))
                setattr(mod, name, Recorded(name, fn, self.calls))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


# a call's plain version, from the arguments the stream halves pass
PLAIN_OF = {
    "residual_chain": lambda a, k: residual_chain_plain(*a[:4]),
    "causal_conv": lambda a, k: causal_conv_plain(*a, **k),
    "causal_conv_transpose": lambda a, k: causal_conv_transpose_plain(*a, **k),
    "rvq_assign": lambda a, k: rvq_assign_plain(*a[:3]),
    "codebook_lookup": lambda a, k: codebook_lookup_plain(a[0], a[1], a[3]),
    "hifigan_unit": lambda a, k: hifigan_unit_plain(*a, **k),
}
ACT_INDEX = {"residual_chain": 1, "causal_conv": 1, "causal_conv_transpose": 1,
             "rvq_assign": 0, "hifigan_unit": 2}  # where the activation input lies


def f32_arm(name, args, kwargs):
    """The call on the f32 arm: its bf16 activations (and running sum)
    widened, its output f32."""
    a, k = widened(name, args, kwargs)
    return KERNELS[name]["fn"](*a, **k)


def widened(name, args, kwargs):
    """(args, kwargs) of a call on the f32 arm (f32_arm)."""
    a, k = list(args), dict(kwargs)
    if name in ACT_INDEX:
        a[ACT_INDEX[name]] = a[ACT_INDEX[name]].float()
    if name == "hifigan_unit" and len(a) > 10 and a[10] is not None:
        a[10] = a[10].float()
    if name == "causal_conv":
        k["out_dtype"] = torch.float32
    if name == "codebook_lookup":
        a[3] = torch.float32
    return tuple(a), k


def conv_rate(x, w, leaky) -> float:
    """The peak rate of a tensor-core conv's products: the dense bf16 rate
    with bf16 weights (its operands are rounded to bf16), else the
    split-TF32 passes' rate."""
    return gemm_rate(w.dtype)


def call_work(name, args, kwargs, out) -> tuple[float, float, float]:
    """(operations, bytes, operation rate) one recorded call needs: each
    tensor argument read once (a cache at its rows), each output written
    once, at the rate of the arithmetic the kernel runs."""
    outs = out if isinstance(out, tuple) else (out,)
    seen, moved = set(), 0
    for t in [*args, *kwargs.values(), *outs]:
        if torch.is_tensor(t) and t.data_ptr() not in seen:
            seen.add(t.data_ptr())
            moved += t.numel() * t.element_size()
    if name == "residual_chain":
        x, w = args[1], args[2]
        return x.shape[0] * chain_flops(x.shape[2], x.shape[1]), moved, gemm_rate(w.dtype)
    if name == "causal_conv":
        x, w = args[1], args[2]
        taps, cin, cout = w.shape
        stride = args[4] if len(args) > 4 else kwargs.get("stride", 1)
        dil = args[5] if len(args) > 5 else kwargs.get("dilation", 1)
        b, t_out = out.shape[0], out.shape[1]
        leaky = args[6] if len(args) > 6 else kwargs.get("leaky")
        arm = _conv_plan(b, t_out, cin, cout, taps, stride, dil, w.dtype == torch.bfloat16)[0]
        return 2.0 * b * t_out * taps * cin * cout, moved, (
            conv_rate(x, w, leaky) if arm == "gemm" else F32_FLOPS)
    if name == "causal_conv_transpose":
        x, w = args[1], args[2]
        leaky = args[5] if len(args) > 5 else kwargs.get("leaky")
        return 2.0 * out.shape[0] * out.shape[1] * 2 * w.shape[1] * w.shape[2], moved, \
            conv_rate(x, w, leaky)
    if name == "rvq_assign":
        z, books = args[0], args[1]
        n_books, dim, book_k = books.shape
        return z.shape[0] * n_books * (2.0 * dim * book_k + 3.0 * book_k), moved, F32_FLOPS
    if name == "codebook_lookup":
        codes, books_t = args[0], args[1]
        used = int(torch.unique(codes).numel())
        read = codes.numel() * 4 + used * books_t.shape[2] * 4
        return float(codes.numel() * books_t.shape[2]), read + out.numel() * out.element_size(), \
            F32_FLOPS
    w1, x = args[3], args[2]  # hifigan_unit
    taps, c, gc = w1.shape
    return 2 * 2.0 * x.shape[0] * x.shape[1] * taps * c * gc, moved, gemm_rate(w1.dtype)


def conv_call_plan(name, args, kwargs, out) -> list:
    """The plan the planner gives a recorded causal_conv (arm, tile, steps
    per block) or causal_conv_transpose (tile, steps per block) call."""
    x, w = args[1], args[2]
    wb, xb = w.dtype == torch.bfloat16, x.dtype == torch.bfloat16
    if name == "causal_conv_transpose":
        stride = args[4] if len(args) > 4 else kwargs["stride"]
        return list(_upsample_plan(x.shape[0], x.shape[1], w.shape[1], w.shape[2], stride, wb,
                                   xb))
    taps, cin, cout = w.shape
    stride = args[4] if len(args) > 4 else kwargs.get("stride", 1)
    dil = args[5] if len(args) > 5 else kwargs.get("dilation", 1)
    return list(_conv_plan(out.shape[0], out.shape[1], cin, cout, taps, stride, dil, wb, xb))


def call_library(name, args, kwargs):
    """One PyTorch call computing a recorded conv's function in bf16
    (cuDNN), or the lookup's (``F.embedding_bag``), on its inputs; None for
    the kernels that have none."""
    bf16 = torch.bfloat16
    if name == "causal_conv":
        cache, x, w = args[:3]
        b = args[3] if len(args) > 3 else kwargs.get("b")
        stride = args[4] if len(args) > 4 else kwargs.get("stride", 1)
        inp = lib_input(cache, x.float()).to(bf16)
        wt = w.permute(2, 1, 0).to(bf16).contiguous()
        bias = None if b is None else b.to(bf16)
        return lambda: F.conv1d(inp, wt, bias, stride)
    if name == "causal_conv_transpose":
        cache, x, w, b = args[:4]
        stride = args[4] if len(args) > 4 else kwargs["stride"]
        inp = lib_input(cache, x.float()).to(bf16)
        wt = w.flip(0).permute(1, 2, 0).to(bf16).contiguous()
        return lambda: F.conv_transpose1d(inp, wt, b.to(bf16), stride, stride)
    if name == "codebook_lookup":
        codes, books_t = args[:2]
        flat, idx = books_t.reshape(-1, books_t.shape[2]), codes.long()
        return lambda: F.embedding_bag(idx, flat, mode="sum")
    if name == "hifigan_unit":  # its two grouped dilated convs (conv2 on stand-in rows)
        cache1, cache2, x, w1, b1, w2, b2, d, groups = args[:9]
        slope = args[9] if len(args) > 9 else kwargs.get("slope", 0.1)
        gc = w1.shape[2]
        a = F.leaky_relu(torch.cat([cache1, x.float()], dim=-2), slope)
        a = a if a.dim() == 3 else a[None]
        a = a.repeat(1, 1, groups) if a.shape[-1] != gc else a
        inp1 = a.transpose(1, 2).to(bf16).contiguous()
        inp2 = lib_input(cache2, a[:, a.shape[1] - x.shape[-2]:]).to(bf16)
        wt1, wt2 = (w.permute(2, 1, 0).to(bf16).contiguous() for w in (w1, w2))
        b1b, b2b = (None if b is None else b.to(bf16) for b in (b1, b2))
        return lambda: (F.conv1d(inp1, wt1, b1b, dilation=d, groups=groups),
                        F.conv1d(inp2, wt2, b2b, groups=groups))
    return None


def rounds_sums(name, wd, kwargs) -> bool:
    """Whether a call rounds an intermediate sum to bf16 (see
    rounding_checks): the chain and the unit with bf16 weights, and an
    upsample with bf16 weights and a ``rounding``."""
    if wd is None or wd.dtype != torch.bfloat16:
        return False
    return name in ("residual_chain", "hifigan_unit") or (
        name == "causal_conv_transpose" and kwargs.get("rounding") is not None)


def hold_calls(path, calls, tables, report, timed: set):
    """Each recorded bf16-boundary call against its plain version (within
    the f32 arm's tolerance plus one bf16 step of the value where the
    output is bf16; codes up to near ties) and against the f32 arm on its
    widened inputs (equal bit for bit, rounded as the arm stores). The
    kernels in ``timed`` also get each call's times (kernel, plain,
    library) and bound, summed into ``report[kernel]``."""
    books, sqnorm, _ = tables
    for name, args, kwargs, out in calls:
        entry = report.setdefault(name, {"calls": 0, "max_abs_err": 0.0, "worst_share": 0.0,
                                         "shapes": set()})
        entry["calls"] += 1
        got = out[0] if name == "hifigan_unit" else out
        entry["shapes"].add(tuple(args[ACT_INDEX.get(name, 0)].shape))
        twin = f32_arm(name, args, kwargs)
        if name == "hifigan_unit":
            require(torch.equal(out[1], twin[1]), f"{path} hifigan_unit: the conv2 cache "
                    "differs from the f32 arm's")
            twin = twin[0]
        require(torch.equal(got, twin if got.dtype == twin.dtype else twin.to(got.dtype)),
                f"{path} {name} {tuple(got.shape)}: the bf16 arm is not the f32 arm rounded")
        ref = PLAIN_OF[name](args, kwargs)
        ref = ref[0] if name == "hifigan_unit" else ref
        torch.cuda.synchronize()
        if name == "rvq_assign":
            held = rvq_near_ties(args[0].float(), books, sqnorm, got, ref, CODE_RTOL)
            require(held["mismatches"] == 0, f"{path} rvq_assign on bf16 z: {held}")
            entry["near_tie_rows"] = entry.get("near_tie_rows", 0) + held["ties"]
            entry["max_abs_err"] = max(entry["max_abs_err"], held["max_excess"])
        else:
            require(got.dtype == ref.dtype and got.shape == ref.shape,
                    f"{path} {name}: {got.dtype} {tuple(got.shape)} against the plain "
                    f"version's {ref.dtype} {tuple(ref.shape)}")
            err = (got.float() - ref.float()).abs()
            scale = float(ref.float().abs().max())
            wd = None if name == "codebook_lookup" else args[3 if name == "hifigan_unit" else 2]
            limit = LOOKUP_ATOL if wd is None else kernel_limit(name, wd.dtype, scale)
            bound = limit + (BF16_STEP * ref.float().abs() if got.dtype == torch.bfloat16 else 0.0)
            rounding = kwargs.get("rounding") if wd is not None and wd.dtype == torch.bfloat16 \
                else None  # a vocoder upsample's rounded product or output: one bf16 step
            if name == "causal_conv_transpose" and rounding == "product":
                bound = bound + BF16_STEP * (ref.float() - args[3]).abs()
            elif name == "causal_conv_transpose" and rounding == "output":
                bound = bound + BF16_STEP * ref.float().abs()
            if rounds_sums(name, wd, kwargs):  # see rounding_checks
                if name != "causal_conv_transpose":
                    bound = bound - limit + FLIP_RTOL * scale
                what = f"{path} {name} {tuple(got.shape)} {got.dtype}"
                fn, plain = KERNELS[name]["fn"], lambda *a, **k: PLAIN_OF[name](a, k)
                first = (lambda out: out[0]) if name == "hifigan_unit" else (lambda out: out)
                unrounded, _ = rounding_checks(name, fn, plain, args, kwargs, first)
                held = rounding_held(got, ref, unrounded(), bound)
                require(held["held"], f"{what}: {held}")
                entry["worst_rms_share"] = max(entry.get("worst_rms_share", 0.0),
                                               held["rms_share"])
                # on exact sums, on the f32 arm (the bf16 arm is it rounded, above)
                _, exact = rounding_checks(name, fn, plain, *widened(name, args, kwargs), first)
                check_exact(what, name, exact,
                            lambda r: kernel_limit(name, wd.dtype, float(r.abs().max())))
            share = float((err / bound).max())
            require(share <= 1.0, f"{path} {name} {tuple(got.shape)} {got.dtype}: max|err| "
                    f"{float(err.max()):.3e} beyond its bound (share {share:.3f})")
            entry["max_abs_err"] = max(entry["max_abs_err"], float(err.max()))
            entry["worst_share"] = max(entry["worst_share"], share)
        if name not in timed:
            continue
        fn, plain = KERNELS[name]["fn"], PLAIN_OF[name]
        k_ms = gpu_ms(lambda: fn(*args, **kwargs), 5, groups=3)
        p_ms = gpu_ms(lambda: plain(args, kwargs), 3, groups=3)
        lib = call_library(name, args, kwargs)
        l_ms = None if lib is None else gpu_ms(lib, 5, groups=3)
        flops, moved, rate = call_work(name, args, kwargs, out)
        b_ms, b_by = bound_ms(flops, moved, rate)
        t = entry.setdefault("times", {"ms": 0.0, "plain_ms": 0.0, "library_ms": None,
                                       "bound_ms": 0.0, "ops_s": 0.0, "bytes": 0.0,
                                       "path": path})
        t["ms"] += k_ms
        t["plain_ms"] += p_ms
        t["bound_ms"] += b_ms
        t["ops_s"] += flops / rate
        t["bytes"] += moved
        if l_ms is not None:
            t["library_ms"] = (t["library_ms"] or 0.0) + l_ms
        plan = None
        if name.startswith("causal_conv"):  # the two conv arms' sites, each with its plan
            plan = conv_call_plan(name, args, kwargs, got)
            entry.setdefault("sites", []).append({
                "x": list(args[1].shape), "out": list(got.shape), "plan": plan, "ms": k_ms,
                "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by})
        log(f"bf16 arm {name:22s} {path:10s} {tuple(got.shape)} kernel={k_ms:.4f} ms "
            f"plain={p_ms:.4f} ms library={l_ms if l_ms is None else round(l_ms, 4)} "
            f"bound={b_ms:.4f} ms ({b_by})" + ("" if plan is None else f" plan={plan}"))


def stores_bf16(calls) -> bool:
    """Whether every activation a bf16-boundary path's launches write is
    bf16, but the audio out (its last launch's) and the int32 codes."""
    for i, (name, _, _, out) in enumerate(calls):
        y = out[0] if name == "hifigan_unit" else out
        want = (torch.int32 if name == "rvq_assign" else
                torch.float32 if i == len(calls) - 1 else torch.bfloat16)
        if y.dtype != want:
            return False
    return True


def code_rows(codes):
    """Wire codes (N, B, rows, L) as the search's rows: stream by stream,
    then time (the order of the z it was given)."""
    return codes.transpose(0, 1).reshape(-1, codes.shape[-1])


def activation_bytes(calls) -> int:
    """Bytes of the dense activations the recorded launches read and write
    (each call's input, running sum and output; no cache, weight or code)."""
    total = 0
    for name, args, kwargs, out in calls:
        ts = [out[0] if name == "hifigan_unit" else out]
        if name != "codebook_lookup":
            ts.append(args[ACT_INDEX[name]])
        if name == "hifigan_unit" and len(args) > 10 and args[10] is not None:
            ts.append(args[10])
        total += sum(t.numel() * t.element_size() for t in ts if t.dtype != torch.int32)
    return total


def boundary_phase(gen, codec, vq, tables, voc, v0):
    """Phase 9a-9b: K3b's and K5's bf16 launch boundaries. Four paths at
    bf16 weights, each once with f32 and once with bf16 boundaries, counted
    and recorded: the denoiser and the codec through
    ``make_mega_stream_stacked`` at BOUNDARY_BATCH streams of
    BOUNDARY_FRAMES frames, the v1 and v0 receivers through
    ``make_stacked_vocoder`` at BOUNDARY_VOC_BATCH streams of the codec's
    f32-boundary wire codes. Every bf16-boundary call is held to its plain
    version and to the f32 arm (:func:`hold_calls`); the audio at bf16
    boundaries within BOUNDARY_RTOL of the f32 run's largest sample (the
    codec's codes up to near ties of the rounded z instead,
    ``utils/checks.py::moved_near_ties``); each dispatch's
    device time (CUDA events around a CUDA graph) and the bytes of its
    activations between launches. Returns (launches by path, report, the
    bf16 arms' entries of the kernels line)."""
    bf16, f32 = torch.bfloat16, torch.float32
    frames = frames_for_streams(BOUNDARY_FRAMES, BOUNDARY_BATCH, SEED + 90)[..., 0]
    paths = [
        ("denoiser", LAUNCHES_PER_DISPATCH["denoiser"], DENOISER_KERNELS,
         lambda bd: make_mega_stream_stacked(gen, FRAME, BOUNDARY_BATCH, bf16, None, bd)),
        ("codec", LAUNCHES_PER_DISPATCH["codec"], CODEC_KERNELS,
         lambda bd: make_mega_stream_stacked(codec, FRAME, BOUNDARY_BATCH, bf16, vq, bd)),
        ("vocoder", LAUNCHES_PER_DISPATCH["vocoder"] - 11, RECEIVER_KERNELS,
         lambda bd: make_stacked_vocoder(voc, FRAME, BOUNDARY_VOC_BATCH, bf16, vq, bd)),
        ("vocoder_v0", LAUNCHES_PER_DISPATCH["vocoder_v0"] - 11, RECEIVER_KERNELS,
         lambda bd: make_stacked_vocoder(v0, FRAME, BOUNDARY_VOC_BATCH, bf16, vq, bd)),
    ]
    timed = {"denoiser": {"residual_chain", "causal_conv", "causal_conv_transpose"},
             "codec": {"rvq_assign", "codebook_lookup"}, "vocoder": {"hifigan_unit"},
             "vocoder_v0": set()}
    by_path, report, arms, wire = {}, {}, {}, None
    for path, per_dispatch, kernels, build in paths:
        inputs = frames if wire is None or not path.startswith("vocoder") else wire
        runs = {}
        for bd in (f32, bf16):
            init, run = build(bd)
            with Recorder() as rec:
                result, launches = counted(
                    f"bf16 boundaries: {path} x{inputs.shape[1]} at {str(bd)[6:]} boundaries",
                    per_dispatch, 1, kernels, lambda: run(init(), inputs))
            out, cache, *codes = result
            require(out.dtype == f32 and all(t.dtype == f32 for t in cache.values())
                    and all(c.dtype == torch.int32 for c in codes),
                    f"{path} at {bd} boundaries: the audio, the caches and the codes keep "
                    "their dtypes")
            by_path[f"{path} {str(bd)[6:]} boundaries x{inputs.shape[1]}"] = launches
            z = [c[1][0] for c in rec.calls if c[0] == "rvq_assign"]
            runs[bd] = {"out": out, "codes": codes[0] if codes else None,
                        "z": z[0] if z else None,
                        "activation_bytes": activation_bytes(rec.calls), "graph": (init, run)}
            if bd == bf16:
                require(stores_bf16(rec.calls), f"{path}: an activation between launches is "
                        "not bf16")
                hold_calls(path, rec.calls, tables, arms, timed[path])
            del rec
        if path == "codec":
            wire = runs[f32]["codes"][:, :BOUNDARY_VOC_BATCH].contiguous()
        y32, y16 = runs[f32]["out"], runs[bf16]["out"]
        scale = float(y32.abs().max())
        err = float((y16 - y32).abs().max())
        entry = {"streams": inputs.shape[1], "frames": BOUNDARY_FRAMES,
                 "max_abs_diff_bf16_vs_f32": err, "max_abs_f32": scale}
        if path == "codec":
            held = moved_near_ties(runs[f32]["z"], runs[bf16]["z"], tables[0],
                                   code_rows(runs[bf16]["codes"]),
                                   code_rows(runs[f32]["codes"]), CODE_RTOL)
            require(held["beyond"] == 0, f"bf16 boundaries: {held['beyond']} code rows moved "
                    "beyond a near tie of the rounded z")
            entry["code_rows_moved_at_near_ties"] = held["moved"]
            entry["code_rows"] = code_rows(runs[f32]["codes"]).shape[0]
        else:
            require(err <= BOUNDARY_RTOL * scale, f"{path}: bf16 boundaries {err:.3e} from the "
                    f"f32 run, beyond {BOUNDARY_RTOL} of its largest sample {scale:.3e}")
        for bd in (f32, bf16):
            init, run = runs[bd]["graph"]
            cache = init()
            dev = graph_ms(lambda: run(cache, inputs), reps=3, groups=3)
            nbytes_ = runs[bd]["activation_bytes"]
            entry[str(bd)[6:]] = {
                "device_ms": dev,
                "us_per_stream_frame": dev * 1e3 / (inputs.shape[1] * BOUNDARY_FRAMES),
                "activation_bytes": nbytes_,
                "activation_bound_ms": nbytes_ / HBM_BYTES_PER_S * 1e3}
        log(f"9b {path}: {json.dumps(entry)}")
        report[path] = entry
        del runs
    log("9b device ms a dispatch at f32 / bf16 boundaries: " + ", ".join(
        f"{path} x{entry['streams']} N={entry['frames']} {entry['float32']['device_ms']:.4f} / "
        f"{entry['bfloat16']['device_ms']:.4f}" for path, entry in report.items()))
    for name in ("causal_conv", "causal_conv_transpose"):  # their sites against cuDNN in bf16
        for site in arms[name].get("sites", []):
            log(f"9b {name}.bf16 site: {json.dumps(site)}")
        report[f"{name}.bf16 sites"] = arms[name].pop("sites", [])
    entries = []
    for name in SERVING_KERNELS:
        arm = arms[name]
        t = arm.pop("times")
        t_bytes = t.pop("bytes") / HBM_BYTES_PER_S
        entries.append({
            "name": f"{name}.bf16", "route": "cuda", "source": KERNELS[name]["source"],
            "replaces": ("dl_speech_enhancement_tpu/ops/vocoder_stacked.py:120 (K5's "
                         "boundary_dtype, to _assemble :434)" if name == "hifigan_unit" else
                         "dl_speech_enhancement_tpu/ops/mega_stacked.py:173 (K3b _assemble's "
                         "boundary_dtype, :173-180, applied :226; make_mega_stream_stacked "
                         ":335)"),
            "launches": sum(counts[name] for path, counts in by_path.items()
                            if path.split()[1] == "bfloat16"),
            "max_abs_err": arm["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "operations" if t.pop("ops_s") >= t_bytes else "bytes",
            "library_ms": t["library_ms"],
            "per": f"sum over the arm's calls in one dispatch of the {t['path']} path at bf16 "
                   "boundaries, bf16 weights"
                   + (", library: cuDNN in bf16" if name.startswith("causal_conv") else ""),
            "calls_held": arm["calls"], "worst_share_of_bound": arm["worst_share"],
            **({"worst_rms_share": arm["worst_rms_share"]} if "worst_rms_share" in arm else {}),
            "shapes": sorted(arm["shapes"]),
            **({"near_tie_rows": arm["near_tie_rows"]} if "near_tie_rows" in arm else {})})
    return by_path, report, entries


def fleet_cli_phase(gen, codec, vq, voc):
    """Phase 9c, the fleet CLI: seeded checkpoints under a temporary exp/
    tree (the denoiser's without PQC, and the ``vctk_v1`` pairing), a seeded
    wav of FLEET_CLI_SECONDS, and ``cli.serve.main`` on the card from that
    directory at ``--streams FLEET_CLI_STREAMS --devices 1`` in blocks of
    FLEET_CLI_BLOCK frames: the stats dict, 18 (34) launches a block, and
    stream 0's wav the one-device fleet's on the same audio, to one PCM16
    step."""
    n = FLEET_CLI_SECONDS * SAMPLE_RATE // FRAME
    cwd, report, by_path = os.getcwd(), {}, {}
    with tempfile.TemporaryDirectory() as root:
        write_exp_tree(root, codec, vq, {"vctk_v1": (CODEC_CONFIG, VOCODER_CONFIG, voc)})
        ckpt = os.path.join(root, "exp", "denoise", "seeded", "checkpoint-1steps")
        save_checkpoint(ckpt, {"params_generator": gen.state_dict()}, load_config(CONFIG))
        audio = frames_for(n, SEED + 91)[:, 0, :, 0].reshape(-1).cpu().numpy()
        write_wav(os.path.join(root, "in.wav"), audio, SAMPLE_RATE)
        pcm = torch.from_numpy(read_wav(os.path.join(root, "in.wav"))[0][:, 0]).to(DEVICE)
        os.chdir(root)
        try:
            for name, args, per_block, kernels in (
                    ("checkpoint --without-pqc", ["--checkpoint", ckpt, "--without-pqc"],
                     LAUNCHES_PER_DISPATCH["denoiser"], DENOISER_KERNELS),
                    ("vctk_v1", ["--model", "vctk_v1"], LAUNCHES_PER_DISPATCH["vocoder"],
                     VOCODER_KERNELS)):
                out = f"{name.split()[0]}.wav"
                stats, launches = counted(
                    f"cli.serve {name} x{FLEET_CLI_STREAMS}", per_block, n // FLEET_CLI_BLOCK,
                    kernels,
                    lambda: serve_cli.main([*args, "--streams", str(FLEET_CLI_STREAMS),
                                            "--devices", "1", "--device", DEVICE,
                                            "-i", "in.wav", "-o", out,
                                            "--block-frames", str(FLEET_CLI_BLOCK),
                                            "--max-outputs", "1"]))
                log(f"9c cli.serve {name}: {json.dumps(stats)}")
                require(stats["streams"] == FLEET_CLI_STREAMS and stats["devices"] == 1
                        and stats["frames"] == n, f"cli.serve {name}: {stats}")
                report[name] = {"stats": stats}
                by_path[f"cli.serve {name} x{FLEET_CLI_STREAMS}"] = launches
            denoiser, _, _ = load_generator_from_checkpoint(ckpt, use_pqc=False, device=DEVICE)
            run = make_sharded_stream(denoiser, batch=FLEET_CLI_STREAMS, device=DEVICE)
            frames = pcm.reshape(1, n, FRAME, 1).expand(FLEET_CLI_STREAMS, -1, -1, -1)
            ref = stream(run, frames.transpose(0, 1), [FLEET_CLI_BLOCK] * (n // FLEET_CLI_BLOCK))
            got = read_wav("checkpoint-0.wav")[0][:, 0]
            err = float(np.abs(got - ref[:, 0, :, 0].reshape(-1).cpu().numpy()).max())
            require(err <= PCM16_STEP, f"cli.serve's stream 0 is {err:.3e} from the fleet's")
            report["checkpoint --without-pqc"]["stream0_max_abs_err_vs_fleet"] = err
        finally:
            os.chdir(cwd)
    return by_path, report


def fleet_split_phase(codec, vq):
    """Phase 9d: ``make_sharded_stream`` of the codec over [cuda:0, cuda:0]
    (two slices of 8 streams on the one card, each with its own copy of the
    weights) against the one-device fleet of 16, two dispatches of 8 frames:
    bit for bit; each fleet's median dispatch wall time."""
    batch = BATCH
    frames = frames_for_streams(sum(MULTI_FRAMES), batch, SEED + 92)
    one = make_sharded_stream(codec, vq, batch=batch, device=DEVICE)
    split = make_sharded_stream(codec, vq, batch=batch, device=[DEVICE, DEVICE])
    want = stream(one, frames, MULTI_FRAMES)
    got, launches = counted(f"fleet split x{batch} over [cuda:0, cuda:0]",
                            LAUNCHES_PER_DISPATCH["codec"], 2 * len(MULTI_FRAMES),
                            CODEC_KERNELS, lambda: stream(split, frames, MULTI_FRAMES))
    require(torch.equal(got, want), "the split fleet is not the one-device fleet bit for bit")
    n = MULTI_FRAMES[0]
    report = {"streams": batch, "slices": 2, "bit_for_bit": True,
              "one_device_dispatch_ms": dispatch_ms(one, frames[:n], 20),
              "split_dispatch_ms": dispatch_ms(split, frames[:n], 20), "frames": n}
    log(f"9d fleet split: {json.dumps(report)}")
    return {f"fleet split x{batch} over [cuda:0, cuda:0]": launches}, report


def long_audio_phase(gen):
    """Phase 9e: ``parallel_denoise`` of the denoiser on LONG_SECONDS of
    seeded 48 kHz audio in LONG_CHUNKS chunks (the chunks as the batch axis
    of the offline ``gen.forward``, cuDNN, TF32 off; the default context,
    the whole model's receptive field ``gen.model_receptive_length``)
    against one long ``gen.forward``: every sample out within
    MAIN_ATOL_F32. Each wall time (host clock, synchronised; the host copies
    of the chunks in and the audio out included) of a second call."""
    n = LONG_SECONDS * SAMPLE_RATE // FRAME
    audio = frames_for(n, SEED + 93).reshape(-1, 1).cpu().numpy()
    context = gen.model_receptive_length
    x = torch.from_numpy(audio[None]).to(DEVICE)
    times = {}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            serial = gen(x, None, train=False)[0]
        torch.cuda.synchronize()
        times["forward_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = parallel_denoise(gen, None, audio, n_chunks=LONG_CHUNKS, device=DEVICE)
        times["parallel_denoise_s"] = time.perf_counter() - t0
    serial = serial[0].cpu().numpy()
    err = float(np.abs(got - serial[:len(got)]).max())
    report = {"seconds": LONG_SECONDS, "chunks": LONG_CHUNKS, "context": context,
              "samples_out": len(got), "samples_in": len(audio), "max_abs_err": err,
              "max_abs_ref": float(np.abs(serial).max()), **times}
    log(f"9e long audio: {json.dumps(report)}")
    require(err <= MAIN_ATOL_F32, f"parallel_denoise {err:.3e} from the long forward")
    return report


def recorded_codes(endpoint, into: list):
    """Keep each code tensor ``endpoint.encode`` returns (on the host)."""
    encode = endpoint.encode

    def call(chunk):
        codes = encode(chunk)
        into.append(codes.cpu())
        return codes
    endpoint.encode = call


def streamer_split_phase(codec, vq, tables):
    """Phase 9f, the streamer's device split: ``AudioCodecStreamer`` with
    the transmitter on the card and the receiver on the CPU (the codes cross
    on the host), on SPLIT_FRAMES frames: its codes equal to those of the
    same two-stage streamer all on the card (the same kernels on the same
    frames), and up to near ties to an all-CPU streamer's (plain modules);
    its audio within MAIN_ATOL_F32 of the all-CPU streamer's over the frames
    before the first differing code. Then the fused streamer with
    ``calibrate_split``: the encoder's share of the frame time."""
    n = SPLIT_FRAMES
    audio = frames_for(n, SEED + 94)[:, 0].reshape(1, -1, 1).cpu().numpy()
    kw = dict(frame_size=FRAME, sample_rate=SAMPLE_RATE, max_latency=CLI_MAX_LATENCY)
    report, codes, outs, zs = {}, {}, {}, []
    streamers = {"split": AudioCodecStreamer(codec, vq, fused=False, tx_device=DEVICE,
                                             rx_device="cpu", **kw),
                 "card": AudioCodecStreamer(codec, vq, fused=False, device=DEVICE, **kw),
                 "cpu": AudioCodecStreamer(codec, vq, fused=False, device="cpu", **kw)}
    split = streamers["split"]
    require(not split.fused and split.tx_encoder.device.type == torch.device(DEVICE).type
            and split.rx_encoder.device.type == "cpu", "the split streamer's endpoints")
    cpu_gen = streamers["cpu"].tx_encoder.gen

    def recording_quantize(vq_state, z):  # the all-CPU transmitter's z, for the near ties
        zs.append(z.cpu())
        return type(cpu_gen).quantize(cpu_gen, vq_state, z)
    by_path = {}
    for name, streamer in streamers.items():
        codes[name] = []
        recorded_codes(streamer.tx_encoder, codes[name])

        def drive(s=streamer):
            s.load()
            return s.run_array(audio)
        if name == "split":
            y, by_path["streamer split: tx cuda, rx cpu"] = counted(
                "streamer split: tx cuda, rx cpu", 11, n + 2,
                ("residual_chain", "causal_conv", "rvq_assign"), drive)
        elif name == "cpu":
            cpu_gen.quantize = recording_quantize
            try:
                y = drive()
            finally:
                del cpu_gen.quantize
        else:
            y = drive()
        outs[name] = produced(y[0, :, 0], n)
        report[name] = streamer.stats()
        log(f"9f streamer {name}: {json.dumps(report[name])}")
    # the recorded calls: the priming chunk, the warm-up frame, then the n frames
    got = {name: torch.stack(c[2:]) for name, c in codes.items()}  # (n, L, 1, rows)
    require(torch.equal(got["split"], got["card"]), "the split streamer's codes are not the "
            "all-card streamer's")
    z = torch.stack(zs[2:])  # (n, 1, rows, D)
    as_rows = (lambda c: c.permute(0, 2, 3, 1).reshape(n, -1, c.shape[1]).to(DEVICE))
    held, agree = held_codes("streamer split vs the all-CPU streamer", z.to(DEVICE), tables,
                             as_rows(got["split"]), as_rows(got["cpu"]))
    err = float(np.abs(outs["split"][:agree] - outs["cpu"][:agree]).max())
    require(err <= MAIN_ATOL_F32, f"the split streamer's audio {err:.3e} from the all-CPU one's")
    report["split_vs_cpu"] = {"near_tie_rows": held["ties"], "frames_compared": agree,
                              "max_abs_err": err}
    calibrated = AudioCodecStreamer(codec, vq, calibrate_split=True, device=DEVICE, **kw)
    calibrated.load()
    produced(calibrated.run_array(audio[:, :n // 2 * FRAME])[0, :, 0], n // 2)
    report["fused_calibrated"] = calibrated.stats()
    require(report["fused_calibrated"]["timing_mode"] == "fused-calibrated-split",
            "the calibrated streamer's timing mode")
    log(f"9f fused, calibrate_split: {json.dumps(report['fused_calibrated'])}")
    return by_path, report


# ---------------------------------------------------------------- times


def latency(run, n_reps: int):
    """Per-dispatch wall ms of one 25 ms frame, cache carried (host clock
    around the call and a synchronize)."""
    frames = frames_for(n_reps + 10, SEED + 1)
    cache, walls = run.init_cache(), []
    for i in range(n_reps + 10):
        t0 = time.perf_counter()
        _, cache = run(cache, frames[i:i + 1])
        torch.cuda.synchronize()
        if i >= 10:
            walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    return {"median_ms": statistics.median(walls),
            "p90_ms": walls[int(0.9 * len(walls)) - 1], "samples": len(walls)}


def throughput(run, n_frames: int, reps: int):
    frames = frames_for(n_frames, SEED + 2)
    cache = run.init_cache()
    ms = gpu_ms(lambda: run(cache, frames), 1, groups=reps)
    audio_s = n_frames * FRAME / SAMPLE_RATE
    return {"frames": n_frames, "ms": ms, "frames_per_s": n_frames / ms * 1e3,
            "rtf": ms / 1e3 / audio_s}


def device_profile(run, frames, wall_ms: float, n_reps: int = 50):
    """Device time of one dispatch of ``frames``, from a ``torch.profiler``
    trace of ``n_reps`` dispatches with the cache carried: in all, per port
    kernel and in other device work (cache tails, layout copies), and its
    share of the unprofiled wall time ``wall_ms`` of a dispatch. None where
    the trace shows no device time."""
    _, cache = run(run.init_cache(), frames)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n_reps):
            _, cache = run(cache, frames)
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 / n_reps
    if device_ms <= 0:
        return None
    kernels_ms = {name: sum(e.self_device_time_total for e in device
                            if f"{name}_kernel" in e.key) / 1e3 / n_reps
                  for name in KERNELS}
    return {"device_ms_per_dispatch": device_ms, "busy_share": device_ms / wall_ms,
            "kernels_ms_per_dispatch": kernels_ms,
            "other_ms_per_dispatch": device_ms - sum(kernels_ms.values())}


# kernels whose sites are also timed as device time (graph_ms), beside their
# CUDA-event time, which a wrapper call's host work floors at few rows
GRAPHED_KERNELS = ("rvq_assign", "codebook_lookup")


def time_kernels(site_fn, names, sizes=None):
    """Phase 4b: each of ``names`` summed over its sites of one dispatch, at
    each (frames per dispatch, repetitions) of ``sizes`` (by default 1, 100
    and 400 frames); ``site_fn(n_frames, weight_dtype)`` gives the sites. The
    sites of GRAPHED_KERNELS also get ``device_ms`` (and their yardstick
    ``library_device_ms``) by :func:`graph_ms`."""
    report = {}
    for n_frames, reps in sizes or ((1, 50), (DISPATCH, 20), (THROUGHPUT_FRAMES, 10)):
        per_kernel = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                             "bound_ms_f32_cores": 0.0, "library_ms": None, "ops": 0.0,
                             "bytes": 0.0, "ops_s": 0.0, "sites": {}}
                      for name in names}
        for name in set(names) & set(GRAPHED_KERNELS):
            per_kernel[name].update(device_ms=0.0, library_device_ms=None)
        for st in site_fn(n_frames, torch.bfloat16):
            k_ms, p_ms = gpu_ms(st.run, reps), gpu_ms(st.plain, reps)
            l_ms = None if st.lib is None else gpu_ms(st.lib, reps)
            b_ms, b_by = bound_ms(st.flops, st.bytes, st.rate)
            agg = per_kernel[st.kernel]
            agg["ms"] += k_ms
            agg["plain_ms"] += p_ms
            agg["bound_ms"] += b_ms
            agg["ops"] += st.flops
            agg["ops_s"] += st.flops / st.rate
            agg["bytes"] += st.bytes
            if l_ms is not None:
                agg["library_ms"] = (agg["library_ms"] or 0.0) + l_ms
            agg["sites"][st.site] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                     "bound_ms": b_ms, "bound_by": b_by}
            if st.plan:
                agg["sites"][st.site]["plan"] = list(st.plan)
            if st.kernel in GRAPHED_KERNELS:
                site = agg["sites"][st.site]
                site["device_ms"] = graph_ms(st.run)
                agg["device_ms"] += site["device_ms"]
                if st.lib is not None:
                    site["library_device_ms"] = graph_ms(st.lib)
                    agg["library_device_ms"] = ((agg["library_device_ms"] or 0.0)
                                                + site["library_device_ms"])
            # beside it, the bound at the f32 rate outside the tensor cores
            f32_ms = bound_ms(st.flops, st.bytes)[0]
            agg["bound_ms_f32_cores"] += f32_ms
            if st.rate != F32_FLOPS:
                agg["sites"][st.site]["bound_ms_f32_cores"] = f32_ms
            log(f"time {st.kernel:22s} {st.site:7s} frames={n_frames:<4d} kernel={k_ms:.4f} ms "
                f"plain={p_ms:.4f} ms library={l_ms if l_ms is None else round(l_ms, 4)} "
                f"bound={b_ms:.4f} ms ({b_by})" + (f" plan={st.plan}" if st.plan else "")
                + "".join(f" {key}={agg['sites'][st.site][key]:.4f} ms"
                          for key in ("device_ms", "library_device_ms")
                          if key in agg["sites"][st.site]))
        for agg in per_kernel.values():
            t_ops, t_bytes = agg.pop("ops_s"), agg["bytes"] / HBM_BYTES_PER_S
            agg["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        report[n_frames] = per_kernel
    return report


def dispatch_ms(run, frames, reps: int) -> float:
    """Median wall ms of ``run(cache, frames)`` with the cache carried (host
    clock around the call and a synchronize), after two warm-up calls."""
    cache, walls = run.init_cache(), []
    for i in range(reps + 2):
        t0 = time.perf_counter()
        _, cache = run(cache, frames)
        torch.cuda.synchronize()
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def cache_memory(run, frames) -> dict:
    """Card memory of one dispatch from zero caches: the bytes its returned
    cache keeps allocated (the storages its entries are views of, which
    stay alive until the next dispatch), the bytes of the entries
    themselves, and the dispatch's peak allocation above what was allocated
    before it."""
    cache = run.init_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, cache = run(cache, frames)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    held = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in cache.values()}
    return {"cache_held_bytes": sum(held.values()),
            "cache_own_bytes": sum(t.numel() * t.element_size() for t in cache.values()),
            "dispatch_peak_bytes": peak}


def single_streams(single, batch: int):
    """B streams served as B single-stream dispatches of ``single``, each
    with its own cache, behind the batched route's ``run(cache, frames)``."""

    def run(caches, frames):
        outs, new = [], []
        for b, cache in enumerate(caches):
            y, cache = single(cache, frames[:, b:b + 1])
            outs.append(y)
            new.append(cache)
        return outs, new

    run.init_cache = lambda: [single.init_cache() for _ in range(batch)]
    return run


def chain_plans(gen, batch: int, n_frames: int) -> dict:
    """The residual chain's (tile, cluster) at each encoder level for
    ``batch`` streams of ``n_frames`` frames (the decoder's mirror them)."""
    plans, t = {}, n_frames * FRAME
    for bi, blk in enumerate(gen.encoder.blocks):
        plans[f"e{bi}ch"] = _chain_plan(batch, t, blk.conv.in_channels, DILATIONS)
        t //= blk.conv.stride
    return plans


def multi_stream_times(path, gen, vq):
    """Phase 4c: per-stream-frame time (median wall time of a dispatch over
    B * N) of B streams at N frames per dispatch, for B in TIME_BATCHES and N
    in BATCH_SIZES, through the kernel route (bf16 weights), the batched
    eager route and (at SINGLE_STREAM_BATCHES) B single-stream kernel
    dispatches; the kernel route's busy share (torch.profiler) and the
    launches of one of its dispatches, which must be the path's 18 or 22 at
    every B."""
    kernels = CODEC_KERNELS if vq is not None else DENOISER_KERNELS
    single = make_scan_stream(gen, vq, frame_size=FRAME)
    report = {}
    for batch in TIME_BATCHES:
        run = make_scan_stream(gen, vq, batch=batch, frame_size=FRAME)
        require(run.backend == "cuda", f"{path} x{batch}: 'auto' took {run.backend!r}")
        eager = make_scan_stream(gen, vq, batch=batch, backend="eager")
        for n in BATCH_SIZES:
            frames = frames_for_streams(n, batch, SEED + 30)
            counted(f"{path} x{batch} N={n} (one timing dispatch)",
                    LAUNCHES_PER_DISPATCH[path], 1, kernels,
                    lambda: run(run.init_cache(), frames))
            k_ms = dispatch_ms(run, frames, 30 if n == 1 else 10)
            e_ms = dispatch_ms(eager, frames, 10 if n == 1 else 3)
            s_ms = (dispatch_ms(single_streams(single, batch), frames, 10 if n == 1 else 3)
                    if batch in SINGLE_STREAM_BATCHES else None)
            prof = device_profile(run, frames, k_ms, 20 if n == 1 else 5)
            mem = cache_memory(run, frames)
            per = 1e3 / (batch * n)
            entry = {"streams": batch, "frames": n, "kernel_ms": k_ms, "eager_ms": e_ms,
                     "single_streams_ms": s_ms,
                     "us_per_stream_frame": {"kernel": k_ms * per, "eager": e_ms * per,
                                             "single_streams": s_ms and s_ms * per},
                     "busy_share": prof["busy_share"] if prof else None, "device": prof,
                     "memory": mem, "chain_plans": chain_plans(gen, batch, n)}
            log(f"{path} B={batch:<3d} N={n:<3d} us per stream-frame: kernel "
                f"{k_ms * per:.2f}, eager {e_ms * per:.2f}, {batch} single-stream "
                "dispatches " + (f"{s_ms * per:.2f}" if s_ms else "not timed")
                + "; kernel route busy share "
                + (f"{prof['busy_share']:.3f}" if prof else "not measured")
                + f"; chain (tile, cluster) {entry['chain_plans']}; cache holds "
                f"{mem['cache_held_bytes']} B for its own {mem['cache_own_bytes']} B, "
                f"dispatch peak {mem['dispatch_peak_bytes']} B")
            report[f"B{batch}_N{n}"] = entry
    return report


def spectrum_entries(sites, worst, by_path, course) -> list:
    """The ``kernels`` line's K6 and K7 entries: K6 at the course's mel loss
    (with the course step's median and its profiled K6 time, ``course``), K7
    summed over the vocoder config's three STFT resolutions; every timed
    shape under ``sites``."""
    entries = []
    for name in SPECTRUM_KERNELS:
        spec = KERNELS[name]
        own = {what: site for what, site in sites.items() if site["kernel"] == name}
        main = ({"course mel": own["course mel"]} if name == "log_mel"
                else {w: v for w, v in own.items() if w.startswith("stft")})
        ops = sum(v["flops"] for v in main.values())
        nb = sum(v["bytes"] for v in main.values())
        entry = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "design": spec["design"],
            "arms": sorted({v["arm"] for v in main.values()}),
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": worst[name],
            "ms": sum(v["ms"] for v in main.values()),
            "device_ms": sum(v["device_ms"] or 0.0 for v in main.values()) or None,
            # the GEMM arm at the same calls (a GEMM-arm site's own time)
            "gemm_arm_ms": sum(v.get("gemm_arm_ms", v["ms"]) for v in main.values()),
            "gemm_arm_device_ms": sum(v.get("gemm_arm_device_ms", v["device_ms"]) or 0.0
                                      for v in main.values()) or None,
            "plain_ms": sum(v["plain_ms"] for v in main.values()),
            "bound_ms": sum(v["bound_ms"] for v in main.values()),
            "bound_by": bound_ms(ops, nb)[1],
            "bound_is": ("what the function needs, as an FFT computes it (spectrum_ops), "
                         "against the audio and output bytes"),
            "gemm_form_ops_ms": sum(v["gemm_form_ops_ms"] for v in main.values()),
            "gemm_form_ops_ms_is": ("the DFT-as-GEMM's operations (4 n_fft a frame and "
                                    "frequency) at the f32 rate: what the kernel does, "
                                    "not a bound of the function"),
            "library_ms": (None if name == "log_mel"
                           else sum(v["library_ms"] for v in main.values())),
            "per": ("one call at the course's mel loss (16 x 48000 samples, 2576 frames, "
                    "n_fft 2048, 80 mels)" if name == "log_mel" else
                    "sum over the vocoder config's three STFT resolutions, 16 x 9600 samples"),
            "sites": own,
        }
        if name == "log_mel":
            entry["eager_fft_ms"] = main["course mel"]["eager_fft_ms"]
            entry["eager_fft_device_ms"] = main["course mel"]["eager_fft_device_ms"]
            entry["library_ms_is"] = ("null: no one PyTorch call computes it; eager_fft_ms "
                                      "times the FFT route's log-mel beside it")
            entry["course_step_median_ms"] = course["step_median_ms"]
            entry["course_step_log_mel_kernel_ms"] = (course["profiled_step"] or {}).get(
                "log_mel_kernel_ms")
        else:
            entry["library_device_ms"] = sum(v["library_device_ms"] or 0.0
                                             for v in main.values()) or None
            entry["max_abs_err_is"] = "largest magnitude error (limit 1e-5 of the largest)"
        entries.append(entry)
    return entries


# ---------------------------------------------------------------- phase 10

DP_DEVICES = ("cuda:0", "cuda:0")  # two ranks on the one card: gloo (parallel.mesh.backend_for)
DP_LOSS_RTOL = 2e-4  # JAX's data-parallel tolerances (tests/test_parallel.py:91-95)
DP_PARAM_ATOL = 5e-5
DP_VQ_ATOL = 1e-5
DP_GRAD_FLOOR = 1e-4  # parameters held at the atol where |grad| is above this of the tensor's largest
CODEC_DP_STEPS = 2
SHARD_BATCH, SHARD_LENGTH = 2, 384000  # 8 s, 640 hops a shard on (data 1, time 2)
SHARD_LOSS_RTOL = 1e-4  # JAX's (tests/test_time_shard.py)
SHARD_PARAM_ATOL = 1e-5
SHARD_FWD_ATOL, SHARD_FWD_RTOL = 2e-5, 1e-4
REDUCE_REPS = 5


def rank_group(mesh):
    return None if mesh is None else mesh.get_group("data")


def timed(drive, params, group):
    """``drive()`` with the launch counters at 0 before and read after: (its
    result, {wall_ms, peak_bytes, launches, reduce_ms}). ``reduce_ms`` is one
    gradient reduction of ``params`` timed alone afterwards (the median of
    REDUCE_REPS, each between two synchronizations), None in one process."""
    for spec in KERNELS.values():
        spec["fn"].launches = 0
    torch.cuda.synchronize()
    if group is not None:
        torch.distributed.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = drive()
    torch.cuda.synchronize()
    stats = {"wall_ms": (time.perf_counter() - t0) * 1e3,
             "peak_bytes": torch.cuda.max_memory_allocated(),
             "launches": {name: spec["fn"].launches for name, spec in KERNELS.items()},
             "reduce_ms": None}
    if group is not None:
        params = [p for p in params if p.grad is not None]
        times = []
        for _ in range(REDUCE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            average_gradients(params, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stats["reduce_ms"] = statistics.median(times)
        stats["reduce_share"] = stats["reduce_ms"] / stats["wall_ms"]
    return result, stats


def net_state(nets: dict, rank0: bool, grads: bool = False) -> dict:
    """The networks' parameters after a step (rank 0's, on the host), each
    tensor's f64 sum (every rank's: the ranks must agree), and in one
    process the gradients the parameters are held by."""
    out = {"sums": {f"{k}.{n}": float(p.detach().double().sum())
                    for k, m in nets.items() for n, p in m.named_parameters()}}
    if rank0:
        out["after"] = {f"{k}.{n}": p.detach().cpu() for k, m in nets.items()
                        for n, p in m.named_parameters()}
    if grads:
        out["grads"] = {f"{k}.{n}": p.grad.detach().cpu() for k, m in nets.items()
                        for n, p in m.named_parameters() if p.grad is not None}
    return out


def dp_course_step(inp, mesh):
    """10a: one course ``train_disc`` step at the config's widths (the
    generator, then the MSD + MPD discriminator) on this rank's rows."""
    cfg = course_config()
    group = rank_group(mesh)
    gen, disc = course_generator(cfg), course_discriminator(cfg)
    opt_g = build_optimizer(gen.parameters(), "Adam", cfg["generator_optimizer_params"],
                            grad_norm=cfg.get("generator_grad_norm", -1))
    opt_d = build_optimizer(disc.parameters(), "Adam", cfg["discriminator_optimizer_params"],
                            grad_norm=cfg.get("discriminator_grad_norm", -1))
    step = make_course_steps(gen, disc, cfg, opt_g, opt_d, group)["train_disc"]
    x, t = (torch.from_numpy(a).to(DEVICE)
            for a in shard_batch(mesh, (inp["mixed"], inp["clean"])))
    (g, d, frags, _), stats = timed(lambda: step(x, t),
                                    [*gen.parameters(), *disc.parameters()], group)
    losses = {"g_loss": float(g), "d_loss": float(d), **{k: float(v) for k, v in frags.items()}}
    lrs = {"generator": cfg["generator_optimizer_params"]["lr"],
           "discriminator": cfg["discriminator_optimizer_params"]["lr"]}
    return {"losses": losses, "lr": lrs, **stats,
            **net_state({"generator": gen, "discriminator": disc}, is_rank0(), mesh is None)}


def codec_dp_config(mesh) -> dict:
    cfg = dict(load_config(CODEC_CONFIG), outdir=None, train_max_steps=CODEC_DP_STEPS,
               save_interval_steps=10 ** 9, eval_interval_steps=10 ** 9,
               log_interval_steps=10 ** 9)
    if mesh is not None:
        cfg["parallel"] = {"data_devices": len(DP_DEVICES)}
    return cfg


def dp_codec_steps(inp, mesh):
    """10b: CODEC_DP_STEPS stage-1 steps of the codec through ``TrainerGAN``
    (the EMA codebooks over the ranks), each on this rank's rows."""
    cfg = codec_dp_config(mesh)
    codec = AudioDecGenerator(**cfg["generator_params"], use_pqc=True, seed=SEED + 80,
                              device=DEVICE)
    disc = build_discriminator(cfg["model_type"], cfg["discriminator_params"], device=DEVICE,
                               seed=SEED + 81)
    vq = VQState(*(torch.from_numpy(inp["vq"][f]).to(DEVICE) for f in VQState._fields))
    tr = ae_workload.Trainer(0, 0, {"train": []}, codec, disc, cfg, vq_state=vq)
    require(tr.mesh is not None or mesh is None, "the codec trainer built no mesh")
    books, steps, states = [], [], []
    # the epoch loop's own feed: this rank's rows of each host batch, pinned
    # and uploaded ahead (TrainerGAN._batches), the wait for each timed
    batches = tr._batches(iter(inp["batches"]))
    for _ in inp["batches"]:
        t0 = time.perf_counter()
        rows = next(batches)
        wait_ms = (time.perf_counter() - t0) * 1e3
        _, stats = timed(lambda: tr._train_step(rows), codec.parameters(), tr.group)
        stats["loader_wait_ms"] = wait_ms
        stats["loader_wait_share"] = wait_ms / (wait_ms + stats["wall_ms"])
        steps.append(stats)
        books.append({f: getattr(tr.vq_state, f).cpu() for f in VQState._fields})
        states.append(net_state({"codec": codec}, is_rank0(), mesh is None))
    batches.close()
    return {"losses": tr._read(tr.total_train_loss, len(inp["batches"])), "books": books,
            "steps": steps, "states": states,
            "lr": {"codec": cfg["generator_optimizer_params"]["lr"]}}


def dp_vocoder_step(inp, mesh):
    """10b: one generator step of the ``vctk_v1`` vocoder workload
    (spectral convergence over the ranks, K7) on the codec's codes."""
    vcfg = load_config(VOCODER_CONFIG)
    group = rank_group(mesh)
    analyzer = AudioDecGenerator(**load_config(CODEC_CONFIG)["generator_params"], use_pqc=True,
                                 seed=SEED + 80, device=DEVICE)
    analyzer.requires_grad_(False)
    vq = VQState(*(torch.from_numpy(inp["vq"][f]).to(DEVICE) for f in VQState._fields))
    voc = build_vocoder()
    disc = build_discriminator(vcfg["model_type"], vcfg["discriminator_params"], device=DEVICE,
                               seed=SEED + 82)
    opt_g = build_optimizer_from_config(vcfg, "generator", voc.parameters())
    opt_d = build_optimizer_from_config(vcfg, "discriminator", disc.parameters())
    steps = voc_workload.make_vocoder_steps(analyzer, vq, voc, disc, vcfg, opt_g, opt_d, group)
    x = torch.from_numpy(shard_batch(mesh, inp["x"])).to(DEVICE)
    frags, stats = timed(lambda: steps["gen"](x), voc.parameters(), group)
    frags = {k: float(v) for k, v in pmean_values(frags, group).items()}
    require("spectral_convergence_loss" in frags, f"vocoder frags {sorted(frags)}")
    return {"losses": frags, "lr": {"vocoder": vcfg["generator_optimizer_params"]["lr"]},
            **stats, **net_state({"vocoder": voc}, is_rank0(), is_rank0())}


def shard_config() -> dict:
    cfg = load_config(CODEC_CONFIG)
    return {"mel_loss_params": cfg["mel_loss_params"], "lambda_mel_loss": cfg["lambda_mel_loss"],
            "lambda_snr_loss": 1.0, "lambda_vq_loss": cfg.get("lambda_vq_loss", 1.0),
            "lr": cfg["generator_optimizer_params"]["lr"]}


def shard_codec(inp):
    codec = AudioDecGenerator(**load_config(CODEC_CONFIG)["generator_params"], use_pqc=True,
                              seed=SEED + 85, device=DEVICE)
    vq = VQState(*(torch.from_numpy(inp["vq"][f]).to(DEVICE) for f in VQState._fields))
    opt = build_optimizer(codec.parameters(), "Adam", {"lr": shard_config()["lr"]})
    return codec, vq, opt


def time_shard_step(inp):
    """10c: the full PQC codec on (data 1, time 2): ``time_sharded_forward``
    on this rank's block, then one time-sharded train step."""
    codec, vq, opt = shard_codec(inp)
    mesh = device_mesh((1, 2), ("data", "time"))
    x, t = (local_shard(mesh, torch.from_numpy(inp[k]).to(DEVICE), batch_axis="data")
            for k in ("x", "target"))
    y = time_sharded_forward(codec, mesh, batch_axis="data")(vq, x)
    steps = make_time_sharded_steps(codec, shard_config(), opt, mesh, batch_axis="data")
    groups = (mesh.get_group("time"), mesh.get_group("data"))
    (new_vq, loss, frags), stats = timed(lambda: steps["train"](vq, x, t), codec.parameters(),
                                         groups)
    return {"loss": float(loss), "frags": {k: float(v) for k, v in frags.items()},
            "y": y.cpu(), "position": mesh.get_local_rank("time"), **stats,
            "books": {f: getattr(new_vq, f).cpu() for f in VQState._fields},
            **net_state({"codec": codec}, is_rank0())}


def blocked_shard_step(inp):
    """10c's reference in one process: the offline forward, then
    ``blocked_reference_step`` over the same 2 shards."""
    codec, vq, opt = shard_codec(inp)
    x, t = (torch.from_numpy(inp[k]).to(DEVICE) for k in ("x", "target"))
    with torch.no_grad():
        y = codec(x, vq, train=False)[0]
    step = blocked_reference_step(codec, shard_config(), opt, 2)
    (new_vq, loss), stats = timed(lambda: step(vq, x, t), codec.parameters(), None)
    return {"loss": float(loss), "y": y.cpu(), **stats,
            "books": {f: getattr(new_vq, f).cpu() for f in VQState._fields},
            **net_state({"codec": codec}, True, True)}


def parallel_rank(device, inp):
    """Phase 10 in one rank (parallel.mesh.launch): 10a, 10b and 10c in turn."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    require(torch.distributed.get_backend() == "gloo", "two ranks on one card must use gloo")
    mesh = mesh_from_config({"parallel": {"data_devices": len(DP_DEVICES)}})
    return {"course": dp_course_step(inp["course"], mesh),
            "codec": dp_codec_steps(inp["codec"], mesh),
            "vocoder": dp_vocoder_step(inp["vocoder"], mesh),
            "time_shard": time_shard_step(inp["time_shard"]),
            "device": str(device)}


def parallel_inputs(codec_vq) -> dict:
    """The phase's seeded batches (numpy) and the codec's codebooks."""
    clean, noise = course_clips(1, SEED + 90)[0]
    mixed = add_noise(clean, noise, 15).astype(np.float32)
    length = load_config(CODEC_CONFIG)["batch_length"]
    vq = {f: getattr(codec_vq, f).cpu().numpy() for f in VQState._fields}
    sc, sn = course_clips(1, SEED + 93, SHARD_LENGTH)[0]
    return {"course": {"mixed": mixed, "clean": clean},
            "codec": {"vq": vq, "batches": [course_clips(1, SEED + 91 + i, length)[0][0]
                                            for i in range(CODEC_DP_STEPS)]},
            "vocoder": {"vq": vq, "x": course_clips(1, SEED + 92,
                                                   load_config(VOCODER_CONFIG)["batch_length"])
                        [0][0]},
            "time_shard": {"vq": vq, "target": sc[:SHARD_BATCH],
                           "x": add_noise(sc[:SHARD_BATCH], sn[:SHARD_BATCH], 15).astype(
                               np.float32)}}


def held_after(what, got, ref, lr_of, atol):
    """Parameters after a step against the one-process step's: within
    ``atol`` where the one-process gradient is above DP_GRAD_FLOOR of its
    tensor's largest |value|, within 2 lr an update elsewhere (Adam's first
    step is about lr * g / (|g| + eps): at a gradient near its rounding floor
    two summation orders may differ in sign). Returns the worst errors."""
    worst_big, worst_all, flips = 0.0, 0.0, 0
    require(sorted(got["after"]) == sorted(ref["after"]), f"{what}: parameter names differ")
    for name, r in ref["after"].items():
        diff = (got["after"][name] - r).abs()
        g = ref["grads"].get(name)
        lr = lr_of(name)
        if g is None:
            require(float(diff.max()) == 0.0, f"{what}: {name} took no gradient but moved")
            continue
        big = g.abs() > DP_GRAD_FLOOR * float(g.abs().max())
        if bool(big.any()):
            worst_big = max(worst_big, float(diff[big].max()))
        worst_all = max(worst_all, float(diff.max()))
        flips += int((diff > atol).sum())
        require(float(diff.max()) <= 2.0 * lr * (1 + 1e-3), f"{what}: {name} moved "
                f"{float(diff.max()):.3e} from the one-process step, beyond 2 lr")
    require(worst_big <= atol, f"{what}: a parameter with a gradient above {DP_GRAD_FLOOR} of "
            f"its tensor's largest is {worst_big:.3e} from the one-process step (limit {atol})")
    log(f"  {what}: parameters within {worst_big:.3e} where the gradient counts (limit "
        f"{atol}); {flips} elements beyond it elsewhere, the largest {worst_all:.3e}")
    return {"param_err": worst_big, "param_err_all": worst_all, "beyond_atol": flips}


def moved_within(what, got: dict, ref: dict, bound: float) -> float:
    worst = max(float((got[k] - ref[k]).abs().max()) for k in ref)
    require(worst <= bound * (1 + 1e-3), f"{what}: a parameter is {worst:.3e} from the "
            f"one-process run's, beyond {bound:.3e}")
    return worst


def ranks_agree(what, results, key):
    a, b = (r[key]["sums"] for r in results)
    worst = max(abs(a[k] - b[k]) / max(1.0, abs(a[k])) for k in a)
    require(worst == 0.0, f"{what}: the ranks' parameters differ (relative {worst:.3e})")


def held_losses(what, got: dict, ref: dict, rtol: float) -> float:
    require(sorted(got) == sorted(ref), f"{what}: losses {sorted(got)} against {sorted(ref)}")
    worst = max(abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in ref)
    require(worst <= rtol, f"{what}: a loss is {worst:.3e} from the one-process value "
            f"(limit {rtol}): {got} against {ref}")
    return worst


def rank_line(what, one, results):
    """Log each rank's wall time, reduction share and peak beside the
    one-process step's."""
    log(f"  {what}, first step: one process {one['wall_ms']:.1f} ms, peak "
        f"{one['peak_bytes'] / 2**30:.2f} GiB; "
        + "; ".join(f"rank {i} {r['wall_ms']:.1f} ms (gradient reduction {r['reduce_ms']:.1f} ms, "
                    f"share {r['reduce_share']:.3f}), peak {r['peak_bytes'] / 2**30:.2f} GiB"
                    for i, r in enumerate(results)))


def parallel_phase(codec_vq):
    """Phase 10: data-parallel and time-sharded training over two gloo ranks
    on the one card (DP_DEVICES), each held to the one-process step; the
    ranks' K6 / K7 launches by path."""
    inp = parallel_inputs(codec_vq)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        one = {"course": dp_course_step(inp["course"], None),
               "codec": dp_codec_steps(inp["codec"], None),
               "vocoder": dp_vocoder_step(inp["vocoder"], None),
               "time_shard": blocked_shard_step(inp["time_shard"])}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    results = launch(parallel_rank, DP_DEVICES, inp)
    launch_s = time.perf_counter() - t0
    report = {"devices": list(DP_DEVICES), "backend": backend_for(DP_DEVICES),
              "launch_seconds": launch_s}
    by_path = {}

    # 10a
    r0 = results[0]["course"]
    ranks_agree("10a", results, "course")
    lr = r0["lr"]
    report["10a_course_step"] = {
        "loss_err": max(held_losses(f"10a rank {i}", r["course"]["losses"],
                                    one["course"]["losses"], DP_LOSS_RTOL)
                        for i, r in enumerate(results)),
        **held_after("10a course step", r0, one["course"],
                     lambda n: lr[n.split(".")[0]], DP_PARAM_ATOL),
        "one_process": {k: one["course"][k] for k in ("wall_ms", "peak_bytes")},
        "ranks": [{k: r["course"][k] for k in ("wall_ms", "peak_bytes", "reduce_ms",
                                                 "reduce_share")} for r in results]}
    rank_line("10a course step (16 x 48000)", one["course"], [r["course"] for r in results])

    # 10b
    r0 = results[0]["codec"]
    for i in range(CODEC_DP_STEPS):
        ranks_agree(f"10b codec step {i + 1}", [{"s": r["codec"]["states"][i]} for r in results],
                    "s")
    worst_vq = 0.0
    for i, (got, ref) in enumerate(zip(r0["books"], one["codec"]["books"])):
        for f in VQState._fields:
            err = float((got[f] - ref[f]).abs().max())
            if i == 0:
                require(err <= DP_VQ_ATOL * max(1.0, float(ref[f].abs().max())),
                        f"10b codec step 1: {f} is {err:.3e} from the one-process EMA")
            worst_vq = max(worst_vq, err / max(1.0, float(ref[f].abs().max())))
    report["10b_codec"] = {
        "loss_err": held_losses("10b codec", r0["losses"], one["codec"]["losses"],
                                DP_LOSS_RTOL),
        "codebook_rel_err": worst_vq,
        # the first step's parameters by its gradients; the last within 2 lr an update
        **held_after("10b codec step 1", r0["states"][0], one["codec"]["states"][0],
                     lambda n: r0["lr"]["codec"], DP_PARAM_ATOL),
        "last_step_param_err": moved_within(
            f"10b codec step {CODEC_DP_STEPS}", r0["states"][-1]["after"],
            one["codec"]["states"][-1]["after"], 2.0 * r0["lr"]["codec"] * CODEC_DP_STEPS),
        "steps": [{"one_process": {k: o[k] for k in ("wall_ms", "peak_bytes", "loader_wait_ms",
                                                       "loader_wait_share")},
                   "ranks": [{k: r["codec"]["steps"][i][k]
                              for k in ("wall_ms", "peak_bytes", "reduce_ms", "reduce_share",
                                        "loader_wait_ms", "loader_wait_share")}
                             for r in results]}
                  for i, o in enumerate(one["codec"]["steps"])]}
    for i, o in enumerate(one["codec"]["steps"]):
        rank_line(f"10b codec stage-1 step {i + 1} (16 x 96000)", o,
                  [r["codec"]["steps"][i] for r in results])
        log("    loader wait (the rank's rows cut, pinned and uploaded): one process "
            f"{o['loader_wait_ms']:.1f} ms, ranks " + ", ".join(
                f"{r['codec']['steps'][i]['loader_wait_ms']:.1f} ms (share "
                f"{r['codec']['steps'][i]['loader_wait_share']:.3f})" for r in results))
    r0 = results[0]["vocoder"]
    ranks_agree("10b vocoder", results, "vocoder")
    # the log-STFT-magnitude term's gradient, 1 / |S| at bins near f32's floor,
    # moves with the output's last bits (cuDNN at 8 rows against 16): the
    # gradients are held as phase 7f holds that term across routes
    # (LOG_MAG_GRAD_RTOL of each tensor's largest), the parameters within 2 lr
    grad_err = max(float((r0["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
                   for k, g in one["vocoder"]["grads"].items())
    require(grad_err <= LOG_MAG_GRAD_RTOL, f"10b vocoder: a gradient is {grad_err:.3e} of its "
            f"tensor's largest from the one-process step's (limit {LOG_MAG_GRAD_RTOL})")
    report["10b_vocoder"] = {
        "loss_err": held_losses("10b vocoder", r0["losses"], one["vocoder"]["losses"],
                                DP_LOSS_RTOL),
        "grad_rel_err": grad_err,
        "param_err_all": moved_within("10b vocoder", r0["after"], one["vocoder"]["after"],
                                      2.0 * r0["lr"]["vocoder"])}
    log(f"  10b vocoder: gradients within {grad_err:.3e} of each tensor's largest (limit "
        f"{LOG_MAG_GRAD_RTOL}), parameters within {report['10b_vocoder']['param_err_all']:.3e}")
    rank_line("10b vocoder step (16 x 9600)", one["vocoder"], [r["vocoder"] for r in results])

    # 10c
    ts = sorted((r["time_shard"] for r in results), key=lambda r: r["position"])
    ref = one["time_shard"]
    got_y = torch.cat([r["y"] for r in ts], dim=1)
    codec = AudioDecGenerator(**load_config(CODEC_CONFIG)["generator_params"], use_pqc=True,
                              seed=SEED + 85, device="cpu")
    warm = ((-(-codec.receptive_length // codec.hop))
            + 2 * decoder_receptive_frames(codec.decoder)) * codec.hop
    require(tuple(got_y.shape) == tuple(ref["y"].shape), f"10c forward {tuple(got_y.shape)}")
    fwd_err = (got_y[:, warm:] - ref["y"][:, warm:]).abs()
    fwd_limit = SHARD_FWD_ATOL + SHARD_FWD_RTOL * ref["y"][:, warm:].abs()
    require(bool((fwd_err <= fwd_limit).all()), f"10c: the sharded forward beyond {warm} "
            f"samples is {float(fwd_err.max()):.3e} from the offline forward")
    require(all(abs(r["loss"] - ref["loss"]) <= SHARD_LOSS_RTOL * abs(ref["loss"]) for r in ts),
            f"10c: losses {[r['loss'] for r in ts]} against the blocked step's {ref['loss']}")
    r0 = next(r for r in ts if "after" in r)
    worst_vq = max(float((r0["books"][f] - ref["books"][f]).abs().max()) for f in ("embed",
                                                                                    "cluster_size"))
    require(worst_vq <= DP_VQ_ATOL, f"10c: the codebooks are {worst_vq:.3e} from the blocked step's")
    report["10c_time_shard"] = {
        "loss_err": abs(r0["loss"] - ref["loss"]) / abs(ref["loss"]),
        "forward_err_beyond_warmup": float(fwd_err.max()), "warmup_samples": warm,
        "codebook_err": worst_vq,
        **held_after("10c time shard", r0, ref, lambda n: shard_config()["lr"], SHARD_PARAM_ATOL),
        "one_process": {k: ref[k] for k in ("wall_ms", "peak_bytes")},
        "ranks": [{k: r[k] for k in ("wall_ms", "peak_bytes", "reduce_ms", "reduce_share")}
                  for r in ts]}
    log(f"  10c: forward within {float(fwd_err.max()):.3e} beyond {warm} samples; loss "
        f"{r0['loss']:.6g} against {ref['loss']:.6g}")
    rank_line("10c time-sharded step (2 x 384000, (data 1, time 2))", ref, ts)

    for what, key, kernels in (("10a course step", "course", ("log_mel",)),
                               ("10b codec steps", "codec", ("log_mel",)),
                               ("10b vocoder step", "vocoder", ("log_mel", "stft_magnitude")),
                               ("10c time-sharded step", "time_shard", ("log_mel",))):
        runs = [r[key]["launches"] if key != "codec" else
                {n: sum(s["launches"][n] for s in r[key]["steps"]) for n in KERNELS}
                for r in results]
        counts = {n: sum(c[n] for c in runs) for n in KERNELS}
        for name in kernels:
            require(all(c[name] > 0 for c in runs), f"{what}: a rank never launched {name}")
        by_path[f"{what} x{len(DP_DEVICES)} ranks"] = counts
    log(f"phase 10 launches: {json.dumps(by_path)}")
    return by_path, report


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    started = time.perf_counter()
    elapsed = {}  # step -> seconds since the start, where the step ended

    def stamp(step):
        elapsed[step] = time.perf_counter() - started
        log(f"[{elapsed[step]:.1f} s] {step} done")

    t0 = time.perf_counter()
    built = _cuda.build()
    for name in _cuda.SOURCES:
        _cuda.load(name)
    log(f"phase 1: built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for name, info in built.items():
        regs = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
        log(f"  {name}: nvcc {info['seconds']:.1f} s; " + " | ".join(regs))
    gp = dict(load_config(CONFIG)["generator_params"])
    gen = AudioDecGenerator(**gp, use_pqc=False, seed=SEED, device=DEVICE)
    log(f"flagship generator: {sum(p.numel() for p in gen.parameters())} params, "
        f"hop {gen.hop}, receptive length {gen.receptive_length}")
    codec_gp = dict(load_config(CODEC_CONFIG)["generator_params"])
    codec = AudioDecGenerator(**codec_gp, use_pqc=True, seed=SEED, device=DEVICE)
    vq = codec_vq_state(codec)
    tables = vq_tables(vq, DEVICE)
    log(f"flagship codec: {sum(p.numel() for p in codec.parameters())} params and "
        f"{vq.embed.numel()} codebook floats {tuple(vq.embed.shape)}, receptive length "
        f"{codec.receptive_length}")
    rng = torch.Generator(device=DEVICE).manual_seed(SEED)
    # real projector outputs of the codec for the search's checks and times
    z_real = streamed_z(codec, frames_for(Z_FRAMES, SEED + 4).reshape(1, 1, -1, 1))
    z_real = z_real.reshape(-1, z_real.shape[-1])

    rx_codec = AudioDecGenerator(**codec_gp, use_pqc=True, seed=SEED + 1, device=DEVICE)
    rx_vq = codec_vq_state(rx_codec)
    voc = build_vocoder()
    log(f"vocoder receiver: {sum(p.numel() for p in voc.parameters())} params, total "
        f"upsample {voc.total_upsample}, folded input conv in f64")
    v0, v2 = build_vocoder(V0_CONFIG), build_vocoder(V2_CONFIG)
    require(vocoder_topology_error(v0, FRAME, hop=codec.hop) is None,
            "the v0 receiver is not on the kernel route")
    stage0_plans = {"vocoder": check_stage0_clusters(voc, "vctk_v1"),
                    "vocoder_v0": check_stage0_clusters(v0, "vctk_v0")}
    log(f"v0 receiver (MultiReceptiveField): {sum(p.numel() for p in v0.parameters())} "
        f"params; v2 receiver: {sum(p.numel() for p in v2.parameters())} params")
    conv_plan_report = conv_plans({"denoiser": gen, "codec": codec, "vocoder": voc,
                                   "vocoder_v0": v0, "vocoder_v2": v2})
    stamp("phase 1 (build, models)")

    log("phase 2: kernels vs plain versions")
    worst = check_kernels(gen, rng)
    codec_worst, codec_ties = check_codec_kernels(codec, tables, z_real, rng)
    batched_worst, batched_ties = check_batched_kernels(gen, codec, tables, z_real, rng)
    stamp("phase 2, codecs")
    voc_worst = check_vocoder_kernels(voc, rng)
    stamp("phase 2, receiver")
    v0_worst = check_vocoder_kernels(v0, rng, V0_BATCH_CHECKS)
    stamp("phase 2, v0 receiver (MultiReceptiveField sites)")

    log("phase 3: main paths")
    launches, main_errs = main_path(gen)
    codec_launches, codec_errs, codec_wire = codec_path(codec, vq, tables)
    stamp("phase 3, codecs' one-stream paths")
    voc_launches, voc_checks = vocoder_path(codec, vq, tables, voc, codec_wire)
    stamp("phase 3, receiver path")
    v0_launches, v0_checks = vocoder_path(codec, vq, tables, v0, codec_wire, "vocoder_v0")
    del codec_wire
    v0_fleet_launches, v0_fleet_checks = vocoder_fleet_path(codec, vq, v0, "vocoder_v0")
    v0_fleet_checks["timed_shapes_vs_batched_eager"] = vocoder_timed_shapes_held(
        codec, vq, tables, v0, V0_TIME_BATCHES, "vocoder_v0")
    stamp("phase 3, v0 receiver path and fleet")
    v2_launches, v2_checks = v2_path(codec, vq, tables, v2)
    del v2
    folded_launches, folded_worst, folded_times = folded_phase(gen, rng)
    probe_launches, probe_times = probe_phase()
    cli_launches, cli_checks = cli_phase(codec, vq, v0)
    stamp("phase 3, vctk_v2, K1f, T1 and the CLI")
    multi_launches, multi_checks = {}, {}
    multi_launches["denoiser"], multi_checks["denoiser"] = multi_stream_path(
        "denoiser", gen, None, None)
    multi_launches["codec"], multi_checks["codec"] = multi_stream_path(
        "codec", codec, vq, tables, rx=(rx_codec, rx_vq))
    multi_checks["denoiser"]["timed_shapes_vs_batched_eager"] = timed_shapes_held(
        "denoiser", gen, None, None)
    multi_checks["codec"]["timed_shapes_vs_batched_eager"] = timed_shapes_held(
        "codec", codec, vq, tables)
    stamp("phase 3, codecs' multi-stream paths")
    voc_fleet_launches, multi_checks["vocoder"] = vocoder_fleet_path(codec, vq, voc)
    multi_checks["vocoder"]["timed_shapes_vs_batched_eager"] = vocoder_timed_shapes_held(
        codec, vq, tables, voc)
    stamp("phase 3, receiver fleet")
    by_path = {"denoiser": launches, "codec": codec_launches, "vocoder": voc_launches,
               f"vocoder fleet x{BATCH}": voc_fleet_launches, "vocoder_v0": v0_launches,
               f"vocoder_v0 fleet x{BATCH}": v0_fleet_launches, "vocoder_v2": v2_launches,
               "K1f": folded_launches, "T1": probe_launches, **cli_launches}
    for path, runs in multi_launches.items():
        for kind, counts in runs.items():
            by_path[f"{path} {kind} x{BATCH}"] = counts

    log("phase 4: times")
    cuda_run = make_scan_stream(gen, frame_size=FRAME)
    eager_run = make_scan_stream(gen, frame_size=FRAME, backend="eager")
    times = {
        "latency_n1_cuda": latency(cuda_run, 200),
        "latency_n1_eager": latency(eager_run, 50),
        "throughput_cuda": throughput(cuda_run, THROUGHPUT_FRAMES, 10),
        "throughput_eager": throughput(eager_run, THROUGHPUT_FRAMES, 3),
    }
    for key, val in times.items():
        log(key, json.dumps(val))
    profile = device_profile(cuda_run, frames_for(1, SEED + 3),
                             times["latency_n1_cuda"]["median_ms"])
    times["device_n1_cuda"] = profile
    log("device_n1_cuda", json.dumps(profile) if profile
        else "not measured (the profiler trace shows no device time)")
    ktimes = time_kernels(lambda n, wd: sites(gen, n, wd, rng), DENOISER_KERNELS)

    codec_run = make_scan_stream(codec, vq, frame_size=FRAME)
    codec_f32 = make_scan_stream(codec, vq, frame_size=FRAME, weight_dtype=torch.float32)
    codec_times = {
        "latency_n1_codec": latency(codec_run, 200),
        "latency_n1_codec_f32": latency(codec_f32, 100),
        "throughput_codec": throughput(codec_run, THROUGHPUT_FRAMES, 5),
    }
    for key, val in codec_times.items():
        log(key, json.dumps(val))
    codec_profile = device_profile(codec_run, frames_for(1, SEED + 3),
                                   codec_times["latency_n1_codec"]["median_ms"])
    codec_times["device_n1_codec"] = codec_profile
    log("device_n1_codec", json.dumps(codec_profile) if codec_profile
        else "not measured (the profiler trace shows no device time)")
    times.update(codec_times)
    codec_ktimes = time_kernels(
        lambda n, wd: codec_sites(codec, tables, z_real, n, wd, rng),
        ("causal_conv", "rvq_assign", "codebook_lookup"))
    batch_sizes = ((1, 20), (BATCH_SIZES[1], 10))
    ktimes_b = time_kernels(lambda n, wd: sites(gen, n, wd, rng, BATCH), DENOISER_KERNELS,
                            batch_sizes)
    codec_ktimes_b = time_kernels(
        lambda n, wd: codec_sites(codec, tables, z_real, n, wd, rng, BATCH),
        ("causal_conv", "rvq_assign", "codebook_lookup"), batch_sizes)
    stamp("phase 4, codecs' one-stream times and sites")
    multi_times = {"denoiser": multi_stream_times("denoiser", gen, None),
                   "codec": multi_stream_times("codec", codec, vq)}
    stamp("phase 4, codecs' multi-stream times")
    voc_times, voc_ktimes, voc_ktimes_b = vocoder_times(codec, vq, voc, rng)
    stamp("phase 4, receiver times")
    v0_times, v0_ktimes, v0_ktimes_b = vocoder_times(codec, vq, v0, rng, V0_TIME_BATCHES,
                                                     "vocoder_v0")
    stamp("phase 4, v0 receiver times")

    log("phase 5: training (the course generator phase, the vocoder metric loss)")
    cfg, vcfg = course_config(), load_config(VOCODER_CONFIG)
    cases = spectrum_cases(cfg, vcfg)
    spectrum_worst, spectrum_checks = check_spectrum_kernels(cases, rng)
    clips = course_clips(6, SEED + 60)
    train_launches = {}
    train_launches["course step"], course_checks = course_routes(cfg, clips[0])
    runs, course_report = course_training(cfg, clips)
    train_launches.update(runs)
    train_launches["vocoder metric loss"], voc_metric_checks = vocoder_metric_routes(
        codec, vq, voc, vcfg)
    train_sites, train_times = training_times(cfg, cases, rng)
    stamp("phase 5, training")
    by_path.update(train_launches)

    log("phase 6: adversarial training (the course's discriminators, step, loop and times)")
    disc_checks = check_discriminators(cfg)
    adv_launches = {}
    adv_launches["adversarial step"], adv_checks = adversarial_routes(cfg, clips[0])
    runs, adv_loop = adversarial_loop(cfg, clips)
    adv_launches.update(runs)
    runs, adv_times = adversarial_times(cfg, clips)
    adv_launches.update(runs)
    stamp("phase 6, adversarial training")
    by_path.update(adv_launches)

    log("phase 7: the AudioDec recipe through its CLIs (codec, statistic, vocoder, denoise, "
        "course) and each workload's step on the kernel and the plain route")
    with tempfile.TemporaryDirectory() as root:
        corpus_seconds = write_recipe_corpus(root)
        recipe_launches, recipe_report = recipe_phase(root, corpus_seconds)
    runs, recipe_report["routes"] = recipe_routes(codec, vq)
    recipe_launches.update(runs)
    recipe_report["prefetch_to_device"] = prefetch_check()
    log(f"7g prefetch_to_device: {json.dumps(recipe_report['prefetch_to_device'])}")
    stamp("phase 7, the AudioDec recipe")
    by_path.update(recipe_launches)

    log("phase 8: evaluation and the reference's checkpoints (export / import, cli.test, "
        "cli.testing_denoise, cli.analyze, cli.dnsmos, the native library)")
    eval_launches, eval_report = evaluation_phase(codec, vq, voc, recipe_report)
    stamp("phase 8, evaluation and the reference's checkpoints")
    by_path.update(eval_launches)

    log("phase 9: bf16 launch boundaries (K3b, K5), the fleet CLI, the fleet split, long "
        "audio and the streamer's device split")
    slice10 = {}
    runs, slice10["boundaries"], arm_entries = boundary_phase(gen, codec, vq, tables, voc, v0)
    by_path.update(runs)
    stamp("phase 9a-9b, bf16 launch boundaries")
    runs, slice10["fleet_cli"] = fleet_cli_phase(gen, codec, vq, voc)
    by_path.update(runs)
    runs, slice10["fleet_split"] = fleet_split_phase(codec, vq)
    by_path.update(runs)
    slice10["long_audio"] = long_audio_phase(gen)
    runs, slice10["streamer_split"] = streamer_split_phase(codec, vq, tables)
    by_path.update(runs)
    stamp("phase 9c-9f, fleets, long audio, the streamer split")

    log("phase 10: data-parallel training over two gloo ranks on the card (the course step, "
        "the codec's stage 1 and the vocoder step through the workloads) and time-sharded "
        "training of the full PQC codec on (data 1, time 2)")
    runs, slice11 = parallel_phase(vq)
    by_path.update(runs)
    stamp("phase 10, data-parallel and time-sharded training")

    name_power = card()
    entries = []
    for name in SERVING_KERNELS:
        spec = KERNELS[name]
        first_path = ("denoiser" if name in DENOISER_KERNELS
                      else "vocoder" if name == "hifigan_unit" else "codec")
        kt, prof, kt_b = {"denoiser": (ktimes, profile, ktimes_b),
                          "codec": (codec_ktimes, codec_profile, codec_ktimes_b),
                          "vocoder": (voc_ktimes, voc_times["device_n1"], voc_ktimes_b),
                          }[first_path]
        agg1, agg, agg400 = (kt[n][name] for n in SIZES)
        # kernels on the tensor cores
        split_tf32 = name in ("residual_chain", "hifigan_unit", "causal_conv",
                              "causal_conv_transpose")
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms") + (
            ("bound_ms_f32_cores",) if split_tf32 else ()) + (
            ("device_ms", "library_device_ms") if name in GRAPHED_KERNELS else ())
        entry = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"],
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": max(batched_worst[name],
                               worst[name] if name in DENOISER_KERNELS else 0.0),
            "ms": agg["ms"], "plain_ms": agg["plain_ms"],
            "bound_ms": agg["bound_ms"], "bound_by": agg["bound_by"],
            "library_ms": agg["library_ms"],
            "per": f"sum over the kernel's sites in one {DISPATCH}-frame dispatch of the "
                   f"{first_path} path, bf16 weights",
            "ms_1frame": agg1["ms"], "plain_ms_1frame": agg1["plain_ms"],
            "bound_ms_1frame": agg1["bound_ms"], "library_ms_1frame": agg1["library_ms"],
            "device_ms_1frame_profiled": (prof["kernels_ms_per_dispatch"][name]
                                          if prof else None),
            f"ms_{THROUGHPUT_FRAMES}frames": agg400["ms"],
            f"plain_ms_{THROUGHPUT_FRAMES}frames": agg400["plain_ms"],
            f"bound_ms_{THROUGHPUT_FRAMES}frames": agg400["bound_ms"],
            f"library_ms_{THROUGHPUT_FRAMES}frames": agg400["library_ms"],
            f"streams_{BATCH}": {
                f"frames_{n}": {key: kt_b[n][name][key] for key in keys}
                for n in BATCH_SIZES},
        }
        if split_tf32:
            entry["bound_is"] = (f"operations at {TF32_FLOPS:.3g} FLOP/s TF32 over the split "
                                 "passes (2 with bf16 weights)"
                                 + (" on the GEMM arm's sites, at the f32 rate on the Cin = 1 "
                                    "and Cout = 1 arms'" if name == "causal_conv" else "")
                                 + f"; bound_ms_f32_cores at {F32_FLOPS:.3g}, the f32 rate "
                                 "earlier runs reported")
            entry["bound_ms_f32_cores"] = agg["bound_ms_f32_cores"]
            entry["bound_ms_f32_cores_1frame"] = agg1["bound_ms_f32_cores"]
            entry[f"bound_ms_f32_cores_{THROUGHPUT_FRAMES}frames"] = agg400["bound_ms_f32_cores"]
        if name in codec_worst:
            entry["max_abs_err"] = max(entry["max_abs_err"], codec_worst[name])
        if name in voc_worst:
            entry["max_abs_err"] = max(entry["max_abs_err"], voc_worst[name], v0_worst[name])
            entry["vocoder_sites"] = {str(n): voc_ktimes[n][name]["sites"] for n in SIZES}
            entry[f"vocoder_sites_streams_{BATCH}"] = {
                str(n): voc_ktimes_b[n][name]["sites"] for n in BATCH_SIZES}
            entry["vocoder_v0"] = {
                f"frames_{n}": {key: v0_ktimes[n][name][key] for key in keys}
                for n in SIZES}
            entry["vocoder_v0"].update({
                f"streams_{BATCH}_frames_{n}": {key: v0_ktimes_b[n][name][key]
                                                for key in keys}
                for n in BATCH_SIZES})
            entry["vocoder_v0_sites"] = {str(n): v0_ktimes[n][name]["sites"] for n in SIZES}
            entry[f"vocoder_v0_sites_streams_{BATCH}"] = {
                str(n): v0_ktimes_b[n][name]["sites"] for n in BATCH_SIZES}
        if name == "hifigan_unit":
            entry["max_abs_err_v0"] = v0_worst[name]
        if name in GRAPHED_KERNELS:
            entry.update({
                "device_ms": agg["device_ms"], "library_device_ms": agg["library_device_ms"],
                "device_ms_1frame": agg1["device_ms"],
                "library_device_ms_1frame": agg1["library_device_ms"],
                f"device_ms_{THROUGHPUT_FRAMES}frames": agg400["device_ms"],
                f"library_device_ms_{THROUGHPUT_FRAMES}frames": agg400["library_device_ms"],
                "device_ms_is": "CUDA events around a CUDA graph of 20 calls (graph_ms)"})
        if name == "rvq_assign":
            entry["max_abs_err_is"] = "largest distance excess of a near-tie pick"
            entry["near_tie_rows"] = codec_ties + batched_ties
            entry["code_mismatches"] = 0
        if name == "causal_conv":
            entry["codec_sites"] = {str(n): codec_ktimes[n]["causal_conv"]["sites"]
                                    for n in SIZES}
            entry[f"codec_sites_streams_{BATCH}"] = {
                str(n): codec_ktimes_b[n]["causal_conv"]["sites"] for n in BATCH_SIZES}
        entries.append(entry)
    entries += spectrum_entries(train_sites, spectrum_worst, by_path, course_report)
    k1f_main = {k: v for k, v in folded_times.items() if k.endswith("frames=1")}
    k1f = {key: sum(v[key] for v in k1f_main.values())
           for key in ("ms", "plain_ms", "bound_ms", "bound_ms_f32_cores")}
    chain = next(e for e in entries if e["name"] == "residual_chain")
    chain["max_abs_err"] = max(chain["max_abs_err"], folded_worst)
    chain["k1f"] = {
        **k1f, "bound_by": bound_ms(sum(v["ops"] for v in k1f_main.values()),
                                    sum(v["bytes"] for v in k1f_main.values()),
                                    TF32_FLOPS / TF32_PASSES[torch.float32])[1],
        "library_ms": None, "max_abs_err_vs_folded_plain": folded_worst,
        "launches": by_path["K1f"]["residual_chain"],
        "per": "K1f (fused_residual_chain_folded runs this kernel): sum over FOLDED_SITES "
               f"(C = 32 at fold 1/2/3, C = 64 at fold 1/2) at one frame; at {DISPATCH} "
               "frames under sites",
        "sites": folded_times}
    probe_main = probe_times.values()
    entries.append({
        "name": "fold_copy", "route": "cuda", "source": KERNELS["fold_copy"]["source"],
        "replaces": KERNELS["fold_copy"]["replaces"],
        "launches": sum(counts["fold_copy"] for counts in by_path.values()),
        "launches_by_path": {path: counts["fold_copy"] for path, counts in by_path.items()},
        "max_abs_err": 0.0,
        **{key: sum(v[key] for v in probe_main)
           for key in ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                       "library_device_ms")},
        "bound_by": bound_ms(0.0, sum(v["bytes"] for v in probe_main))[1],
        "library_ms_is": "torch.clone of the folded view",
        "per": "sum over the probe's four defined shapes", "sites": probe_times})
    entries += arm_entries
    report = {"card": name_power, "seconds": time.perf_counter() - started,
              "elapsed_seconds_by_step": elapsed,
              "main_path_errors": main_errs, "codec_path_checks": codec_errs,
              "vocoder_path_checks": voc_checks, "vocoder_times": voc_times,
              "unit_plans_one_stream_one_frame": stage0_plans,
              "causal_conv_plans": conv_plan_report,
              "vocoder_v0_path_checks": v0_checks, "vocoder_v0_fleet_checks": v0_fleet_checks,
              "vocoder_v0_times": v0_times, "vocoder_v2_checks": v2_checks,
              "cli_checks": cli_checks,
              "multi_stream_checks": multi_checks, "multi_stream_times": multi_times,
              "times": times, "kernels": entries,
              "training": {"spectrum_kernel_checks": spectrum_checks,
                           "course_step_routes": course_checks, "course": course_report,
                           "vocoder_metric_loss_routes": voc_metric_checks,
                           "times": train_times, "spectrum_sites": train_sites,
                           "adversarial": {"discriminators_vs_cpu": disc_checks,
                                           "step_routes": adv_checks, "loop": adv_loop,
                                           "times": adv_times},
                           "recipe": recipe_report},
              "evaluation": eval_report, "slice10": slice10, "slice11": slice11,
              "kernel_sites": {str(n): {k: v["sites"] for k, v in agg.items()}
                               for n, agg in ktimes.items()},
              "codec_kernel_sites": {str(n): {k: v["sites"] for k, v in agg.items()}
                                     for n, agg in codec_ktimes.items()},
              f"kernel_sites_streams_{BATCH}": {
                  str(n): {k: v["sites"] for k, v in agg.items()}
                  for n, agg in (*ktimes_b.items(), *(
                      (f"codec {n}", a) for n, a in codec_ktimes_b.items()))}}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['seconds']:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(name_power)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
