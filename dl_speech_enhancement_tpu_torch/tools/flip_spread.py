"""How far apart two evaluations of a bf16-weight kernel's function can be,
on one card.

    python -m dl_speech_enhancement_tpu_torch.tools.flip_spread [--out FILE]

With bf16 weights residual_chain and hifigan_unit round intermediate
operands to bf16 (as the JAX kernels do), and a vocoder upsample its
product: the function jumps where such an f32 sum crosses a bf16 rounding
midpoint. For each site below (the chain sites at one stream of 1 and 16
frames, units at the v1 and v0 receivers' widths, two upsamples) it prints
the kernel's largest distance from its plain version on the card, and the
plain version's on the card from the same plain version on the CPU (f32
sums in another order), and the plain version's on unrounded operands (the
port's function before it rounded them), each over the largest |output|;
the shares of elements beyond chip_smoke.py's KERNEL_RTOL_BF16 and
CHAIN_ATOL; and ``utils/checks.py::rounding_held``'s RMS share (the
kernel's RMS distance from the plain version over its distance from the
unrounded one). Operands
are N(0, 0.3^2) from a seeded generator, weights unit-gain; TF32 is off in
both matmul and cuDNN.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows as JSON here")
    args = ap.parse_args()
    import torch

    from dl_speech_enhancement_tpu_torch.ops import mega_kernel as mk
    from dl_speech_enhancement_tpu_torch.ops import stream_kernel as sk
    from dl_speech_enhancement_tpu_torch.ops import vocoder_kernel as vk
    from dl_speech_enhancement_tpu_torch.utils.checks import rounding_held

    if not torch.cuda.is_available():
        print("flip_spread: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * 0.3

    def cpu(ts):
        return [t.cpu() if torch.is_tensor(t) else t for t in ts]

    def unrounded(ts, *weights):
        return [t.float() if i in weights else t for i, t in enumerate(ts)]

    rows = []

    def row(site, got, ref, alt, loose):
        scale = float(ref.abs().max())
        err, spread = (got - ref).abs(), (alt.to(ref.device) - ref).abs()
        held = rounding_held(got, ref, loose)
        r = {"site": site, "scale": scale, "kernel_vs_plain": float(err.max()) / scale,
             "plain_vs_cpu_plain": float(spread.max()) / scale,
             "unrounded_vs_plain": float((loose - ref).abs().max()) / scale,
             "share_beyond_1e-4_rel": float((err > 1e-4 * scale).float().mean()),
             "share_beyond_2e-6": float((err > 2e-6).float().mean()),
             "rms_share": held["rms_share"], "held": held["held"]}
        rows.append(r)
        print(f"{site}: kernel vs plain {r['kernel_vs_plain']:.2e}, plain vs CPU plain "
              f"{r['plain_vs_cpu_plain']:.2e}, unrounded vs plain "
              f"{r['unrounded_vs_plain']:.2e} of {scale:.3g}; beyond 1e-4 rel "
              f"{r['share_beyond_1e-4_rel']:.2e}, beyond 2e-6 {r['share_beyond_2e-6']:.2e}; "
              f"rms share {r['rms_share']:.3f}", flush=True)

    for c, per_frame in ((32, 1200), (64, 400), (128, 100), (256, 20)):
        for frames in (1, 16):
            t = per_frame * frames
            ops = (rn(78, c), rn(t, c), (rn(3, 7, c, c) / 0.3 / (7 * c) ** 0.5).bfloat16(),
                   (rn(3, c, c) / 0.3 / c ** 0.5).bfloat16())
            got, ref = sk.residual_chain(*ops), sk.residual_chain_plain(*ops)
            row(f"residual_chain C={c} rows={t}", got, ref, sk.residual_chain_plain(*cpu(ops)),
                sk.residual_chain_plain(*unrounded(ops, 2, 3)))
    for batch, t, c, groups, k, d, tiled in ((1, 20, 256, 3, 11, 1, True),
                                             (16, 320, 256, 3, 11, 5, False),
                                             (1, 1200, 32, 3, 11, 1, True),
                                             (16, 20, 256, 1, 3, 1, False)):
        cin = c if tiled else groups * c
        ops = (rn(batch, (k - 1) * d, cin), rn(batch, k - 1, groups * c), rn(batch, t, cin) * 3,
               (rn(k, c, groups * c) / 0.3 / (k * c) ** 0.5).bfloat16(), rn(groups * c),
               (rn(k, c, groups * c) / 0.3 / (k * c) ** 0.5).bfloat16(), rn(groups * c),
               d, groups)
        got, ref = vk.hifigan_unit(*ops)[0], vk.hifigan_unit_plain(*ops)[0]
        row(f"hifigan_unit B={batch} rows={t} c={c} groups={groups} k={k} d={d}", got, ref,
            vk.hifigan_unit_plain(*cpu(ops))[0], vk.hifigan_unit_plain(*unrounded(ops, 3, 5))[0])
    for cin, cout, s, t in ((512, 256, 5, 64), (256, 128, 4, 320)):
        ops = (rn(16, 1, cin), rn(16, t, cin), (rn(2 * s, cin, cout) / 0.3 / cin ** 0.5).bfloat16(),
               rn(cout), s, 0.1, "product")
        got, ref = mk.causal_conv_transpose(*ops), mk.causal_conv_transpose_plain(*ops)
        row(f"causal_conv_transpose {cin}->{cout} s={s} rows={t} (product rounded)", got, ref,
            mk.causal_conv_transpose_plain(*cpu(ops)),
            mk.causal_conv_transpose_plain(*unrounded(ops, 2)))
    print("end:", _card())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "sites": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
