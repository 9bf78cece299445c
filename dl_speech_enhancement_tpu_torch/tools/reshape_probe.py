#!/usr/bin/env python3
"""Relayout probe: the sublane<->lane fold reshapes of the stacked-region
kernels, through a hand-written CUDA copy kernel (csrc/fold_copy.cu).

Counterpart of the JAX repository's tools/reshape_probe.py, which checks
whether Mosaic lowers two value-space reshapes inside a Pallas TPU kernel:

- fold:   (R, C)   -> (R/s, s*C)   (s consecutive rows side by side)
- unfold: (R, s*C) -> (R*s, C)     (the inverse)

at the shapes the stacked-region kernel would use, and holds each result to
numpy's ``x.reshape``. Run from the repository root on the card:

    python3 -m dl_speech_enhancement_tpu_torch.tools.reshape_probe

Exit 0 when every shape agrees with numpy. Two of the six shapes, (112, 128)
and (32, 256) folded by 5, have no fold: their rows are not a multiple of
5, numpy refuses the reshape, and so does :func:`fold_copy` (ValueError, no
launch). The probe counts a shape as agreeing when the kernel's result
equals numpy's exactly, or when both refuse it.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dl_speech_enhancement_tpu_torch.ops import _cuda

# (shape, s, mode) as the JAX probe runs them: the encoder's level-1..3 folds
# (stride 4, 5, 5 on 64/128/256 lanes) and the decoder's unfolds
SHAPES = (((416, 64), 4, "fold"), ((112, 128), 5, "fold"), ((32, 256), 5, "fold"),
          ((104, 4 * 64), 4, "unfold"), ((24, 5 * 128), 5, "unfold"),
          ((8, 5 * 256), 5, "unfold"))


def folded_shape(shape, s: int, mode: str) -> tuple[int, int]:
    """The destination shape of ``mode`` ('fold' or 'unfold') by ``s``;
    ValueError where the rows (fold) or the width (unfold) are not a
    multiple of ``s``."""
    r, c = shape
    if mode not in ("fold", "unfold"):
        raise ValueError(f"mode must be 'fold' or 'unfold', got {mode!r}")
    if s < 1 or (r if mode == "fold" else c) % s:
        raise ValueError(f"cannot {mode} {tuple(shape)} by {s}: "
                         f"{'rows' if mode == 'fold' else 'width'} not a multiple of {s}")
    return (r // s, s * c) if mode == "fold" else (r * s, c // s)


def fold_copy_plain(x: torch.Tensor, s: int, mode: str) -> torch.Tensor:
    """Plain PyTorch version of :func:`fold_copy`: ``x.reshape(...).clone()``."""
    return x.reshape(folded_shape(tuple(x.shape), s, mode)).clone()


def fold_copy(x: torch.Tensor, s: int, mode: str) -> torch.Tensor:
    """``x`` (R, C) f32, contiguous, folded ``(R, C) -> (R/s, s*C)`` or
    unfolded ``(R, s*C) -> (R*s, C)`` into a new tensor
    (csrc/fold_copy.cu); its plain version on a CPU tensor."""
    if x.dim() != 2:
        raise ValueError(f"fold_copy takes a (rows, width) matrix, got {tuple(x.shape)}")
    out_shape = folded_shape(tuple(x.shape), s, mode)
    if x.device.type == "cpu":
        return fold_copy_plain(x, s, mode)
    if x.device.type != "cuda":
        raise ValueError(f"fold_copy: unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("fold_copy: x must be a contiguous float32 tensor")
    out = torch.empty(out_shape, device=x.device)
    lib = _cuda.load("fold_copy")
    _cuda.launch(lib, "dse_fold_copy", "fold_copy", x, x.data_ptr(), out.data_ptr(),
                 x.shape[0], x.shape[1], s, int(mode == "unfold"))
    fold_copy.launches += 1
    return out


fold_copy.launches = 0


def probe(shape, s: int, mode: str, device="cuda") -> dict:
    """One shape: ``x = arange(R * C)`` as (R, C) through :func:`fold_copy`
    on ``device``, held to numpy's ``x.reshape``. Returns ``{"shape", "s",
    "mode", "ok", "result"}`` with result 'OK', 'MISMATCH' or 'REFUSED, as
    numpy' / 'REFUSED, numpy folds it'."""
    r, c = shape
    x = np.arange(r * c, dtype=np.float32).reshape(r, c)
    try:
        want = x.reshape((r // s, s * c) if mode == "fold" else (r * s, c // s))
    except ValueError:
        want = None
    try:
        got = fold_copy(torch.from_numpy(x).to(device), s, mode).cpu().numpy()
    except ValueError:
        got = None
    if want is None or got is None:
        ok = want is None and got is None
        result = "REFUSED, as numpy" if ok else "REFUSED, numpy folds it"
    else:
        ok = got.shape == want.shape and np.array_equal(got, want)
        result = "OK" if ok else "MISMATCH"
    return {"shape": list(shape), "s": s, "mode": mode, "ok": ok, "result": result}


def main(device="cuda") -> int:
    results = [probe(shape, s, mode, device) for shape, s, mode in SHAPES]
    for res in results:
        print(f"{res['mode']} {tuple(res['shape'])} s={res['s']}: {res['result']}")
    ok = all(res["ok"] for res in results)
    print("RESULT:", "every shape agrees with numpy" if ok else "mismatch")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
