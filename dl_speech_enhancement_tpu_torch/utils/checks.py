"""Checks of the port's outputs against a reference.

Check-only: chip_smoke.py and the tests hold kernels to their plain versions
with these; no path of the port calls them.
"""

from __future__ import annotations

import math

import torch


def rvq_near_ties(z, books, sqnorm, codes, ref, rtol: float = 1e-5) -> dict:
    """Hold wire codes (R, L) against reference codes ``ref`` for the same
    ``z`` (R, D), allowing near ties. ``books`` (L, D, K) and ``sqnorm`` (L,
    K) are the tables of ops/mega_kernel.py::rvq_assign.

    Two searches that sum ``r.E`` in other orders may pick different
    codewords where distances differ by about an f32 ulp. Walking the stages
    along ``ref``'s residuals, a row whose code differs at stage l is a near
    tie when its pick's distance exceeds ``ref``'s pick's by at most ``rtol *
    max(1, |min distance|)``; its later stages are not compared (they follow
    another residual). Returns ``{"ties": rows, "mismatches": rows,
    "max_excess": largest such excess among the ties}``."""
    n_books, _, book_k = books.shape
    r, ref = z, ref.long()
    codes = codes.long().to(z.device)
    done = torch.zeros(z.shape[0], dtype=torch.bool, device=z.device)
    ties, bad, excess = 0, 0, 0.0
    for l in range(n_books):
        dist = (r * r).sum(1, keepdim=True) - 2.0 * (r @ books[l]) + sqnorm[l]
        want, pick = ref[:, l] - l * book_k, codes[:, l] - l * book_k
        differ = ~done & (pick != want)
        if bool(differ.any()):
            in_range = (pick >= 0) & (pick < book_k)
            d_pick = dist.gather(1, pick.clamp(0, book_k - 1)[:, None])[:, 0]
            d_want = dist.gather(1, want[:, None])[:, 0]
            tol = rtol * dist.min(1).values.abs().clamp(min=1.0)
            tie = differ & in_range & (d_pick - d_want <= tol)
            ties += int(tie.sum())
            bad += int((differ & ~tie).sum())
            if bool(tie.any()):
                excess = max(excess, float((d_pick - d_want)[tie].abs().max()))
            done |= differ
        r = r - books[l].t()[want]
    return {"ties": ties, "mismatches": bad, "max_excess": excess}


def moved_near_ties(z_ref, z, books, codes, ref, rtol: float = 1e-5) -> dict:
    """Hold wire codes (R, L) of a search on ``z`` against ``ref``, the
    codes of the same search on ``z_ref`` (R, D), where z moved from z_ref
    (bf16 activations between launches, say). A row whose code differs
    first at stage l is allowed where the two picks' distances for ``ref``'s
    residual differ by at most ``2 |dz| |E_codes - E_ref|`` plus ``rtol *
    max(1, |min distance|)``: up to stage l both searches subtracted the same
    codewords, so their residuals differ by dz = z - z_ref, and a change dz
    moves one codeword's distance past another's by at most that. Returns
    ``{"moved": rows that differ, "beyond": rows beyond the bound}``."""
    n_books, _, book_k = books.shape
    r, books = z_ref.double(), books.double()
    dz = (z.double() - r).norm(dim=1)
    done = torch.zeros(r.shape[0], dtype=torch.bool, device=r.device)
    moved = beyond = 0
    for l in range(n_books):
        e = books[l]
        dist = (r * r).sum(1, keepdim=True) - 2 * r @ e + (e * e).sum(0)
        k_ref, k = ref[:, l].long() - l * book_k, codes[:, l].long() - l * book_k
        rows = torch.nonzero(~done & (k_ref != k))[:, 0]
        if rows.numel():
            gap = dist[rows, k[rows]] - dist[rows, k_ref[rows]]
            allowed = (2 * dz[rows] * (e[:, k[rows]] - e[:, k_ref[rows]]).norm(dim=0)
                       + rtol * dist[rows].min(1).values.abs().clamp(min=1.0))
            moved += rows.numel()
            beyond += int((gap > allowed).sum())
            done[rows] = True
        r = r - e.t()[k_ref]
    return {"moved": moved, "beyond": beyond}


# With bf16 weights residual_chain, hifigan_unit and a vocoder upsample that
# rounds its product or output round an f32 sum to bf16 before the next
# product, as the JAX kernels do. Two evaluations that take such a sum in
# different orders (a kernel and its plain version, or the plain version on
# two devices) round it one bf16 step apart wherever it lies near a rounding
# midpoint, and the step spreads through the later products and roundings:
# on dense weights no bound on the largest error both holds every such pair
# and fails a kernel that does not round at all (both are ~1e-3 of the
# largest output). Those kernels are therefore held two ways:
# - on exact_sum_weights every sum is exact in any order, so the kernel must
#   meet its plain version at the tolerance of a kernel without such
#   roundings, while the plain version on unrounded operands (the same call
#   on the weights cast to f32) lies at least ROUNDING_GAP times that away;
# - on dense weights (rounding_held): within FLIP_RTOL of the largest
#   output, and at most FLIP_RMS_SHARE as far from the plain version as from
#   the unrounded one, in RMS (a step's spread touches a share of the
#   elements; an unrounded operand moves every one, so a kernel that does
#   not round lies much nearer the unrounded version). The share reached
#   0.31 on an H100 (chip_smoke.py's bf16-boundary chain calls) and 0.52 in
#   tests/test_torch_port_chain_plan.py's emulation of the chain at C = 256
#   (numpy's exp there, not the plain version's).
FLIP_RTOL = 2.0 ** -8
FLIP_RMS_SHARE = 0.75
ROUNDING_GAP = 10.0


def exact_sum_weights(w: torch.Tensor, seed: int = 0, tap_sets=None) -> torch.Tensor:
    """Weights of ``w``'s shape, dtype and device, (..., taps, in, out),
    under which every product sum of a kernel and its plain version is
    exact whatever its order: each output column of each leading index reads
    one (tap, input channel) term from each set of ``tap_sets`` (all taps
    by default; an upsample's phases each read their own pair of taps), a
    value of 7 fraction bits in +-[1, 2), exact in bf16; every other
    weight is 0. A bf16 operand times such a weight is exact in f32, and a
    sum of it with zeros is that product, so the rounded operands after it
    are the same bits on every side."""
    *lead, taps, cin, cout = w.shape
    g = torch.Generator().manual_seed(seed)
    flat = torch.zeros(math.prod(lead), taps, cin, cout)
    cols = torch.arange(cout)
    for taps_of in (tap_sets or [range(taps)]):
        taps_of = torch.as_tensor(list(taps_of))
        for block in flat:
            tap = taps_of[torch.randint(len(taps_of), (cout,), generator=g)]
            ch = torch.randint(cin, (cout,), generator=g)
            value = (128 + torch.randint(128, (cout,), generator=g)) / 128.0
            block[tap, ch, cols] = value * (2 * torch.randint(2, (cout,), generator=g) - 1)
    return flat.reshape(w.shape).to(dtype=w.dtype, device=w.device)


def rounding_held(got: torch.Tensor, ref: torch.Tensor, unrounded: torch.Tensor,
                  bound=None) -> dict:
    """A bf16-weight kernel's output ``got`` that rounds intermediate sums,
    against its plain version ``ref`` and the plain version on unrounded
    operands ``unrounded``, on dense weights: ``{"held": bool, "max_err",
    "scale", "rms_share"}``. Held where every |got - ref| is within
    ``bound`` (FLIP_RTOL of the largest |ref| by default; a tensor bounds
    element by element) and rms(got - ref) is at most FLIP_RMS_SHARE of
    rms(got - unrounded)."""
    got, ref, unrounded = got.float(), ref.float(), unrounded.float()
    diff = (got - ref).abs()
    scale = float(ref.abs().max())
    bound = FLIP_RTOL * scale if bound is None else bound
    within = bool((diff <= bound).all())
    away = float((got - unrounded).pow(2).mean().sqrt())
    share = float(diff.pow(2).mean().sqrt()) / away if away > 0 else math.inf
    return {"held": within and share <= FLIP_RMS_SHARE, "max_err": float(diff.max()),
            "scale": scale, "rms_share": share}
