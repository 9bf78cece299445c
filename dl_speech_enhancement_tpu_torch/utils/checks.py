"""Checks of the port's outputs against a reference.

Check-only: chip_smoke.py and the tests hold kernels to their plain versions
with these; no path of the port calls them.
"""

from __future__ import annotations

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
