"""The slow clip's plain version (``subzero_tpu_torch/geometry/regions.py``'s
``slow_regions_plain``, copied): every slow row through
``clip.intersect_regions``, then the retry of the first odd rows."""

from __future__ import annotations

import torch

from .clip import ClipRegions, first_true, intersect_regions

# the retry's perturbation, as a multiple of the first pass's
RETRY_SCALE = -41.0


def slow_regions_plain(p_verts, p_n, q_verts, q_n, qi, qj, shift, perturb,
                       ssel, n_slow, cap: int, retry_rows: int):
    """Plain PyTorch version of ``regions_cuda``, with its signature: every
    row of ``ssel`` through ``clip.intersect_regions``, the rows past
    n_slow zeroed, then the retry of the first ``retry_rows`` odd rows and
    its merge where it resolves.  Returns (ClipRegions, parity_bad)."""
    R, PC = ssel.shape[0], qi.shape[0]
    dev = p_verts.device
    live = (torch.arange(R, device=dev) < n_slow) & (ssel < PC)
    ssafe = torch.clamp(ssel, min=0, max=PC - 1)
    i, j, sh = qi[ssafe], qj[ssafe], shift[ssafe]

    def clip_rows(rows, pscale):
        return intersect_regions(
            p_verts[i[rows]], p_n[i[rows]], q_verts[j[rows]] + sh[rows][:, None, :],
            q_n[j[rows]], CAP=cap, perturb=perturb[ssafe[rows]] * pscale,
        )

    def on_live(x):
        keep = live.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=dev))

    regs = ClipRegions(*(on_live(x) for x in clip_rows(slice(None), 1.0)))
    bad = live & regs.overflow
    if retry_rows > 0:
        bsel = first_true(bad, retry_rows, R)
        bsafe = torch.clamp(bsel, max=R - 1)
        regs2 = clip_rows(bsafe, RETRY_SCALE)
        idx = torch.where((bsel < R) & ~regs2.overflow, bsafe, R)

        def put(a, b):
            ext = torch.cat([a, a[:1]], dim=0)  # row R: dropped
            ext[idx] = b
            return ext[:R]

        regs = ClipRegions(*(put(a, b) for a, b in zip(regs, regs2)))
    return regs, bad

