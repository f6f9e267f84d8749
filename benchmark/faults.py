"""The faults a cell can have, planted in an answer of the timed path: each
maps (the state before a call, the state after it) to a broken state after
it.  ``tests/test_bench_faults.py`` plants them in the program and sees
``correct`` come out false; ``calibrate`` reads them on the chip against the
reference's answers, beside the control."""

from __future__ import annotations

import torch


def unchanged(before, after):
    """The call returns its state unchanged."""
    return after.replace(floes=before.floes, ocean=before.ocean)


def half_left_out(before, after):
    """The second half of the live floes keep their state: half the batch
    not stepped."""
    live = torch.nonzero(before.floes.active & after.floes.active)[:, 0]
    kept = live[len(live) // 2:]

    def mix(a, b):
        a = a.clone()
        a[kept] = b[kept]
        return a

    return after.replace(floes=type(after.floes)(*(mix(a, b) for a, b in
                                                   zip(after.floes, before.floes))))


def answer_altered(before, after):
    """Every live floe's velocity off by a thousandth where it is made."""
    f = after.floes
    return after.replace(floes=f._replace(u=torch.where(f.active, f.u * 1.001, f.u)))


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}
