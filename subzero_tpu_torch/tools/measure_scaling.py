"""What the decomposed step's communication costs, on the ranks it runs on
(port of ``tools/measure_scaling.py``).

One process a rank, as ``torchrun`` starts them; every rank runs this file:

    # four cards, one rank each (NCCL)
    torchrun --nproc_per_node 4 -m subzero_tpu_torch.tools.measure_scaling [N_FLOES] [N_STEPS]
    # four ranks on the CPU, or four ranks sharing one card, through gloo
    torchrun --nproc_per_node 4 -m subzero_tpu_torch.tools.measure_scaling \\
        [N_FLOES] [N_STEPS] --backend gloo [--device cpu]

The field is ``bench.build_sim(N_FLOES, L, 2e3, bins=True)`` (8 000 floes and
15 steps by default, L = 4e5 (N_FLOES / 8000)^1/2: bench.py's density).

1. **Comm isolation.**  Each row times the production step on D ranks, then
   the same step with every neighbour exchange handed back to its sender
   (``decomp.COMM_IDENTITY``: the same buffers, packing, contacts and
   coupling, but no data moves), and reports ``proxy_eff = sps_prod /
   sps_identity``.  Rows: 1-D over D x-slabs a step at a time; 1-D through
   the segment driver that ``run_decomp`` runs; 2-D over (D/2, 2) slabs.
2. **Volume.**  ``comm_bytes_per_step`` (halo, migration and the amortised
   grid sums, as capacity bounds) beside the bytes the exchanges and every
   collective of the timed steps actually sent (``Comm.stats``).
3. **Link projection.**  A rank's per-step bytes leave over the H100 SXM's
   NVLink 4: 900 GB/s bidirectional a GPU, 450 GB/s out (NVIDIA H100 Tensor
   Core GPU datasheet).  Both neighbours' buffers leave through the same
   NVSwitch links, so the whole ``comm_bytes_per_step`` total is divided by
   450 GB/s (the JAX tool halved it for a ring of separate links).  The
   compute scale ``t_slab`` is measured in the same run: the single-device
   ``run_scan`` step of ``bench.build_sim`` at N_FLOES / D floes (dense, at
   the same density) on rank 0's device.  ``projected_eff = t_slab /
   (t_slab + t_link)``.  This is a projection: several ranks on one card
   have no peer link to measure.

Context rows: the single-device ``run_scan`` of the whole field (binned), and
``run_decomp`` with fracture on at 1 rank and at D ranks.  Timings are rank
0's, handed to every rank; rank 0 prints a markdown table, and every rank
prints its figures as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import warnings

import torch
import torch.distributed as dist

# NVLink 4 of one H100 SXM: 900 GB/s bidirectional, so 450 GB/s one way
# (NVIDIA H100 Tensor Core GPU datasheet)
NVLINK_BYTES_PER_S = 450e9
DX = 2e3


def side(n_floes: int) -> float:
    """The box side that keeps bench.py's floe density."""
    return 4e5 * (n_floes / 8000.0) ** 0.5


def split_2d(D: int) -> tuple:
    """The 2-D layout of D ranks: (D/2, 2), as the JAX tool's (4, 2) of 8."""
    return (max(D // 2, 1), 2)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _release(dev):
    """Hand the cached blocks of a finished run back to the card: the ranks
    may share it, and rank 0's single-device and 1-rank runs of the whole
    field (a dense broad phase over every floe) cache tens of GiB."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _rank0(x):
    """Rank 0's value of ``x`` on every rank."""
    got = [x]
    dist.broadcast_object_list(got, src=0)
    return got[0]


def comm_row(sim, dec, n_steps: int, segment: bool) -> dict:
    """One comm-isolation row: the production step, then the identity."""
    from ..geometry import two_cross
    from ..parallel import decomp

    decomp.COMM_IDENTITY = False
    l0 = two_cross.launch_count()
    sps_prod, done, sent = decomp.time_decomp_steps(sim, dec, n_steps, segment)
    launches = two_cross.launch_count() - l0
    decomp.COMM_IDENTITY = True
    try:
        sps_ident, done_i, sent_i = decomp.time_decomp_steps(sim, dec, n_steps, segment)
    finally:
        decomp.COMM_IDENTITY = False
    vol = decomp.comm_bytes_per_step(sim, dec)
    return {
        "sps_prod": sps_prod, "sps_identity": sps_ident,
        "exchange_bytes_per_step": sent["exchange_bytes"] / done,
        "bytes_sent_per_step": sent["bytes_sent"] / done,
        "identity_exchange_bytes_per_step": sent_i["exchange_bytes"] / done_i,
        "identity_bytes_sent_per_step": sent_i["bytes_sent"] / done_i,
        "comm_bytes_per_step": vol,
        # narrow-phase kernel launches of the production run, warm-up included
        "kernel_launches": launches, "steps": done + 1,
    }


def _scan_sps(sim, n_steps: int) -> float:
    """Steps/s of ``run_scan`` after a warm run of the same length."""
    from ..simulation import run_scan

    dev = sim.model.floes.verts.device
    run_scan(sim, n_steps)
    _sync(dev)
    t0 = time.perf_counter()
    run_scan(sim, n_steps, start_tstep=n_steps)
    _sync(dev)
    return n_steps / (time.perf_counter() - t0)


def measure(n_floes=8000, n_steps=15, device=None) -> dict:
    """Every figure of the tool, on every rank of the default process group
    (``multihost.initialize`` first).  Timings are rank 0's; the bytes are
    this rank's own."""
    from .. import bench
    from ..parallel import make_decomp, make_decomp_2d, multihost, run_decomp
    from ..settings import FractureSettings, HiblerYieldCurve

    dev = multihost.rank_device(device)
    D = dist.get_world_size()
    rank = dist.get_rank()
    L = side(n_floes)
    base = bench.build_sim(n_floes, L, DX, bins=True, device=dev)

    def fresh():
        return dataclasses.replace(base)

    m = base.model
    layouts = (
        (f"1-D {D} slabs, per-step", make_decomp(m.floes, m.domain), False),
        (f"1-D {D} slabs, segment driver", make_decomp(m.floes, m.domain), True),
        (f"2-D {split_2d(D)} slabs, per-step",
         make_decomp_2d(m.floes, m.domain, n_dev=split_2d(D)), False),
    )
    rows = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # overflow notes of the identity runs
        for label, dec, seg in layouts:
            r = comm_row(fresh(), dec, n_steps, seg)
            r["sps_prod"], r["sps_identity"] = _rank0((r["sps_prod"], r["sps_identity"]))
            r["proxy_eff"] = min(r["sps_prod"] / r["sps_identity"], 1.0)
            rows.append({"configuration": label, **r})

    # single-device context on rank 0 while the others wait: the whole field
    # (binned, run_scan) and one slab's share of it (t_slab)
    n_slab = max(n_floes // D, 1)
    single = {}
    if rank == 0:
        single["scan_sps"] = _scan_sps(fresh(), n_steps)
        slab = bench.build_sim(n_slab, side(n_slab), DX, device=dev)
        single["t_slab_s"] = 1.0 / _scan_sps(slab, n_steps)
        del slab
        _release(dev)
    single = _rank0(single)
    for r in rows:
        t_link = r["comm_bytes_per_step"]["total"] / NVLINK_BYTES_PER_S
        r["t_link_s"] = t_link
        r["projected_eff"] = single["t_slab_s"] / (single["t_slab_s"] + t_link)

    # run_decomp with fracture on: 1 rank (rank 0 through a one-rank group),
    # then every rank
    one = dist.new_group([0])
    fracture = FractureSettings(fractures_on=True, criteria=HiblerYieldCurve(),
                                dt=max(n_steps // 2, 1), deform_on=False)
    runs = {}
    for nd, group in ((1, one), (D, None)):
        if nd == 1 and rank != 0:
            continue
        sim = dataclasses.replace(base, fracture_settings=fracture, n_dt=n_steps)
        dec = make_decomp(sim.model.floes, sim.model.domain, n_devices=nd, group=group)
        _sync(dev)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sim = run_decomp(sim, dec)
        _sync(dev)
        runs[str(nd)] = {"seconds": time.perf_counter() - t0, "steps": sim.run_stats["steps"],
                         "kernel_launches": sim.run_stats["kernel_launches"]}
        del sim, dec
        _release(dev)
    runs = _rank0(runs)
    return {
        "ranks": D, "backend": dist.get_backend(), "device": str(dev),
        "n_floes": int(base.model.floes.count()), "n_steps": n_steps, "L": L,
        "rows": rows, "single_device_scan_sps": single["scan_sps"],
        "t_slab_s": single["t_slab_s"], "t_slab_floes": n_slab,
        "nvlink_bytes_per_s": NVLINK_BYTES_PER_S,
        "run_decomp_fracture": runs,
    }


def table(res: dict) -> str:
    """The JAX tool's markdown table, with the link projection on NVLink."""
    lines = ["| configuration | prod sps | identity sps | proxy eff | comm MB/step "
             "(bound) | exchanged MB/step | NVLink time | projected eff |",
             "|---|---|---|---|---|---|---|---|"]
    for r in res["rows"]:
        lines.append(
            f"| {r['configuration']} | {r['sps_prod']:.3f} | {r['sps_identity']:.3f} | "
            f"{r['proxy_eff']:.3f} | {r['comm_bytes_per_step']['total'] / 1e6:.3f} | "
            f"{r['exchange_bytes_per_step'] / 1e6:.3f} | {r['t_link_s'] * 1e6:.1f} us | "
            f"**{r['projected_eff']:.3f}** |")
    return "\n".join(lines)


def main(argv=None) -> dict:
    from ..parallel import multihost

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_floes", nargs="?", type=int, default=8000)
    ap.add_argument("n_steps", nargs="?", type=int, default=15)
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: this rank's card)")
    a = ap.parse_args(argv)
    multihost.initialize(backend=a.backend)
    try:
        res = measure(a.n_floes, a.n_steps, a.device)
        if dist.get_rank() == 0:
            print(f"ranks: {res['ranks']} ({res['backend']}) on {res['device']}  "
                  f"n_floes: {res['n_floes']}  n_steps: {res['n_steps']}", flush=True)
            print(f"single-device run_scan (binned): {res['single_device_scan_sps']:.3f} sps; "
                  f"t_slab ({res['t_slab_floes']} floes, dense) "
                  f"{res['t_slab_s'] * 1e3:.3f} ms", flush=True)
            for nd, r in res["run_decomp_fracture"].items():
                print(f"run_decomp fracture-on {nd} rank(s): {r['seconds']:.1f} s wall",
                      flush=True)
            print(table(res), flush=True)
        print(json.dumps({"rank": dist.get_rank(), **res}), flush=True)
    finally:
        dist.destroy_process_group()
    return res


if __name__ == "__main__":
    main()
