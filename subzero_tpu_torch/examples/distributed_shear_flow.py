"""shear_flow over a domain decomposition: the distributed entry point.

One process per rank, as ``torchrun`` starts them; every rank runs this file
and rank 0 writes the output:

    # four cards, one rank each (NCCL)
    torchrun --nproc_per_node 4 -m subzero_tpu_torch.examples.distributed_shear_flow
    # the CPU, four ranks (gloo)
    torchrun --nproc_per_node 4 -m subzero_tpu_torch.examples.distributed_shear_flow \\
        --backend gloo --device cpu

Several ranks on one card must use ``--backend gloo``: NCCL refuses two ranks
of one communicator on the same GPU, so under gloo each rank computes on the
card and its messages go through host memory.

The physics configuration is examples/shear_flow.py's (the port's
``examples.shear_flow.build``); the example swaps ``run`` for ``run_decomp``
over 1-D x-slabs, one a rank (the halo margin must stay under the slab
width: ``make_decomp`` raises otherwise, so 4 slabs at 500 floes).
"""

import argparse
import time

import torch

from ..parallel import make_decomp, multihost, run_decomp
from .shear_flow import build


def main(n_dt=500, n_floes=500, backend=None, device=None,
         out_dir="output/distributed_shear_flow", dtype=torch.float32):
    multihost.initialize(backend=backend)
    dev = multihost.rank_device(device)
    # every rank holds the writers (they open no file until they write);
    # only rank 0 writes
    sim = build(dtype=dtype, n_dt=n_dt, out_dir=out_dir, n_floes=n_floes, device=dev)
    dec = make_decomp(sim.model.floes, sim.model.domain)
    if multihost.is_io_process():
        print(f"{dec.comm.size} rank(s) ({dec.comm.backend}) on {dev}, {dec.n_dev} "
              f"slabs (local_cap {dec.local_cap}, halo {dec.halo_cap})")
    t0 = time.time()
    sim = run_decomp(sim, dec)
    if multihost.is_io_process():
        print(f"ran {n_dt} steps in {time.time() - t0:.2f}s; "
              f"{int(sim.model.floes.count())} floes")
    return sim


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default=None, help="nccl (default) or gloo")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: this rank's card)")
    ap.add_argument("--n-dt", type=int, default=500)
    ap.add_argument("--n-floes", type=int, default=500)
    ap.add_argument("--out-dir", default="output/distributed_shear_flow")
    opts = ap.parse_args()
    main(n_dt=opts.n_dt, n_floes=opts.n_floes, backend=opts.backend,
         device=opts.device, out_dir=opts.out_dir)
    torch.distributed.destroy_process_group()
