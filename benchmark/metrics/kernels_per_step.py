"""Device kernels a step over the profiled stretch (torch.profiler's trace;
memsets and copies not counted)."""


def read(run):
    p = run.profile
    if p is None or p["kernels"] == 0:
        return None
    return p["kernels"] / run.profiled_steps
