"""The share of the profiled stretch's wall time in which no device
activity ran (torch.profiler's trace), %."""


def read(run):
    p = run.profile
    if p is None or p["window_s"] <= 0 or p["device_events"] == 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
