"""The mean wall time of one fracture pass (``run_stats``' fracture seconds
over its fracture passes), the calls of the traced stretches left out, ms."""


def read(run):
    calls = run.plain_calls()
    n = sum(r.host_pass_count.get("fracture", 0) for r in calls)
    if n == 0:
        return None
    return 1e3 * sum(r.host_pass_seconds.get("fracture", 0.0) for r in calls) / n
