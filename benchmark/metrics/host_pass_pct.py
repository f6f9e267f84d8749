"""The host life cycle's share of the window's wall time: the seconds of
every host pass (``run_stats["host_pass_seconds"]``) over the calls' wall
time, the calls of the traced stretches left out, %."""


def read(run):
    calls = run.plain_calls()
    if run.cell.entry != "run" or not calls:
        return None
    host = sum(sum(r.host_pass_seconds.values()) for r in calls)
    return 100.0 * host / sum(r.seconds for r in calls)
