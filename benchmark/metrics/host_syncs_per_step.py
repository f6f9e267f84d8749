"""Host synchronisations a step over the sync-counted stretch
(``torch.cuda.set_sync_debug_mode("warn")``, by source line)."""


def read(run):
    s = run.syncs
    if s is None or s["steps"] == 0:
        return None
    return sum(s["by_line"].values()) / s["steps"]
