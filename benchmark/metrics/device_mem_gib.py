"""The card's peak reserved memory over set-up and window
(``torch.cuda.max_memory_reserved``, the graphs' pools included), GiB."""


def read(run):
    return run.memory_peak_bytes / 2**30
