"""One module per metric, named as the metric is in ``BENCHMARK.json``.
Each gives ``read(run)``: the metric's value from a finished run
(``benchmark.run.Run``), or None where the run holds nothing to read it
from; the harness then leaves the metric out of its line."""
