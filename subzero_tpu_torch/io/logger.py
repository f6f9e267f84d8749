"""Simulation logger.

Own copy of ``subzero_tpu/io/logger.py`` (the Julia model's ``SubzeroLogger``,
logger.jl):
writes to ``./log/<simname>.log`` and rate-limits each unique message to
``messages_per_tstep`` occurrences per timestep.
"""

from __future__ import annotations

import logging
import os


class SimulationLogger:
    def __init__(self, name: str = "sim", messages_per_tstep: int = 1, dir="log"):
        os.makedirs(dir, exist_ok=True)
        self.path = os.path.join(dir, f"{name}.log")
        self.messages_per_tstep = messages_per_tstep
        self._counts: dict = {}
        self._tstep = -1
        self.logger = logging.getLogger(f"subzero_tpu_torch.{name}")
        self.logger.setLevel(logging.INFO)
        self.logger.handlers.clear()
        handler = logging.FileHandler(self.path)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s")
        )
        self.logger.addHandler(handler)
        self.logger.propagate = False

    def log(self, message: str, tstep: int | None = None, level=logging.INFO):
        if tstep is not None and tstep != self._tstep:
            self._tstep = tstep
            self._counts = {}
        key = message
        n = self._counts.get(key, 0)
        if n >= self.messages_per_tstep:
            return
        self._counts[key] = n + 1
        suffix = f" [tstep {tstep}]" if tstep is not None else ""
        self.logger.log(level, message + suffix)

    def warn(self, message: str, tstep: int | None = None):
        self.log(message, tstep, logging.WARNING)

    def close(self):
        for h in self.logger.handlers:
            h.flush()
            h.close()
        self.logger.handlers.clear()
