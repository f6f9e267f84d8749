"""The benchmark's driver: a cell's set-up and its measured window.

A simulation has no arrivals, so a cell is a closed loop in passes.  The
window steps the field back to back through the program's public entry
(``simulation.run_scan`` or ``simulation.run``) in calls of
``call_steps`` steps, each call going on from the last one's ``tstep`` (and,
for ``run``, from its ``run_stats["rng_state"]``, as ``restore_simulation``
resumes a run).  At the window's start, and whenever a pass of the
configuration's ``n_dt`` steps ends, the initial state comes back and the
pass runs again from step 0, so every pass does the same work.

Everything particular to a configuration, a cell or a metric is a file that
is found by its name: ``configs/<config>.json``, ``cells/<cell>.json``,
``metrics/<metric>.py`` and ``roofline/<kernel>.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.profiler

from . import build
from .inputs import seeds


def port_package() -> build.Package:
    import subzero_tpu_torch.constants as constants
    import subzero_tpu_torch.core as core
    import subzero_tpu_torch.settings as settings
    import subzero_tpu_torch.simulation as simulation

    return build.Package(core, settings, constants, simulation)


def reference_package() -> build.Package:
    from .reference import constants, core, settings, simulation

    return build.Package(core, settings, constants, simulation)


def port_modulus(floes) -> float:
    from subzero_tpu_torch.examples.common import modulus_from_floes

    return modulus_from_floes(floes)


def reference_modulus(floes) -> float:
    area = floes.area[floes.active]
    if area.dtype == torch.bfloat16:   # numpy has no bfloat16 (the control)
        area = area.float()
    return build.modulus(area.cpu().numpy())


@dataclasses.dataclass
class Cell:
    name: str
    spec: dict       # cells/<name>.json
    cfg: dict        # configs/<spec["config"]>.json

    @property
    def entry(self) -> str:
        return self.spec["entry"]

    @property
    def call_steps(self) -> int:
        return self.spec["call_steps"]

    @property
    def calls_per_pass(self) -> int:
        return self.cfg["n_dt"] // self.call_steps


def load_cell(name: str) -> Cell:
    spec = build.load_json("cells", name)
    return Cell(name, spec, build.load_json("configs", spec["config"]))


@dataclasses.dataclass
class CallRecord:
    pass_no: int
    call_no: int       # within its pass
    seconds: float     # from the last call's return (or the window's start)
    steps: int
    overflow_steps: int
    host_pass_seconds: dict
    host_pass_count: dict
    graph_stats: Optional[dict]


class Driver:
    """Calls the program's entry on ``sim`` in ``cell.call_steps``-step
    calls from the state ``initial`` (which it never writes: the program
    copies what it is handed)."""

    def __init__(self, sim, cell: Cell, simulation_module):
        if cell.entry not in ("run_scan", "run"):
            raise ValueError(f"unknown entry {cell.entry!r}")
        if cell.cfg["n_dt"] % cell.call_steps:
            raise ValueError("a pass must be a whole number of calls")
        self.sim, self.cell, self.sm = sim, cell, simulation_module
        self.initial = sim.model
        if cell.entry == "run":
            sim.n_dt = cell.call_steps - 1   # run steps start_tstep..+n_dt

    def restore(self) -> None:
        self.sim.model = self.initial
        self.sim.rng_state = None          # the run's generator from sim.seed

    def call(self, call_no: int) -> CallRecord:
        sim, t = self.sim, call_no * self.cell.call_steps
        with torch.profiler.record_function("bench.call"):
            if self.cell.entry == "run_scan":
                self.sm.run_scan(sim, self.cell.call_steps, start_tstep=t)
            else:
                self.sm.run(sim, start_tstep=t)
        hs, hc = {}, {}
        if self.cell.entry == "run":
            sim.rng_state = sim.run_stats["rng_state"]
            hs = dict(sim.run_stats["host_pass_seconds"])
            hc = dict(sim.run_stats["host_pass_count"])
        return CallRecord(0, call_no, 0.0, self.cell.call_steps, sim.n_overflow,
                          hs, hc, sim.run_stats.get("graph"))


@dataclasses.dataclass
class Snapshot:
    """One compared call: the program's state before and after it, and its
    generator state before and after (``run``)."""
    call_no: int
    before: object
    rng_before: Optional[dict]
    after: object = None
    rng_after: Optional[dict] = None
    max_floe_id: Optional[int] = None


def sample_calls(cell: Cell, seed: int) -> list:
    """The calls of the first pass whose answers are compared: the cell's
    ``check.calls`` drawn from the seed, and the calls that hold each step
    of ``check.at_steps`` (the host passes the cell runs)."""
    ck = cell.spec["check"]
    rng = seeds(seed)["sample"]
    n = cell.calls_per_pass
    drawn = rng.choice(n, size=min(ck["calls"], n), replace=False).tolist()
    fixed = [s // cell.call_steps for s in ck.get("at_steps", [])]
    return sorted(set(int(c) for c in drawn + fixed))


class Hooks:
    """What the window does besides stepping, by (pass, call): keep the
    compared calls' states, and in a traced run the profiled and the
    sync-counted stretches.  ``done()``: whether the window may close."""

    def __init__(self, driver: Driver, samples: list, stretches=()):
        self.driver = driver
        self.samples = {c: None for c in samples}
        self.stretches = list(stretches)

    def before(self, p: int, k: int) -> None:
        if p == 0 and k in self.samples:
            sim = self.driver.sim
            self.samples[k] = Snapshot(k, sim.model, sim.rng_state)
        for s in self.stretches:
            s.before(p, k)

    def after(self, p: int, k: int) -> None:
        if p == 0 and k in self.samples:
            sim, snap = self.driver.sim, self.samples[k]
            snap.after = sim.model
            if self.driver.cell.entry == "run":
                snap.rng_after = sim.run_stats["rng_state"]
                snap.max_floe_id = sim.run_stats["max_floe_id"]
        for s in self.stretches:
            s.after(p, k)

    def done(self) -> bool:
        return all(s.done for s in self.stretches)

    def snapshots(self) -> list:
        return [s for s in self.samples.values() if s is not None and s.after is not None]


@dataclasses.dataclass
class Window:
    records: list
    seconds: float
    steps: int
    sim_seconds: float


def run_window(driver: Driver, seconds: float, hooks: Hooks,
               sync: Callable[[], None]) -> Window:
    """Step passes back to back for ``seconds`` (and on until ``hooks`` are
    done); each call's record holds the time from the last return."""
    cell = driver.cell
    records, steps = [], 0
    driver.restore()
    t0 = last = time.perf_counter()
    p = k = 0
    while True:
        if k == cell.calls_per_pass:
            driver.restore()
            p, k = p + 1, 0
        hooks.before(p, k)
        rec = driver.call(k)
        now = time.perf_counter()
        rec.pass_no, rec.seconds = p, now - last
        records.append(rec)
        last = now
        steps += rec.steps
        hooks.after(p, k)
        k += 1
        if now - t0 >= seconds and hooks.done():
            break
    sync()
    end = time.perf_counter()
    records[-1].seconds += end - last
    return Window(records, end - t0, steps, steps * float(cell.cfg["dt"]))


def warm_up(driver: Driver) -> None:
    """One call from the initial state at each of the cell's
    ``warmup_steps``: every program the window replays is captured and
    every host pass it runs has run once (libraries loaded)."""
    for step in driver.cell.spec["warmup_steps"]:
        driver.restore()
        driver.call(step // driver.cell.call_steps)
    driver.restore()


def free() -> None:
    """Return what the program's dropped state held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def build_program(cell: Cell, inp, device):
    return build.build_sim(port_package(), cell.cfg, inp, device, port_modulus)


def build_reference(cell: Cell, inp, device, dtype=None):
    cfg = cell.cfg if dtype is None else dict(cell.cfg, dtype=dtype)
    return build.build_sim(reference_package(), cfg, inp, device, reference_modulus)


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, float), q))
