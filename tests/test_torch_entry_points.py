"""The entry points that came with the host life cycle stand on their own
like the rest of the port (tests/test_torch_independence.py): the new
constructors want the card unless the caller names the CPU, the logger is the
port's own (``subzero_tpu_torch.<name>``), and the native clip library builds
from the port's own source into the port's own ``_build/``."""

import pytest
import torch

from subzero_tpu_torch import core
from subzero_tpu_torch.geometry import polygon

from test_torch_independence import SQUARE, _tensors
from torch_port_helpers import REPO

NEW_CONSTRUCTORS = {
    "make_topography": lambda **kw: core.make_topography(
        [SQUARE], dtype=torch.float64, **kw),
    "topography_from_polys": lambda **kw: core.topography_from_polys(
        [SQUARE], dtype=torch.float64, **kw),
    "pad_polygon": lambda **kw: polygon.pad_polygon(
        SQUARE, 8, dtype=torch.float64, **kw),
}


@pytest.mark.parametrize("name", list(NEW_CONSTRUCTORS))
def test_new_constructor_without_device_wants_the_card(name):
    if torch.cuda.is_available():
        ts = list(_tensors(NEW_CONSTRUCTORS[name]()))
        assert ts and all(t.is_cuda for t in ts)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NEW_CONSTRUCTORS[name]()
    ts = list(_tensors(NEW_CONSTRUCTORS[name](device="cpu")))
    assert ts and all(t.device.type == "cpu" for t in ts)


def test_logger_and_native_library_are_the_ports_own(tmp_path):
    from subzero_tpu_torch import native
    from subzero_tpu_torch.io.logger import SimulationLogger

    log = SimulationLogger("indep", dir=str(tmp_path))
    assert log.logger.name == "subzero_tpu_torch.indep"
    log.warn("twice", 3)
    log.warn("twice", 3)  # rate-limited to one a time step
    log.close()
    assert (tmp_path / "indep.log").read_text().count("twice") == 1
    assert native.SOURCE.parent == REPO / "subzero_tpu_torch" / "native"
    assert native.LIB_PATH.parent == REPO / "subzero_tpu_torch" / "_build"
