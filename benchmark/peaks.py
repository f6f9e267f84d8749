"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
dense rates, at the full 700 W power limit; the run prints the card's own
limit beside every share of them).

``f32_ops_per_s`` is the rate of single float32 adds and multiplies outside
the tensor cores: the data sheet's 67 TFLOP/s counts a fused multiply-add as
two operations, and the port's kernels are built without FMA contraction
(``--fmad=false``), so each of their operations is one instruction, at half
that rate."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_ops_per_s": 67e12 / 2},
}


def of(device_name: str):
    """The card's peaks, or None for a card the table does not hold."""
    return PEAKS.get(device_name)
