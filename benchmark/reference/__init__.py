"""The benchmark's plain reference: a frozen copy of ``subzero_tpu_torch``'s
plain PyTorch path at commit c748c81 (the port's own eager step, the host
life cycle and the floe-field set-up), which the benchmark's correctness
check runs beside the program.  It imports nothing of the program, so a
later change to the program leaves it as it is.

What differs from the program, and why:

  * the narrow phase (B1) and the slow clip (B2) are their plain versions,
    ``geometry.clip.two_cross_pairs`` and ``geometry.regions.
    slow_regions_plain``, on every device: no hand-written kernel;
  * the host's polygon booleans and pairwise overlap areas are pure
    Python and numpy (``geometry.host_clip``), where the program runs its
    native C++ build of the same algorithm; the ladder of retries is the
    program's, in its order;
  * every step runs eagerly (``simulation``): no CUDA graph, no run
    segments, no callback, writer or logger;
  * ``simulation.ALLOW_TF32`` (False) sets the matmul precision, which the
    TF32 control turns on, and ``simulation.STORE_DTYPE`` (None) rounds
    the state where a step or a host pass stores it, which the bfloat16
    control sets (``benchmark.calibrate``).

Where the reference's own arithmetic comes from: the port's plain path at
c748c81 is what the repo's CPU tests hold to the JAX package, the system's
first implementation, in float64 (``tests/test_torch_*.py``); this copy is
held to the port's CPU path at that commit by ``benchmark/tests/
test_bench_reference.py``.
"""
