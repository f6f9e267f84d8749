"""The benchmark of subzero_tpu_torch: see README.md."""
