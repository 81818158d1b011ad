"""The port's kernel-variant bench: ``python -m
eonerf_code_tpu_torch.bench.kernel_variants`` and ``python -m
eonerf_code_tpu_torch.bench.composite`` (ops in ``variants``)."""
