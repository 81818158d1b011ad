#!/usr/bin/env python
"""Evaluation entry point of the PyTorch and CUDA port
(eonerf_code_tpu_torch/cli.py). Runs on the card.

    python eval_eonerf_torch.py <run_id> --logs_dir logs --output_dir out --dsm --gt_dir ...
"""

from eonerf_code_tpu_torch.cli import eval_cli

if __name__ == "__main__":
    eval_cli()
