#!/usr/bin/env python
"""Evaluation entry point of the PyTorch and CUDA port
(eonerf_code_tpu_torch/cli.py). Runs on the card, or on the CPU with
``--device cpu``; ``--data_axis N`` renders over N processes (one a card),
the outputs written by rank 0.

    python eval_eonerf_torch.py <run_id> --logs_dir logs --output_dir out --dsm --gt_dir ...
"""

from eonerf_code_tpu_torch.cli import device_flag, eval_cli

if __name__ == "__main__":
    device, argv = device_flag()
    eval_cli(argv, device=device)
