#!/usr/bin/env python
"""Training entry point of the PyTorch and CUDA port, with the reference's
flag names (eonerf_code_tpu_torch/cli.py). Runs on the card.

    python train_eonerf_torch.py --root_dir ... --img_dir ... --exp_name ... \
        --compute_dtype bfloat16 --max_train_steps 300000
"""

from eonerf_code_tpu_torch.cli import main_train

if __name__ == "__main__":
    main_train()
