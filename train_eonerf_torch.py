#!/usr/bin/env python
"""Training entry point of the PyTorch and CUDA port, with the reference's
flag names (eonerf_code_tpu_torch/cli.py). Runs on the card, or on the
CPU with ``--device cpu``; ``--data_axis N`` trains data parallel over N
processes, one a card (or N CPU processes), or joins the group under
``torchrun --nproc_per_node N``.

    python train_eonerf_torch.py --root_dir ... --img_dir ... --exp_name ... \
        --compute_dtype bfloat16 --max_train_steps 300000 [--data_axis 8]
"""

from eonerf_code_tpu_torch.cli import device_flag, main_train

if __name__ == "__main__":
    device, argv = device_flag()
    main_train(argv, device=device)
