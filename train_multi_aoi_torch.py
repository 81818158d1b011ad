#!/usr/bin/env python
"""Multi-AOI scene-parallel training entry point of the PyTorch and CUDA
port (eonerf_code_tpu_torch/train/multi.py): S independent AOI scenes, one
model each, trained together over a ("scene", "data") grid of processes,
one a card. Each scene lands in its own run directory that
eval_eonerf_torch.py evaluates. Runs on the card, or on the CPU with
``--device cpu``.

    python train_multi_aoi_torch.py --root_dirs A,B --img_dirs iA,iB \\
        --logs_dir logs --exp_name pod0 --scene_axis 2 --data_axis 4 \\
        --compute_dtype bfloat16 [--save_freq 1000] [--resume]
"""

from eonerf_code_tpu_torch.cli import device_flag
from eonerf_code_tpu_torch.train.multi import main_multi_train

if __name__ == "__main__":
    device, argv = device_flag()
    main_multi_train(argv, device=device)
