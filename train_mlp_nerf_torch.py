#!/usr/bin/env python
"""Vanilla-NeRF training entry point of the PyTorch and CUDA port on a
nerf_synthetic scene (eonerf_code_tpu_torch/train/train_vanilla.py): the
flags and defaults of train_mlp_nerf.py, plus ``--device`` (the card by
default, ``--device cpu`` for the host). Trains, then prints the test
split's PSNR, the mean of each view's.

    python train_mlp_nerf_torch.py --data_root data/nerf_synthetic --scene lego \\
        [--max_steps 50000] [--n_test_images 8] [--device cpu]
"""

import argparse

from eonerf_code_tpu_torch.cli import device_flag
from eonerf_code_tpu_torch.train.train_vanilla import eval_psnr, train_vanilla


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_root", type=str, default="data/nerf_synthetic",
                        help="the root dir of the dataset")
    parser.add_argument("--train_split", type=str, default="trainval",
                        choices=["train", "trainval"], help="which train split to use")
    parser.add_argument("--scene", type=str, default="lego", help="which scene to use")
    parser.add_argument("--test_chunk_size", type=int, default=1024)
    parser.add_argument("--cone_angle", type=float, default=0.0)
    parser.add_argument("--logs_dir", type=str, default="logs",
                        help="output directory to save experiment logs")
    parser.add_argument("--exp_name", type=str, default=None, help="experiment name")
    parser.add_argument("--model", type=str, default="nerf",
                        choices=["nerf", "s-nerf", "sat-nerf", "eo-nerf"],
                        help="kept for flag parity; this entry always trains the vanilla "
                             "NeRF (as the reference does)")
    # knobs the reference hardcodes (train_mlp_nerf.py:85-99)
    parser.add_argument("--max_steps", type=int, default=50000)
    parser.add_argument("--batch_size", type=int, default=4096)
    parser.add_argument("--lr", type=float, default=5e-4)
    parser.add_argument("--net_depth", type=int, default=8)
    parser.add_argument("--net_width", type=int, default=256)
    parser.add_argument("--n_samples", type=int, default=129)
    parser.add_argument("--grid_resolution", type=int, default=64)
    parser.add_argument("--n_test_images", type=int, default=None)
    return parser


def main(argv=None):
    """Train and evaluate; returns the test PSNR (dB)."""
    device, argv = device_flag(argv)
    args = build_parser().parse_args(argv)
    result = train_vanilla(
        subject_id=args.scene, root_fp=args.data_root, logs_dir=args.logs_dir,
        max_steps=args.max_steps, batch_size=args.batch_size, lr=args.lr,
        net_depth=args.net_depth, net_width=args.net_width, n_samples=args.n_samples,
        grid_resolution=args.grid_resolution, train_split=args.train_split, device=device)
    psnr = eval_psnr(result, split="test", root_fp=args.data_root, subject_id=args.scene,
                     n_images=args.n_test_images, chunk=args.test_chunk_size)
    print(f"test PSNR: {psnr:.2f} dB ({result['elapsed_s']:.0f}s, {args.max_steps} steps)")
    return psnr


if __name__ == "__main__":
    main()
