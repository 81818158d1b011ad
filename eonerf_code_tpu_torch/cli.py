"""Command-line interface: the JAX package's cli.py flag surface (the
reference's opt.py names) over the port's trainer and eval run.

Every flag of the JAX package's parsers is here, with its ``dest``.
``--use_pallas {true,false}`` sets ``TrainConfig.use_pallas`` (unset: the
fused kernels for a bfloat16 8x256 run on the card); ``--freq_reg_end_step``
and ``--freq_reg_start_step`` set the coarse-to-fine PE annealing.
``--data_axis N`` trains or evaluates data parallel over N processes (-1:
every visible card), as ``python train_eonerf.py --data_axis 8`` does in
the JAX package: the entry point spawns one worker a rank
(``parallel.mesh.launch``), or under ``torchrun`` joins the launcher's
group. ``--steps_per_call`` (the JAX megastep's scan length) is accepted
and ignored with a warning. Flags the reference declared but never read
warn and are ignored (``IGNORED_FLAGS``).
"""

import argparse
import dataclasses
import os
import sys

from eonerf_code_tpu_torch.config import TrainConfig

IGNORED_FLAGS = ["noise_std", "sc_lambda", "ds_lambda", "ds_drop", "t_embbeding_tau",
                 "t_embbeding_vocab"]


def _strict_bool(v):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def build_parser():
    p = argparse.ArgumentParser(description="EO-NeRF on PyTorch and CUDA")
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--logs_dir", type=str, default="logs")
    p.add_argument("--gt_dir", type=str, default=None)
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--ckpt_path", type=str, default=None,
                   help="checkpoint to resume training from")
    p.add_argument("--exp_name", type=str, default="eo-nerf")
    p.add_argument("--aoi_id", type=str, default=None)
    p.add_argument("--model", type=str, default="eo-nerf", choices=["eo-nerf", "sat-nerf"])
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--batch_size", type=int, default=1024)
    p.add_argument("--img_downscale", type=float, default=1.0)
    p.add_argument("--max_train_steps", type=int, default=300000)
    p.add_argument("--fc_units", type=int, default=256, dest="net_width")
    p.add_argument("--fc_layers", type=int, default=8, dest="net_depth")
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--n_importance", type=int, default=0,
                   help="hierarchical fine samples")
    p.add_argument("--sc_n_samples", type=int, default=-1,
                   help="shadow-march samples per solar ray: -1 (default) = auto, "
                        "min(n_samples, max(n_samples//2, 64)); 0 = follow --n_samples; "
                        "an explicit count > 0 wins")
    p.add_argument("--chunk", type=int, default=1024)
    p.add_argument("--geometric_shadows", action="store_true", default=True)
    p.add_argument("--no_geometric_shadows", dest="geometric_shadows", action="store_false")
    p.add_argument("--radiometric_normalization", action="store_true", default=False)
    p.add_argument("--rpc_correction", action="store_true", default=False)
    p.add_argument("--ecef", action="store_true", default=False)
    p.add_argument("--n_grid", type=int, default=128)
    p.add_argument("--init_dsm_path", type=str, default=None)
    p.add_argument("--init_conf_path", type=str, default=None)
    p.add_argument("--shadow_masks_dir", type=str, default=None)
    p.add_argument("--subset_Nviews", type=int, default=None, dest="subset_n_views")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--seed", type=int, default=42)
    g = p.add_argument_group("extensions beyond the reference flag surface")
    g.add_argument("--occ_tighten", action="store_true", default=False,
                   help="concentrate samples on each ray's occupied span")
    g.add_argument("--no_occ_tighten_shadows", dest="occ_tighten_shadows",
                   action="store_false", default=None,
                   help="keep the shadow march uniform even with --occ_tighten")
    g.add_argument("--occ_tighten_start_step", type=int, default=2000)
    g.add_argument("--occ_entropy_max", type=float, default=None,
                   help="tighten only while the probe rays' weight entropy is <= this "
                        "(default: no entropy gate)")
    g.add_argument("--use_pallas", type=_strict_bool, default=None, metavar="{true,false}",
                   help="the fused kernels (true) or the per-sample path (false); unset: the "
                        "kernels for a bfloat16 8x256 run on the card")
    g.add_argument("--trunk_quant", type=str, default="none", choices=["none", "int8", "int8_full"],
                   help="int8 trunk products inside the fused kernels; int8_full also "
                        "quantizes the trunk's backward products")
    g.add_argument("--bwd_acts", type=str, default="saved", choices=["recompute", "saved"],
                   help="fused-kernel backward: read the trunk activations the forward saved "
                        "(default) or recompute them")
    g.add_argument("--freq_reg_end_step", type=int, default=0,
                   help="coarse-to-fine PE annealing: full bandwidth at this step, the "
                        "companion of --rpc_correction (0 = off)")
    g.add_argument("--freq_reg_start_step", type=int, default=0,
                   help="annealing ramp start (must be < --freq_reg_end_step)")
    g.add_argument("--data_axis", type=int, default=1,
                   help="processes on the ray-batch axis, one a card (-1: every visible card)")
    g.add_argument("--lr_decay_steps", type=int, default=None,
                   help="decay lr per N steps instead of per epoch")
    g.add_argument("--first_shadow_step", type=int, default=None)
    g.add_argument("--first_beta_step", type=int, default=None)
    g.add_argument("--steps_per_call", type=int, default=None,
                   help="accepted and ignored: the port takes one step a call")
    g.add_argument("--val_freq", type=int, default=None)
    g.add_argument("--save_freq", type=int, default=None)
    g.add_argument("--device_eval", action="store_true", default=None,
                   help="the validation MAE on the device, failures raise (default: the "
                        "device with a host fallback)")
    g.add_argument("--no_device_eval", dest="device_eval", action="store_false",
                   help="the host GeoTIFF MAE path")
    return p


def device_flag(argv=None):
    """The root scripts' one flag of their own, ``--device`` ("cuda" by
    default, one card a rank; "cpu" runs every rank on the CPU, gloo
    between them), split from the reference's flags: (device, the rest)."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default="cuda")
    args, rest = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    return args.device, rest


def config_from_args(argv=None):
    args, unknown = build_parser().parse_known_args(argv)
    # "--flag value" pairs: each unknown flag warns once
    i = 0
    while i < len(unknown):
        tok = unknown[i]
        val = ""
        if tok.startswith("--") and i + 1 < len(unknown) and not unknown[i + 1].startswith("--"):
            val = " " + unknown[i + 1]
            i += 1
        why = ("dead in the reference too, deliberately not implemented"
               if tok.lstrip("-") in IGNORED_FLAGS else "unknown flag")
        print(f"warning: ignoring flag {tok}{val} ({why})", file=sys.stderr)
        i += 1
    d = vars(args)
    if d["steps_per_call"] is not None:
        print(f"warning: ignoring flag --steps_per_call {d['steps_per_call']} (the port takes "
              "one step a call)", file=sys.stderr)
    known = {f.name for f in dataclasses.fields(TrainConfig)}
    return TrainConfig(**{k: v for k, v in d.items() if k in known})


def _train(cfg, device):
    from eonerf_code_tpu_torch.train.loop import Trainer

    return Trainer(cfg, device=device).run()


def main_train(argv=None, device="cuda"):
    """Train from the command line; with ``--data_axis`` other than 1 on
    every rank of a data axis (``parallel.mesh.launch``). Prints and
    returns rank 0's stats (None on the other ranks under ``torchrun``)."""
    from eonerf_code_tpu_torch.parallel.mesh import launch

    cfg = config_from_args(argv)
    stats = launch(_train, {"cfg": cfg}, cfg.data_axis, device).get(0)
    if stats is not None:
        print(stats)
    return stats


def build_eval_parser():
    p = argparse.ArgumentParser(description="EO-NeRF evaluation on PyTorch and CUDA")
    p.add_argument("run_id")
    p.add_argument("--logs_dir", type=str, default="logs")
    p.add_argument("--output_dir", type=str, default="eval_out")
    p.add_argument("--epoch_nb", type=int, default=None)
    p.add_argument("--root_dir", type=str, default=None)
    p.add_argument("--img_dir", type=str, default=None)
    p.add_argument("--gt_dir", type=str, default=None)
    p.add_argument("--dsm", action="store_true")
    p.add_argument("--pinhole", action="store_true",
                   help="virtual pinhole camera for the DSM sweep (default: orthographic)")
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--dsm_resolution", type=float, default=None)
    p.add_argument("--data_axis", type=int, default=0,
                   help="processes to render over, one a card: 0 or 1 one device, -1 every "
                        "visible card")
    p.add_argument("--export_rpc", action="store_true",
                   help="write bundle-adjusted per-view RPC metadata (a run trained with "
                        "--rpc_correction)")
    return p


def eval_cli(argv=None, device="cuda"):
    """Evaluate from the command line. Prints and returns rank 0's result
    (None on the other ranks under ``torchrun``)."""
    from eonerf_code_tpu_torch.eval.run import eval_eonerf

    args = build_eval_parser().parse_args(argv)
    out = eval_eonerf(args.run_id, args.logs_dir, args.output_dir, epoch_nb=args.epoch_nb,
                      root_dir=args.root_dir, img_dir=args.img_dir, gt_dir=args.gt_dir,
                      dsm=args.dsm, chunk=args.chunk, dsm_resolution=args.dsm_resolution,
                      pinhole=args.pinhole, data_axis=args.data_axis, device=device)
    if out is None:
        return None
    if args.export_rpc:
        from eonerf_code_tpu_torch.eval.export import export_adjusted_rpcs

        rpc_dir = os.path.join(args.output_dir, args.run_id, "rpc_adjusted")
        exported = export_adjusted_rpcs(os.path.join(args.logs_dir, args.run_id), rpc_dir,
                                        epoch_nb=args.epoch_nb, root_dir=args.root_dir,
                                        img_dir=args.img_dir)
        # a dict in dsm mode, a per-view list otherwise
        out = dict(out) if isinstance(out, dict) else {"report": out}
        out["rpc_adjusted_dir"] = rpc_dir
        out["rpc_adjusted_views"] = len(exported)
    print(out)
    return out
