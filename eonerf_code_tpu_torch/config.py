"""Training configuration: the fields of the JAX package's ``TrainConfig``
(config.py) that the port's trainer reads, with the same names and
defaults, the same ``__post_init__`` checks, and JSON round trip.

Left out: ``steps_per_call`` (the JAX megastep's scan length, which a
per-step loop has no use for); cli.py accepts and ignores it.
"""

import dataclasses
import json
import os
import warnings
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # paths
    root_dir: str = ""                   # scene: view jsons, train.txt, test.txt
    img_dir: Optional[str] = None        # images (None = root_dir)
    logs_dir: str = "logs"
    gt_dir: Optional[str] = None         # lidar GT: <aoi_id>_DSM.tif, _CLS.tif (validation MAE)
    cache_dir: Optional[str] = None      # per-image ray and prior caches
    ckpt_path: Optional[str] = None      # resume from this checkpoint directory
    exp_name: str = "eo-nerf"
    aoi_id: Optional[str] = None         # GT raster prefix (None: the view id's first 7 chars)

    # model / dataset
    model: str = "eo-nerf"               # eo-nerf | sat-nerf (no radiometric norm)
    img_downscale: float = 1.0
    ecef: bool = False                   # ECEF scene frame instead of UTM
    subset_n_views: Optional[int] = None  # train on the first N views of train.txt

    # training
    lr: float = 5e-4
    lr_gamma_per_epoch: float = 0.9      # StepLR(gamma=0.9) per epoch
    lr_decay_steps: Optional[int] = None  # decay every N steps instead of per epoch
    batch_size: int = 1024
    max_train_steps: int = 300000
    n_samples: int = 128
    n_importance: int = 0                # hierarchical fine samples
    sc_n_samples: int = -1               # shadow-march samples per solar ray:
                                         # -1 = auto, 0 = follow n_samples,
                                         # > 0 explicit (resolve_sc_n_samples)
    sampler: str = "auto"                # auto | uniform | tighten | hierarchical:
                                         # auto picks from the scene's altitude
                                         # envelope (compact -> tighten, wide ->
                                         # hierarchical); explicit occ_tighten /
                                         # n_importance win (Trainer._resolve_sampler)
    occ_tighten_max_envelope_m: float = 60.0  # auto tightens only below this
    net_depth: int = 8
    net_width: int = 256
    chunk: int = 1024                    # val/eval render block (rays)
    seed: int = 42
    compute_dtype: str = "float32"       # or "bfloat16" (the fused kernels' type)

    # EO-NeRF switches
    geometric_shadows: bool = True       # shadow pass from first_shadow_epoch on
    radiometric_normalization: bool = True
    rpc_correction: bool = False         # learnable per-image ray-origin offsets
    freq_reg_end_step: int = 0           # > 0: coarse-to-fine PE annealing, full
                                         # bandwidth at this step (models/freq_reg.py),
                                         # the companion of rpc_correction; 0 = off
    freq_reg_start_step: int = 0         # the annealing ramp's start
    first_shadow_epoch: int = 2
    first_beta_epoch: int = 2            # MSE before, beta loss after
    first_shadow_step: Optional[int] = None  # step-based overrides of the
    first_beta_step: Optional[int] = None    # epoch gates

    # occupancy grid: maintained every occ_update_every steps; sampled from
    # only with occ_tighten, past the warm-up step, once its occupied
    # fraction is stable (and the entropy gate, if set, passes)
    n_grid: int = 128
    occ_update_every: int = 50
    occ_enabled: bool = True
    occ_max_cells: Optional[int] = 262144  # cells probed per update (None = all)
    occ_tighten: bool = False            # camera rays sample their occupied span
    occ_tighten_shadows: Optional[bool] = None  # the same for shadow rays
                                         # (None = follow occ_tighten)
    occ_tighten_start_step: int = 2000   # warm-up before trusting the grid
    occ_explore_frac: float = 0.25       # share of rays per step that keep the
                                         # full range despite the grid
    occ_entropy_max: Optional[float] = None  # tighten only while the probe rays'
                                         # mean normalized weight entropy is <=
                                         # this (None: no entropy gate)

    # priors: a DSM reprojected into every view as per-ray depth (with an
    # optional confidence raster), and binary shadow masks
    init_dsm_path: Optional[str] = None
    init_conf_path: Optional[str] = None
    shadow_masks_dir: Optional[str] = None
    depth_weight: float = 100.0
    depth_weight_decay: float = 0.8      # per epoch

    # evaluation: the validation MAE on the device (True: failures raise),
    # on the host GeoTIFF path (False), or the device with a host fallback
    # (None)
    device_eval: Optional[bool] = None
    # validation and checkpoint cadence in steps (None: val_freq = one epoch,
    # save_freq = 4 x val_freq), and the views a validation renders
    val_freq: Optional[int] = None
    save_freq: Optional[int] = None
    n_val_images: int = 5

    # int8 trunk tier of the fused camera, shadow and coarse kernels: "int8"
    # runs the trunk's products (forward and the backward's recompute) in int8
    # with per-column weight scales and dynamic per-group activation scales,
    # straight-through gradients (dgrad and wgrad in the compute dtype);
    # "int8_full" also runs the trunk's dgrad and wgrad in int8
    trunk_quant: str = "none"

    # fused-kernel backward: "saved" streams the trunk activations from the
    # differentiated forward to the backward, which then skips the trunk's
    # recompute (all or nothing per step, under KernelField's stream cap);
    # "recompute" reruns the forward inside the backward. int8 tiers always
    # recompute.
    bwd_acts: str = "saved"

    # data parallel (parallel/mesh.py): processes on the ray-batch axis, one
    # a card; -1 or 0 = every visible card
    data_axis: int = 1

    # the render backend (models/fused.py::make_render_field): None = the
    # fused kernels for a bfloat16 8x256 field on the card, else the field
    # itself; True = the kernels (a shape or dtype they do not take raises);
    # False = the field itself, the per-sample path, also on the card
    use_pallas: Optional[bool] = None

    def __post_init__(self):
        if self.model == "eo-nerf":
            self.radiometric_normalization = True
        if self.freq_reg_start_step > 0 and self.freq_reg_end_step <= 0:
            raise ValueError("freq_reg_start_step set but freq_reg_end_step is 0: annealing is "
                             "enabled by the END step (start defaults to 0)")
        if self.freq_reg_end_step > 0 and self.freq_reg_start_step >= self.freq_reg_end_step:
            raise ValueError(f"freq_reg_start_step ({self.freq_reg_start_step}) must be < "
                             f"freq_reg_end_step ({self.freq_reg_end_step})")
        if self.trunk_quant not in ("none", "int8", "int8_full"):
            raise ValueError(f"trunk_quant={self.trunk_quant!r}: one of 'none', 'int8', "
                             "'int8_full'")

    def save(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def load(cls, path):
        with open(path) as f:
            d = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def log_dir(self):
        return os.path.join(self.logs_dir, self.exp_name)

    def resolve_sc_n_samples(self):
        """Concrete shadow-march sample count. -1 = auto: at least half the
        camera count and at least 64, never more than n_samples (the JAX
        package's rule, validated at n_samples 96-192); 0 = n_samples."""
        if self.sc_n_samples == -1:
            resolved = min(self.n_samples, max(self.n_samples // 2, 64))
            if not 64 <= self.n_samples <= 192:
                warnings.warn(
                    f"sc_n_samples auto rule resolving {self.n_samples} -> "
                    f"{resolved} shadow samples is outside its validated "
                    "range (n_samples 96-192). Quality is unverified here: "
                    "A/B against --sc_n_samples 0 (full count) before "
                    "trusting converged results.",
                    stacklevel=2)
            return resolved
        if self.sc_n_samples == 0:
            return self.n_samples
        if self.sc_n_samples < 0:
            raise ValueError(
                f"sc_n_samples={self.sc_n_samples}: only -1 (auto), 0 "
                "(follow n_samples) and positive counts are valid")
        return self.sc_n_samples

    def resolved_occ_tighten_shadows(self):
        """Shadow-march tightening follows occ_tighten unless overridden."""
        if self.occ_tighten_shadows is None:
            return self.occ_tighten
        return self.occ_tighten_shadows
