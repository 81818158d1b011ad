"""Training configuration: the fields of the JAX package's ``TrainConfig``
(config.py) that the port's trainer reads, with the same names and
defaults, and JSON round trip.

Left out until the slices that read them: dataset paths and options,
validation cadence and eval, data parallelism, and ``steps_per_call`` (the
JAX megastep's scan length, which a per-step loop has no use for). The
trainer raises ``NotImplementedError`` on the values of the fields below
that need a later slice (``freq_reg_end_step`` > 0, ``bwd_acts="saved"``
with ``trunk_quant="none"``), so a default configuration must set
``bwd_acts="recompute"`` or an int8 ``trunk_quant`` (with which the JAX
package, too, falls back to the recompute backward).
"""

import dataclasses
import json
import os
import warnings
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # paths
    logs_dir: str = "logs"
    ckpt_path: Optional[str] = None      # resume from this checkpoint directory
    exp_name: str = "eo-nerf"

    # model
    model: str = "eo-nerf"               # eo-nerf | sat-nerf (no radiometric norm)

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
    seed: int = 42
    compute_dtype: str = "float32"       # or "bfloat16" (the fused kernels' type)

    # EO-NeRF switches
    geometric_shadows: bool = True       # shadow pass from first_shadow_epoch on
    radiometric_normalization: bool = True
    rpc_correction: bool = False         # learnable per-image ray-origin offsets
    freq_reg_end_step: int = 0           # > 0: coarse-to-fine PE annealing (later slice)
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

    # priors
    depth_weight: float = 100.0
    depth_weight_decay: float = 0.8      # per epoch

    # checkpoint cadence (None -> 4 epochs, the JAX package's val_freq x 4)
    save_freq: Optional[int] = None

    # int8 trunk tier of the fused camera, shadow and coarse kernels: "int8"
    # runs the trunk's products (forward and the backward's recompute) in int8
    # with per-column weight scales and dynamic per-group activation scales,
    # straight-through gradients (dgrad and wgrad in the compute dtype);
    # "int8_full" also runs the trunk's dgrad and wgrad in int8
    trunk_quant: str = "none"

    # fused-kernel backward: "recompute" (this port) or "saved" (later slice)
    bwd_acts: str = "saved"

    def __post_init__(self):
        if self.model == "eo-nerf":
            self.radiometric_normalization = True
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
