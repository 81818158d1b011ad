"""The EO-NeRF single-AOI training loop, as the JAX package's train/loop.py.

- The ray pool comes from ``SatelliteDataset(cfg.root_dir, ...)`` (the
  train split, with the depth, confidence and shadow priors the config
  names), or from the caller (``data``, ``n_images``, ``alt_envelope``).
- The whole ray pool lives on the device; each epoch draws a permutation
  (``torch.randperm`` from an explicit device generator seeded from
  ``cfg.seed``) and each step gathers its batch by index.
- A step: gather -> ``render_rays`` (camera and shadow passes through the
  fused kernels on a kernel-backed field) -> the utils/metrics.py losses ->
  backward -> Adam at the StepLR learning rate of that step.
- Epoch gates as the reference schedule (train_eonerf.py:139-155,304-306):
  MSE before and the beta loss from ``first_beta_epoch``, the shadow pass
  from ``first_shadow_epoch`` (or the step overrides), the depth-prior
  weight decaying 0.8 per epoch.
- The sampler: ``_resolve_sampler`` turns ``sampler="auto"`` into
  occupancy tightening on a compact altitude envelope and hierarchical
  sampling on a wide one, before opts.json is written. The occupancy grid
  is updated every ``occ_update_every`` steps, before the step, and handed
  to the renderer only once the warm-up, stability and entropy gates pass.
- Checkpoints carry {params, opt_state, step, epoch, rng, occ, gate}, the
  gate as plain history lists and its verdict (``tighten_active``), and
  the ``occ_sampling.json`` sidecar with the same three fields
  (authoritative on restore and in eval when present); resume continues
  the same random stream and samples as the uninterrupted run. A
  checkpoint without ``opt_state`` (imported for evaluation) cannot
  resume.
- Coarse-to-fine PE annealing (``freq_reg_end_step`` > 0, the companion of
  ``rpc_correction``): each step renders through the step's PE mask folded
  into the trunk (models/freq_reg.py), all-ones past the ramp; the grid
  updates, the entropy probe and the validation renders read the same
  masked view mid-ramp (``_reg_field``), and ``train/pe_alpha`` is logged.
- Validation every ``val_freq`` steps (a trainer over ``cfg.root_dir``
  only): each view of the val split rendered whole, without exploration,
  through ``render_image`` (the fused kernels on a kernel-backed field);
  the beta loss and PSNR of the test views, their registered DSM MAE
  against ``cfg.gt_dir`` on the device (``eval/device.py``) or on the host
  (``eval/dsm.py``), image panels, and the ``epoch=best`` checkpoint when
  the mean MAE improves.
- Data parallel (``cfg.data_axis`` != 1, inside a process group:
  parallel/mesh.py): every rank holds the pool and a replica of the
  parameters and the optimizer, and trains on its contiguous rows of each
  global batch; the losses are each rank's share of the global batch's,
  divided by the global batch's prior counts (utils/metrics.py; every rank
  gathers the global batch, so the counts need no collective), the per-ray
  draws the global batch's (``ops.sampling.RowShare``), and one all-reduce
  a step sums the gradients and the loss values before every rank takes
  the same Adam step. The gates take rank 0's grid, occupied fraction and probe entropy
  after each update. Rank 0 alone writes opts.json, the metrics and the
  checkpoints and validates; the others wait at a barrier.

The JAX package scans K steps inside one compiled call (its megastep); here
the steps are a plain Python loop.
"""

import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.satellite import SatelliteDataset
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.models.encoders import barf_alpha
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.freq_reg import field_weights, pe_masked, step_pe_mask
from eonerf_code_tpu_torch.models.fused import make_render_field
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.ops.sampling import RowShare
from eonerf_code_tpu_torch.ops.volrend import render_weights, weight_entropy
from eonerf_code_tpu_torch.parallel import mesh as pmesh
from eonerf_code_tpu_torch.render.satellite import RenderConfig, render_image, render_rays
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.utils import metrics as M
from eonerf_code_tpu_torch.utils.tb import MetricsLogger, NullLogger

_POOL_DTYPES = {"rays": torch.float32, "rgbs": torch.float32, "ts": torch.long,
                "depth_prior": torch.float32, "conf_prior": torch.float32,
                "shadow_prior": torch.float32}


def make_lr_schedule(cfg: TrainConfig, steps_per_epoch: int):
    """The reference's per-epoch StepLR(gamma) schedule, or per
    ``lr_decay_steps`` steps. Step i (0-based, the update count optax
    evaluates the schedule at) trains at lr * gamma^(i // decay_every)."""
    decay_every = cfg.lr_decay_steps or max(steps_per_epoch, 1)

    def lr_schedule(step):
        return cfg.lr * (cfg.lr_gamma_per_epoch ** (step // decay_every))

    return lr_schedule


def make_optimizer(params, cfg: TrainConfig):
    """Adam with optax's defaults (beta 0.9 / 0.999, eps 1e-8); the train
    step sets each step's learning rate from the schedule."""
    return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def make_loss_fn(field, rcfg: RenderConfig, has_depth=False, has_conf=False,
                 has_shadow=False, world=1):
    """Per-batch loss with the reference's schedule semantics
    (train_eonerf.py:139-155). ``pe_mask``: render through the PE-masked
    trunk (the JAX ``loss_fn``'s ``mask_trunk_pe``); gradients reach the raw
    parameters. The dict carries the rgb mse under "mse" (``make_train_step``
    logs its PSNR). On a data axis of ``world`` ranks the batch is this
    rank's rows of ``global_batch``, whose prior counts every rank divides
    by (no collective: each rank holds the global batch), and the loss and
    the dict's values are this rank's shares of the global batch's
    (utils/metrics.py); ``global_batch`` defaults to ``batch``."""

    def loss_fn(batch, w_depth, shadows, use_beta, generator=None, occ_grid=None, pe_mask=None,
                global_batch=None):
        gb = batch if global_batch is None else global_batch
        rays = satrays_from_tensor(batch["rays"], batch["ts"])
        out = render_rays(pe_masked(field, pe_mask), rays, rcfg, shadows, generator, occ_grid)
        mse = M.mse(out["rgb"], batch["rgbs"], world=world)
        if use_beta:
            loss, loss_dict = M.uncertainty_aware_loss(batch["rgbs"], out["rgb"], out["beta"],
                                                       world)
        else:
            loss = mse
            loss_dict = {"loss": loss, "coarse_color": loss}
        if has_depth:
            conf, gconf = (batch["conf_prior"], gb["conf_prior"]) if has_conf else (None, None)
            aux, aux_d = M.depth_loss_l2(batch["depth_prior"], out["depth"][:, 0], conf, w_depth,
                                         M.depth_valid(gb["depth_prior"], gconf).sum())
            loss = loss + aux
            loss_dict.update(aux_d)
        if has_shadow and shadows:
            aux, aux_d = M.shadow_loss_l2(batch["shadow_prior"], out["geo_shadows"][:, 0],
                                          M.shadow_counts(gb["shadow_prior"]), world)
            loss = loss + aux
            loss_dict.update(aux_d)
        loss_dict["mse"] = mse
        return loss, loss_dict

    return loss_fn


def make_train_step(field, optimizer, lr_schedule, rcfg: RenderConfig, has_depth=False,
                    has_conf=False, has_shadow=False, mesh=None):
    """One training step on ``field`` (an EONerfField or its KernelField),
    updating the optimizer's parameters in place. Returns
    ``step_fn(batch, step, w_depth, shadows, use_beta, generator=None,
    occ_grid=None, pe_mask=None, global_batch=None)`` -> the loss dict
    (detached), its "psnr" that of the step's mse. On a process group
    (``mesh.distributed``; ``batch`` this rank's rows of ``global_batch``)
    the gradients and the loss shares are summed over the ranks in one
    all-reduce before the update, after every parameter has a gradient (so
    a head that a step does not reach, as the transient head before its
    epoch or the shadow path before its gate, needs no special case), and
    the dict holds the global batch's values."""
    mesh = pmesh.Mesh.single() if mesh is None else mesh
    loss_fn = make_loss_fn(field, rcfg, has_depth, has_conf, has_shadow, mesh.world)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step_fn(batch, step, w_depth, shadows, use_beta, generator=None, occ_grid=None,
                pe_mask=None, global_batch=None):
        optimizer.zero_grad(set_to_none=False)
        loss, loss_dict = loss_fn(batch, w_depth, shadows, use_beta, generator, occ_grid, pe_mask,
                                  global_batch)
        loss.backward()
        for p in params:
            # optax updates every parameter, an unused one with a zero
            # gradient (its moments decay); torch.optim skips a None grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss_dict = {k: v.detach().clone() if torch.is_tensor(v) else v
                     for k, v in loss_dict.items()}
        mesh.all_reduce_([p.grad for p in params]
                         + [v for v in loss_dict.values() if torch.is_tensor(v)])
        loss_dict["psnr"] = M.psnr_of(loss_dict.pop("mse"))
        lr = lr_schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return loss_dict

    return step_fn


OCC_SIDECAR = "occ_sampling.json"


def ray_pool(ds):
    """A train dataset's ray pool, as the JAX package's trainers put it on
    the device: rays (N, 11), rgbs, ts and the priors the dataset has."""
    data = {"rays": ds.all_rays, "rgbs": ds.all_rgbs.astype(np.float32),
            "ts": ds.all_ids_img[:, 0].astype(np.int32)}
    if ds.prior_depths is not None:
        data["depth_prior"] = ds.prior_depths
        if ds.prior_confs is not None:
            data["conf_prior"] = ds.prior_confs
    if ds.prior_shadows is not None:
        data["shadow_prior"] = ds.prior_shadows
    return data


def dataset_pool(cfg: TrainConfig):
    """(train dataset, ray pool, n_images) from ``cfg.root_dir``
    (:func:`ray_pool`)."""
    ds = SatelliteDataset(
        cfg.root_dir, cfg.img_dir, split="train", img_downscale=cfg.img_downscale,
        utm=not cfg.ecef, cache_dir=cfg.cache_dir, prior_dsm_path=cfg.init_dsm_path,
        prior_conf_path=cfg.init_conf_path, shadow_masks_dir=cfg.shadow_masks_dir,
        subset=cfg.subset_n_views)
    return ds, ray_pool(ds), len(ds.json_files)


def occ_hist_stable(hist, window=5, tol=0.05, tol_drift=0.025):
    """The occupancy gate's stability test over a history of occupied
    fractions, floats (one grid) or (S,) arrays (one a scene, all of which
    must pass): every entry of the last ``window`` within ``tol`` of the
    latest, and the drift across the window under ``tol_drift`` (a slow
    monotonic drift stays under the scatter tolerance while the grid is
    still moving). Computed in the history's own dtype."""
    if len(hist) < window:
        return False
    win = np.asarray(hist[-window:])
    ref, first = win[-1], win[0]
    if np.any(ref <= 0) or np.any(first <= 0):
        return False
    scatter = np.max(np.abs(win - ref), axis=0) / ref
    drift = np.abs(ref - first) / first
    return bool(np.all(scatter < tol) and np.all(drift < tol_drift))


class Trainer:
    """Single-AOI trainer. With no ``data`` it builds the ray pool, the
    image count and the altitude envelope from ``SatelliteDataset`` over
    ``cfg.root_dir`` (:func:`dataset_pool`), and the validation views
    (``val_ds``, the val split), as the JAX package's Trainer.
    Else the caller gives the pool and there is no validation: ``data`` holds ``rays`` (N, 11), ``rgbs``
    (N, 3), ``ts`` (N,) image indices and optionally ``depth_prior``,
    ``conf_prior``, ``shadow_prior`` (N,); ``n_images`` sizes the per-image
    embeddings; ``alt_envelope`` = (lo, hi), the scene's altitude envelope in
    metres, is what ``sampler="auto"`` reads. Runs on ``device`` (the card
    by default; on a data axis, this rank's device).

    ``cfg.data_axis`` other than 1 takes the process group this process
    belongs to (``parallel.mesh.current``: started by
    ``parallel.mesh.launch``, ``torchrun`` or the command line), whose size
    it must be; ``batch_size`` must divide by it. Rank 0 builds the pool
    (and writes the caches) before the other ranks read it."""

    def __init__(self, cfg: TrainConfig, data=None, n_images=None, device="cuda",
                 alt_envelope=None):
        self.cfg = cfg
        self.mesh = pmesh.current(cfg.data_axis, device)
        if cfg.batch_size % self.mesh.world:
            raise ValueError(f"batch_size={cfg.batch_size} does not divide over "
                             f"data_axis={self.mesh.world} ranks")
        main = self.mesh.is_main
        self.validates = data is None
        self.train_ds = self.val_ds = None
        if data is None:
            with self.mesh.main_first():
                self.train_ds, data, n_images = dataset_pool(cfg)
                if main:      # validation runs on rank 0 alone
                    self.val_ds = SatelliteDataset(cfg.root_dir, cfg.img_dir, split="val",
                                                   img_downscale=cfg.img_downscale,
                                                   utm=not cfg.ecef, cache_dir=cfg.cache_dir)
            alt_envelope = self.train_ds.alt_envelope()
        self.alt_envelope = alt_envelope
        self.device = torch.device(device)
        if cfg.rpc_correction and cfg.freq_reg_end_step <= 0:
            print("warning: --rpc_correction without --freq_reg_end_step: joint camera "
                  "refinement usually needs coarse-to-fine PE annealing to converge (the JAX "
                  "package measured offsets at corr +0.99 against the injected bias with "
                  "annealing, +0.13 without, on a TPU)", file=sys.stderr)
        self.log_dir = cfg.log_dir()
        # the sampler resolves before opts.json is written (a reload never
        # re-guesses), and sc_n_samples after it (hierarchical rewrites
        # n_samples, which the auto rule reads)
        self._resolve_sampler()
        cfg.sc_n_samples = cfg.resolve_sc_n_samples()
        if main:
            os.makedirs(self.log_dir, exist_ok=True)
            cfg.save(os.path.join(self.log_dir, "opts.json"))
        self.logger = MetricsLogger(self.log_dir) if main else NullLogger()

        unknown = set(data) - set(_POOL_DTYPES)
        if unknown:
            raise ValueError(f"unknown ray-pool entries {sorted(unknown)}")
        self.device_data = {k: torch.as_tensor(v).to(self.device, _POOL_DTYPES[k])
                            for k, v in data.items()}
        self.n_rays = self.device_data["rays"].shape[0]
        self.n_images = n_images
        self.steps_per_epoch = max(self.n_rays // cfg.batch_size, 1)
        self.val_freq = cfg.val_freq or self.steps_per_epoch   # reference :180
        self.save_freq = cfg.save_freq or self.val_freq * 4

        dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
        self.field = EONerfField(
            n_images, net_depth=cfg.net_depth, net_width=cfg.net_width,
            radiometric_normalization=cfg.radiometric_normalization,
            rpc_correction=cfg.rpc_correction, compute_dtype=dtype, device=self.device,
            generator=torch.Generator().manual_seed(cfg.seed))
        self.render_field = make_render_field(self.field, cfg)
        self.lr_schedule = make_lr_schedule(cfg, self.steps_per_epoch)
        self.optimizer = make_optimizer(self.field.parameters(), cfg)
        self.occ_grid = (OccupancyGrid.create(cfg.n_grid, device=self.device)
                         if cfg.occ_enabled else None)
        self.render_step_size = 2.0 / cfg.n_samples
        self.rcfg = RenderConfig(n_samples=cfg.n_samples, sc_n_samples=cfg.sc_n_samples,
                                 n_importance=cfg.n_importance, occ_tighten=cfg.occ_tighten,
                                 occ_tighten_shadows=cfg.resolved_occ_tighten_shadows(),
                                 occ_explore_frac=cfg.occ_explore_frac)
        # validation renders do not explore
        self.rcfg_eval = dataclasses.replace(self.rcfg, occ_explore_frac=0.0)
        self.train_step = make_train_step(
            self.render_field, self.optimizer, self.lr_schedule, self.rcfg,
            has_depth="depth_prior" in data, has_conf="conf_prior" in data,
            has_shadow="shadow_prior" in data, mesh=self.mesh)
        # one stream for the epoch permutations, the sampling jitter and the
        # occupancy probes, equal on every rank; a step's per-ray draws are
        # the global batch's, of which each rank keeps its rows
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step_generator = RowShare(self.generator, self.mesh.rank, self.mesh.world)
        self.step = 0
        self.epoch = 0
        self.best_val_mae = float("inf")
        self._gt_grid = None          # the GT DSM on the device (_gt_grid_local)
        # one occupied fraction and (with the entropy gate) one probe entropy
        # per grid update: the tightening gates read them
        self._occ_frac_hist = []
        self._entropy_hist = []
        if cfg.ckpt_path:
            self.restore(cfg.ckpt_path)
        # the replicas start from rank 0's parameters (every rank seeds and
        # restores the same, so this changes no bit)
        self.mesh.broadcast_(list(self.field.state_dict().values()))

    # ---- sampler selection ----

    def _resolve_sampler(self):
        """Resolve ``cfg.sampler`` into concrete sampling flags, in place,
        and return the mode (the JAX package's ``Trainer._resolve_sampler``).

        Explicit flags win (``occ_tighten`` / ``n_importance`` set by the
        user or by a reloaded opts.json). ``auto`` picks from the scene's
        altitude envelope: tightening on a compact one (at most
        ``occ_tighten_max_envelope_m``; uniform when there is no grid),
        hierarchical sampling on a wide one, where tightening diverges. The
        hierarchical shape is 3/4 of the samples coarse and half of those
        again as fine samples (128 -> 96 + 48)."""
        cfg = self.cfg
        if cfg.occ_tighten or cfg.n_importance > 0 or cfg.sampler == "uniform":
            mode = ("tighten" if cfg.occ_tighten else
                    "hierarchical" if cfg.n_importance > 0 else "uniform")
            cfg.sampler = mode
            return mode
        mode = cfg.sampler
        if mode == "auto":
            if self.alt_envelope is None:
                raise ValueError("sampler='auto' picks from the scene's altitude envelope: "
                                 "pass alt_envelope=(lo, hi) in metres, or set the sampler")
            lo, hi = self.alt_envelope
            if (hi - lo) <= cfg.occ_tighten_max_envelope_m:
                mode = "tighten" if cfg.occ_enabled else "uniform"
            else:
                mode = "hierarchical"
        if mode == "tighten":
            if not cfg.occ_enabled:
                mode = "uniform"      # tightening needs the grid
            else:
                cfg.occ_tighten = True
        elif mode == "hierarchical":
            cfg.n_samples = max((3 * cfg.n_samples) // 4, 8)
            cfg.n_importance = max(cfg.n_samples // 2, 4)
        elif mode != "uniform":
            raise ValueError(f"unknown sampler mode {mode!r}")
        cfg.sampler = mode
        return mode

    # ---- checkpointing ----

    def _state(self):
        state = {"params": self.field.state_dict(), "opt_state": self.optimizer.state_dict(),
                 "step": self.step, "epoch": self.epoch, "rng": self.generator.get_state(),
                 "gate": {"frac_hist": list(self._occ_frac_hist),
                          "entropy_hist": list(self._entropy_hist),
                          "tighten_active": self._occ_for_sampling() is not None}}
        if self.occ_grid is not None:
            state["occ"] = {"occs": self.occ_grid.occs, "binaries": self.occ_grid.binaries}
        return state

    def _on_main(self, fn):
        """``fn()`` on rank 0 while the other ranks wait (a barrier)."""
        if self.mesh.is_main:
            fn()
        self.mesh.barrier()

    def save(self, epoch_tag=None):
        """Checkpoint and its ``occ_sampling.json`` sidecar: the gate history
        (so a resume samples as the uninterrupted run) and whether the
        sampler takes the grid at this step (what eval reads). Every rank
        holds the same state; the trainer saves on rank 0 alone."""
        state = self._state()
        return ckpt_lib.save_checkpoint(
            self.log_dir, self.epoch if epoch_tag is None else epoch_tag, state,
            sidecars={OCC_SIDECAR: state["gate"]})

    def restore(self, path):
        state = ckpt_lib.restore_checkpoint(path, map_location="cpu")
        if "opt_state" not in state or "rng" not in state:
            raise ValueError(f"checkpoint {path} was imported for evaluation and carries no "
                             "optimizer state or random stream: it cannot resume training")
        self.field.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.generator.set_state(state["rng"])
        if self.occ_grid is not None and "occ" in state:
            self.occ_grid = dataclasses.replace(
                self.occ_grid, occs=state["occ"]["occs"].to(self.device),
                binaries=state["occ"]["binaries"].to(self.device))
        sidecar = os.path.join(path, OCC_SIDECAR)
        if os.path.exists(sidecar):       # authoritative when present, as in the JAX package
            with open(sidecar) as f:
                gate = json.load(f)
        else:                             # a checkpoint from before the grid has none
            gate = state.get("gate", {})
        self._occ_frac_hist = [float(x) for x in gate.get("frac_hist", [])]
        self._entropy_hist = [float(x) for x in gate.get("entropy_hist", [])]

    # ---- coarse-to-fine PE annealing ----

    def _pe_mask(self, step):
        """The training step's PE mask (latent,) on the device, None when the
        annealing is off (the JAX ``_pe_mask_block`` for one step). Past the
        ramp it is all-ones: the same graph, full-bandwidth arithmetic."""
        return step_pe_mask(self.cfg, step, self.field.pos_enc_deg, self.device)

    def _reg_mask(self, step=None):
        """The mask every consumer outside the loss reads at ``step``
        (default: the current one): the step's mask inside the ramp, None
        (the raw parameters) outside it."""
        step = self.step if step is None else step
        if step >= self.cfg.freq_reg_end_step:
            return None
        return self._pe_mask(step)

    def _reg_field(self, step=None):
        """The render field as every consumer must see it at ``step`` (the
        JAX ``_reg_params``): PE-masked while the ramp runs. The masked
        trunk rows get no gradient and keep their random initial values, so
        the raw parameters mid-ramp would mix trained low-frequency
        structure with untrained noise."""
        return pe_masked(self.render_field, self._reg_mask(step))

    def _reg_params(self, step=None):
        """FieldWeights as the consumers read them at ``step``
        (``_reg_field``'s)."""
        return field_weights(pe_masked(self.field, self._reg_mask(step)))

    # ---- occupancy gates ----

    def _occ_update(self):
        """One grid update through the plain field's density (a matrix
        product, not a kernel of the port), masked mid-ramp."""
        density = pe_masked(self.field, self._reg_mask()).density
        with torch.no_grad():
            self.occ_grid = self.occ_grid.update(
                density, self.render_step_size, max_cells=self.cfg.occ_max_cells,
                generator=self.generator)

    def _occ_step(self):
        """A grid update and, with tightening, the gate history it feeds:
        the occupied fraction and (with the entropy gate) the probe entropy.
        On a data axis every rank updates (its probes keep the generators
        in step), rank 0 alone runs the entropy probe, and every rank takes
        rank 0's grid, fraction and entropy, so the gates branch alike."""
        cfg = self.cfg
        self._occ_update()
        probe = cfg.occ_tighten and cfg.occ_entropy_max is not None
        frac = float(self.occ_grid.binaries.float().mean()) if cfg.occ_tighten else 0.0
        h = self._weight_entropy() if probe and self.mesh.is_main else 0.0
        if self.mesh.distributed:
            stats = torch.tensor([frac, h], dtype=torch.float64, device=self.device)
            self.mesh.broadcast_([self.occ_grid.occs, self.occ_grid.binaries, stats])
            frac, h = stats.tolist()
        if cfg.occ_tighten:
            self._occ_frac_hist.append(frac)
            if probe:
                self._entropy_hist.append(h)
                self.logger.scalar("occ/weight_entropy", h, self.step)

    def _occ_grid_stable(self, window=5, tol=0.05, tol_drift=0.025):
        """True once the occupied fraction has stopped moving
        (:func:`occ_hist_stable`)."""
        return occ_hist_stable(self._occ_frac_hist, window, tol, tol_drift)

    def _weight_entropy(self):
        """Mean normalized weight entropy over the opaque ones of up to 2048
        fixed, evenly strided pool rays, density-rendered with up to 64
        uniform samples (the probe must not depend on the grid it gates);
        1.0 when no ray is opaque yet. On a kernel-backed field the density
        runs through the density kernel, one launch per probe; masked
        mid-ramp."""
        k = int(min(self.cfg.n_samples, 64))
        n = int(min(2048, self.n_rays))
        idx = torch.from_numpy(np.linspace(0, self.n_rays - 1, num=n).astype(np.int64))
        rays = self.device_data["rays"][idx.to(self.device)]
        o, d = rays[:, 0:3], rays[:, 3:6]
        near, far = rays[:, 6], rays[:, 7]
        tm = (torch.arange(k, dtype=torch.float32, device=self.device) + 0.5) / k
        z = near[:, None] + (far - near)[:, None] * tm[None, :]
        delta = torch.broadcast_to((far - near)[:, None] / k, z.shape)
        pos = o[:, None, :] + d[:, None, :] * z[..., None]
        with torch.no_grad():
            w, _, _ = render_weights(self._reg_field().density(pos).float(), delta)
        opaque = (w.sum(dim=-1) > 0.5).float()
        n_op = float(opaque.sum())
        if n_op == 0:
            return 1.0
        return float((weight_entropy(w) * opaque).sum()) / n_op

    def _entropy_ok(self):
        """True when the entropy gate is off or the latest probe shows
        surface-like weight distributions."""
        if self.cfg.occ_entropy_max is None:
            return True
        return bool(self._entropy_hist) and self._entropy_hist[-1] <= self.cfg.occ_entropy_max

    def _occ_for_sampling(self, step=None):
        """The grid handed to the sampler: None until tightening is on, past
        the warm-up step, with a stable grid and the entropy gate passed."""
        step = self.step if step is None else step
        if (self.cfg.occ_tighten and self.occ_grid is not None
                and step >= self.cfg.occ_tighten_start_step
                and self._entropy_ok()
                and self._occ_grid_stable()):
            return self.occ_grid
        return None

    # ---- training ----

    def epoch_flags(self, epoch, step=None):
        """(shadows, use_beta) at this epoch and step."""
        cfg = self.cfg
        step = self.step if step is None else step
        if cfg.first_shadow_step is not None:
            shadows = bool(cfg.geometric_shadows and step >= cfg.first_shadow_step)
        else:
            shadows = bool(cfg.geometric_shadows and epoch >= cfg.first_shadow_epoch)
        if cfg.first_beta_step is not None:
            use_beta = bool(step >= cfg.first_beta_step)
        else:
            use_beta = bool(epoch >= cfg.first_beta_epoch)
        return shadows, use_beta

    def run(self, max_steps=None, log_every=50):
        """Train to max_steps. A checkpoint is saved even when the loop dies
        mid-flight (resume via ckpt_path then continues from it)."""
        try:
            return self._run(max_steps, log_every)
        except BaseException:
            if self.step > 0 and self.mesh.is_main:
                try:
                    self.save()
                    self.logger.flush()
                except Exception:
                    pass
            raise

    def _run(self, max_steps=None, log_every=50):
        cfg = self.cfg
        max_steps = max_steps or cfg.max_train_steps
        bs = cfg.batch_size
        tic = time.time()
        rays_done = 0
        w_depth = cfg.depth_weight * (cfg.depth_weight_decay ** self.epoch)
        next_log = self.step

        while self.step < max_steps:
            perm = torch.randperm(self.n_rays, generator=self.generator, device=self.device)
            i = 0
            while i < self.steps_per_epoch and self.step < max_steps:
                shadows, use_beta = self.epoch_flags(self.epoch, self.step)
                if self.occ_grid is not None and self.step % cfg.occ_update_every == 0:
                    self._occ_step()
                idx = perm[i * bs:(i + 1) * bs]
                global_batch = {k: v[idx] for k, v in self.device_data.items()}
                batch = {k: pmesh.shard_rows(v, self.mesh.rank, self.mesh.world)
                         for k, v in global_batch.items()}
                loss_dict = self.train_step(batch, self.step, w_depth, shadows, use_beta,
                                            self.step_generator, self._occ_for_sampling(),
                                            pe_mask=self._pe_mask(self.step),
                                            global_batch=global_batch)
                rays_done += bs
                i += 1
                self.step += 1
                done_step = self.step - 1

                if done_step >= next_log:
                    ld = {k: float(v) for k, v in loss_dict.items()}
                    self.logger.scalars({k: v for k, v in ld.items() if k != "psnr"},
                                        done_step, "train/")
                    self.logger.scalar("train/psnr", ld["psnr"], done_step)
                    self.logger.scalar("lr", self.lr_schedule(done_step), done_step)
                    self.logger.scalar("epoch", self.epoch, done_step)
                    if cfg.freq_reg_end_step > 0:
                        self.logger.scalar(
                            "train/pe_alpha",
                            float(barf_alpha(done_step, cfg.freq_reg_start_step,
                                             cfg.freq_reg_end_step, self.field.pos_enc_deg)),
                            done_step)
                    dt = time.time() - tic
                    if dt > 0 and done_step > 0:
                        self.logger.scalar("perf/rays_per_sec", rays_done / dt, done_step)
                    next_log = done_step + log_every

                if done_step > 0 and done_step % self.save_freq == 0:
                    self._on_main(self.save)
                if self.validates and done_step > 0 and done_step % self.val_freq == 0:
                    self._on_main(self.validate)

            self.epoch += 1
            w_depth *= cfg.depth_weight_decay

        self._on_main(self.save)
        self.logger.flush()
        elapsed = time.time() - tic
        return {"steps": self.step, "epochs": self.epoch, "elapsed_s": elapsed,
                "rays_per_sec": rays_done / max(elapsed, 1e-9)}

    # ---- validation ----

    def render_view(self, sample, shadows=None, generator=None, depth_only=False):
        """One whole view through ``render_image`` in ``cfg.chunk`` blocks,
        without exploration, with the sampler's grid, through the masked
        view mid-ramp; a fresh generator seeded 0 when none is given, so
        each call draws the same jitter."""
        shadows = self.epoch_flags(self.epoch)[0] if shadows is None else shadows
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        rays = satrays_from_tensor(torch.as_tensor(sample["rays"]).to(self.device, torch.float32),
                                   torch.as_tensor(sample["ts"]).to(self.device))
        return render_image(self._reg_field(), rays, self.rcfg_eval, shadows, chunk=self.cfg.chunk,
                            generator=generator, occ_grid=self._occ_for_sampling(),
                            depth_only=depth_only)

    def validate(self):
        """Render up to ``n_val_images`` val views; log the test views'
        (i > 0) beta loss, PSNR and, with ``gt_dir``, registered DSM MAE
        means, image panels of views 0 and 1, and save ``epoch=best`` when
        the mean MAE improves."""
        from eonerf_code_tpu_torch.utils.viz import visualize_depth

        cfg = self.cfg
        n = min(cfg.n_val_images, self.val_ds.num_val_images())
        agg = {"loss": [], "coarse_color": [], "coarse_logbeta": [], "psnr": [], "mae": []}
        for i in range(n):
            sample = self.val_ds.get_val_sample(i)
            out = self.render_view(sample)
            rgbs = torch.as_tensor(sample["rgbs"]).to(self.device, torch.float32)
            _, ld = M.uncertainty_aware_loss(rgbs, out["rgb"], out["beta"])
            if i <= 1:
                # the reference's gt/pred/albedo/shadows/depth panel
                # (train_eonerf.py:235-249)
                h, w = sample["h"], sample["w"]
                rgb, albedo, shadow, depth = (out[k].float().cpu().numpy().reshape(h, w, -1)
                                              for k in ("rgb", "albedo_rgb", "geo_shadows", "depth"))
                panel = [sample["rgbs"].reshape(h, w, 3), rgb, albedo, shadow,
                         visualize_depth(depth[..., 0])]
                tag = "train_0/gt_pred_depth" if i == 0 else "val_0/gt_pred_depth"
                self.logger.image_panel(tag, panel, self.step)
            if i > 0:
                # loss and PSNR need no lidar GT (train_eonerf.py:199); the MAE does
                for k in ("loss", "coarse_color", "coarse_logbeta"):
                    agg[k].append(float(ld[k]))
                agg["psnr"].append(float(M.psnr(out["rgb"], rgbs)))
                if cfg.gt_dir is not None:
                    try:
                        agg["mae"].append(self._val_mae(sample, out))
                    except Exception:    # the MAE is best-effort during training
                        traceback.print_exc()
                        self.logger.scalar("val/mae_failed", 1.0, self.step)
        for k, v in agg.items():
            if v:
                self.logger.scalar(f"val/{k}", float(np.mean(v)), self.step)
        # the best-geometry model: late shadow and uncertainty training can
        # degrade the DSM, so the best-val-MAE checkpoint is the one to evaluate
        if agg["mae"] and float(np.mean(agg["mae"])) < self.best_val_mae:
            self.best_val_mae = float(np.mean(agg["mae"]))
            self.save(epoch_tag="best")
            self.logger.scalar("val/best_mae", self.best_val_mae, self.step)
        self.logger.flush()

    def _gt_grid_local(self):
        """The GT DSM on the device over its own grid in local scene
        coordinates, water-masked, cached: (gt (H, W), xoff_l, ytop_l, res)."""
        if self._gt_grid is not None:
            return self._gt_grid
        from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile

        cfg = self.cfg
        scene = self.train_ds.scene
        f = GeoTiffFile(os.path.join(cfg.gt_dir, f"{cfg.aoi_id}_DSM.tif"))
        gt = f.read(1).astype(np.float32)
        if f.nodata is not None and not np.isnan(f.nodata):
            gt = np.where(gt == f.nodata, np.nan, gt)
        cls_path = os.path.join(cfg.gt_dir, f"{cfg.aoi_id}_CLS.tif")
        if os.path.exists(cls_path):
            from eonerf_code_tpu_torch.eval.dsm import _load_water_mask

            water = _load_water_mask(cls_path)
            h_, w_ = min(water.shape[0], gt.shape[0]), min(water.shape[1], gt.shape[1])
            gt[:h_, :w_] = np.where(water[:h_, :w_], np.nan, gt[:h_, :w_])
        if cfg.ecef:
            # the ECEF cube's offset is the scene centre: its deltas map to
            # (easting, northing, altitude) through the exact-Jacobian frame
            from eonerf_code_tpu_torch.eval.device import ecef_to_utm_frame

            zs = scene.utm_zonestring
            zone = int("".join(c for c in zs if c.isdigit()))
            south = "".join(c for c in zs if c.isalpha()).upper() < "N"
            jac, (off_e, off_n, alt0) = ecef_to_utm_frame(scene.scene_offset, zone, south)
            self._ecef_frame = (torch.as_tensor(jac, dtype=torch.float32, device=self.device),
                                float(alt0))
        else:
            off_e, off_n = scene.scene_offset[0], scene.scene_offset[1]
        self._gt_grid = (torch.as_tensor(gt, device=self.device), float(f.bounds.left - off_e),
                         float(f.bounds.top - off_n), float(f.res[0]))
        return self._gt_grid

    def val_mae_device(self, sample, out):
        """Registered DSM MAE on the device: the depth denormalized in the
        local frame, splatted onto the GT grid, registered and compared
        (eval/device.py); no GeoTIFF, one host read of the result."""
        return float(self.val_dsm_device(sample, out)[0])

    def val_dsm_device(self, sample, out):
        """(MAE tensor, (dx, dy, bias)): :meth:`val_mae_device` with the
        registration it found, the shift in GT cells (the search's edge is
        +-5) and the altitude bias in metres."""
        from eonerf_code_tpu_torch.eval.device import device_dsm_mae, rasterize_local

        gt, xoff_l, ytop_l, res = self._gt_grid_local()
        scene = self.train_ds.scene
        rays = torch.as_tensor(sample["rays"]).to(self.device, torch.float32)
        depth = out["depth"].to(self.device, torch.float32).reshape(-1, 1)
        scale = torch.as_tensor(scene.scene_scale, dtype=torch.float32, device=self.device)
        xyz_l = (rays[:, 0:3] + rays[:, 3:6] * depth) * scale     # local metres
        if self.cfg.ecef:
            jac, alt0 = self._ecef_frame
            enu = xyz_l @ jac.T
            easts_l, norths_l, alts = enu[:, 0], enu[:, 1], alt0 + enu[:, 2]
        else:
            easts_l, norths_l = xyz_l[:, 0], xyz_l[:, 1]
            alts = xyz_l[:, 2] + float(scene.scene_offset[2])
        pred = rasterize_local(easts_l, norths_l, alts, xoff_l, ytop_l, res, gt.shape[1],
                               gt.shape[0])
        return device_dsm_mae(pred, gt)

    def _val_mae(self, sample, out):
        """The validation MAE: on the device (``device_eval`` None or True)
        with a host fallback logged as ``val/device_eval_fallback`` when
        None (True raises), on the host when False."""
        if self.cfg.device_eval is False:
            return self._val_mae_host(sample, out)
        try:
            return self.val_mae_device(sample, out)
        except Exception:
            if self.cfg.device_eval:
                raise
            traceback.print_exc()
            self.logger.scalar("val/device_eval_fallback", 1.0, self.step)
            return self._val_mae_host(sample, out)

    def _val_mae_host(self, sample, out):
        """The host GeoTIFF path: the view's DSM at the AOI's resolution
        (0.5 m JAX, 0.3 m IARPA, else the GT raster's), then
        eval/dsm.py's registration and MAE."""
        from eonerf_code_tpu_torch.eval.dsm import compute_mae_and_save_dsm_diff
        from eonerf_code_tpu_torch.io.geotiff import GeoTiffFile

        cfg = self.cfg
        aoi_id = cfg.aoi_id or sample["src_id"][:7]
        res = 0.5 if "JAX" in aoi_id else 0.3
        if cfg.aoi_id and not ("JAX" in aoi_id or "IARPA" in aoi_id):
            res = GeoTiffFile(os.path.join(cfg.gt_dir, f"{aoi_id}_DSM.tif")).res[0]
        val_dir = os.path.join(self.log_dir, "val")
        tmp = os.path.join(val_dir, f"tmp_dsm_{self.step}.tif")
        self.train_ds.dsm_from_depth(sample["rays"], out["depth"].float().cpu().numpy(),
                                     dsm_path=tmp, resolution=res)
        mae = compute_mae_and_save_dsm_diff(tmp, sample["src_id"], cfg.gt_dir, val_dir,
                                            self.epoch, aoi_id, save=False)
        os.remove(tmp)
        return mae
