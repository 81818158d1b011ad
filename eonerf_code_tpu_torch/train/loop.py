"""The EO-NeRF single-AOI training loop, as the JAX package's train/loop.py.

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
  gate history as plain lists; resume continues the same random stream and
  samples as the uninterrupted run.

The JAX package scans K steps inside one compiled call (its megastep); here
the steps are a plain Python loop. Waiting for the data-and-eval slice:
``SatelliteDataset`` (the caller hands the trainer its ray pool and the
scene's altitude envelope), validation and its DSM MAE.
"""

import dataclasses
import os
import time

import numpy as np
import torch

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import make_render_field
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.ops.volrend import render_weights, weight_entropy
from eonerf_code_tpu_torch.render.satellite import RenderConfig, render_rays
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.utils import metrics as M
from eonerf_code_tpu_torch.utils.tb import MetricsLogger

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
                 has_shadow=False):
    """Per-batch loss with the reference's schedule semantics
    (train_eonerf.py:139-155)."""

    def loss_fn(batch, w_depth, shadows, use_beta, generator=None, occ_grid=None):
        rays = satrays_from_tensor(batch["rays"], batch["ts"])
        out = render_rays(field, rays, rcfg, shadows, generator, occ_grid)
        if use_beta:
            loss, loss_dict = M.uncertainty_aware_loss(batch["rgbs"], out["rgb"], out["beta"])
        else:
            loss = M.mse(out["rgb"], batch["rgbs"])
            loss_dict = {"loss": loss, "coarse_color": loss}
        if has_depth:
            aux, aux_d = M.depth_loss_l2(batch["depth_prior"], out["depth"][:, 0],
                                         batch.get("conf_prior") if has_conf else None, w_depth)
            loss = loss + aux
            loss_dict.update(aux_d)
        if has_shadow and shadows:
            aux, aux_d = M.shadow_loss_l2(batch["shadow_prior"], out["geo_shadows"][:, 0])
            loss = loss + aux
            loss_dict.update(aux_d)
        loss_dict["psnr"] = M.psnr(out["rgb"], batch["rgbs"])
        return loss, loss_dict

    return loss_fn


def make_train_step(field, optimizer, lr_schedule, rcfg: RenderConfig, has_depth=False,
                    has_conf=False, has_shadow=False):
    """One training step on ``field`` (an EONerfField or its KernelField),
    updating the optimizer's parameters in place. Returns
    ``step_fn(batch, step, w_depth, shadows, use_beta, generator=None,
    occ_grid=None)`` -> the loss dict (detached)."""
    loss_fn = make_loss_fn(field, rcfg, has_depth, has_conf, has_shadow)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step_fn(batch, step, w_depth, shadows, use_beta, generator=None, occ_grid=None):
        optimizer.zero_grad(set_to_none=False)
        loss, loss_dict = loss_fn(batch, w_depth, shadows, use_beta, generator, occ_grid)
        loss.backward()
        for p in params:
            # optax updates every parameter, an unused one with a zero
            # gradient (its moments decay); torch.optim skips a None grad
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = lr_schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        return {k: v.detach() if torch.is_tensor(v) else v for k, v in loss_dict.items()}

    return step_fn


def check_supported(cfg: TrainConfig):
    """Raise for the options whose code waits for a later slice of the port."""
    later = []
    if cfg.freq_reg_end_step > 0:
        later.append("freq_reg_end_step > 0 (coarse-to-fine PE annealing: bundle-adjustment "
                     "slice)")
    # an int8 tier takes the recompute backward whatever bwd_acts says (the
    # JAX package's fallback, announced by make_render_field)
    int8_saved = cfg.bwd_acts == "saved" and cfg.trunk_quant != "none"
    if cfg.bwd_acts != "recompute" and not int8_saved:
        later.append(f"bwd_acts={cfg.bwd_acts!r} (the saved-activations stream: a later "
                     "kernel slice; use 'recompute')")
    if later:
        raise NotImplementedError("not in the port yet: " + "; ".join(later))


class Trainer:
    """Single-AOI trainer over a ray pool given by the caller: ``data`` holds
    ``rays`` (N, 11), ``rgbs`` (N, 3), ``ts`` (N,) image indices and
    optionally ``depth_prior``, ``conf_prior``, ``shadow_prior`` (N,), as the
    JAX package's Trainer builds them from its dataset; ``n_images`` sizes
    the per-image embeddings; ``alt_envelope`` = (lo, hi), the scene's
    altitude envelope in metres, is what ``sampler="auto"`` reads. Runs on
    ``device`` (the card by default)."""

    def __init__(self, cfg: TrainConfig, data, n_images, device="cuda", alt_envelope=None):
        check_supported(cfg)
        self.cfg = cfg
        self.alt_envelope = alt_envelope
        self.device = torch.device(device)
        self.log_dir = cfg.log_dir()
        os.makedirs(self.log_dir, exist_ok=True)
        # the sampler resolves before opts.json is written (a reload never
        # re-guesses), and sc_n_samples after it (hierarchical rewrites
        # n_samples, which the auto rule reads)
        self._resolve_sampler()
        cfg.sc_n_samples = cfg.resolve_sc_n_samples()
        cfg.save(os.path.join(self.log_dir, "opts.json"))
        self.logger = MetricsLogger(self.log_dir)

        unknown = set(data) - set(_POOL_DTYPES)
        if unknown:
            raise ValueError(f"unknown ray-pool entries {sorted(unknown)}")
        self.device_data = {k: torch.as_tensor(v).to(self.device, _POOL_DTYPES[k])
                            for k, v in data.items()}
        self.n_rays = self.device_data["rays"].shape[0]
        self.n_images = n_images
        self.steps_per_epoch = max(self.n_rays // cfg.batch_size, 1)
        self.save_freq = cfg.save_freq or 4 * self.steps_per_epoch

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
        self.train_step = make_train_step(
            self.render_field, self.optimizer, self.lr_schedule, self.rcfg,
            has_depth="depth_prior" in data, has_conf="conf_prior" in data,
            has_shadow="shadow_prior" in data)
        # one stream for the epoch permutations, the sampling jitter and the
        # occupancy probes
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.step = 0
        self.epoch = 0
        # one occupied fraction and (with the entropy gate) one probe entropy
        # per grid update: the tightening gates read them
        self._occ_frac_hist = []
        self._entropy_hist = []
        if cfg.ckpt_path:
            self.restore(cfg.ckpt_path)

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
                          "entropy_hist": list(self._entropy_hist)}}
        if self.occ_grid is not None:
            state["occ"] = {"occs": self.occ_grid.occs, "binaries": self.occ_grid.binaries}
        return state

    def save(self, epoch_tag=None):
        return ckpt_lib.save_checkpoint(
            self.log_dir, self.epoch if epoch_tag is None else epoch_tag, self._state())

    def restore(self, path):
        state = ckpt_lib.restore_checkpoint(path, map_location="cpu")
        self.field.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.generator.set_state(state["rng"])
        if self.occ_grid is not None and "occ" in state:
            self.occ_grid = dataclasses.replace(
                self.occ_grid, occs=state["occ"]["occs"].to(self.device),
                binaries=state["occ"]["binaries"].to(self.device))
        gate = state.get("gate", {})     # a checkpoint from before the grid has none
        self._occ_frac_hist = list(gate.get("frac_hist", []))
        self._entropy_hist = list(gate.get("entropy_hist", []))

    # ---- occupancy gates ----

    def _occ_update(self):
        """One grid update through the plain field's density (a matrix
        product, not a kernel of the port)."""
        with torch.no_grad():
            self.occ_grid = self.occ_grid.update(
                self.field.density, self.render_step_size, max_cells=self.cfg.occ_max_cells,
                generator=self.generator)

    def _occ_grid_stable(self, window=5, tol=0.05, tol_drift=0.025):
        """True once the occupied fraction has stopped moving: every entry
        of the last ``window`` within ``tol`` of the latest, and the drift
        across the window under ``tol_drift`` (a slow monotonic drift stays
        under the scatter tolerance while the grid is still moving)."""
        h = self._occ_frac_hist
        if len(h) < window:
            return False
        ref, first = h[-1], h[-window]
        if ref <= 0 or first <= 0:
            return False
        return (max(abs(x - ref) for x in h[-window:]) / ref < tol
                and abs(ref - first) / first < tol_drift)

    def _weight_entropy(self):
        """Mean normalized weight entropy over the opaque ones of up to 2048
        fixed, evenly strided pool rays, density-rendered with up to 64
        uniform samples (the probe must not depend on the grid it gates);
        1.0 when no ray is opaque yet. On a kernel-backed field the density
        runs through the density kernel, one launch per probe."""
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
            w, _, _ = render_weights(self.render_field.density(pos).float(), delta)
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
            if self.step > 0:
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
                    self._occ_update()
                    if cfg.occ_tighten:
                        self._occ_frac_hist.append(float(self.occ_grid.binaries.float().mean()))
                        if cfg.occ_entropy_max is not None:
                            h = self._weight_entropy()
                            self._entropy_hist.append(h)
                            self.logger.scalar("occ/weight_entropy", h, self.step)
                idx = perm[i * bs:(i + 1) * bs]
                batch = {k: v[idx] for k, v in self.device_data.items()}
                loss_dict = self.train_step(batch, self.step, w_depth, shadows, use_beta,
                                            self.generator, self._occ_for_sampling())
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
                    dt = time.time() - tic
                    if dt > 0 and done_step > 0:
                        self.logger.scalar("perf/rays_per_sec", rays_done / dt, done_step)
                    next_log = done_step + log_every

                if done_step > 0 and done_step % self.save_freq == 0:
                    self.save()

            self.epoch += 1
            w_depth *= cfg.depth_weight_decay

        self.save()
        self.logger.flush()
        elapsed = time.time() - tic
        return {"steps": self.step, "epochs": self.epoch, "elapsed_s": elapsed,
                "rays_per_sec": rays_done / max(elapsed, 1e-9)}
