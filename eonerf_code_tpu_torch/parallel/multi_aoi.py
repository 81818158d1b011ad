"""Multi-AOI training: S independent AOI scenes, one model each, in one
process or over a ("scene", "data") grid of processes (the JAX package's
parallel/multi_aoi.py).

- Every scene has its own ``EONerfField`` (embedding tables sized to the
  largest scene's image count; the rows a smaller scene never draws get a
  zero gradient), its own Adam, its own occupancy grid, and, with
  ``use_pallas``, its own kernel field. Scene i's initial weights come
  from (seed, i).
- The scene groups of the mesh (parallel/mesh.py) split the scenes into
  contiguous runs; a process holds and trains its group's scenes only. Each
  scene's ray batch is split over its group's data ranks as the
  single-AOI trainer splits one (``make_train_step(mesh=...)``: each rank
  renders its rows of the global batch, one all-reduce a step sums the
  gradients within the data group). No collective crosses scenes but the
  gathers of the per-scene values every rank must see (losses, occupied
  fractions, a pod checkpoint's state: ``Mesh.gather_rows(axis="scene")``).
- Where the JAX package vmaps the single-scene step over the stacked
  scenes (one compiled program, one kernel launch over the local scenes),
  the port loops over its scenes: a step launches the kernels once a
  scene.
- Ray pools are wrap-padded to the largest scene's length and stacked
  (S, N_max, ...); each scene's draws are uniform over its true ray count,
  so the padding is never drawn. Scenes without a depth or shadow prior see
  neutral sentinels (depth -1, confidence 10, shadow 1), which zero their
  terms exactly, so one loss serves every scene.
- Random numbers are a pure function of (seed, step, scene): each step's
  batch indices and jitter come from a generator seeded from them, the grid
  updates from another. Scene i's draws depend neither on S nor on the
  split, and a resumed run replays an uninterrupted one bit for bit (the
  JAX package's fold_in(base, 2 step) and fold_in(base, 2 step + 1) give it
  the same property with another stream).
- Pod checkpoints (:meth:`MultiAOITrainer.save_pod`) hold the stacked state
  of every scene: parameters, Adam's moments and count, step, occupancy
  grids and the gate history (a NaN-padded tail ring, and the
  ``pod_occ_sampling.json`` sidecar).
"""

import json
import os
import types

import numpy as np
import torch

from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.freq_reg import step_pe_mask
from eonerf_code_tpu_torch.models.fused import make_render_field
from eonerf_code_tpu_torch.models.encoders import sinusoidal_latent_dim
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.ops.sampling import RowShare
from eonerf_code_tpu_torch.parallel import mesh as pmesh
from eonerf_code_tpu_torch.render.satellite import RenderConfig
from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
from eonerf_code_tpu_torch.train.loop import (
    _POOL_DTYPES,
    make_optimizer,
    make_train_step,
    occ_hist_stable,
    ray_pool,
)

POD_SIDECAR = "pod_occ_sampling.json"
# the loss dict's terms, summed in the JAX scene loss's order
_LOSS_TERMS = ("loss", "depth_l2", "shadows_term1")
# what a seed is drawn for
_INIT, _STEP, _GRID = 0, 1, 2


def stack_params(states):
    """Per-scene state dicts -> one dict of (S, ...) tensors."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def unstack_params(stacked, n_scenes):
    """Inverse of :func:`stack_params`."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_scenes)]


def scene_seed(*parts):
    """A 64-bit seed from non-negative integers (seed, purpose, step, scene)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(1, np.uint64)[0])


def adam_state(optimizer, field):
    """``optimizer``'s Adam state over ``field``'s parameters as optax keeps
    it: {"count", "mu": {name: exp_avg}, "nu": {name: exp_avg_sq}} (count 0
    and zero moments before the first step)."""
    names = [n for n, _ in field.named_parameters()]
    state = optimizer.state_dict()["state"]
    if not state:
        zeros = {n: torch.zeros_like(p) for n, p in field.named_parameters()}
        return {"count": torch.tensor(0.0), "mu": zeros,
                "nu": {n: z.clone() for n, z in zeros.items()}}
    return {"count": state[0]["step"].detach().clone().float().cpu(),
            "mu": {n: state[i]["exp_avg"] for i, n in enumerate(names)},
            "nu": {n: state[i]["exp_avg_sq"] for i, n in enumerate(names)}}


def load_adam_state(optimizer, field, count, mu, nu):
    """Set ``optimizer``'s Adam state from :func:`adam_state`'s form."""
    names = [n for n, _ in field.named_parameters()]
    sd = optimizer.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(count)), "exp_avg": mu[n].clone(),
                       "exp_avg_sq": nu[n].clone()} for i, n in enumerate(names)}
    optimizer.load_state_dict(sd)


class MultiAOITrainer:
    """Scene-parallel trainer over device-resident per-scene ray pools, on
    ``mesh`` (a ``parallel.mesh.Mesh``; None: one process on ``device``).
    The arguments and defaults are the JAX package's ``MultiAOITrainer``'s
    (``cfg`` is accepted and unused there too; ``interpret`` has no
    counterpart); ``compute_dtype`` is a torch dtype or its name;
    ``use_pallas`` True renders through the kernels (``KernelField``: the
    fused kernels on the card, their plain versions on CPU tensors), False
    through the field, None by ``make_render_field``'s rule. ``n_images``
    overrides the embedding tables' rows (default: the largest scene's
    image count)."""

    GATE_HIST_LEN = 8

    def __init__(self, datasets, mesh=None, cfg=None, n_samples=64, batch_size=1024,
                 lr=5e-4, net_depth=8, net_width=256, seed=42, compute_dtype=torch.float32,
                 use_pallas=False, bwd_acts="saved", perturb=True, freq_reg_start_step=0,
                 freq_reg_end_step=0, sc_n_samples=0, rpc_correction=False, n_importance=0,
                 occ_enabled=False, occ_tighten=False, occ_tighten_start_step=2000,
                 occ_update_every=50, n_grid=64, occ_max_cells=65536, lr_decay_steps=None,
                 lr_gamma=0.9, device="cuda", n_images=None):
        self.mesh = pmesh.Mesh.single(device) if mesh is None else mesh
        self.device = self.mesh.device
        self.n_scenes = len(datasets)
        n_groups = self.mesh.shape["scene"]
        if self.n_scenes % n_groups:
            raise ValueError(f"{self.n_scenes} scenes do not tile a scene axis of {n_groups}")
        if batch_size % self.mesh.world:
            raise ValueError(f"batch_size={batch_size} does not divide over "
                             f"{self.mesh.world} data ranks")
        per = self.n_scenes // n_groups
        self.local = list(range(self.mesh.scene_rank * per, (self.mesh.scene_rank + 1) * per))
        self.batch_size = batch_size
        self.seed = seed
        self.rcfg = RenderConfig(n_samples=n_samples, sc_n_samples=sc_n_samples or n_samples,
                                 n_importance=n_importance, occ_tighten=occ_tighten,
                                 occ_tighten_shadows=occ_tighten, perturb=perturb)
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        n_images = n_images or max(len(d.json_files) for d in datasets)
        self.n_images = n_images
        backend = TrainConfig(use_pallas=use_pallas, bwd_acts=bwd_acts)
        self.fields, self.render_fields, self.optimizers = [], [], []
        for i in self.local:
            field = EONerfField(n_images, net_depth=net_depth, net_width=net_width,
                                rpc_correction=rpc_correction, compute_dtype=compute_dtype,
                                device=self.device,
                                generator=torch.Generator().manual_seed(scene_seed(seed, _INIT, i)))
            self.fields.append(field)
            self.render_fields.append(make_render_field(field, backend))
            self.optimizers.append(make_optimizer(field.parameters(), TrainConfig(lr=lr)))
        self.pos_enc_deg = self.fields[0].pos_enc_deg
        # the single-AOI StepLR rule per lr_decay_steps steps, else constant
        # (not the single-AOI trainer's per-epoch default)
        if lr_decay_steps:
            self._lr_fn = lambda step: lr * lr_gamma ** (step // lr_decay_steps)
        else:
            self._lr_fn = lambda step: lr

        self.n_rays_per_scene = np.array([d.all_rays.shape[0] for d in datasets], np.int32)
        n_max = int(self.n_rays_per_scene.max())
        self.n_rays = n_max     # the padded pool length

        def pad(x):
            # wrap-pad: the fill is real data but never drawn
            x = np.asarray(x)
            reps = -(-n_max // x.shape[0])
            return x if x.shape[0] == n_max else np.concatenate([x] * reps, axis=0)[:n_max]

        # the priors: scenes without one see neutral sentinels that zero
        # its term exactly (depth -1: invalid; conf 10: passes the >= 4
        # mask, so only the depth decides; shadow 1: all lit)
        self._has_depth = any(d.prior_depths is not None for d in datasets)
        self._has_conf = self._has_depth and any(d.prior_confs is not None for d in datasets)
        self._has_shadow_prior = any(d.prior_shadows is not None for d in datasets)
        sentinels = {"depth_prior": -1.0, "conf_prior": 10.0, "shadow_prior": 1.0}
        keys = ["rays", "rgbs", "ts"] + [k for k, on in (
            ("depth_prior", self._has_depth), ("conf_prior", self._has_conf),
            ("shadow_prior", self._has_shadow_prior)) if on]
        pools = [ray_pool(datasets[i]) for i in self.local]
        self.data = {k: torch.stack([
            torch.as_tensor(pad(pool[k] if k in pool else np.full(
                (pool["rays"].shape[0],), sentinels[k], np.float32))).to(self.device,
                                                                        _POOL_DTYPES[k])
            for pool in pools]) for k in keys}
        # the depth weight 100 * 0.8^epoch, the epoch from the smallest
        # scene's pool
        self._steps_per_epoch = max(int(self.n_rays_per_scene.min()) // batch_size, 1)
        self.depth_weight, self.depth_weight_decay = 100.0, 0.8

        # per-scene occupancy grids; the stability gate opens only when
        # every scene's grid is stable (one sampling mode for all scenes)
        self.occ_enabled = occ_enabled
        self.occ_tighten = occ_tighten
        self.occ_tighten_start_step = occ_tighten_start_step
        self.occ_update_every = occ_update_every
        self.occ_max_cells = occ_max_cells
        self._occ_frac_hist = []    # (S,) float32 occupied fractions, one an update
        self._render_step_size = 2.0 / n_samples
        self.occ_grids = ([OccupancyGrid.create(n_grid, device=self.device) for _ in self.local]
                          if occ_enabled else None)
        self._freq_reg = types.SimpleNamespace(freq_reg_start_step=freq_reg_start_step,
                                               freq_reg_end_step=freq_reg_end_step)
        self._steps = [make_train_step(rf, opt, self._lr_fn, self.rcfg, self._has_depth,
                                       self._has_conf, self._has_shadow_prior, mesh=self.mesh)
                       for rf, opt in zip(self.render_fields, self.optimizers)]
        self.step = 0

    # ---- schedule, annealing, gates ----

    def lr_at(self, step):
        """The optimizer's learning rate at a step."""
        return float(self._lr_fn(step))

    def _pe_mask(self, step):
        """(latent,) coarse-to-fine mask of a step; all-ones when the
        annealing is off (the JAX scene loss applies it always; the step
        here passes None then, the same function)."""
        mask = step_pe_mask(self._freq_reg, step, self.pos_enc_deg, self.device)
        if mask is None:
            return torch.ones(sinusoidal_latent_dim(3, 0, self.pos_enc_deg), device=self.device)
        return mask

    def _grids_stable(self, window=5, tol=0.05, tol_drift=0.025):
        """The single-AOI stability test on EVERY scene's occupied-fraction
        history (``train.loop.occ_hist_stable``)."""
        return occ_hist_stable(self._occ_frac_hist, window, tol, tol_drift)

    def occ_gate_open(self, step=None):
        """True when tightened sampling is on: past the warm-up step and
        every scene's grid stable."""
        step = self.step if step is None else step
        return bool(self.occ_tighten and self.occ_grids is not None
                    and step >= self.occ_tighten_start_step and self._grids_stable())

    def _gather_scenes(self, local):
        """{key: (S, ...)} on every rank from this rank's {key: (local S, ...)}."""
        return self.mesh.gather_rows(local, self.local[0], self.n_scenes, axis="scene")

    def _maybe_update_grids(self):
        """Every ``occ_update_every`` steps, before the step: each local
        scene's grid updated through its plain field's density (its own
        generator), data rank 0's grids on every rank of the group, and with
        tightening every scene's occupied fraction appended to the
        history."""
        if self.occ_grids is None or self.step % self.occ_update_every != 0:
            return
        with torch.no_grad():
            for j, i in enumerate(self.local):
                gen = torch.Generator(device=self.device).manual_seed(
                    scene_seed(self.seed, _GRID, self.step, i))
                self.occ_grids[j] = self.occ_grids[j].update(
                    self.fields[j].density, self._render_step_size,
                    max_cells=self.occ_max_cells, generator=gen)
        self.mesh.broadcast_([t for g in self.occ_grids for t in (g.occs, g.binaries)])
        if self.occ_tighten:
            fracs = torch.stack([g.binaries.float().mean() for g in self.occ_grids])
            self._occ_frac_hist.append(
                self._gather_scenes({"frac": fracs})["frac"].cpu().numpy())

    # ---- training ----

    def _draw(self, i, step):
        """Scene ``i``'s generator at ``step`` and the global batch it draws
        first: indices uniform over the scene's true ray count (the padding
        is never drawn), then the step's jitter."""
        gen = torch.Generator(device=self.device).manual_seed(
            scene_seed(self.seed, _STEP, step, i))
        return gen, torch.randint(0, int(self.n_rays_per_scene[i]), (self.batch_size,),
                                  generator=gen, device=self.device)

    def train_steps(self, n_steps, shadows=False, idx=None):
        """Run ``n_steps`` steps of every scene; returns the (S,) losses of
        the last step (float32, on the CPU). ``idx`` (S, batch) gives every
        step's global batch indices instead of the draws (tests)."""
        losses = None
        mesh = self.mesh
        for _ in range(n_steps):
            self._maybe_update_grids()
            occ = self.occ_gate_open()
            w_depth = self.depth_weight * self.depth_weight_decay ** (
                self.step // self._steps_per_epoch)
            pe_mask = step_pe_mask(self._freq_reg, self.step, self.pos_enc_deg, self.device)
            step_losses = []
            for j, i in enumerate(self.local):
                gen, ix = self._draw(i, self.step)
                if idx is not None:
                    ix = torch.as_tensor(np.asarray(idx[i]), dtype=torch.long, device=self.device)
                global_batch = {k: v[j][ix] for k, v in self.data.items()}
                batch = {k: pmesh.shard_rows(v, mesh.rank, mesh.world)
                         for k, v in global_batch.items()}
                ld = self._steps[j](batch, self.step, w_depth, shadows, True,
                                    RowShare(gen, mesh.rank, mesh.world),
                                    self.occ_grids[j] if occ else None, pe_mask=pe_mask,
                                    global_batch=global_batch)
                total = ld["loss"]
                for k in _LOSS_TERMS[1:]:
                    if k in ld:
                        total = total + ld[k]
                step_losses.append(total.float())
            losses = step_losses
            self.step += 1
        if losses is None:
            return None
        return self._gather_scenes({"loss": torch.stack(losses)})["loss"].cpu()

    # ---- pod checkpoints ----

    def _gate_pytree(self):
        """The gate history's tail as a NaN-padded (GATE_HIST_LEN, S) ring,
        its length and the gate's verdict."""
        ring = np.full((self.GATE_HIST_LEN, self.n_scenes), np.nan, np.float32)
        tail = self._occ_frac_hist[-self.GATE_HIST_LEN:]
        if tail:
            ring[-len(tail):] = np.stack(tail)
        return {"frac_hist": torch.from_numpy(ring), "n_frac": len(self._occ_frac_hist),
                "tighten_active": int(self.occ_gate_open())}

    def state_pytree(self):
        """Every scene's training state, stacked (S, ...), on every rank (a
        collective over the scene axis): {"params", "opt_state": {"count",
        "mu", "nu"}, "step", "gate", "occ"}."""
        local = {}
        for j, (field, opt) in enumerate(zip(self.fields, self.optimizers)):
            adam = adam_state(opt, field)
            rows = {f"params/{k}": v for k, v in field.state_dict().items()}
            rows.update({f"mu/{k}": v for k, v in adam["mu"].items()})
            rows.update({f"nu/{k}": v for k, v in adam["nu"].items()})
            rows["count"] = adam["count"].to(self.device)
            if self.occ_grids is not None:
                rows["occs"], rows["binaries"] = self.occ_grids[j].occs, self.occ_grids[j].binaries
            for k, v in rows.items():
                local.setdefault(k, []).append(v.detach())
        got = {k: v.cpu() for k, v in self._gather_scenes(
            {k: torch.stack(v) for k, v in local.items()}).items()}

        def part(prefix):
            return {k[len(prefix):]: v for k, v in got.items() if k.startswith(prefix)}

        state = {"params": part("params/"),
                 "opt_state": {"count": got["count"], "mu": part("mu/"), "nu": part("nu/")},
                 "step": self.step, "gate": self._gate_pytree()}
        if self.occ_grids is not None:
            state["occ"] = {"occs": got["occs"], "binaries": got["binaries"]}
        return state

    def save_pod(self, pod_dir, state=None):
        """Checkpoint every scene's state (:meth:`state_pytree`, or
        ``state``) under ``pod_dir/ckpts/epoch=<step>`` with the
        ``pod_occ_sampling.json`` sidecar (the per-scene gate history);
        written by the mesh's rank 0. Returns the checkpoint path."""
        state = self.state_pytree() if state is None else state
        path = ckpt_lib._ckpt_dir(pod_dir, self.step)
        if self.mesh.is_root:
            side = {"occ_frac_hist": [np.asarray(h).tolist() for h in self._occ_frac_hist],
                    "tighten_active": self.occ_gate_open()}
            ckpt_lib.save_checkpoint(pod_dir, self.step, state, sidecars={POD_SIDECAR: side})
        self.mesh.barrier()
        return path

    def restore_pod(self, path):
        """Restore a :meth:`save_pod` checkpoint (this rank's scenes), the
        step and the gate history: the sidecar (under its old name,
        ``occ_sampling.json``, in checkpoints from before the rename), else
        the checkpoint's ring. A checkpoint from before the gate pytree
        restores with an empty history (the JAX package retries its restore
        without the gate's template; a torch checkpoint has no template)."""
        state = ckpt_lib.restore_checkpoint(path, map_location="cpu")
        opt = state["opt_state"]
        for j, i in enumerate(self.local):
            self.fields[j].load_state_dict({k: v[i] for k, v in state["params"].items()})
            load_adam_state(self.optimizers[j], self.fields[j], opt["count"][i],
                            {k: v[i] for k, v in opt["mu"].items()},
                            {k: v[i] for k, v in opt["nu"].items()})
            if self.occ_grids is not None and "occ" in state:
                self.occ_grids[j] = OccupancyGrid(
                    occs=state["occ"]["occs"][i].to(self.device),
                    binaries=state["occ"]["binaries"][i].to(self.device),
                    resolution=self.occ_grids[j].resolution)
        self.step = int(state["step"])
        sidecar = os.path.join(path, POD_SIDECAR)
        if not os.path.exists(sidecar):
            sidecar = os.path.join(path, "occ_sampling.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                side = json.load(f)
            self._occ_frac_hist = [np.asarray(h, np.float32)
                                   for h in side.get("occ_frac_hist", [])]
        elif "gate" in state:
            ring = np.asarray(state["gate"]["frac_hist"], np.float32)
            self._occ_frac_hist = [row for row in ring if not np.any(np.isnan(row))]
        else:
            self._occ_frac_hist = []

    # ---- per-scene views ----

    def _local_index(self, i):
        if i not in self.local:
            raise ValueError(f"scene {i} is trained by scene group {i // len(self.local)}, "
                             f"not by this process's ({self.mesh.scene_rank})")
        return self.local.index(i)

    def scene_params(self, i):
        """Scene ``i``'s parameters (a state dict; this process's scenes)."""
        return {k: v.detach().clone()
                for k, v in self.fields[self._local_index(i)].state_dict().items()}

    def scene_occ_state(self, i):
        """Scene ``i``'s occupancy arrays in the single-AOI checkpoint
        contract ({"occs", "binaries"}), or None when the grid is off."""
        if self.occ_grids is None:
            return None
        g = self.occ_grids[self._local_index(i)]
        return {"occs": g.occs.cpu(), "binaries": g.binaries.cpu()}
