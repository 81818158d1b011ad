#!/usr/bin/env python3
"""Drive the PyTorch port's render-and-DSM path, its training step, its
saved-activations backward, its sampler=auto training (hierarchical and
occupancy-tightened), its per-sample branch (ray entropy and the nadir
diagnostics, render and training), its int8 trunk tier (trunk_quant int8
and int8_full, render and training), the JAX package's default
training run from a generated scene on disk with its validation (the val
split rendered whole, the registered DSM MAE on the card, the best
checkpoint), its kernel-variant bench, trained runs (the synthetic
scene's registered MAE after 2000 steps, and bundle adjustment under
coarse-to-fine PE annealing), data parallel and multi-AOI training, and
the vanilla-NeRF path (train_mlp_nerf_torch.py on a Blender scene), the
native host library and the production-scale scene, once on one CUDA
card.

    python3 chip_smoke.py

Phases (one JSON line each; any failure raises and exits non-zero):

1. build       - nvcc builds the two libraries from the checkout
                 (eonerf_code_tpu_torch/csrc/fused_render.cu and
                 kernel_variants.cu) and g++ the native host library
                 (csrc/geo_native.cpp), all started together, into the
                 git-ignored eonerf_code_tpu_torch/_build/.
2. kernels     - every kernel against its plain PyTorch version at its
                 main-path shapes, full 8x256 bf16 field: the camera and
                 shadow forwards at the render shapes (4096 rays; camera
                 K=127 and, hierarchical, K=143 after sample_pdf; shadow
                 K=63), their backwards at the training shapes (1024 rays,
                 camera K=127 and K=143, a random cotangent), the
                 coarse-weights kernel at the hierarchical render's (4096
                 rays, K=95), the density kernel at the entropy probe's
                 (2048 x 64 points) and at the diagnostics render's shadow
                 pass and probes (4096 x 63), the per-point field kernel at
                 a render chunk's camera samples (4096 x 127 points), its
                 backward at a training batch's (1024 x 127) and the density
                 backward at the batch's shadow samples (1024 x 63), random
                 cotangents: errors, kernel / plain / bound times, in-cube
                 samples and TFLOP/s reached; for the streamed camera, shadow
                 and coarse forwards the rows they computed (the samples
                 with deltam != 0) against the padded samples, and a
                 table of the clock cycles a tile spends in each phase,
                 the point modes' field and density tiles with them
                 (stream_fwd_phases, from an instrumented copy of csrc/
                 built beside the libraries; bench/stream_fwd.py); the
                 point forwards also at ragged point counts (1, 127, 129
                 and a partial last tile: point_fwd_ragged), every point
                 forward's call one launch of its mode by the library's
                 counter (fused_field.point_fwd_kernel_launches). Then the
                 int8 trunk tier's
                 launches at the same shapes (forwards in scale groups of the
                 2048-row target, backwards of the 1024-row one, int8 and
                 int8_full), each against its plain version, with the group
                 amax each quantized with, and each one's int8 trunk alone
                 (fused_render.q8_trunk): the path the shape takes (one
                 cluster launch, or layer-major past 16 CTAs a group), the
                 cluster's CTAs, the clusters the card holds at once, the
                 trunk's CUDA-event time against its bound and beside the
                 layer-major path's on the same inputs, both paths' stream
                 columns and group amax the same bits. Then int8_full's
                 trunk backward alone at the training shapes (camera K=127,
                 shadow K=63): the cotangent chain (q8_chain_cluster_kernel)
                 and the weight gradient (q8_wgrad_kernel) each timed alone
                 on a workspace the whole call filled, held against the
                 plain trunk backward on that call's own inputs, whose two
                 halves (fused_field.trunk_chain_q8, trunk_wgrad_q8) are
                 timed as each kernel's plain version (the PE cotangent,
                 the cotangent amax and the weight gradients the same bits,
                 the bias sums within 1e-6), beside their bounds and their
                 library yardsticks (bench/q8_backward.py). Then the
                 saved-activations pair at
                 the training shapes (camera K=127 and K=143, shadow K=63):
                 the forward that writes the activation stream (the
                 streamed forward's save mode, one launch by the library's
                 count of that mode) against its
                 plain version (outputs, and h0..h7 of the stream) and bit
                 for bit against the non-saving kernel, the backward from the
                 stream against the plain backward from the plain
                 activations and against the recompute kernel (rel-L2 1e-6;
                 the same bits expected), with the stream's MiB; then, for
                 the saved camera (K=127) and shadow backwards, their four
                 launches timed one by one beside the wgrad and dgrad
                 passes' library yardsticks, each launch's bound and its
                 share of it, and (camera) the dgrad kernel's phases (clock
                 cycles a tile, from an instrumented copy of csrc/ built
                 beside the two libraries) (bench/backward_passes.py). A
                 second shape of a kernel goes into its summary row under
                 other_shapes.
3. render      - a full-width EONerfField (20 images, seeded init, bf16)
                 behind make_render_field renders a 512x512 orthographic
                 nadir sweep with shadows in 4096-ray chunks. All 13
                 outputs must have their shapes and be finite, each kernel
                 must have launched once per chunk (the streamed forward's
                 launches by the library's own count), and a 1024-ray subset
                 must agree with the per-sample (non-kernel) path.
4. dsm         - the rendered depth is rasterised to a DSM on the card, and
                 device_dsm_mae must recover a known shift and z-bias
                 applied to a copy of it. The field is untrained: this
                 checks the machinery, not quality.
5. render_hier - the same sweep with hierarchical sampling (96 coarse + 48
                 fine camera samples, 64 shadow samples): the coarse,
                 camera and shadow kernels each once per chunk, outputs
                 finite, a 1024-ray subset against the per-sample path.
6. train       - Trainer.run takes 20 steps (batch 1024, 128 camera and 64
                 shadow samples, uniform sampler, shadows and the beta loss
                 from step 10) of a full-width bf16 field on a
                 device-resident pool of 2^20 seeded rays over 20 oblique
                 views with their own sun directions. Every loss must be
                 finite, the parameters must move, each kernel must launch
                 once per step that runs it, and on one batch the
                 whole-step gradient through the kernels must agree with
                 the gradient through the per-sample module path. Then 10
                 more steps are timed: rays/s and ms per step split into
                 forward kernels, backward kernels, optimizer and the rest.
6b. train_saved - phase 6's configuration with bwd_acts="saved" (the JAX
                 package's default): the save forwards and the saved
                 backwards once per step that runs them (the save forwards
                 also by the library's count of the save mode), the plain
                 forwards and the recompute backwards never, step_save_ok
                 true, one
                 batch's whole-step gradient against the recompute
                 backward's (rel-L2 1e-6), 10 timed steps beside phase 6's.
7. train_auto  - Trainer with sampler="auto" and the occupancy grid at the
                 JAX package's defaults (n_grid 128, 262,144 cells a
                 grid update, batch 1024, n_samples 128), on the same pool:
                 a wide altitude envelope resolves to hierarchical sampling
                 (96 + 48; the coarse kernel once per step; 20 steps, then
                 10 timed), a compact one to occupancy tightening (12
                 steps, grid updates at steps 0 and 8, each with the
                 entropy probe through the density kernel, by the wrapper's
                 count and the library's). The tightening
                 gates need a stable history that a few steps cannot build:
                 after the first grid update the phase seeds five copies of
                 its occupied fraction, as the JAX package's tests seed a
                 converged history, so steps 1-7 sample tightened (checked,
                 and timed). Losses finite, parameters moved, ms per step.
8. render_diag - the phase-3 sweep with ray entropy and the nadir
                 diagnostics on, which take the per-sample branch: the
                 field kernel once per chunk, the density kernel three times
                 (shadow pass, downward and upward probe), the camera and
                 shadow kernels never, by the wrappers' counts and the
                 library's (the point modes' launches). Outputs finite, entropy in
                 [0, log10(127)], the probes in [0, 1]; on a 1024-ray subset
                 depth and rgb against the fused branch, the diagnostics
                 against the per-sample module path; rays/s and chunk ms
                 against the kernels timed alone.
9. train_diag  - make_train_step on the kernel-backed field of a new
                 full-width bf16 field with ray entropy on (the per-sample
                 branch), batch 1024, 128 camera and 64 shadow samples, 20
                 steps on the pool, shadows and the beta loss from step 10:
                 the field kernel forward and backward once per step, the
                 density kernel forward and backward once per shadow step
                 (the forwards by the library's count as well). Losses finite, parameters moved, the whole-step gradient of
                 one batch against the per-sample module path; then 10
                 timed steps.
10. render_q8  - the phase-3 and phase-5 sweeps through
                 make_render_field(field, TrainConfig(trunk_quant="int8")):
                 the int8 camera, shadow (and coarse) launches once per chunk,
                 the bf16 ones never; rays/s; depth and rgb against the bf16
                 renders (rel-L2 within 0.1) and the camera op against bf16
                 on one chunk (within 0.05), the JAX package's own bounds.
11. train_q8   - Trainer.run with trunk_quant int8 and int8_full at the
                 default bwd_acts (the recompute fallback), 20 steps then 10
                 timed, as phase 6: launches, losses, moved parameters, and
                 against the bf16 kernels the whole-step weight-gradient
                 cosine (above 0.95) and the camera op's origin-gradient
                 cosine (above 0.9); at int8_full the library's own counts
                 show the trunk backward's kernels: the cluster chain and
                 the weight gradient once a backward, the layer-major pair
                 never.
12. data       - generate_scene writes the hermetic scene (20 train views of
                 256x256, 2 test views) under logs/, and SatelliteDataset
                 builds its train pool: (1,310,720, 11) finite rays in the
                 cube, altitude envelope (-2, 32) m; seconds of each.
13. train_default - Trainer(TrainConfig(root_dir, img_dir,
                 compute_dtype="bfloat16")) on that scene with every other
                 field at the JAX package's default (bwd_acts "saved",
                 sampler "auto" resolving to occupancy tightening, 8x256,
                 batch 1024, 128 samples), the shadow and beta gates cut from
                 epoch 2 to step 10: 20 steps (losses finite, parameters
                 moved, the saved kernels once per step that runs them, the
                 save forwards also by the library's count), then 10 timed.
13b. validate  - that trainer (TrainConfig with gt_dir, aoi_id "SYN_068",
                 device_eval=True and a val_freq beyond the run) validates
                 once to warm up and once timed: the val split's 3 views of
                 256x256 (the first train view, then the 2 test views), 64
                 chunks of 1024 rays a view, the camera and shadow forwards
                 once a chunk each (the wrappers' and the library's counts),
                 no save forward or backward; val loss, PSNR and MAE logged,
                 no val/mae_failed or val/device_eval_fallback scalar,
                 epoch=best with its occ_sampling.json; seconds per view,
                 and view 1's load (host ray casting) and render seconds.
                 View 1's MAE on the card and on the host from one depth
                 render, apart by less than max(0.3 host, 0.5 m) (the JAX
                 package's bound); one val chunk through the kernels against
                 the per-sample module path without jitter (PATH_TOL).
14. variants   - the kernel-variant bench through its entry points
                 (bench.kernel_variants.main with all 20 variants and their
                 baseline trunk_gemm, and
                 bench.composite.main with all 4) at the TPU scripts'
                 defaults: 1,040,384 points, 2048-row tiles, 10 timed calls
                 after one warm-up, so each variant's launch count is 11.
                 Then each variant's kernel against its plain version at the
                 gates below (and the compositing epilogue on the density
                 kernel's own sigma; mm_i8 and mm_i8_k512 also from a random
                 int8 h0, timed too), one line each: ms beside the baseline
                 of the variant's own design and their difference (nope,
                 norelu, nocast, trunk_int2 and the epilogues against
                 trunk_gemm, full against trunk), plain ms, bound ms
                 and its share, the rate and its share of the H100 SXM peak,
                 and for the slab chains the same chain as library calls
                 (torch.matmul, torch._int_mm, torch._scaled_mm; "none" and
                 why where there is none); mm_bwd_saved also with its
                 passes timed one by one (slab_dgrad on dgemm, slab_wgrad,
                 reduce) beside the 8-product g @ W^T chain and the 8
                 A^T G products as library calls, each pass's bound and
                 slab_wgrad's bytes a second. Then the save-or-recompute
                 decision: t(mm_fwd_save) + t(mm_bwd_saved) against
                 t(mm_only) + t(mm_bwd_rec).

15. quality    - the north star's third done-test (eonerf_code_tpu_torch/
                 e2e.py): the JAX convergence pin's scene (5 views of
                 64x64, 2 m GT, seed 0) and configuration (batch 2048, 64
                 samples, no occupancy grid, shadows from step 1500), 2000
                 steps a run: A the pin's own (8x128 float32: the per-sample
                 path, no kernel launch), B 8x256 bf16 (the saved kernels:
                 2000 camera save forwards and saved backwards, 500 shadow
                 ones, by the wrappers' and the library's counts), C and D B
                 at int8 and int8_full (recompute). Each run's steps,
                 seconds, rays/s, last logged loss and PSNR, and the
                 registered MAE of the first val view's depth on the card
                 (device_eval=True, no host fallback) with its shift; B's
                 also on the host, within max(0.3 host, 0.5 m). A and B
                 must land under 1.5 m (the pin); C and D are printed.
                 First, use_pallas on the card: unset and True give
                 KernelField for a bf16 8x256 field, False the field itself,
                 True raises ValueError for a float32 one.
16. bundle_adjust - ab_bundle_adjust.py's small scene (5 views of 64x64,
                 seed 3) with RPCs biased by up to 3 px, at B's
                 configuration: the arm "biased" (no bundle adjustment),
                 then the annealed arm (rpc_correction, full PE bandwidth
                 at step 1000) stopped at step 500 for its gates: (i) one
                 batch through the kernels against the per-sample module
                 path under the same mask (loss, whole gradient, offsets'
                 gradient); (ii) the raw trunk rows masked at every step so
                 far keep their initial bits and get a zero gradient; (iii)
                 finite, non-zero offsets; (v) load_run of the step-500
                 checkpoint reads what _reg_params gives, bit for bit, and
                 its eval_cli --dsm sweep (16 chunks of 256 rays) launches
                 the camera and shadow forwards 16 times each. Then it
                 trains on to 2000: (iv) train/pe_alpha never falls and
                 reaches 10 at step 1000. Both arms' MAE and shift, the
                 learned offsets against the injected biases (mean-centred,
                 sign-matched: their correlation and median residual), and
                 the bundle-adjusted RPC export are printed, not gated.
17. data_parallel - parallel/mesh.py, in train_saved's configuration
                 (bf16 8x256, batch 1024, 128 / 64 samples, the saved
                 backward, seed 0) with shadows and the beta loss from step
                 5, 10 steps on the 2^20-ray pool (then 20 more timed by
                 CUDA events after each step). (a) world 1 over NCCL in
                 this process (data_axis=-1 on the one card) against the
                 plain Trainer: losses and parameters the same bits, the
                 saved pair's launches by the wrappers' and the library's
                 counts; then the two timed in turn over three 20-step
                 windows each, and 6 steps of each traced (device ms by
                 kernel group, NCCL's apart, idle share, the host's
                 costliest operations). (b) world 2 over gloo (the backend
                 for ranks sharing one card), both ranks on cuda:0
                 (parallel.mesh.launch spawns them), 512 rays a rank: the
                 loss trajectory within rtol 2e-3 / atol 1e-5 of (a), the
                 ranks' parameters the same bits, each rank's launches;
                 then one saved camera and one saved shadow pair on 1024
                 rays split over the ranks against the unsplit calls: the
                 per-ray outputs and d_rayin the same bits (or which
                 differs and by how much), the all-reduced weight gradients
                 within 1e-5 rel-L2. (c) in the same ranks phase render's
                 sweep without jitter through render_image_sharded:
                 render_image's bits, 32 + 32 forward launches a rank;
                 then eval_cli --dsm --data_axis 2 on train_default's run,
                 its MAE (gated equal: each rank skips the draws of the
                 chunks before its run) and shift beside phase eval's
                 --data_axis 1. (d)
                 (b) over NCCL one card a rank where the machine has two
                 cards, else a line saying it was not run. Seconds of each
                 part and the rays/s at world 1 and 2, not gated: two ranks
                 on one card measure contention, not scaling.
18. multi_aoi  - parallel/multi_aoi.py and train/multi.py. (a)
                 main_multi_train (device "cuda") on phase data's 20-view
                 256x256 scene beside a 5-view 64x64 scene of phase
                 quality's kind (unequal pools), 8x256 bf16, the kernels,
                 saved, batch 1024, 20 steps with shadows from 10: the
                 launches by the wrappers' and the library's counts, twice
                 a scene's; eval_cli --dsm on each scene's run directory,
                 a finite MAE. On two scenes of quality's kind (seeds 0
                 and 1): (b) scene 0 trained beside scene 1 and alone, from
                 the same weights and image count, 3 steps: the same bits;
                 (c) one shadowed step through the kernels against the
                 per-sample path (the module in bf16): losses and each
                 scene's gradient within 2e-2, and the hierarchical
                 sampler's coarse kernel once a scene and step; the
                 two-scene step against the single-AOI trainer's (64 / 64
                 samples, uniform, batch 1024 a scene), CUDA events after
                 each step over 20-step windows in turn, not gated; (d)
                 --scene_axis 2 over gloo, both ranks on this card, against
                 --scene_axis 1, 6 steps with pod checkpoints every 3: every
                 run directory and pod checkpoint the same bits, and a run
                 of 3 steps resumed to 6 the same bits (NCCL across scene
                 groups needs a card a rank: a line says it was not run);
                 (e) both scenes 2000 steps at run B's configuration as
                 flags of the command line, each scene's registered MAE
                 (e2e.score on its run's weights) under QUALITY_MAE_M.
19. vanilla    - the vanilla-NeRF path, which launches no kernel of the
                 port's own (its products are float32 torch ones, as the
                 JAX package's are flax ones). e2e.vanilla writes a
                 Blender scene of the JAX pin's kind (8 frames of 100x100,
                 io/png.py); train_mlp_nerf_torch.main trains it on the
                 card at train_mlp_nerf.py's defaults (8x256, batch 4096,
                 129 samples, a 64^3 grid every 16 steps, lr 5e-4,
                 float32, TF32 off) for 300 steps and evaluates the 8 test
                 views: the test PSNR over the pin's 18 dB, the
                 parameters and the grid on the card. Then on the trained
                 model, CUDA events: a step as train_vanilla takes it (the
                 host's batch, its copy, render, loss, backward, Adam)
                 over a window after warm-up, a whole-grid update, the
                 test views' eval render; rays/s of each, the PSNR of a
                 render of the background alone beside the gate; then 5
                 steps traced (device ms by library kernel group, the
                 idle share), not gated. The JAX pin's own flags (2x32,
                 batch 256, 17 samples, a 16^3 grid) through the same
                 entry point, 300 steps: its PSNR over 18 dB. DNeRF
                 (4x64 warp, 8x256 NeRF) once on the card and once on the
                 CPU from the same weights, forward and density on 1024 x
                 64 points: outputs in [0, 1], sigma >= 0, within 1e-4.
20. native     - the native host library (eonerf_code_tpu_torch/native,
                 csrc/geo_native.cpp, built by g++ in phase build): g++'s
                 version and the threads; rpc_localize against the numpy
                 solve on 1,024,000 points of a production view's RPC
                 (lon/lat within 1e-14), ncc_search against the numpy
                 search on phase eval's DSM pair (the same shift), one
                 320x320 view's cast_rays through both paths in turns, the
                 production scene's generate_scene and dataset (seconds).
21. production - that scene (e2e.py's production run: 10 views of
                 320x320, 1,024,000 rays) at its configuration (batch
                 4096, 96 / 96 samples, recompute, sampler tighten), the
                 gates moved to steps 10, 20 and 40 and the grid updated
                 every 5 steps, 60 steps: the camera and shadow pair's
                 launches by the wrappers' and the library's counts (row
                 8 none: the grid update reads the plain field), finite
                 losses, the stability gate opened from its own history
                 (not before step 10) and held, rays/s by CUDA events,
                 view 0's registered MAE finite.

Then the kernels summary line, the card's name and power limit as
nvidia-smi reports them, and last {"ok": true, "device": {...}}.
Exits non-zero without printing results when no CUDA device is present.
"""

import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
N_CHUNK = 4096
# H100 SXM dense peaks (NVIDIA data sheet, at the 700 W power limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version: both round to bf16 at the same points, but the
# f32 sums run in another order (tensor-core fragments vs cuBLAS), so a
# bf16 rounding (2^-8 relative) can flip and travel through the trunk.
# Outputs are of order 1 (depth in [0, 2], albedo/t_s in [0, 1], geo in
# [0, 1]).
KERNEL_TOL = {"max_abs": 2e-2, "mean_abs": 2e-3}
# Kernel path vs the per-sample module path on a 1024-ray subset: the
# per-sample path rounds the way flax does (bf16 bias add, bf16 head
# outputs), the kernels keep f32 bias adds and f32 heads, so roundings
# differ at every layer; held on the mean over rays.
PATH_TOL = {"depth_mean_abs": 2e-2, "rgb_mean_abs": 2e-2}
# Backward kernel vs plain version, per gradient tensor and for d_rayin:
# the same rounding points, another summation order. The difference is
# dominated by ReLU masks that flip between the two recomputed forwards at
# the few samples that carry most of a ray's cotangent; over 1024 rays the
# worst tensor stayed under 0.9 % in tests/test_torch_cuda.py.
BWD_REL_L2 = 1e-2
# The per-point backwards (field, density) under a random cotangent on every
# point: each point carries a full share of every gradient, so a mask or
# rounding that flips at any point moves the sums more than under the ray
# backwards' compositing cotangent, which a few samples a ray dominate.
# Measured on NVIDIA H100 80GB HBM3, 700 W: worst tensor 1.95e-2 (field)
# and 7.2e-3 (density). Both bf16 versions lie 11 % from the plain version
# in float32 and the kernel no farther than the plain one (ratio 1.001 and
# 0.995), held at 1.1.
POINT_BWD_REL_L2 = 3e-2
POINT_BWD_F32_RATIO = 1.1
N_TRAIN = 1024             # rays per training batch (TrainConfig's default)
N_POOL = 1 << 20           # rays in the training pool
N_VIEWS = 20
TRAIN_STEPS = 20
TIMED_STEPS = 10
# density kernel vs plain version: sigma is unbounded (softplus), so the
# errors are held relative to the largest reference value, at the forward
# kernels' tolerance
DENSITY_TOL = {"max_rel": 2e-2, "mean_rel": 2e-3}
# coarse weights vs plain version: a ray's weights sum to at most 1, so over
# 95 samples a typical weight is about 1e-2; held at a tenth of that at
# worst, and at 1 % of the mean weight on average
COARSE_TOL = {"max_abs": 1e-3, "mean_abs": 1e-4, "mean_rel": 1e-2}
N_PROBE_RAYS, N_PROBE_SAMPLES = 2048, 64    # the trainer's entropy probe
WIDE_ENVELOPE = (-2.0, 220.0)    # metres: wider than occ_tighten_max_envelope_m
COMPACT_ENVELOPE = (-2.0, 32.0)
WIDE_STEPS = 20
COMPACT_STEPS = 12
COMPACT_UPDATE_EVERY = 8
# Whole-step gradient through the kernels vs through the per-sample module
# path (autograd through EONerfField) on one batch: the per-sample path
# rounds as flax does (bf16 bias adds and heads), the kernels keep f32 bias
# adds and heads. Measured 3.9e-3 on NVIDIA H100 80GB HBM3, 700 W; held at
# 5x that.
GRAD_PATH_REL_L2 = 2e-2
# The per-sample branch (train_diag) adds the shadow term's d_pos chain at
# every shadow sample. There the kernel path and the module's bf16 path lie
# 1.41e-2 and 1.51e-2 from the module in float32 and 2.01e-2 from each
# other, about the quadrature sum of two independent errors (H100, 700 W).
# Held: the kernel path against the float32 module at GRAD_PATH_REL_L2,
# against the bf16 module at twice that.
GRAD_PATH_DIAG_REL_L2 = 2 * GRAD_PATH_REL_L2
# Ray entropy and the nadir probes, kernel per-sample branch vs the module's
# per-sample path on the 1024-ray subset: the module rounds as flax does
# (bf16 bias adds and heads), the kernels keep f32 bias adds and heads.
# Measured 1.0e-4 (entropy, in [0, 2.1]) and 9.3e-6 (the probes' mean
# alpha, at most 0.03 on this untrained field) mean abs on NVIDIA H100
# 80GB HBM3, 700 W; held at 20x that.
DIAG_TOL = {"entropy_mean_abs": 2e-3, "opacity_after_surface_mean_abs": 2e-4}
# int8 trunk tier: the H100 SXM's dense int8 peak (the same data sheet)
PEAK_INT8_OPS = 1979e12
# int8 kernels vs their plain versions: both quantize the same bf16 PE and
# form the same exact int32 products, dequantized in the same order, so each
# group's amax agrees unless a PE lane's sin rounds to another bf16 on one
# side (1e-3 relative per group and quantization point); the cotangents'
# amax (int8_full) is compared at layer 7, the chain's first quantization,
# which follows the bf16 head chain, summed in another order (each lower
# layer's inherits the chain's drift, below).
Q8_AMAX_REL = 1e-3
Q8_GAMAX_REL = 2e-2
# int8_full backward: where the bf16 head chain's other summation order moves
# a group's cotangent amax by an ulp, the group re-rounds, and the trunk's
# gradients and d_rayin move with it (tests/test_torch_cuda.py: trunk layer
# 0 at 2.1e-2 rel-L2 at 1024 x 127 on NVIDIA H100 80GB HBM3, 700 W; the
# shadow op, without a head chain, agrees to 1.4e-6). Those tensors are held
# at 5e-2 and the kernel no farther than 1.25 times the plain version from
# the plain version in float32; every other tensor at BWD_REL_L2.
Q8_FULL_REL_L2 = 5e-2
Q8_FULL_F32_RATIO = 1.25
# int8_full's trunk backward alone against the plain trunk backward on the
# kernels' own inputs: the products are exact and every rounding the
# plain version's, so the PE cotangent, the cotangent amax and the weight
# gradients must be the same bits; the bias sums run in another order (a
# CTA's column sums in a fixed tree): f32 sums of 131,072 rows, held at 1e-6
Q8_CHAIN_BIAS_REL_L2 = 1e-6
# int8 against bf16, the JAX package's own bounds
# (tests/test_trunk_quant.py): the camera op's channels within rel-L2 0.05,
# render_rays' depth and rgb within 0.1, the step's weight-gradient cosine
# above 0.95 and the camera op's origin-gradient cosine above 0.9
Q8_CAMERA_REL_L2 = 0.05
Q8_RENDER_REL_L2 = 0.1
Q8_GRAD_COS = 0.95
Q8_ORIGIN_COS = 0.9
# saved-activations backward vs the recompute kernel: the stream holds the
# recompute's own bf16 activations, so the same bits are expected; held at
# the JAX package's saved-vs-recompute pin (tests/test_fused_render.py)
SAVED_REL_L2 = 1e-6
# the JAX package's default training run on the generated scene
SCENE_VIEWS, SCENE_SIZE = 20, 256
SCENE_ENVELOPE = (-2.0, 32.0)
DSM_SHIFT = (3, -2)        # (dx, dy) in cells
# the kernel-variant bench at the TPU script's defaults
VARIANT_N, VARIANT_TILE, VARIANT_ITERS = 1040384, 2048, 10
# (the gates of a variant against its plain version: bench/variants.py)
DSM_ZBIAS = 1.5            # metres


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def tpu_kernel_site(fn_name, module="fused_render.py"):
    """file:line of a Pallas kernel body in the JAX reference package that
    sits beside the port, or in one of its research scripts under scripts/
    (module "bench_kernel_variants.py" or "proto_composite.py"); read as
    text, never imported."""
    paths = sorted(ROOT.glob(f"scripts/{module}")) + sorted(ROOT.glob(f"*/ops/pallas/{module}"))
    for path in paths:
        if path.parts[-4] == "eonerf_code_tpu_torch":
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if line.startswith(f"def {fn_name}("):
                return f"{path.relative_to(ROOT)}:{i}"
    raise FileNotFoundError(f"Pallas kernel {fn_name} not found")


def grad_errors(ff, got, ref):
    """rel-L2 of each of the 36 weight-gradient tensors and of the input
    gradients after them (d_rayin, or d_pos and d_emb), and the max abs
    difference over all of them."""
    views = [ff.flatten_weights(ff.kernel_views(ff.KernelWeights(g[0], g[1]))) for g in (got, ref)]
    rel = []
    for a, b in list(zip(*views)) + list(zip(got[2:], ref[2:])):
        den = float(b.norm())
        rel.append(float((a - b).norm()) / den if den > 0 else float(a.norm()))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    return rel, max_abs


def rel_l2(a, b):
    den = float(b.float().norm())
    diff = float((a.float() - b.float()).norm())
    return diff / den if den > 0 else diff


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the quality and bundle-adjustment phases (15, 16): the JAX convergence
# pin's gate on the registered MAE of the first val view after 2000 steps
# (tests/test_convergence_slow.py:35), for runs A and B
QUALITY_MAE_M = 1.5
# the annealed arm's gates at a mid-ramp step: one batch through the kernels
# against the per-sample module path under the same mask, both bf16. The
# per-sample path rounds as flax does (bf16 bias adds and heads), the
# kernels keep f32 bias adds and heads: the whole gradient at phase 6's
# GRAD_PATH_REL_L2. The offsets' gradient (the camera op's d_rayin[:, 0:3]
# against autograd through the sample positions) sums each view's rays'
# rounded origin gradients; measured 3.18e-2 (the loss 2.5e-4 relative, the
# whole gradient 4.7e-3) on NVIDIA H100 80GB HBM3, 700 W, the plain versions
# in bf16 on the CPU 1.1e-2 at a toy size; held at 3x and 8x
BA_MID_STEP = 500
BA_LOSS_RTOL = 2e-3
BA_OFFSET_GRAD_REL_L2 = 1e-1
# the eval sweep of the mid-ramp checkpoint: the 64x64 nadir view in chunks
# of 256 rays, 16 camera and 16 shadow forwards
BA_EVAL_CHUNK = 256


class Launches:
    """The wrappers' launch counts of the camera and shadow ops (set to 0
    here) and the library's own counts since then: the save mode by op
    (`*_fwd_save_kernel`), the streamed forward by op (`*_fwd_stream_kernel`)
    and the dgrad kernel."""

    def __init__(self, fr):
        self.fr = fr
        self.fns = {"camera_fwd": fr.camera_forward, "shadow_fwd": fr.shadow_forward,
                    "camera_bwd": fr.camera_backward, "shadow_bwd": fr.shadow_backward,
                    "camera_fwd_save": fr.camera_forward_save,
                    "shadow_fwd_save": fr.shadow_forward_save,
                    "camera_bwd_saved": fr.camera_backward_saved,
                    "shadow_bwd_saved": fr.shadow_backward_saved,
                    "camera_fwd_q8": fr.camera_forward_q8, "shadow_fwd_q8": fr.shadow_forward_q8,
                    "camera_bwd_q8": fr.camera_backward_q8,
                    "shadow_bwd_q8": fr.shadow_backward_q8,
                    "camera_bwd_q8_full": fr.camera_backward_q8_full,
                    "shadow_bwd_q8_full": fr.shadow_backward_q8_full}
        for fn in self.fns.values():
            fn.launches = 0
        self.save0 = fr.save_fwd_kernel_launches()
        self.stream0 = fr.stream_fwd_kernel_launches()
        self.dgrad0 = fr.dgrad_kernel_launches()

    def read(self):
        out = {n: fn.launches for n, fn in self.fns.items()}
        save, stream = self.fr.save_fwd_kernel_launches(), self.fr.stream_fwd_kernel_launches()
        out.update({f"{m}_fwd_save_kernel": save[m] - self.save0[m] for m in save})
        out.update({f"{m}_fwd_stream_kernel": stream[m] - self.stream0[m] for m in stream})
        out["dgrad_kernel"] = self.fr.dgrad_kernel_launches() - self.dgrad0
        return out


def by_path(kernel_rows, path, launches):
    """Record the launches of a phase in the kernel rows it ran."""
    for name, n in launches.items():
        if name in kernel_rows and n:
            kernel_rows[name].setdefault("launches_by_path", {})[path] = n


def expected_train_launches(run_cfg, steps, shadow_steps):
    """The camera and shadow wrappers' launches of a training run by its
    configuration: the saved pair (and the library's save mode and dgrad
    counts), the int8 or int8_full ops, or none on the per-sample path."""
    quant = run_cfg.get("trunk_quant", "none")
    if run_cfg.get("compute_dtype") != "bfloat16":
        return {}
    if quant == "none":
        return {"camera_fwd_save": steps, "shadow_fwd_save": shadow_steps,
                "camera_bwd_saved": steps, "shadow_bwd_saved": shadow_steps,
                "camera_fwd_save_kernel": steps, "shadow_fwd_save_kernel": shadow_steps,
                "dgrad_kernel": steps + shadow_steps}
    sfx = "_full" if quant == "int8_full" else ""
    return {"camera_fwd_q8": steps, "shadow_fwd_q8": shadow_steps,
            f"camera_bwd_q8{sfx}": steps, f"shadow_bwd_q8{sfx}": shadow_steps}


def quality_phase(torch, dev, card, log_root, kernel_rows):
    """Phase 15: the quality runs A-D (eonerf_code_tpu_torch/e2e.py) on
    the JAX pin's scene: each run's launches, steps, seconds, rays/s, last
    logged loss and PSNR, and the registered MAE of the first val view's
    depth on the card with its shift; B's MAE also on the host. A and B
    must land under QUALITY_MAE_M; C and D are printed beside B."""
    from eonerf_code_tpu_torch import e2e
    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.models.eonerf import EONerfField
    from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
    from eonerf_code_tpu_torch.ops import fused_render as fr

    # use_pallas on the card: unset and True take the kernels for a bf16
    # 8x256 field, False the field itself; True refuses a float32 field
    fields = {dt: EONerfField(5, compute_dtype=dt, device=dev,
                              generator=torch.Generator().manual_seed(0))
              for dt in (torch.bfloat16, torch.float32)}
    backends = {str(v): type(make_render_field(fields[torch.bfloat16],
                                               TrainConfig(use_pallas=v))).__name__
                for v in (None, True, False)}
    try:
        make_render_field(fields[torch.float32], TrainConfig(use_pallas=True))
        backends["True, float32"] = "accepted"
    except ValueError:
        backends["True, float32"] = "ValueError"
    del fields
    if backends != {"None": "KernelField", "True": "KernelField", "False": "EONerfField",
                    "True, float32": "ValueError"}:
        raise AssertionError(f"use_pallas picked otherwise on the card: {backends}")

    root = log_root / "chip_smoke_quality"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    scene = e2e.make_scene(str(root), "scene", **e2e.SCENE)
    scene_s = time.perf_counter() - t0
    steps = e2e.STEPS
    shadow_steps = steps - e2e.PIN["first_shadow_step"]
    quality = {}
    for run, run_cfg in e2e.RUNS.items():
        tq = e2e.make_trainer(scene, str(root), f"quality_{run}", steps, dev, **run_cfg)
        path = "kernels" if isinstance(tq.render_field, KernelField) else "per_sample"
        want_path = "kernels" if run_cfg.get("compute_dtype") == "bfloat16" else "per_sample"
        if path != want_path or (run == "B" and not tq.render_field.save_acts):
            raise RuntimeError(f"quality run {run} took the {path} path")
        counts = Launches(fr)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = tq.run(max_steps=steps, log_every=e2e.LOG_EVERY)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = counts.read()
        expect = expected_train_launches(run_cfg, steps, shadow_steps)
        got = {k: launches[k] for k in launches if k in expect or k in counts.fns}
        want = {k: expect.get(k, 0) for k in got}
        logged = e2e.last_logged(tq)
        sample = tq.val_ds.get_val_sample(0)
        depth = tq.render_view(sample, depth_only=True)
        mae = tq._val_mae(sample, depth)
        _, (dx, dy, bias) = tq.val_dsm_device(sample, depth)
        res = {"path": path, "net": f"{tq.cfg.net_depth}x{tq.cfg.net_width}",
               "compute_dtype": tq.cfg.compute_dtype, "trunk_quant": tq.cfg.trunk_quant,
               "bwd_acts": tq.cfg.bwd_acts, "steps": stats["steps"], "seconds": seconds,
               "rays_per_s": stats["rays_per_sec"], "final_loss": logged["train/loss"][1],
               "final_psnr": logged["train/psnr"][1], "logged_at_step": logged["train/loss"][0],
               "mae_m": mae, "shift": [int(dx), int(dy)], "bias_m": float(bias),
               "launches": got, "expected_launches": want}
        if run == "B":
            res["mae_host_m"] = tq._val_mae_host(sample, depth)
            res["mae_host_bound_m"] = max(0.3 * res["mae_host_m"], 0.5)
        quality[run] = res
        by_path(kernel_rows, f"quality_{run}", got)
        emit({"phase": "quality", "run": run, **res, "card": card})
        del tq
        torch.cuda.empty_cache()
    summary = {"phase": "quality_summary", "use_pallas": backends, "scene_seconds": scene_s,
               "gate_m": QUALITY_MAE_M,
               **{f"mae_{r}_m": q["mae_m"] for r, q in quality.items()},
               **{f"shift_{r}": q["shift"] for r, q in quality.items()}, "card": card}
    emit(summary)
    for run, res in quality.items():
        if res["launches"] != res["expected_launches"]:
            raise AssertionError(f"quality run {run} launched otherwise: {res}")
        if not (math.isfinite(res["mae_m"]) and math.isfinite(res["final_loss"])):
            raise AssertionError(f"quality run {run}: no finite MAE or loss: {res}")
    for run in ("A", "B"):
        if not quality[run]["mae_m"] < QUALITY_MAE_M:
            raise AssertionError(f"quality run {run}: registered MAE {quality[run]['mae_m']} m "
                                 f"is not under the JAX pin's {QUALITY_MAE_M} m")
    b = quality["B"]
    if not abs(b["mae_m"] - b["mae_host_m"]) < b["mae_host_bound_m"]:
        raise AssertionError(f"quality run B: device MAE against host MAE: {b}")
    return quality


def bundle_adjust_phase(torch, dev, card, log_root, kernel_rows):
    """Phase 16: the bundle-adjustment arms (eonerf_code_tpu_torch/e2e.py)
    at B's configuration on the biased scene. The annealed arm stops at
    BA_MID_STEP for gates (i)-(v), then trains on; both arms' MAE and
    shift, the learned offsets against the injected biases and the
    bundle-adjusted export are printed."""
    from eonerf_code_tpu_torch import e2e
    from eonerf_code_tpu_torch.cli import eval_cli
    from eonerf_code_tpu_torch.eval.export import export_adjusted_rpcs
    from eonerf_code_tpu_torch.eval.run import load_run
    from eonerf_code_tpu_torch.models.encoders import barf_alpha
    from eonerf_code_tpu_torch.models.freq_reg import field_weights
    from eonerf_code_tpu_torch.models.fused import KernelField
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.ops.fused_field import flatten_weights
    from eonerf_code_tpu_torch.train.loop import make_loss_fn

    root = log_root / "chip_smoke_ba"
    shutil.rmtree(root, ignore_errors=True)
    scene = e2e.make_scene(str(root), "scene_biased", rpc_bias_px=e2e.BIAS_PX, **e2e.BA_SCENE)
    steps = e2e.STEPS
    arms = {}
    tb = e2e.make_trainer(scene, str(root), "ba_biased", steps, dev,
                          **e2e.arm_overrides("biased", steps))
    arms["biased"] = e2e.train_and_score(tb, steps)
    emit({"phase": "bundle_adjust", "arm": "biased", **arms["biased"], "card": card})
    del tb

    ta = e2e.make_trainer(scene, str(root), "ba_annealed", steps, dev,
                          **e2e.arm_overrides("biased+ba", steps))
    if not (isinstance(ta.render_field, KernelField) and ta.field.rpc_correction
            and ta.cfg.freq_reg_end_step == steps // 2):
        raise RuntimeError("the annealed arm did not take the kernels with bundle adjustment")
    trunk = ta.field.trunk
    skip = next(i for i in range(ta.cfg.net_depth) if trunk._skips_after(i)) + 1
    layers = {"hidden_0": (trunk.hidden_0, 0), f"hidden_{skip}": (getattr(trunk, f"hidden_{skip}"),
                                                                  ta.cfg.net_width)}
    init = {n: m.weight.detach().clone() for n, (m, _) in layers.items()}
    counts = Launches(fr)
    t0 = time.perf_counter()
    ta.run(max_steps=BA_MID_STEP, log_every=e2e.LOG_EVERY)
    mid_s = time.perf_counter() - t0
    launches_mid = counts.read()
    ckpt = pathlib.Path(ta.save())
    epoch_mid = int(ckpt.name.split("=")[1])
    # (i) one batch, evenly strided over the pool, shadows and the beta loss
    # on, through the kernels and through the per-sample module path under
    # the step's mask
    mask = ta._pe_mask(ta.step)
    idx = torch.linspace(0, ta.n_rays - 1, ta.cfg.batch_size, device=dev).long()
    batch = {k: v[idx] for k, v in ta.device_data.items()}
    losses, grads, offset_grads, masked_grads = [], [], [], []
    zero = torch.stack([ta._pe_mask(s) for s in range(ta.step + 1)]).amax(0) == 0
    for rfield in (ta.render_field, ta.field):
        ta.field.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(rfield, ta.rcfg)(batch, 0.0, True, True,
                                                torch.Generator(device=dev).manual_seed(5),
                                                None, mask)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in ta.field.parameters()]))
        offset_grads.append(ta.field.ray_correction_enc.weight.grad.float().flatten().clone())
        masked_grads.append(max(float(m.weight.grad[:, off:][:, zero].abs().max())
                                for m, off in layers.values()))
    # (ii) the raw trunk rows masked at every step so far: their initial bits
    rows_kept = {n: bool(torch.equal(m.weight[:, off:][:, zero], init[n][:, off:][:, zero]))
                 for n, (m, off) in layers.items()}
    rows_moved = {n: bool(not torch.equal(m.weight[:, off:][:, ~zero], init[n][:, off:][:, ~zero]))
                  for n, (m, off) in layers.items()}
    # (iii) the offsets
    offsets = ta.field.ray_correction_enc.weight.detach()
    # (v) load_run of the mid-ramp checkpoint against _reg_params, then its
    # eval_cli --dsm sweep through the kernels
    _, rf_l, _ = load_run(ta.log_dir, epoch_nb=epoch_mid, device=dev)
    reg = flatten_weights(ta._reg_params())
    loaded = flatten_weights(field_weights(rf_l))
    load_equal = all(torch.equal(a.detach(), b.detach()) for a, b in zip(reg, loaded))
    eval_counts = Launches(fr)
    eval_out = eval_cli([ta.cfg.exp_name, "--logs_dir", ta.cfg.logs_dir, "--output_dir",
                         str(root / "eval_mid"), "--dsm", "--epoch_nb", str(epoch_mid),
                         "--chunk", str(BA_EVAL_CHUNK), "--dsm_resolution",
                         str(e2e.SCENE["dsm_resolution"])])
    torch.cuda.synchronize()
    eval_launches = eval_counts.read()
    n_chunks = -(-e2e.SCENE["img_size"] ** 2 // BA_EVAL_CHUNK)
    mid = {"step": ta.step, "checkpoint": ckpt.name, "seconds": mid_s,
           "pe_alpha": float(barf_alpha(ta.step, ta.cfg.freq_reg_start_step,
                                        ta.cfg.freq_reg_end_step, ta.field.pos_enc_deg)),
           "launches": {k: launches_mid[k] for k in ("camera_fwd_save", "camera_bwd_saved",
                                                     "shadow_fwd_save", "shadow_bwd_saved",
                                                     "camera_fwd_save_kernel")},
           "loss_kernels": losses[0], "loss_per_sample": losses[1],
           "loss_rel": abs(losses[0] - losses[1]) / abs(losses[1]),
           "grad_rel_l2": rel_l2(grads[0], grads[1]),
           "offset_grad_rel_l2": rel_l2(offset_grads[0], offset_grads[1]),
           "masked_pe_rows": int(zero.sum()), "masked_rows_grad_max": masked_grads,
           "masked_rows_bit_equal": rows_kept, "unmasked_rows_moved": rows_moved,
           "offsets_finite": bool(torch.isfinite(offsets).all()),
           "offsets_abs_max": float(offsets.abs().max()),
           "load_run_equals_reg_params": load_equal,
           "load_run_masked": getattr(rf_l, "pe_mask", None) is not None,
           "eval_mae_m": eval_out["mae"],
           "eval_launches": {k: eval_launches[k] for k in ("camera_fwd", "shadow_fwd",
                                                           "camera_fwd_stream_kernel",
                                                           "shadow_fwd_stream_kernel")},
           "eval_chunks": n_chunks,
           "tolerance": {"loss_rel": BA_LOSS_RTOL, "grad_rel_l2": GRAD_PATH_REL_L2,
                         "offset_grad_rel_l2": BA_OFFSET_GRAD_REL_L2}}
    emit({"phase": "bundle_adjust_mid", **mid, "card": card})
    want_mid = {"camera_fwd_save": BA_MID_STEP, "camera_bwd_saved": BA_MID_STEP,
                "shadow_fwd_save": 0, "shadow_bwd_saved": 0, "camera_fwd_save_kernel": BA_MID_STEP}
    if mid["launches"] != want_mid:
        raise AssertionError(f"the annealed arm's first {BA_MID_STEP} steps launched "
                             f"otherwise: {mid['launches']} != {want_mid}")
    if not (mid["loss_rel"] <= BA_LOSS_RTOL and mid["grad_rel_l2"] <= GRAD_PATH_REL_L2
            and mid["offset_grad_rel_l2"] <= BA_OFFSET_GRAD_REL_L2):
        raise AssertionError(f"(i) the masked batch through the kernels against the per-sample "
                             f"path: {mid}")
    if not (mid["masked_pe_rows"] > 0 and max(masked_grads) == 0 and all(rows_kept.values())
            and all(rows_moved.values())):
        raise AssertionError(f"(ii) the masked trunk rows moved or got a gradient: {mid}")
    if not (mid["offsets_finite"] and mid["offsets_abs_max"] > 0):
        raise AssertionError(f"(iii) the offsets: {mid}")
    if not (load_equal and mid["load_run_masked"]
            and all(v == n_chunks for v in mid["eval_launches"].values())
            and math.isfinite(eval_out["mae"])):
        raise AssertionError(f"(v) load_run or the eval sweep of the mid-ramp checkpoint: {mid}")
    by_path(kernel_rows, "bundle_adjust_mid_eval", {k: eval_launches[k]
                                                    for k in ("camera_fwd", "shadow_fwd")})

    counts = Launches(fr)
    res = e2e.train_and_score(ta, steps)
    launches_rest = counts.read()
    res["seconds"] += mid_s
    by_path(kernel_rows, "bundle_adjust", {k: launches_mid[k] + launches_rest[k]
                                          for k in launches_rest})
    # (iv) the logged annealing progress
    with open(pathlib.Path(ta.log_dir) / "metrics.jsonl") as f:
        alpha = sorted((r["step"], r["value"]) for r in map(json.loads, f)
                       if r["tag"] == "train/pe_alpha")
    res["pe_alpha"] = alpha
    res["offsets"] = e2e.report_learned_offsets(ta, scene)
    exported = export_adjusted_rpcs(ta.log_dir, str(root / "rpc_adjusted"))
    res["export"] = {"views": len(exported),
                     "d_col_d_row_px": [[v["d_col"], v["d_row"]] for v in exported.values()]}
    arms["biased+ba"] = res
    emit({"phase": "bundle_adjust", "arm": "biased+ba", **res, "card": card})
    alpha_at = dict(alpha)
    deg = ta.field.pos_enc_deg
    if not (alpha and all(a[1] <= b[1] for a, b in zip(alpha, alpha[1:]))
            and alpha_at.get(ta.cfg.freq_reg_end_step) == deg and alpha[-1][1] == deg):
        raise AssertionError(f"(iv) train/pe_alpha: {alpha}")
    emit({"phase": "bundle_adjust_summary",
          **{f"mae_{a}_m": r["mae_m"] for a, r in arms.items()},
          **{f"shift_{a}": r["shift"] for a, r in arms.items()},
          "offset_corr": res["offsets"]["corr"],
          "offset_median_resid_px": res["offsets"]["median_resid_px"], "card": card})
    return arms



# ---- 17. data_parallel (parallel/mesh.py): the worker functions below run
# in the ranks that parallel.mesh.launch spawns (module level, so they
# pickle), and in this process at world 1 ----

DP_STEPS = 10
DP_SHADOW_FROM = 5          # shadows and the beta loss from this step on
DP_TIMED = 20               # steps a timed window (shadows and beta on), not gated
DP_WINDOWS = 3              # (a): the plain and the world-1 trainer's windows, in turn
DP_TRACED = 6               # (a): steps of each traced with torch.profiler
# world 2 against world 1 on one global batch: the JAX package's weak-scaling
# pin (tests/test_trainer_mesh.py)
DP_TRAJ_TOL = {"rtol": 2e-3, "atol": 1e-5}
# the halves' weight gradients summed (the all-reduce) against the whole
# batch's: each half sums its own rows in the kernels' fixed order, so the
# float32 sums round in another order
SPLIT_WGRAD_REL_L2 = 1e-5
DP_SAVED = ("camera_fwd_save", "shadow_fwd_save", "camera_bwd_saved", "shadow_bwd_saved")


def dp_config(log_root, exp_name, data_axis):
    """train_saved's configuration (bf16 8x256, batch 1024, 128 camera and 64
    shadow samples, uniform sampler, the saved backward, seed 0) with the
    shadow and beta gates at step 5, on ``data_axis`` processes."""
    from eonerf_code_tpu_torch.config import TrainConfig

    return TrainConfig(logs_dir=str(log_root), exp_name=exp_name, sampler="uniform",
                       occ_enabled=False, bwd_acts="saved", compute_dtype="bfloat16",
                       batch_size=N_TRAIN, n_samples=128, sc_n_samples=64,
                       first_shadow_step=DP_SHADOW_FROM, first_beta_step=DP_SHADOW_FROM,
                       max_train_steps=DP_STEPS, save_freq=10 ** 9, seed=0,
                       data_axis=data_axis)


def dp_trainer(device, log_root, exp_name, data_axis):
    """A trainer of :func:`dp_config` on this rank over the 2^20-ray pool,
    after DP_STEPS steps, and what they gave: each step's (global) loss,
    this rank's parameters and its launches of the saved pair (the
    wrappers' and the library's counts), its mesh. The trainer's step
    records a CUDA event after each step (``step_events``, which
    :func:`dp_window` reads)."""
    import torch

    from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.train.loop import Trainer

    shutil.rmtree(pathlib.Path(log_root) / exp_name, ignore_errors=True)
    tr = Trainer(dp_config(log_root, exp_name, data_axis),
                 synthetic_ray_pool(N_POOL, N_VIEWS, device), n_images=N_VIEWS, device=device)
    losses, tr.step_events, step_fn = [], [], tr.train_step

    def step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        losses.append(out["loss"])
        tr.step_events.append(torch.cuda.Event(enable_timing=True))
        tr.step_events[-1].record()
        return out

    tr.train_step = step
    counted = {name: getattr(fr, name.replace("_fwd", "_forward").replace("_bwd", "_backward"))
               for name in DP_SAVED}
    for fn in counted.values():
        fn.launches = 0
    save_before, dgrad_before = fr.save_fwd_kernel_launches(), fr.dgrad_kernel_launches()
    tr.run(max_steps=DP_STEPS, log_every=10 ** 9)
    save_now = fr.save_fwd_kernel_launches()
    launches = {name: fn.launches for name, fn in counted.items()}
    launches.update({f"{m}_fwd_save_kernel": save_now[m] - save_before[m] for m in save_now},
                    dgrad_kernel=fr.dgrad_kernel_launches() - dgrad_before)
    params = {k: v.detach().cpu() for k, v in tr.field.state_dict().items()}
    return tr, {"losses": [float(v) for v in losses[:DP_STEPS]], "params": params,
                "launches": launches,
                "mesh": {"rank": tr.mesh.rank, "world": tr.mesh.world,
                         "distributed": tr.mesh.distributed, "backend": tr.mesh.backend}}


def dp_window(tr, steps):
    """Milliseconds a step over ``steps`` more steps of a
    :func:`dp_trainer` (shadows and beta on), from the CUDA events after
    each: the steps and the host's gaps between them, not the checkpoint
    that each ``Trainer.run`` writes at its end."""
    import torch

    first = len(tr.step_events)
    tr.run(max_steps=tr.step + steps, log_every=10 ** 9)
    torch.cuda.synchronize()
    return tr.step_events[first].elapsed_time(tr.step_events[-1]) / (steps - 1)


def dp_allreduce_ms(tr):
    """The step's gradient all-reduce alone (5 calls; it sums the spent
    gradients again)."""
    import torch

    grads = [p.grad for p in tr.field.parameters()]
    tr.mesh.all_reduce_(grads)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        tr.mesh.all_reduce_(grads)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 5


def dp_trace(tr, steps):
    """``steps`` steps of ``tr`` under torch.profiler (train/profile_step.py's
    kernel groups and NCCL's): ms a step by the CUDA events, device ms a
    step by group and in all, the device's idle share, and the host's self
    ms a step of its ten costliest operations."""
    from eonerf_code_tpu_torch.train.profile_step import trace

    ms, per_group, host = trace(lambda: dp_window(tr, steps), steps)
    device_ms = sum(per_group.values())
    return {"steps": steps, "ms_per_step": ms, "device_ms_per_step": per_group,
            "device_ms_total": device_ms, "idle_share": 1.0 - device_ms / ms,
            "host_self_ms_top": host}


def dp_train(device, log_root, exp_name, data_axis):
    """:func:`dp_trainer`, then DP_TIMED timed steps (rays/s of the global
    batch, ms a step) and the gradient all-reduce alone."""
    tr, res = dp_trainer(device, log_root, exp_name, data_axis)
    ms = dp_window(tr, DP_TIMED)
    return {**res, "rays_per_s": N_TRAIN * 1e3 / ms, "ms_per_step": ms,
            "allreduce_ms": dp_allreduce_ms(tr)}


def dp_expected_launches():
    shadow_steps = DP_STEPS - DP_SHADOW_FROM
    return {"camera_fwd_save": DP_STEPS, "shadow_fwd_save": shadow_steps,
            "camera_bwd_saved": DP_STEPS, "shadow_bwd_saved": shadow_steps,
            "camera_fwd_save_kernel": DP_STEPS, "shadow_fwd_save_kernel": shadow_steps,
            "dgrad_kernel": DP_STEPS + shadow_steps}


def dp_split_check(mesh):
    """One saved camera and one saved shadow pair on 1024 rays of a training
    step's shapes (camera K=127, shadow K=63), each rank on its contiguous
    half: the per-ray outputs and d_rayin gathered against the unsplit
    calls' (bit for bit, or which differs and by how much), the weight
    gradients all-reduced against the unsplit ones (rel-L2)."""
    import torch

    from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
    from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
    from eonerf_code_tpu_torch.models.eonerf import EONerfField
    from eonerf_code_tpu_torch.ops import fused_field as ff
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.ops.sampling import set_last_valid
    from eonerf_code_tpu_torch.render import satellite as sat

    dev = mesh.device
    field = EONerfField(N_VIEWS, compute_dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        kw = ff.pack_kernel_weights(ff.pack_params(field), torch.bfloat16)
    pool = synthetic_ray_pool(N_TRAIN, N_VIEWS, dev, seed=11)
    rays = satrays_from_tensor(pool["rays"], pool["ts"])
    cfg = sat.RenderConfig(n_samples=128, sc_n_samples=64)
    gen = torch.Generator(device=dev).manual_seed(21)
    z, delta, _, mask = sat._camera_samples(rays.origins, rays.viewdirs, rays.t_near, cfg, gen)
    emb = torch.randn((N_TRAIN, 4), generator=gen, device=dev)
    rayin = torch.cat([rays.origins, rays.viewdirs, emb, torch.zeros((N_TRAIN, 6), device=dev)],
                      dim=1)
    sc_o = rays.origins + rays.viewdirs * (0.5 + z[:, :1])     # plausible surface points
    _, sc_z, sc_delta, sc_mask = sat._sample_block(
        sc_o, -rays.sundirs, torch.zeros_like(rays.t_near), cfg.sc_n_samples, cfg.ray_span, True,
        cfg.cube_bound, gen)
    rayin_sc = torch.cat([sc_o, -rays.sundirs, torch.zeros((N_TRAIN, 10), device=dev)], dim=1)
    cases = {
        "camera": ((rayin, z, set_last_valid(delta, mask, cfg.inf_delta) * mask),
                   torch.randn((N_TRAIN, fr.ACC_COLS), generator=gen, device=dev),
                   fr.camera_forward_save, fr.camera_backward_saved),
        "shadow": ((rayin_sc, sc_z, sc_delta * sc_mask, sc_mask.float()),
                   torch.randn((N_TRAIN,), generator=gen, device=dev),
                   fr.shadow_forward_save, fr.shadow_backward_saved)}
    half = N_TRAIN // mesh.world
    rows = slice(mesh.rank * half, (mesh.rank + 1) * half)
    res = {}
    for op, (args, g, fwd_save, bwd_saved) in cases.items():
        args = [t.contiguous() for t in args]
        mine = [t[rows].contiguous() for t in args]
        out, stream = fwd_save(kw, *mine)
        d_mats, d_biases, d_rayin = bwd_saved(kw, *mine, g[rows].contiguous(), stream)
        mesh.all_reduce_([d_mats, d_biases])
        got = mesh.gather_rows({"out": out, "d_rayin": d_rayin}, mesh.rank * half, N_TRAIN)
        out_w, stream_w = fwd_save(kw, *args)
        whole = bwd_saved(kw, *args, g, stream_w)
        want = {"out": out_w, "d_rayin": whole[2]}
        wg, wg_ref = torch.cat([d_mats, d_biases]), torch.cat(whole[:2])
        res[op] = {"rays": N_TRAIN, "samples": args[1].shape[1],
                   "per_ray_bitwise": all(torch.equal(got[k], want[k]) for k in want),
                   "differs_max_abs": {k: float((got[k] - want[k]).abs().max()) for k in want
                                       if not torch.equal(got[k], want[k])},
                   "wgrad_rel_l2": float((wg - wg_ref).norm() / wg_ref.norm())}
    return res


def dp_sweep(mesh):
    """Phase render's 512x512 nadir sweep without jitter through
    render_image_sharded on this rank's run of 4096-ray chunks: its camera
    and shadow forward launches (the wrappers' and the library's counts),
    seconds, and on every rank whether each output is render_image's, bit
    for bit (render_image run first, outside the counts)."""
    import torch

    from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
    from eonerf_code_tpu_torch.models.eonerf import EONerfField
    from eonerf_code_tpu_torch.models.fused import make_render_field
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.render import satellite as sat
    from eonerf_code_tpu_torch.render.nadir import nadir_rays_with_sun

    dev = mesh.device
    field = EONerfField(20, compute_dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    rf = make_render_field(field)
    rays_np, _, _ = nadir_rays_with_sun(512, 512, 35.0, 140.0, np.array([256.0, 256.0, 60.0]))
    rays = satrays_from_tensor(torch.from_numpy(rays_np).to(dev),
                               torch.zeros(rays_np.shape[0], dtype=torch.long, device=dev))
    cfg = sat.RenderConfig(n_samples=128, sc_n_samples=64, perturb=False)
    want = sat.render_image(rf, rays, cfg, True, chunk=N_CHUNK)
    fr.camera_forward.launches = fr.shadow_forward.launches = 0
    stream_before = fr.stream_fwd_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sat.render_image_sharded(rf, rays, cfg, True, mesh, chunk=N_CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stream_now = fr.stream_fwd_kernel_launches()
    return {"rays": rays_np.shape[0], "seconds": seconds,
            "launches": {"camera_fwd": fr.camera_forward.launches,
                         "shadow_fwd": fr.shadow_forward.launches},
            "stream_fwd_kernel_launches": {f"{m}_fwd": stream_now[m] - stream_before[m]
                                           for m in stream_now},
            "bitwise_render_image": all(torch.equal(got[k], want[k]) for k in want),
            "differs_max_abs": {k: float((got[k].float() - want[k].float()).abs().max())
                                for k in want if not torch.equal(got[k], want[k])}}


def dp_worker(device, log_root, exp_name, sweep):
    """A rank of phase 17 (b) and (d): the training run at world 2, the split
    saved pair and, with ``sweep``, the sharded sweep, each timed."""
    from eonerf_code_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.current(2, device)
    t0 = time.perf_counter()
    out = {"train": dp_train(device, log_root, exp_name, 2)}
    out["train_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["split"] = dp_split_check(mesh)
    out["split_s"] = time.perf_counter() - t0
    if sweep:
        out["sweep"] = dp_sweep(mesh)
    return out


def dp_world_two(torch, ranks, ref, label, card):
    """(b) and (d): the gates on the two ranks' results against (a)'s run."""
    a, b = ranks[0]["train"], ranks[1]["train"]
    params_equal = all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    err = [abs(x - y) - (DP_TRAJ_TOL["atol"] + DP_TRAJ_TOL["rtol"] * abs(y))
           for x, y in zip(a["losses"], ref["losses"])]
    expect = dp_expected_launches()
    res = {"phase": "data_parallel", "part": label["part"], "backend": a["mesh"]["backend"],
           "devices": label["devices"], "world": 2, "steps": DP_STEPS, "batch": N_TRAIN,
           "rays_per_rank": N_TRAIN // 2, "pool_rays": N_POOL,
           "loss_first_last": [a["losses"][0], a["losses"][-1]],
           "loss_max_abs_diff_vs_world_1": max(abs(x - y)
                                               for x, y in zip(a["losses"], ref["losses"])),
           "loss_tolerance": DP_TRAJ_TOL, "losses_within": all(e <= 0 for e in err),
           "ranks_params_bitwise": params_equal,
           "launches_by_rank": [ranks[r]["train"]["launches"] for r in (0, 1)],
           "expected_launches_each_rank": expect,
           "split": ranks[0]["split"], "split_tolerance_wgrad_rel_l2": SPLIT_WGRAD_REL_L2,
           "rays_per_s": a["rays_per_s"], "rays_per_s_world_1": ref["rays_per_s"],
           "ms_per_step": a["ms_per_step"], "allreduce_ms": a["allreduce_ms"],
           "seconds": {"train": ranks[0]["train_s"], "split": ranks[0]["split_s"]},
           "card": card}
    emit(res)
    split_ok = all(s["per_ray_bitwise"] and s["wgrad_rel_l2"] <= SPLIT_WGRAD_REL_L2
                   for s in ranks[0]["split"].values())
    if not (res["backend"] == label["backend"] and res["losses_within"] and params_equal
            and split_ok
            and all(ranks[r]["train"]["launches"] == expect for r in (0, 1))):
        raise AssertionError(f"data parallel {label}: {res}")


def data_parallel_phase(torch, dev, card, log_root, eval_args, eval_ortho, scene_info):
    """Phase 17 (a)-(d); ``eval_args`` and ``eval_ortho`` are phase eval's
    orthographic eval_cli arguments and its one-process result on
    train_default's run (its MAE and shift)."""
    from eonerf_code_tpu_torch.cli import eval_cli
    from eonerf_code_tpu_torch.eval import dsm as eval_dsm
    from eonerf_code_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    # (a) world 1 over NCCL in this process, against the plain trainer; then
    # each timed over DP_WINDOWS windows in turn, and traced
    t0 = time.perf_counter()
    plain_tr, plain = dp_trainer(dev, log_root, "chip_smoke_dp_plain", 1)
    windows = {"plain": [], "world_1": []}
    with tempfile.TemporaryDirectory(prefix="eonerf_dp_") as tmp:
        pmesh.setup(0, 1, f"file://{tmp}/rendezvous", "cuda:0")
        try:
            one_tr, one = dp_trainer(torch.device("cuda:0"), log_root, "chip_smoke_dp1", -1)
            for _ in range(DP_WINDOWS):
                windows["plain"].append(dp_window(plain_tr, DP_TIMED))
                windows["world_1"].append(dp_window(one_tr, DP_TIMED))
            traces = {"plain": dp_trace(plain_tr, DP_TRACED),
                      "world_1": dp_trace(one_tr, DP_TRACED)}
            one["allreduce_ms"] = dp_allreduce_ms(one_tr)
        finally:
            pmesh.teardown()
    del plain_tr, one_tr
    ms = {k: statistics.median(v) for k, v in windows.items()}
    one.update(ms_per_step=ms["world_1"], rays_per_s=N_TRAIN * 1e3 / ms["world_1"])
    res_a = {"phase": "data_parallel", "part": "a", "backend": one["mesh"]["backend"],
             "devices": ["cuda:0"], "world": 1, "mesh": one["mesh"], "steps": DP_STEPS,
             "batch": N_TRAIN, "pool_rays": N_POOL,
             "losses_bitwise": one["losses"] == plain["losses"],
             "params_bitwise": all(torch.equal(one["params"][k], plain["params"][k])
                                   for k in plain["params"]),
             "launches": one["launches"], "expected_launches": dp_expected_launches(),
             "rays_per_s": one["rays_per_s"], "rays_per_s_plain": N_TRAIN * 1e3 / ms["plain"],
             "ms_per_step": ms["world_1"], "ms_per_step_plain": ms["plain"],
             "ms_per_step_windows": windows, "window_steps": DP_TIMED, "traces": traces,
             "allreduce_ms": one["allreduce_ms"],
             "seconds": time.perf_counter() - t0, "card": card}
    emit(res_a)
    if not (one["mesh"]["distributed"] and one["mesh"]["backend"] == "nccl"
            and res_a["losses_bitwise"] and res_a["params_bitwise"]
            and one["launches"] == dp_expected_launches()):
        raise AssertionError(f"data parallel (a): {res_a}")

    # (b) world 2 on this card over gloo, and (c) the sharded sweep in the
    # same ranks
    t0 = time.perf_counter()
    ranks = pmesh.launch(dp_worker, {"log_root": str(log_root), "exp_name": "chip_smoke_dp2",
                                     "sweep": True}, 2, "cuda:0")
    launch_s = time.perf_counter() - t0
    dp_world_two(torch, ranks, one, {"part": "b", "backend": "gloo",
                                     "devices": ["cuda:0", "cuda:0"]}, card)
    sweeps = [ranks[r]["sweep"] for r in (0, 1)]
    n_chunks = sweeps[0]["rays"] // N_CHUNK
    totals = {k: sum(s["stream_fwd_kernel_launches"][k] for s in sweeps)
              for k in sweeps[0]["stream_fwd_kernel_launches"]}
    res_c = {"phase": "data_parallel", "part": "c_sweep",
             "backend": ranks[0]["train"]["mesh"]["backend"], "world": 2,
             "rays": sweeps[0]["rays"], "chunk": N_CHUNK,
             "bitwise_render_image": [s["bitwise_render_image"] for s in sweeps],
             "differs_max_abs": sweeps[0]["differs_max_abs"],
             "launches_by_rank": [s["launches"] for s in sweeps],
             "stream_fwd_kernel_launches_by_rank": [s["stream_fwd_kernel_launches"]
                                                    for s in sweeps],
             "expected_total": {"camera_fwd": n_chunks, "shadow_fwd": n_chunks},
             "seconds_by_rank": [s["seconds"] for s in sweeps],
             "launch_and_ranks_s": launch_s, "card": card}
    emit(res_c)
    if not (all(res_c["bitwise_render_image"])
            and totals == {"camera_fwd": n_chunks, "shadow_fwd": n_chunks, "coarse_fwd": 0}
            and all(s["launches"] == {"camera_fwd": n_chunks // 2, "shadow_fwd": n_chunks // 2}
                    for s in sweeps)):
        raise AssertionError(f"data parallel sweep: {res_c}")

    # (c) eval_cli --dsm --data_axis 2 on train_default's run, its MAE and
    # shift (the registration rerun here on the DSM rank 0 wrote) beside
    # phase eval's --data_axis 1
    t0 = time.perf_counter()
    out_root = log_root / "chip_smoke_eval_dp"
    shutil.rmtree(out_root, ignore_errors=True)
    out2 = eval_cli([*eval_args, "--output_dir", str(out_root), "--data_axis", "2"],
                    device="cuda:0")
    eval_s = time.perf_counter() - t0
    shifts = []
    compute_shift = eval_dsm.compute_shift_arrays

    def recorded_shift(*args, **kwargs):
        got = compute_shift(*args, **kwargs)
        shifts.append([int(got[0]), int(got[1])])
        return got

    eval_dsm.compute_shift_arrays = recorded_shift
    try:
        src_id = pathlib.Path(out2["dsm_path"]).stem
        mae_again = eval_dsm.compute_mae_and_save_dsm_diff(
            out2["dsm_path"], src_id, scene_info["gt_dir"], str(out_root / "registration"),
            "dp", scene_info["aoi_id"], save=False)
    finally:
        eval_dsm.compute_shift_arrays = compute_shift
    res_e = {"phase": "data_parallel", "part": "c_eval",
             "backend": pmesh.backend_for("cuda:0", 2), "world": 2,
             "mae_m": out2["mae"], "shift": shifts[-1], "mae_m_reregistered": mae_again,
             "data_axis_1": {"mae_m": eval_ortho["mae_m"], "shift": eval_ortho["shift"]},
             "mae_equal_data_axis_1": out2["mae"] == eval_ortho["mae_m"],
             "dsm_exists": pathlib.Path(out2["dsm_path"]).exists(), "seconds": eval_s,
             "card": card}
    emit(res_e)
    if not (math.isfinite(out2["mae"]) and res_e["dsm_exists"]
            and res_e["mae_equal_data_axis_1"]):
        raise AssertionError(f"data parallel eval: {res_e}")

    # (d) NCCL at world 2, one card a rank, where the machine has two
    if torch.cuda.device_count() >= 2:
        ranks_n = pmesh.launch(dp_worker, {"log_root": str(log_root),
                                           "exp_name": "chip_smoke_dp2_nccl", "sweep": False},
                               2, "cuda")
        dp_world_two(torch, ranks_n, one, {"part": "d", "backend": "nccl",
                                           "devices": ["cuda:0", "cuda:1"]}, card)
    else:
        emit({"phase": "data_parallel", "part": "d", "run": False,
              "why": f"NCCL at world 2 needs two cards; this machine has "
                     f"{torch.cuda.device_count()}", "card": card})
    emit({"phase": "data_parallel", "part": "seconds", "seconds": time.perf_counter() - t_phase,
          "card": card})


# ---- 18. multi_aoi (parallel/multi_aoi.py, train/multi.py): two scenes,
# one model each, through the command line a user calls, and the trainer ----

MA_STEPS = 20
MA_SHADOW_FROM = 10
MA_TIMED = 20               # steps a timed window, not gated
MA_WINDOWS = ("single", "multi", "multi", "single")
MA_BITS_STEPS = 3           # (b): one step without shadows, two with
MA_SPLIT_STEPS = 6          # (d): --scene_axis 2 against 1, and 3 + 3 resumed
# (e): the JAX pin's configuration (run B's: e2e.PIN with e2e.WIDE) as flags
# of the multi-AOI command line, whose loss takes the beta term on every step
MA_PIN_FLAGS = ("--sampler", "uniform", "--n_samples", "64", "--batch_size", "2048",
                "--lr_decay_steps", "1000", "--first_shadow_step", "1500", "--seed", "0",
                "--log_every", "500")


def ma_argv(infos, logs, exp, steps, *extra):
    """The multi-AOI command line over the scenes ``infos`` at 8x256 bf16
    (the kernels and the saved backward: the defaults on the card)."""
    return ["--root_dirs", ",".join(i["root_dir"] for i in infos),
            "--img_dirs", ",".join(i["img_dir"] for i in infos),
            "--gt_dirs", ",".join(i["gt_dir"] for i in infos), "--logs_dir", str(logs),
            "--exp_name", exp, "--max_train_steps", str(steps), "--compute_dtype", "bfloat16",
            *extra]


def ma_states(logs, exp, names):
    """Each scene's run-dir checkpoint and every pod checkpoint of a run."""
    from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib

    run = pathlib.Path(logs) / exp
    out = {n: ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(str(run / n)))
           for n in names}
    out["_pod"] = {p.name: ckpt_lib.restore_checkpoint(str(p))
                   for p in sorted((run / "_pod" / "ckpts").iterdir())}
    return out


def ma_differs(a, b, path=""):
    """The paths at which two nested states differ (NaN equal to NaN)."""
    import torch

    if isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            return [path or "/"]
        return [d for k in a for d in ma_differs(a[k], b[k], f"{path}/{k}")]
    if torch.is_tensor(a):
        same = (torch.is_tensor(b) and a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a.nan_to_num(), b.nan_to_num())))
        return [] if same else [path]
    return [] if a == b else [path]


def ma_timed(get, put, run, steps):
    """ms a step over ``steps`` steps of ``run(n)``, from CUDA events after
    each call of the step function that ``get`` returns (``put`` swaps it):
    the last scene's step of a multi-AOI step, or the single-AOI trainer's."""
    import torch

    events, step_fn = [], get()

    def step(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
        return out

    put(step)
    try:
        run(steps + 1)
        torch.cuda.synchronize()
    finally:
        put(step_fn)
    return events[0].elapsed_time(events[-1]) / steps


def multi_aoi_phase(torch, dev, card, log_root, scene_info, kernel_rows):
    """Phase 18 (a)-(e); ``scene_info`` is phase data's 20-view scene."""
    from eonerf_code_tpu_torch import e2e
    from eonerf_code_tpu_torch.cli import eval_cli
    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.data.satellite import SatelliteDataset
    from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec, generate_scene
    from eonerf_code_tpu_torch.models.fused import KernelField
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.parallel.multi_aoi import MultiAOITrainer
    from eonerf_code_tpu_torch.train import checkpoints as ckpt_lib
    from eonerf_code_tpu_torch.train.loop import Trainer, ray_pool
    from eonerf_code_tpu_torch.train.multi import main_multi_train

    t_phase = time.perf_counter()
    root = log_root / "chip_smoke_multi_aoi"
    shutil.rmtree(root, ignore_errors=True)
    # the quality phase's scene and a second of its kind (another seed),
    # under AOI ids of their own
    aois = ["SYN_100", "SYN_101"]
    small = [generate_scene(str(root / f"scene_{aoi}"),
                            SyntheticSceneSpec(**dict(e2e.SCENE, seed=seed)), aoi_id=aoi)
             for seed, aoi in enumerate(aois)]
    small_aois = ["--aoi_ids", ",".join(aois)]

    # (a) phase data's 20-view 256x256 scene beside the quality scene
    # (unequal pools), 8x256 bf16 through the kernels, saved, batch 1024
    names_a = [scene_info["aoi_id"], aois[0]]
    counts = Launches(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats_a = main_multi_train(ma_argv([scene_info, small[0]], root, "pod_a", MA_STEPS,
                                       "--batch_size", str(N_TRAIN), "--first_shadow_step",
                                       str(MA_SHADOW_FROM), "--log_every", "10", "--aoi_ids",
                                       ",".join(names_a)), device="cuda")
    torch.cuda.synchronize()
    seconds_a = time.perf_counter() - t0
    launches = counts.read()
    one = expected_train_launches({"compute_dtype": "bfloat16"}, MA_STEPS,
                                  MA_STEPS - MA_SHADOW_FROM)
    expect = {k: 2 * v for k, v in one.items()}
    got = {k: launches[k] for k in launches if k in expect or k in counts.fns}
    want = {k: expect.get(k, 0) for k in got}
    by_path(kernel_rows, "multi_aoi", got)
    opts = [TrainConfig.load(str(root / "pod_a" / n / "opts.json")) for n in names_a]
    evals = []
    for n in names_a:
        t0 = time.perf_counter()
        out = eval_cli([f"pod_a/{n}", "--logs_dir", str(root), "--output_dir",
                        str(root / "eval"), "--dsm",
                        "--dsm_resolution", str(SyntheticSceneSpec().dsm_resolution)],
                       device="cuda")
        evals.append({"run": n, "mae_m": out["mae"], "seconds": time.perf_counter() - t0})
    res_a = {"phase": "multi_aoi", "part": "a", "scenes": names_a, "steps": MA_STEPS,
             "shadows_from": MA_SHADOW_FROM, "batch_per_scene": N_TRAIN,
             "resolved": [{k: getattr(c, k) for k in ("sampler", "n_samples", "sc_n_samples",
                                                       "occ_tighten", "use_pallas", "bwd_acts")}
                          for c in opts],
             "launches": got, "expected_launches": want,
             "expected_launches_one_scene": one, "seconds": seconds_a,
             "rays_per_s_cli": stats_a["rays_per_sec"], "eval": evals, "card": card}
    emit(res_a)
    if not (got == want and all(c.use_pallas is True and c.bwd_acts == "saved" for c in opts)
            and all(math.isfinite(e["mae_m"]) for e in evals)):
        raise AssertionError(f"multi_aoi (a): {res_a}")

    # (b), (c) and the rates on the two small scenes, through the trainer
    ds = [SatelliteDataset(i["root_dir"], i["img_dir"], split="train") for i in small]
    kw = dict(device=dev, compute_dtype=torch.bfloat16, use_pallas=True, n_samples=64,
              sc_n_samples=64, batch_size=N_TRAIN, seed=0)
    # (b) scene 0 beside scene 1 and alone: the same weights (seed, 0) and
    # image count, the same draws (seed, step, 0)
    pair = MultiAOITrainer(ds, None, **kw)
    alone = MultiAOITrainer(ds[:1], None, n_images=pair.n_images, **kw)
    if not (isinstance(pair.render_fields[0], KernelField) and pair.render_fields[0].save_acts):
        raise RuntimeError("the multi-AOI trainer did not pick the saved kernels")
    for tr in (pair, alone):
        tr.train_steps(1, shadows=False)
        tr.train_steps(MA_BITS_STEPS - 1, shadows=True)
    sp, sa = pair.state_pytree(), alone.state_pytree()
    scene0 = {"params": {k: v[:1] for k, v in sp["params"].items()},
              "opt_state": {"count": sp["opt_state"]["count"][:1],
                            "mu": {k: v[:1] for k, v in sp["opt_state"]["mu"].items()},
                            "nu": {k: v[:1] for k, v in sp["opt_state"]["nu"].items()}}}
    differs_b = ma_differs(scene0, {"params": sa["params"], "opt_state": sa["opt_state"]})
    res_b = {"phase": "multi_aoi", "part": "b", "steps": MA_BITS_STEPS,
             "scene_0_beside_scene_1_is_alone": not differs_b, "differs": differs_b[:10],
             "card": card}
    emit(res_b)
    del pair, alone, sp, sa, scene0
    if differs_b:
        raise AssertionError(f"multi_aoi (b): {res_b}")

    # (c) the kernel path against the per-sample path (the module in bf16):
    # one shadowed step from the same weights and draws; then the
    # hierarchical sampler's coarse kernel, once a scene and step
    paths = {p: MultiAOITrainer(ds, None, **{**kw, "use_pallas": p}) for p in (True, False)}
    losses_c = {p: tr.train_steps(1, shadows=True) for p, tr in paths.items()}
    grad_rel = []
    for fk, fp in zip(paths[True].fields, paths[False].fields):
        gk = torch.cat([p.grad.float().reshape(-1) for p in fk.parameters()])
        gp = torch.cat([p.grad.float().reshape(-1) for p in fp.parameters()])
        grad_rel.append(float((gk - gp).norm() / gp.norm()))
    loss_rel = float((losses_c[True] / losses_c[False] - 1).abs().max())
    del paths
    fr.coarse_forward.launches = 0
    hier = MultiAOITrainer(ds, None, **{**kw, "n_samples": 48, "n_importance": 24})
    hier.train_steps(2, shadows=True)
    coarse = fr.coarse_forward.launches
    del hier
    res_c = {"phase": "multi_aoi", "part": "c", "loss_kernels": losses_c[True].tolist(),
             "loss_per_sample": losses_c[False].tolist(), "loss_max_rel": loss_rel,
             "grad_rel_l2": grad_rel, "tolerance": GRAD_PATH_REL_L2,
             "hierarchical_coarse_launches": coarse, "expected_coarse_launches": 2 * 2,
             "card": card}
    emit(res_c)
    if not (loss_rel <= GRAD_PATH_REL_L2 and max(grad_rel) <= GRAD_PATH_REL_L2
            and coarse == 2 * 2):
        raise AssertionError(f"multi_aoi (c): {res_c}")

    # the two-scene step against the single-AOI trainer's on the same
    # configuration (uniform, shadows and the beta loss on), CUDA events
    # after each step, windows in turn
    single = Trainer(TrainConfig(logs_dir=str(root), exp_name="single", sampler="uniform",
                                 occ_enabled=False, compute_dtype="bfloat16",
                                 batch_size=N_TRAIN, n_samples=64, sc_n_samples=64,
                                 first_shadow_step=0, first_beta_step=0, save_freq=10 ** 9,
                                 seed=0),
                     ray_pool(ds[0]), n_images=len(ds[0].json_files), device=dev)
    multi = MultiAOITrainer(ds, None, **kw)
    single.run(max_steps=2, log_every=10 ** 9)
    multi.train_steps(2, shadows=True)
    windows = {"single": [], "multi": []}
    for who in MA_WINDOWS:
        if who == "single":
            ms = ma_timed(lambda: single.train_step,
                          lambda f: setattr(single, "train_step", f),
                          lambda n: single.run(max_steps=single.step + n, log_every=10 ** 9),
                          MA_TIMED)
        else:
            ms = ma_timed(lambda: multi._steps[-1], lambda f: multi._steps.__setitem__(-1, f),
                          lambda n: multi.train_steps(n, shadows=True), MA_TIMED)
        windows[who].append(ms)
    ms = {k: statistics.median(v) for k, v in windows.items()}
    emit({"phase": "multi_aoi", "part": "rate", "batch_per_scene": N_TRAIN,
          "ms_per_step": ms, "ms_per_step_windows": windows, "window_steps": MA_TIMED,
          "rays_per_s_single": N_TRAIN * 1e3 / ms["single"],
          "rays_per_s_two_scenes": 2 * N_TRAIN * 1e3 / ms["multi"], "card": card})
    del single, multi, ds
    torch.cuda.empty_cache()

    # (d) --scene_axis 2 over gloo, both ranks on this card, against
    # --scene_axis 1; 3 steps, a pod checkpoint, --resume to 6 against 6
    t0 = time.perf_counter()
    split = ("--batch_size", str(N_TRAIN), "--n_samples", "64", "--first_shadow_step", "2",
             "--occ_tighten_start_step", "0", "--save_freq", "3", *small_aois)
    main_multi_train(ma_argv(small, root, "one", MA_SPLIT_STEPS, *split, "--scene_axis", "1"),
                     device="cuda:0")
    t1 = time.perf_counter()
    main_multi_train(ma_argv(small, root, "two", MA_SPLIT_STEPS, *split, "--scene_axis", "2"),
                     device="cuda:0")
    t2 = time.perf_counter()
    main_multi_train(ma_argv(small, root, "res", MA_SPLIT_STEPS // 2, *split), device="cuda:0")
    resumed = main_multi_train(ma_argv(small, root, "res", MA_SPLIT_STEPS, *split, "--resume"),
                               device="cuda:0")
    st = {e: ma_states(root, e, aois) for e in ("one", "two", "res")}
    differs_two = ma_differs(st["one"], st["two"])
    differs_res = ma_differs(st["one"], st["res"])
    res_d = {"phase": "multi_aoi", "part": "d", "backend": "gloo", "devices": ["cuda:0"] * 2,
             "steps": MA_SPLIT_STEPS, "pod_checkpoints": sorted(st["two"]["_pod"]),
             "scene_axis_2_is_1": not differs_two, "differs": differs_two[:10],
             "resumed_steps_run": resumed["steps_run"], "resume_is_uninterrupted": not differs_res,
             "differs_resumed": differs_res[:10],
             "seconds": {"scene_axis_1": t1 - t0, "scene_axis_2": t2 - t1,
                         "resumed": time.perf_counter() - t2}, "card": card}
    emit(res_d)
    emit({"phase": "multi_aoi", "part": "d_nccl", "run": False,
          "why": "NCCL across scene groups needs a card a rank; this run shares one card over "
                 f"gloo ({torch.cuda.device_count()} visible)", "card": card})
    if differs_two or differs_res or resumed["steps_run"] != MA_SPLIT_STEPS // 2:
        raise AssertionError(f"multi_aoi (d): {res_d}")

    # (e) the JAX pin's kind twice over: 2000 steps of both scenes at run B's
    # configuration, each scene's registered MAE (the first val view's depth,
    # e2e.score) under the pin's 1.5 m
    counts = Launches(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats_e = main_multi_train(ma_argv(small, root, "pin", e2e.STEPS, *MA_PIN_FLAGS,
                                       *small_aois), device="cuda")
    torch.cuda.synchronize()
    seconds_e = time.perf_counter() - t0
    launches_e = counts.read()
    expect_e = {k: 2 * v for k, v in expected_train_launches(
        {"compute_dtype": "bfloat16"}, e2e.STEPS, e2e.STEPS - e2e.PIN["first_shadow_step"]).items()}
    got_e = {k: launches_e[k] for k in launches_e if k in expect_e or k in counts.fns}
    want_e = {k: expect_e.get(k, 0) for k in got_e}
    scores = {}
    for info, aoi in zip(small, aois):
        scorer = e2e.make_trainer(info, str(root), f"score_{aoi}", e2e.STEPS, dev,
                                  **e2e.RUNS["B"])
        state = ckpt_lib.restore_checkpoint(ckpt_lib.latest_checkpoint(
            str(root / "pin" / aoi)), map_location="cpu")
        scorer.field.load_state_dict(state["params"])
        scores[aoi] = e2e.score(scorer)
        del scorer
    res_e = {"phase": "multi_aoi", "part": "e", "steps": e2e.STEPS,
             "flags": list(MA_PIN_FLAGS), "seconds": seconds_e,
             "rays_per_s_cli": stats_e["rays_per_sec"], "launches": got_e,
             "expected_launches": want_e, "scores": scores, "gate_m": QUALITY_MAE_M,
             "card": card}
    emit(res_e)
    if not (got_e == want_e and all(s["mae_m"] < QUALITY_MAE_M for s in scores.values())):
        raise AssertionError(f"multi_aoi (e): {res_e}")
    emit({"phase": "multi_aoi", "part": "seconds", "seconds": time.perf_counter() - t_phase,
          "card": card})
    shutil.rmtree(root, ignore_errors=True)


# phase 19: train_mlp_nerf.py's defaults on e2e.vanilla's scene; the JAX
# pin's gate (tests/test_blender.py:114) after 300 steps
VANILLA_STEPS = 300
VANILLA_PSNR_DB = 18.0
VANILLA_CHUNK = 8192         # eval_psnr's own chunk
VANILLA_WARMUP, VANILLA_TIMED = 5, 20
# DNeRF on the card against the CPU, max abs: float32 both (TF32 off),
# cuBLAS and the CPU sum in another order
DNERF_TOL = 1e-4
DNERF_RAYS, DNERF_SAMPLES = 1024, 64
VANILLA_TRACED = 5
# the vanilla step's library kernels by a substring of the lowercased name,
# first match wins
VANILLA_GROUPS = (("gemm", "gemm"), ("adam (foreach)", "multi_tensor_apply"),
                  ("concat", "catarray"), ("reduce", "reduce_kernel"), ("scan", "scan"),
                  ("index", "index"), ("elementwise", "elementwise"))


def vanilla_group(name):
    low = name.lower()
    return next((g for g, key in VANILLA_GROUPS if key in low), "other")


def vanilla_phase(torch, dev, card, log_root):
    """Phase 19 (see the module's docstring)."""
    import train_mlp_nerf_torch
    from eonerf_code_tpu_torch import e2e
    from eonerf_code_tpu_torch.train import train_vanilla as tv
    from eonerf_code_tpu_torch.train.profile_step import trace

    t_phase = time.perf_counter()
    root = log_root / "chip_smoke_vanilla"
    shutil.rmtree(root, ignore_errors=True)
    data_root, subject = e2e.vanilla(str(root))

    # the entry point as a user calls it; the result of its train_vanilla
    # call is kept for the timings below
    results, real = [], train_mlp_nerf_torch.train_vanilla

    def keep(**kw):
        results.append(real(**kw))
        return results[-1]

    train_mlp_nerf_torch.train_vanilla = keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psnr = train_mlp_nerf_torch.main([
            "--data_root", data_root, "--scene", subject, "--train_split", "train",
            "--logs_dir", str(root / "logs"), "--max_steps", str(VANILLA_STEPS),
            "--test_chunk_size", str(VANILLA_CHUNK)])
        torch.cuda.synchronize()
        seconds_cli = time.perf_counter() - t0
    finally:
        train_mlp_nerf_torch.train_vanilla = real
    res = results[0]
    model, grid, rcfg, ds = res["model"], res["grid"], res["rcfg"], res["dataset"]
    devices = {"params": sorted({p.device.type for p in model.parameters()}),
               "grid": [grid.occs.device.type, grid.binaries.device.type]}
    with open(root / "logs" / f"vanilla_{subject}" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    rays_logged = [r["value"] for r in logged if r["tag"] == "perf/rays_per_sec"]

    # the eval render of the test views (already on the host as rays)
    test_ds = type(ds)(subject, data_root, split="test")
    views = [test_ds.full_image(i) for i in range(len(test_ds))]
    n_eval = sum(v["rays_o"].shape[0] for v in views)
    eval_ms = time_ms(torch, lambda: [tv.render_view(model, grid, rcfg, v, VANILLA_CHUNK)
                                      for v in views], 3)
    background_db = float(np.mean([-10 * np.log10(np.mean((1.0 - v["pixels"]) ** 2))
                                   for v in views]))
    # a whole-grid update, then a training step as train_vanilla takes it
    gen = torch.Generator(device=dev).manual_seed(1)
    grid_ms = time_ms(torch, lambda: tv.occ_update(model, grid, rcfg, gen), 5)
    opt = tv.make_optimizer(model, 5e-4)

    def step():
        tv.train_step(model, opt, grid, tv.batch_to(ds.sample_batch(), dev), rcfg, 5e-4, gen)

    for _ in range(VANILLA_WARMUP - 1):
        step()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(torch, step, VANILLA_TIMED)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    traced_ms, per_group, host = trace(lambda: time_ms(torch, step, VANILLA_TRACED),
                                       VANILLA_TRACED + 1, group_of=vanilla_group)
    res_a = {"phase": "vanilla", "part": "train", "steps": VANILLA_STEPS,
             "batch": ds.num_rays, "n_samples": rcfg.n_samples, "grid": grid.resolution,
             "frames": len(ds), "psnr_db": psnr, "gate_db": VANILLA_PSNR_DB,
             "psnr_background_only_db": background_db, "seconds_cli": seconds_cli,
             "seconds_train": res["elapsed_s"], "rays_per_s_logged": rays_logged[-1],
             "step_ms": step_ms, "rays_per_s_step": ds.num_rays / step_ms * 1e3,
             "steps_timed": VANILLA_TIMED, "grid_update_ms": grid_ms,
             "eval_rays": n_eval, "eval_ms": eval_ms, "eval_rays_per_s": n_eval / eval_ms * 1e3,
             "peak_mem_gib": peak_gib, "devices": devices, "card": card}
    emit(res_a)
    device_ms = sum(per_group.values())
    emit({"phase": "vanilla", "part": "trace", "steps": VANILLA_TRACED, "ms_per_step": traced_ms,
          "device_ms_per_step": per_group, "device_ms_total": device_ms,
          "idle_share": 1.0 - device_ms / traced_ms if device_ms else None,
          "host_self_ms_top": host, "card": card})
    if not (psnr > VANILLA_PSNR_DB and devices == {"params": ["cuda"], "grid": ["cuda"] * 2}):
        raise AssertionError(f"vanilla: {res_a}")
    del model, grid, opt, res, results

    # the JAX pin's own flags (tests/test_blender.py:104-111; 2x32, batch
    # 256, 17 samples, a 16^3 grid) on the card, all 8 test views
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psnr_pin = train_mlp_nerf_torch.main([
        "--data_root", data_root, "--scene", subject, "--train_split", "train",
        "--logs_dir", str(root / "logs_pin"), "--max_steps", str(VANILLA_STEPS),
        "--batch_size", "256", "--net_depth", "2", "--net_width", "32", "--n_samples", "17",
        "--grid_resolution", "16", "--test_chunk_size", str(VANILLA_CHUNK)])
    res_pin = {"phase": "vanilla", "part": "pin", "steps": VANILLA_STEPS, "psnr_db": psnr_pin,
               "gate_db": VANILLA_PSNR_DB, "psnr_background_only_db": background_db,
               "seconds_cli": time.perf_counter() - t0, "card": card}
    emit(res_pin)
    if not psnr_pin > VANILLA_PSNR_DB:
        raise AssertionError(f"vanilla pin: {res_pin}")
    dnerf_check(torch, dev, card)
    emit({"phase": "vanilla", "part": "seconds", "seconds": time.perf_counter() - t_phase,
          "card": card})
    shutil.rmtree(root, ignore_errors=True)


def dnerf_check(torch, dev, card):
    """Phase 19's DNeRF line: its widths, the card against the CPU on the
    same weights and points."""
    from eonerf_code_tpu_torch.models.dnerf import DNeRF

    rng = np.random.default_rng(0)
    x = rng.uniform(-1.5, 1.5, (DNERF_RAYS, DNERF_SAMPLES, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (DNERF_RAYS, 1, 1)).astype(np.float32)
    d = rng.normal(size=(DNERF_RAYS, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    outs = []
    for device in ("cpu", dev):
        m = DNeRF(device=device, generator=torch.Generator().manual_seed(2))
        args = [torch.from_numpy(a).to(device) for a in (x, t, d)]
        with torch.no_grad():
            rgb, sigma = m(*args)
            outs.append([o.cpu() for o in (rgb, sigma, m.density(*args[:2]))])
    on_card = all(p.device.type == "cuda" for p in m.parameters())
    (c_rgb, c_sigma, c_dens), (g_rgb, g_sigma, g_dens) = outs
    res_b = {"phase": "vanilla", "part": "dnerf", "points": DNERF_RAYS * DNERF_SAMPLES,
             "max_abs": {"rgb": float((g_rgb - c_rgb).abs().max()),
                         "sigma": float((g_sigma - c_sigma).abs().max()),
                         "density": float((g_dens - c_dens).abs().max())},
             "tol": DNERF_TOL, "rgb_range": [float(g_rgb.min()), float(g_rgb.max())],
             "sigma_min": float(g_sigma.min()), "sigma_max": float(g_sigma.max()),
             "params_on_card": on_card, "card": card}
    emit(res_b)
    if not (on_card and max(res_b["max_abs"].values()) <= DNERF_TOL
            and 0.0 <= res_b["rgb_range"][0] and res_b["rgb_range"][1] <= 1.0
            and res_b["sigma_min"] >= 0.0):
        raise AssertionError(f"vanilla dnerf: {res_b}")


NATIVE_POINTS = 1_024_000     # one pass over the production scene's 10 views of 320x320
NATIVE_LOCALIZE_ATOL = 1e-14  # tests/test_torch_native.py's pin (the JAX package's)
NATIVE_TURNS = ("native", "numpy", "native")
PROD_STEPS = 60
PROD_TIGHTEN_FROM = 10       # the gates moved from steps 2000 / 6000 / 12000
PROD_SHADOW_FROM = 20
PROD_BETA_FROM = 40
PROD_OCC_EVERY = 5           # the grid updated at steps 0, 5, .., 55 (the run's: every 50)


def step_probe(trainer):
    """e2e.StepProbe on ``trainer``'s step (``tightened``: one bool a
    step, whether the sampler had the grid), keeping each step's loss too
    (``losses``, on the card, read at the end)."""
    from eonerf_code_tpu_torch import e2e

    class LossProbe(e2e.StepProbe):
        def step(self, *args, **kwargs):
            out = super().step(*args, **kwargs)
            self.losses.append(out["loss"])
            return out

    probe = LossProbe(trainer)
    probe.losses = []
    return probe


class NumpyRPC:
    """An RPCModel whose localization takes the numpy solve at any size."""

    def __init__(self, rpc):
        self.rpc = rpc

    def localization(self, col, row, alt):
        return self.rpc.localization(col, row, alt, use_native=False)


def native_phase(card, log_root, eval_pair):
    """Phase 20: the native host library on the card's host. The build
    (phase build made it), g++'s version and the threads; rpc_localize
    against the numpy solve on NATIVE_POINTS points of a production view's
    RPC (lon/lat within NATIVE_LOCALIZE_ATOL); ncc_search against the numpy
    search on phase eval's DSM pair (the same shift); cast_rays of one
    320x320 view through both paths in turns (NATIVE_TURNS); the production
    scene's generate_scene and SatelliteDataset through the native path.
    Returns the production scene's info dict."""
    from eonerf_code_tpu_torch import e2e, native
    from eonerf_code_tpu_torch.data.satellite import SatelliteDataset, cast_rays
    from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec
    from eonerf_code_tpu_torch.eval import registration as reg
    from eonerf_code_tpu_torch.geo.rpc import localize
    from eonerf_code_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    lib_path, _ = native.build()
    gxx = subprocess.run([_build.gxx_path(), "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    threads = os.environ.get("OMP_NUM_THREADS") or f"OMP_NUM_THREADS unset, {os.cpu_count()} cores"

    root = log_root / "chip_smoke_production"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    info = e2e.make_scene(str(root), "scene", **e2e.PRODUCTION_SCENE)
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = SatelliteDataset(info["root_dir"], info["img_dir"], split="train")
    dataset_s = time.perf_counter() - t0
    pool_shape = list(ds.all_rays.shape)
    rpc = ds.all_rpcs[0]
    size = e2e.PRODUCTION_SCENE["img_size"]
    spec = SyntheticSceneSpec(**e2e.PRODUCTION_SCENE)
    del ds

    rng = np.random.default_rng(0)
    cols, rows = rng.uniform(0, size, NATIVE_POINTS), rng.uniform(0, size, NATIVE_POINTS)
    alts = rng.uniform(spec.min_alt, spec.max_alt, NATIVE_POINTS)
    t0 = time.perf_counter()
    lon_c, lat_c = native.rpc_localize(rpc, cols, rows, alts)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lon_p, lat_p = localize(rpc.coeffs(), cols, rows, alts)
    numpy_s = time.perf_counter() - t0
    loc = {"points": NATIVE_POINTS, "native_s": native_s, "numpy_s": numpy_s,
           "speedup": numpy_s / native_s,
           "max_abs_lon": float(np.abs(lon_c - lon_p).max()),
           "max_abs_lat": float(np.abs(lat_c - lat_p).max()), "tolerance": NATIVE_LOCALIZE_ATOL}

    grid_c, grid_r = np.meshgrid(np.arange(size), np.arange(size))
    times, rays = {"native": [], "numpy": []}, {}
    for turn in NATIVE_TURNS:
        model = rpc if turn == "native" else NumpyRPC(rpc)
        t0 = time.perf_counter()
        rays[turn] = cast_rays(grid_c.ravel(), grid_r.ravel(), model, spec.min_alt, spec.max_alt)
        times[turn].append(time.perf_counter() - t0)
    diff = np.abs(rays["native"].astype(np.float64) - rays["numpy"])
    ulp = np.spacing(np.abs(rays["numpy"]).astype(np.float32)).astype(np.float64)
    cast = {"pixels": size * size, "native_s": times["native"], "numpy_s": times["numpy"],
            "same_bits": bool(np.array_equal(rays["native"], rays["numpy"])),
            "max_abs": float(diff.max()), "max_ulps": float((diff / ulp).max())}

    u, v = (np.asarray(a, np.float64) for a in eval_pair)
    u, v = (a if a.ndim == 3 else a[None] for a in (u, v))
    t0 = time.perf_counter()
    shift_c = native.ncc_search(u[0], v[0], 5, 0, 0)
    ncc_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    shift_p = reg.compute_ncc(u, v, 5, 0, 0, use_native=False)
    ncc_numpy_s = time.perf_counter() - t0
    ncc = {"shape": list(u.shape[1:]), "finite": int(np.isfinite(u).sum()),
           "native_shift": list(shift_c), "numpy_shift": list(shift_p),
           "native_s": ncc_native_s, "numpy_s": ncc_numpy_s}
    res = {"phase": "native", "library": lib_path.name, "gxx": gxx, "threads": threads,
           "localize": loc, "cast_rays_view": cast, "ncc": ncc,
           "production_scene_s": scene_s, "production_dataset_s": dataset_s,
           "production_pool_shape": pool_shape, "seconds": time.perf_counter() - t_phase,
           "card": card}
    emit(res)
    if not (loc["max_abs_lon"] <= NATIVE_LOCALIZE_ATOL and loc["max_abs_lat"] <= NATIVE_LOCALIZE_ATOL):
        raise AssertionError(f"native localization against numpy: {loc}")
    if shift_c != shift_p:
        raise AssertionError(f"native NCC search against numpy: {ncc}")
    if cast["max_ulps"] > 1.0:
        raise AssertionError(f"cast_rays native against numpy: {cast}")
    if pool_shape != [spec.n_views * size * size, 11]:
        raise AssertionError(f"the production pool is {pool_shape}")
    return info


def production_phase(torch, dev, card, log_root, info, kernel_rows):
    """Phase 21: the production scene (e2e.py's production run) at its
    configuration, the gates moved to steps PROD_TIGHTEN_FROM,
    PROD_SHADOW_FROM and PROD_BETA_FROM and the grid updated every
    PROD_OCC_EVERY steps, PROD_STEPS steps: the launches of rows 1-4 by the
    wrappers' and the library's counts (row 8 none: the grid update reads
    the plain field, as the JAX trainer's does, and the entropy probe is
    off), finite losses, rays/s by CUDA events over steps 1 ..
    PROD_STEPS - 1, then view 0's registered MAE (finite). The stability
    gate reads the updates' own history, nothing seeded: it must open at
    or after PROD_TIGHTEN_FROM and hold to the last step (on an H100 the
    occupied fraction settled by the 6th update and the gate opened at
    step 45). A check of the path, not of quality."""
    from eonerf_code_tpu_torch import e2e
    from eonerf_code_tpu_torch.models.fused import KernelField
    from eonerf_code_tpu_torch.ops import fused_field as ff
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    workdir = log_root / "chip_smoke_production"
    shutil.rmtree(workdir / "logs", ignore_errors=True)
    cfg = e2e.scale_config("production", info, str(workdir), PROD_STEPS,
                           occ_tighten_start_step=PROD_TIGHTEN_FROM,
                           first_shadow_step=PROD_SHADOW_FROM, first_beta_step=PROD_BETA_FROM,
                           occ_update_every=PROD_OCC_EVERY)
    t0 = time.perf_counter()
    tp = Trainer(cfg, device=dev)
    trainer_s = time.perf_counter() - t0
    if not (isinstance(tp.render_field, KernelField) and not tp.render_field.save_acts
            and tp.cfg.sampler == "tighten"):
        raise RuntimeError(f"the production configuration took {type(tp.render_field).__name__}"
                           f", sampler {tp.cfg.sampler}")
    probe = step_probe(tp)
    counts = Launches(fr)
    ff.density_forward.launches = 0
    point0 = ff.point_fwd_kernel_launches()
    tp.run(max_steps=1, log_every=10 ** 9)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    tp.run(max_steps=PROD_STEPS, log_every=10 ** 9)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    launches = counts.read()
    launches["density_fwd"] = ff.density_forward.launches
    launches["density_fwd_point_kernel"] = ff.point_fwd_kernel_launches()["density"] - point0["density"]
    shadow_steps = PROD_STEPS - PROD_SHADOW_FROM
    expect = {"camera_fwd": PROD_STEPS, "camera_bwd": PROD_STEPS, "shadow_fwd": shadow_steps,
              "shadow_bwd": shadow_steps, "camera_fwd_stream_kernel": PROD_STEPS,
              "shadow_fwd_stream_kernel": shadow_steps, "coarse_fwd_stream_kernel": 0,
              "dgrad_kernel": PROD_STEPS + shadow_steps,
              # the grid update reads the plain field, as the JAX trainer's
              # does (its train/loop.py:287-291), and the entropy probe is
              # off (occ_entropy_max None): row 8 stays off this path
              "density_fwd": 0, "density_fwd_point_kernel": 0}
    got = {k: launches[k] for k in launches if k in expect or k in counts.fns}
    want = {k: expect.get(k, 0) for k in got}
    losses = [float(x) for x in probe.losses]
    tightened = probe.tightened
    t0 = time.perf_counter()
    mae = e2e.view_mae(tp)
    mae_s = time.perf_counter() - t0
    res = {"phase": "production", "pool_rays": tp.n_rays, "batch": cfg.batch_size,
           "sampler": tp.cfg.sampler, "n_samples": tp.cfg.n_samples,
           "sc_n_samples": tp.cfg.sc_n_samples, "bwd_acts": tp.cfg.bwd_acts, "steps": tp.step,
           "gates": {"tighten": PROD_TIGHTEN_FROM, "shadow": PROD_SHADOW_FROM,
                     "beta": PROD_BETA_FROM, "occ_update_every": PROD_OCC_EVERY},
           "occupied_fraction": tp._occ_frac_hist,
           "tightened_steps": sum(tightened),
           "tightened_from": tightened.index(True) if any(tightened) else None,
           "span_share": e2e.span_share(tp),
           "losses_finite": all(math.isfinite(x) for x in losses),
           "loss_first_last": [losses[0], losses[-1]],
           "ms_per_step": ms / (PROD_STEPS - 1),
           "rays_per_s": cfg.batch_size * (PROD_STEPS - 1) / (ms * 1e-3),
           "mae_m": mae, "mae_s": mae_s, "trainer_s": trainer_s, "launches": got,
           "expected_launches": want, "seconds": time.perf_counter() - t_phase, "card": card}
    emit(res)
    by_path(kernel_rows, "production", {k: got[k] for k in ("camera_fwd", "camera_bwd", "shadow_fwd",
                                                            "shadow_bwd")})
    if got != want:
        raise AssertionError(f"production launched otherwise: {res}")
    if not (res["losses_finite"] and math.isfinite(mae)):
        raise AssertionError(f"production: a loss or the MAE is not finite: {res}")
    opened = res["tightened_from"]
    if opened is None or opened < PROD_TIGHTEN_FROM or not all(tightened[opened:]):
        raise AssertionError(f"production: the gate did not open from step {PROD_TIGHTEN_FROM} "
                             f"and hold: {res}")
    del tp
    torch.cuda.empty_cache()
    return res


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1

    from eonerf_code_tpu_torch import native
    from eonerf_code_tpu_torch.bench import backward_passes as bp
    from eonerf_code_tpu_torch.bench import stream_fwd as sf
    from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
    from eonerf_code_tpu_torch.eval.device import device_dsm_mae
    from eonerf_code_tpu_torch.models.eonerf import EONerfField
    from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
    from eonerf_code_tpu_torch.ops import _build
    from eonerf_code_tpu_torch.ops import fused_field as ff
    from eonerf_code_tpu_torch.ops import fused_render as fr
    from eonerf_code_tpu_torch.ops.fused_field import (
        density_subset,
        flatten_weights,
        is_bias,
        pack_params,
    )
    from eonerf_code_tpu_torch.ops.raster import rasterize_pointcloud
    from eonerf_code_tpu_torch.ops.sampling import set_last_valid
    from eonerf_code_tpu_torch.render import satellite as sat
    from eonerf_code_tpu_torch.render.nadir import nadir_rays_with_sun

    # the plain versions' float32 products must not drop to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. build ----
    t0 = time.perf_counter()
    phase_src = bp.phase_source()   # the dgrad kernel's instrumented copy (bench/backward_passes.py)
    fwd_phase_src = sf.phase_source()   # the streamed forwards' (bench/stream_fwd.py)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:   # one compiler a source, all together
        phase_build = pool.submit(_build.build, phase_src)
        fwd_phase_build = pool.submit(_build.build, fwd_phase_src)
        native_build = pool.submit(native.build)   # the host library, g++
        built = _build.build_all()
        phase_lib, _ = phase_build.result()
        fwd_phase_lib, _ = fwd_phase_build.result()
        native_lib, _ = native_build.result()
    _build.load_library()
    _build.load_variants_library()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          **{stem: {"library": path.name,
                    "ptxas": [ln.strip() for ln in log.splitlines()
                              if "registers" in ln or "spill" in ln]}
             for stem, (path, log) in built.items()},
          "dgrad_phases_library": phase_lib.name, "fwd_phases_library": fwd_phase_lib.name,
          "native_library": native_lib.name, "card": card})

    # ---- 2. kernels against their plain versions at main-path shapes ----
    field = EONerfField(20, compute_dtype=torch.bfloat16, device=dev,
                        generator=torch.Generator().manual_seed(0))
    rf = make_render_field(field)
    if not isinstance(rf, KernelField):
        raise RuntimeError("make_render_field did not pick the kernels for a bf16 8x256 field")
    with torch.no_grad():
        kw = ff.pack_kernel_weights(pack_params(field), torch.bfloat16)
    cfg = sat.RenderConfig(n_samples=128, sc_n_samples=64)
    scene_scale = np.array([256.0, 256.0, 60.0])
    rays_np, h, w = nadir_rays_with_sun(512, 512, 35.0, 140.0, scene_scale)
    rays_all = satrays_from_tensor(torch.from_numpy(rays_np).to(dev),
                                   torch.zeros(rays_np.shape[0], dtype=torch.long, device=dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    mid = rays_np.shape[0] // 2     # a chunk from the middle of the image, away from its edge
    sub = sat.SatRays(*(x[mid:mid + N_CHUNK] for x in rays_all))
    z_mid, delta, _, mask = sat._camera_samples(sub.origins, sub.viewdirs, sub.t_near, cfg, gen)
    deltam = (set_last_valid(delta, mask, cfg.inf_delta) * mask).contiguous()
    emb = torch.randn((N_CHUNK, 4), generator=gen, device=dev)
    rayin = torch.cat([sub.origins, sub.viewdirs, emb,
                       torch.zeros((N_CHUNK, 6), device=dev)], dim=1).contiguous()
    sc_o = sub.origins + sub.viewdirs * (0.5 + z_mid[:, :1])     # plausible surface points
    _, sc_z, sc_delta, sc_mask = sat._sample_block(
        sc_o, -sub.sundirs, torch.zeros_like(sub.t_near), cfg.sc_n_samples, cfg.ray_span,
        True, cfg.cube_bound, gen)
    rayin_sc = torch.cat([sc_o, -sub.sundirs, torch.zeros((N_CHUNK, 10), device=dev)],
                         dim=1).contiguous()
    sc_dm = (sc_delta * sc_mask).contiguous()
    sc_m = sc_mask.float().contiguous()
    z_mid, sc_z = z_mid.contiguous(), sc_z.contiguous()

    # the hierarchical shapes: the 96 stratified z of the same chunk and the
    # 48 fine z that sample_pdf draws from the coarse kernel's weights,
    # merged and sorted (K=143), the 1e10 sentinel on the last valid sample
    cfg_h = sat.RenderConfig(n_samples=96, n_importance=48, sc_n_samples=64)
    with torch.no_grad():
        h_mid, h_delta, _, h_mask = sat._camera_samples(sub.origins, sub.viewdirs, sub.t_near,
                                                        cfg_h, gen, field=rf)
    h_dm = (set_last_valid(h_delta, h_mask, cfg_h.inf_delta) * h_mask).contiguous()
    h_mid = h_mid.contiguous()

    # multiply-adds per sample from the field's own (unpadded) layer shapes:
    # trunk + sigma head for the shadow pass, every per-sample matrix for the
    # camera pass; only in-cube samples need them (the rest carry deltam = 0)
    fw = pack_params(field)
    density_macs = sum(x.numel() for x in density_subset(fw) if not is_bias(x))
    camera_macs = sum(x.numel() for x in flatten_weights(fw) if not is_bias(x))
    camera_bytes = ff.MAT_ELEMENTS * 2 + ff.BIAS_ELEMENTS * 4 + N_CHUNK * 8 * 4
    kernel_rows = {}

    def stream_launches_since(before):
        """stream_fwd_kernel launches by op since the library's counts
        `before` (fused_render.stream_fwd_kernel_launches)."""
        now = fr.stream_fwd_kernel_launches()
        return {f"{m}_fwd": now[m] - before[m] for m in now}

    def point_launches_since(before):
        """Launches of stream_fwd_kernel's point modes by op since the
        library's counts `before` (fused_field.point_fwd_kernel_launches)."""
        now = ff.point_fwd_kernel_launches()
        return {f"{m}_fwd": now[m] - before[m] for m in now}

    def point_launch(name, fn):
        """fn(), a call of the point forward `name`, which must launch its
        point mode once by the library's counters, and no other streamed
        forward in its place."""
        before, before_rays = ff.point_fwd_kernel_launches(), fr.stream_fwd_kernel_launches()
        out = fn()
        got = {**point_launches_since(before), **stream_launches_since(before_rays)}
        if got != {k: int(k == name) for k in got}:
            raise AssertionError(f"{name}: the library counted {got}, not one launch of its mode")
        return out

    def record(name, k, row):
        """The first shape of a kernel is its summary row; another shape
        that the main path gives it goes beside it, under other_shapes."""
        if name in kernel_rows:
            kernel_rows[name].setdefault("other_shapes", []).append(
                {"samples": k, **{key: row[key] for key in
                                  ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "trunk")
                                  if key in row}})
        else:
            kernel_rows[name] = row

    def rows_computed(k, n_valid):
        """The streamed forwards' rows (the samples with deltam != 0: in the
        cube) against the padded samples of the call (the rows of the
        design before it)."""
        padded = N_CHUNK * fr.kpad_of(k)
        return {"rows_computed": n_valid, "padded_samples": padded,
                "computed_share": n_valid / padded}

    # (name, kernel, plain version, K, in-cube samples, MACs per sample,
    # bytes, TPU kernel)
    cases = [
        ("camera_fwd", lambda: fr.camera_forward(kw, rayin, z_mid, deltam),
         lambda: fr.camera_forward_reference(kw, rayin, z_mid, deltam),
         z_mid.shape[1], int(mask.sum()), camera_macs,
         rayin.numel() * 4 + 2 * z_mid.numel() * 4 + camera_bytes, "_camera_fwd_kernel"),
        ("shadow_fwd", lambda: fr.shadow_forward(kw, rayin_sc, sc_z, sc_dm, sc_m),
         lambda: fr.shadow_forward_reference(kw, rayin_sc, sc_z, sc_dm, sc_m),
         sc_z.shape[1], int(sc_mask.sum()), density_macs,
         rayin_sc.numel() * 4 + 3 * sc_z.numel() * 4
         + ff.DENSITY_MAT_ELEMENTS * 2 + ff.DENSITY_BIAS_ELEMENTS * 4 + N_CHUNK * 4,
         "_shadow_fwd_kernel"),
        ("camera_fwd", lambda: fr.camera_forward(kw, rayin, h_mid, h_dm),
         lambda: fr.camera_forward_reference(kw, rayin, h_mid, h_dm),
         h_mid.shape[1], int(h_mask.sum()), camera_macs,
         rayin.numel() * 4 + 2 * h_mid.numel() * 4 + camera_bytes, "_camera_fwd_kernel"),
    ]
    for name, kern, plain, k, n_valid, macs, nbytes, tpu_fn in cases:
        dm_case = deltam if k == z_mid.shape[1] else (sc_dm if k == sc_z.shape[1] else h_dm)
        n_rows = int((dm_case != 0).sum())
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        max_err, mean_err = float(err.max()), float(err.mean())
        finite = bool(torch.isfinite(got).all())
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        # least time: the trunk/head matrix products of the in-cube samples at
        # the bf16 tensor-core peak, against each input read and each output
        # written once at the memory rate
        flops = 2.0 * macs * n_valid
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda",
               "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
               "replaces": tpu_kernel_site(tpu_fn), "launches": None,
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "library_ms": None}
        record(name, k, row)
        emit({"phase": "kernels", "name": name, "rays": N_CHUNK, "samples": k,
              "kpad": fr.kpad_of(k), "valid_samples": n_valid, **rows_computed(k, n_rows),
              "macs_per_sample": macs,
              "max_abs_err": max_err, "mean_abs_err": mean_err,
              "tolerance": KERNEL_TOL, "finite": finite, "ms": ms, "plain_ms": plain_ms,
              "bound_ms": row["bound_ms"], "gflop": flops / 1e9,
              "tflops_achieved": flops / (ms * 1e-3) / 1e12, "card": card})
        if not (finite and max_err <= KERNEL_TOL["max_abs"]
                and mean_err <= KERNEL_TOL["mean_abs"]):
            raise AssertionError(f"{name} at K={k}: kernel disagrees with its plain version "
                                 f"(max {max_err}, mean {mean_err}, finite {finite})")

    # where a streamed forward's tile goes: clock cycles a tile of each phase
    # (bench/stream_fwd.py, the instrumented copy built beside the libraries)
    for case, res in {**sf.phases(built=fwd_phase_src),
                      **sf.phases(built=fwd_phase_src, cases=("camera_save", "shadow_save")),
                      **sf.phases(built=fwd_phase_src, cases=("field", "density"))}.items():
        emit({"phase": "kernels", "name": "stream_fwd_phases", "case": case, **res,
              "phases": list(sf.PHASES), "card": card})

    # backward kernels at the training shapes: the first N_TRAIN rays of the
    # same inputs (uniform K=127 and hierarchical K=143), a random per-ray
    # cotangent
    nb = N_TRAIN
    b_in = [t[:nb].contiguous() for t in (rayin, z_mid, deltam)]
    b_in_h = [t[:nb].contiguous() for t in (rayin, h_mid, h_dm)]
    b_sc = [t[:nb].contiguous() for t in (rayin_sc, sc_z, sc_dm, sc_m)]
    gacc = torch.randn((nb, fr.ACC_COLS), generator=gen, device=dev)
    ggeo = torch.randn((nb,), generator=gen, device=dev)
    camera_bwd_bytes = (gacc.numel() * 4 + ff.MAT_ELEMENTS * (2 + 4)
                        + ff.BIAS_ELEMENTS * (4 + 4) + nb * fr.RAYIN_COLS * 4)
    bwd_cases = [
        ("camera_bwd", lambda: fr.camera_backward(kw, *b_in, gacc),
         lambda: fr.camera_backward_reference(kw, *b_in, gacc),
         b_in[1].shape[1], int(mask[:nb].sum()), camera_macs,
         sum(t.numel() * 4 for t in b_in) + camera_bwd_bytes, "_camera_bwd_kernel"),
        ("shadow_bwd", lambda: fr.shadow_backward(kw, *b_sc, ggeo),
         lambda: fr.shadow_backward_reference(kw, *b_sc, ggeo),
         b_sc[1].shape[1], int(sc_mask[:nb].sum()), density_macs,
         sum(t.numel() * 4 for t in b_sc) + ggeo.numel() * 4
         + ff.DENSITY_MAT_ELEMENTS * (2 + 4) + ff.DENSITY_BIAS_ELEMENTS * (4 + 4)
         + nb * fr.RAYIN_COLS * 4,
         "_shadow_bwd_kernel"),
        ("camera_bwd", lambda: fr.camera_backward(kw, *b_in_h, gacc),
         lambda: fr.camera_backward_reference(kw, *b_in_h, gacc),
         b_in_h[1].shape[1], int(h_mask[:nb].sum()), camera_macs,
         sum(t.numel() * 4 for t in b_in_h) + camera_bwd_bytes, "_camera_bwd_kernel"),
    ]
    for name, kern, plain, k, n_valid, macs, nbytes, tpu_fn in bwd_cases:
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        rel, max_err = grad_errors(ff, got, ref)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        # least time: recompute, dgrad and wgrad, each the forward's
        # multiply-adds per in-cube sample, at the bf16 tensor-core peak
        flops = 3 * 2.0 * macs * n_valid
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda", "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
               "replaces": tpu_kernel_site(tpu_fn), "launches": None, "max_abs_err": max_err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}
        record(name, k, row)
        emit({"phase": "kernels", "name": name, "rays": nb, "samples": k,
              "valid_samples": n_valid, "max_rel_l2": max(rel), "rel_l2_d_rayin": rel[-1],
              "max_abs_err": max_err, "tolerance_rel_l2": BWD_REL_L2, "finite": finite,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": row["bound_ms"],
              "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12,
              "card": card})
        if not (finite and max(rel) <= BWD_REL_L2):
            raise AssertionError(f"{name} at K={k}: kernel disagrees with its plain version "
                                 f"(rel-L2 {rel})")
    # the coarse-weights kernel at the hierarchical render's shapes: the 96
    # stratified camera z of a chunk (95 samples), the 1e10 sentinel on the
    # last valid one
    c_mid, c_delta, _, c_mask = sat._camera_samples(sub.origins, sub.viewdirs, sub.t_near,
                                                    sat.RenderConfig(n_samples=96), gen)
    c_dm = (set_last_valid(c_delta, c_mask, cfg_h.inf_delta) * c_mask).contiguous()
    c_mid = c_mid.contiguous()
    rayin_c = torch.cat([sub.origins, sub.viewdirs, torch.zeros((N_CHUNK, 10), device=dev)],
                        dim=1).contiguous()
    # the density kernel at the entropy probe's shapes: 64 uniform samples on
    # [near, far] of 2048 rays
    probe = sat.SatRays(*(x[:N_PROBE_RAYS] for x in sub))
    tm = (torch.arange(N_PROBE_SAMPLES, device=dev) + 0.5) / N_PROBE_SAMPLES
    z_p = probe.t_near[:, None] + (probe.t_far - probe.t_near)[:, None] * tm
    pos_p = (probe.origins[:, None, :] + probe.viewdirs[:, None, :] * z_p[..., None])
    pos_p = pos_p.reshape(-1, 3).contiguous()
    density_bytes = ff.DENSITY_MAT_ELEMENTS * 2 + ff.DENSITY_BIAS_ELEMENTS * 4
    extra = {
        "coarse_fwd": (lambda: fr.coarse_forward(kw, rayin_c, c_mid, c_dm),
                       lambda: fr.coarse_forward_reference(kw, rayin_c, c_mid, c_dm),
                       N_CHUNK, c_mid.shape[1], int(c_mask.sum()),
                       rayin_c.numel() * 4 + 3 * c_mid.numel() * 4 + density_bytes,
                       ("_coarse_fwd_kernel", "fused_render.py")),
        "density_fwd": (lambda: ff.density_forward(kw, pos_p),
                        lambda: ff.density_forward_reference(kw, pos_p),
                        pos_p.shape[0], 1, pos_p.shape[0],
                        pos_p.numel() * 4 + density_bytes + pos_p.shape[0] * 4,
                        ("_density_fwd_kernel", "fused_field.py")),
    }
    for name, (kern, plain, n_rows, k, n_work, nbytes, (tpu_fn, module)) in extra.items():
        got = point_launch(name, kern) if name == "density_fwd" else kern()
        ref = plain()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        finite = bool(torch.isfinite(got).all())
        if name == "density_fwd":
            scale = float(ref.abs().max())
            errs = {"max_rel": float(err.max()) / scale, "mean_rel": float(err.mean()) / scale}
            tol = DENSITY_TOL
        else:
            scale = float(ref.abs().mean())
            errs = {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
                    "mean_rel": float(err.mean()) / scale}
            tol = COARSE_TOL
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        # least time: the density trunk of every sample that needs it (the
        # in-cube ones for the coarse pass, every point for the density
        # kernel) at the bf16 peak, against the bytes at the memory rate
        flops = 2.0 * density_macs * n_work
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda", "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
               "replaces": tpu_kernel_site(tpu_fn, module), "launches": None,
               "max_abs_err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}
        record(name, k, row)
        emit({"phase": "kernels", "name": name, "rows": n_rows, "samples": k,
              "work_samples": n_work,
              **(rows_computed(k, int((c_dm != 0).sum())) if name == "coarse_fwd" else {}),
              "max_abs_err": float(err.max()), "errors": errs,
              "reference_scale": {"max|sigma|" if name == "density_fwd" else "mean|w|": scale},
              "tolerance": tol, "finite": finite,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": row["bound_ms"],
              "gflop": flops / 1e9, "tflops_achieved": flops / (ms * 1e-3) / 1e12,
              "card": card})
        if not (finite and all(errs[key] <= tol[key] for key in tol)):
            raise AssertionError(f"{name}: kernel disagrees with its plain version "
                                 f"({errs}, finite {finite})")

    # the per-point field and density kernels at the per-sample branch's
    # shapes (ray entropy, the nadir diagnostics): the field forward over a
    # render chunk's camera samples (4096 x 127 points, each ray's embedding
    # on its samples), its backward over a training batch's (1024 x 127), the
    # density backward over the batch's shadow samples (1024 x 63), random
    # cotangents; every point counts, in the cube or not, as the JAX function
    # evaluates them all
    pos_f = (sub.origins[:, None, :] + sub.viewdirs[:, None, :] * z_mid[..., None]).reshape(-1, 3)
    emb_f = emb[:, None, :].expand(-1, z_mid.shape[1], -1).reshape(-1, 4)
    pos_f, emb_f = pos_f.contiguous(), emb_f.contiguous()
    n_fb = N_TRAIN * z_mid.shape[1]
    pos_b, emb_b = pos_f[:n_fb], emb_f[:n_fb]
    g_f = torch.randn((n_fb, ff.FIELD_COLS), generator=gen, device=dev)
    g_f[:, 6:] = 0.0
    sc_pos = (sc_o[:, None, :] - sub.sundirs[:, None, :] * sc_z[..., None]).reshape(-1, 3)
    sc_pos = sc_pos.contiguous()
    n_db = N_TRAIN * sc_z.shape[1]
    pos_d = sc_pos[:n_db]
    g_d = torch.randn((n_db,), generator=gen, device=dev)
    field_bytes = ff.MAT_ELEMENTS * 2 + ff.BIAS_ELEMENTS * 4
    kw32 = ff.KernelWeights(kw.mats.float(), kw.biases)
    point_cases = [
        ("field_fwd", lambda: ff.field_forward(kw, pos_f, emb_f),
         lambda: ff.field_forward_reference(kw, pos_f, emb_f), pos_f.shape[0], camera_macs, 1,
         pos_f.shape[0] * (3 + 4 + ff.FIELD_COLS) * 4 + field_bytes, "_field_fwd_kernel"),
        ("field_bwd", lambda: ff.field_backward(kw, pos_b, emb_b, g_f),
         lambda: ff.field_backward_reference(kw, pos_b, emb_b, g_f), n_fb, camera_macs, 3,
         n_fb * (3 + 4 + ff.FIELD_COLS + 3 + 4) * 4 + field_bytes
         + (ff.MAT_ELEMENTS + ff.BIAS_ELEMENTS) * 4, "_field_bwd_kernel"),
        ("density_bwd", lambda: ff.density_backward(kw, pos_d, g_d),
         lambda: ff.density_backward_reference(kw, pos_d, g_d), n_db, density_macs, 3,
         n_db * (3 + 1 + 3) * 4 + density_bytes
         + (ff.DENSITY_MAT_ELEMENTS + ff.DENSITY_BIAS_ELEMENTS) * 4, "_density_bwd_kernel"),
        # the density forward at the diagnostics render's shadow pass and
        # probes (4096 x 63 points each), for the chunk's time split
        ("density_fwd", lambda: ff.density_forward(kw, sc_pos),
         lambda: ff.density_forward_reference(kw, sc_pos), sc_pos.shape[0], density_macs, 1,
         sc_pos.numel() * 4 + density_bytes + sc_pos.shape[0] * 4, "_density_fwd_kernel"),
    ]

    def point_fwd_errors(name, got, ref, n_pts):
        """(errors, ok, largest absolute error, tolerance) of a point
        forward's output: softplus outputs (sigma, t_beta) relative to their
        largest value, sigmoid outputs (albedo, t_s) as the forward kernels,
        the field's two pad columns exact zeros."""
        got, ref = got.reshape(n_pts, -1), ref.reshape(n_pts, -1)
        soft = [0, 5] if name == "field_fwd" else [0]
        errs = {}
        for c in soft:
            e, sc = (got[:, c] - ref[:, c]).abs(), float(ref[:, c].abs().max())
            errs[f"col{c}_max_rel"] = float(e.max()) / sc
            errs[f"col{c}_mean_rel"] = float(e.mean()) / sc
        ok = all(errs[f"col{c}_max_rel"] <= DENSITY_TOL["max_rel"]
                 and errs[f"col{c}_mean_rel"] <= DENSITY_TOL["mean_rel"] for c in soft)
        if name == "field_fwd":
            e = (got[:, 1:5] - ref[:, 1:5]).abs()
            errs.update(sigmoid_max_abs=float(e.max()), sigmoid_mean_abs=float(e.mean()),
                        pad_max_abs=float(got[:, 6:].abs().max()))
            ok = ok and (errs["sigmoid_max_abs"] <= KERNEL_TOL["max_abs"]
                         and errs["sigmoid_mean_abs"] <= KERNEL_TOL["mean_abs"]
                         and errs["pad_max_abs"] == 0.0)
        ok = ok and bool(torch.isfinite(got).all())
        return (errs, ok, float((got - ref).abs().max()),
                {"softplus_rel": DENSITY_TOL, "sigmoid_abs": KERNEL_TOL})

    for name, kern, plain, n_pts, macs, passes, nbytes, tpu_fn in point_cases:
        got = point_launch(name, kern) if passes == 1 else kern()
        ref = plain()
        torch.cuda.synchronize()
        if passes == 1:
            finite = bool(torch.isfinite(got).all())
            errs, ok, max_err, tol = point_fwd_errors(name, got, ref, n_pts)
        else:
            rel, max_err = grad_errors(ff, got, ref)
            finite = all(bool(torch.isfinite(t).all()) for t in got)
            names = ["d_pos", "d_emb"][:len(got) - 2]
            errs = {"max_rel_l2_weights": max(rel[:-len(names)]),
                    **{f"rel_l2_{n}": r for n, r in zip(names, rel[-len(names):])}}
            ok = max(rel) <= POINT_BWD_REL_L2
            # both bf16 versions against the plain version in float32
            ref32 = (ff.field_backward_reference(kw32, pos_b, emb_b, g_f) if name == "field_bwd"
                     else ff.density_backward_reference(kw32, pos_d, g_d))
            errs["vs_f32"] = {"kernel_max_rel_l2": max(grad_errors(ff, got, ref32)[0]),
                              "plain_max_rel_l2": max(grad_errors(ff, ref, ref32)[0])}
            ok = ok and (errs["vs_f32"]["kernel_max_rel_l2"]
                         <= POINT_BWD_F32_RATIO * errs["vs_f32"]["plain_max_rel_l2"])
            if name == "density_bwd":
                errs["head_grads_max_abs"] = float(got[0][ff.DENSITY_MAT_ELEMENTS:].abs().max())
                ok = ok and errs["head_grads_max_abs"] == 0.0
            tol = {"rel_l2": POINT_BWD_REL_L2, "vs_f32_ratio": POINT_BWD_F32_RATIO}
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        # least time: the trunk (and, for the field, head) products of every
        # point, times the passes (recompute, dgrad, wgrad for a backward), at
        # the bf16 peak, against each input read and output written once
        flops = passes * 2.0 * macs * n_pts
        ops_ms = flops / PEAK_BF16_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda", "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
               "replaces": tpu_kernel_site(tpu_fn, "fused_field.py"), "launches": None,
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None}
        record(name, n_pts, row)
        emit({"phase": "kernels", "name": name, "points": n_pts, "macs_per_point": macs,
              "errors": errs, "tolerance": tol, "finite": finite, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": row["bound_ms"], "gflop": flops / 1e9,
              "tflops_achieved": flops / (ms * 1e-3) / 1e12, "card": card})
        if not (finite and ok):
            raise AssertionError(f"{name} at {n_pts} points: kernel disagrees with its plain "
                                 f"version ({errs}, finite {finite})")
    # the point modes at ragged point counts: one point, one short of a
    # tile, one past it, and a count whose last block ends in a partial
    # tile (the chunk's points, each with its ray's embedding)
    for n_pts in (1, 127, 129, 128 * 2016 + 77):
        pts, embs = pos_f[:n_pts], emb_f[:n_pts]
        for name, kern, plain in (
                ("field_fwd", lambda: ff.field_forward(kw, pts, embs),
                 lambda: ff.field_forward_reference(kw, pts, embs)),
                ("density_fwd", lambda: ff.density_forward(kw, pts),
                 lambda: ff.density_forward_reference(kw, pts))):
            got = point_launch(name, kern)
            errs, ok, max_err, tol = point_fwd_errors(name, got, plain(), n_pts)
            emit({"phase": "kernels", "name": "point_fwd_ragged", "op": name, "points": n_pts,
                  "blocks": _build.load_library().eonerf_point_fwd_blocks(n_pts), "errors": errs,
                  "max_abs_err": max_err, "tolerance": tol, "card": card})
            if not ok:
                raise AssertionError(f"{name} at {n_pts} points: kernel disagrees with its "
                                     f"plain version ({errs})")
    point_ms = {"field_fwd_chunk": kernel_rows["field_fwd"]["ms"],
                "density_fwd_chunk": kernel_rows["density_fwd"]["other_shapes"][-1]["ms"],
                "field_fwd_batch": time_ms(torch, lambda: ff.field_forward(kw, pos_b, emb_b), 10),
                "density_fwd_batch": time_ms(torch, lambda: ff.density_forward(kw, pos_d), 10)}

    # the forward kernels at the training shapes, for the step's time split
    train_fwd_ms = (time_ms(torch, lambda: fr.camera_forward(kw, *b_in), 10)
                    + time_ms(torch, lambda: fr.shadow_forward(kw, *b_sc), 10))

    # the int8 trunk tier's kernels at the same shapes: forwards at the render
    # chunk (scale groups of the 2048-row target), backwards at the training
    # batch (the 1024-row target), a random cotangent; the group amax each
    # kernel quantized with against its plain version's
    with torch.no_grad():
        q8w = ff.quantize_kernel_trunk(
            ff.pack_kernel_weights(pack_params(field), torch.float32).mats)
    trunk_macs = sum(x.numel() for x in fw.trunk_w)
    q8_fwd_cases = [
        ("camera_fwd_q8", fr.camera_forward_q8, fr.camera_forward_reference,
         (rayin, z_mid, deltam), int(mask.sum()), camera_macs, KERNEL_TOL,
         rayin.numel() * 4 + 2 * z_mid.numel() * 4 + camera_bytes),
        ("shadow_fwd_q8", fr.shadow_forward_q8, fr.shadow_forward_reference,
         (rayin_sc, sc_z, sc_dm, sc_m), int(sc_mask.sum()), density_macs, KERNEL_TOL,
         rayin_sc.numel() * 4 + 3 * sc_z.numel() * 4 + density_bytes + N_CHUNK * 4),
        ("coarse_fwd_q8", fr.coarse_forward_q8, fr.coarse_forward_reference,
         (rayin_c, c_mid, c_dm), int(c_mask.sum()), density_macs, COARSE_TOL,
         rayin_c.numel() * 4 + 3 * c_mid.numel() * 4 + density_bytes),
        ("camera_fwd_q8", fr.camera_forward_q8, fr.camera_forward_reference,
         (rayin, h_mid, h_dm), int(h_mask.sum()), camera_macs, KERNEL_TOL,
         rayin.numel() * 4 + 2 * h_mid.numel() * 4 + camera_bytes),
    ]
    # (name, kernel, plain version, inputs, in-cube samples, MACs per sample,
    # int8_full, bytes)
    q8_bwd_cases = [
        ("camera_bwd_q8", fr.camera_backward_q8, fr.camera_backward_reference,
         (*b_in, gacc), int(mask[:nb].sum()), camera_macs, False,
         sum(t.numel() * 4 for t in b_in) + camera_bwd_bytes),
        ("camera_bwd_q8_full", fr.camera_backward_q8_full, fr.camera_backward_reference,
         (*b_in, gacc), int(mask[:nb].sum()), camera_macs, True,
         sum(t.numel() * 4 for t in b_in) + camera_bwd_bytes),
        ("shadow_bwd_q8", fr.shadow_backward_q8, fr.shadow_backward_reference,
         (*b_sc, ggeo), int(sc_mask[:nb].sum()), density_macs, False,
         sum(t.numel() * 4 for t in b_sc) + ggeo.numel() * 4
         + ff.DENSITY_MAT_ELEMENTS * (2 + 4) + ff.DENSITY_BIAS_ELEMENTS * (4 + 4)
         + nb * fr.RAYIN_COLS * 4),
        ("shadow_bwd_q8_full", fr.shadow_backward_q8_full, fr.shadow_backward_reference,
         (*b_sc, ggeo), int(sc_mask[:nb].sum()), density_macs, True,
         sum(t.numel() * 4 for t in b_sc) + ggeo.numel() * 4
         + ff.DENSITY_MAT_ELEMENTS * (2 + 4) + ff.DENSITY_BIAS_ELEMENTS * (4 + 4)
         + nb * fr.RAYIN_COLS * 4),
        ("camera_bwd_q8", fr.camera_backward_q8, fr.camera_backward_reference,
         (*b_in_h, gacc), int(h_mask[:nb].sum()), camera_macs, False,
         sum(t.numel() * 4 for t in b_in_h) + camera_bwd_bytes),
        ("camera_bwd_q8_full", fr.camera_backward_q8_full, fr.camera_backward_reference,
         (*b_in_h, gacc), int(h_mask[:nb].sum()), camera_macs, True,
         sum(t.numel() * 4 for t in b_in_h) + camera_bwd_bytes),
    ]

    def q8_trunk_launched(call):
        """The int8 trunk's CUDA kernels that one call launches, by the
        library's own launch counts: how many of each."""
        before = fr.q8_trunk_kernel_launches()
        call()
        torch.cuda.synchronize()
        return {k: n - before[k] for k, n in fr.q8_trunk_kernel_launches().items()}

    def q8_trunk_alone(args, n_valid, target, camera, write_all, amax, call):
        """The int8 trunk alone at a case's shape (the forwards': the PE and
        h7 to the stream; the backwards': every h): the path the shape
        takes, its cluster, the clusters the card holds at once, its
        CUDA-event time and its bound (the int8 operations of the valid
        samples at the int8 peak against the bytes of rayin, z and the
        stream columns written), beside the layer-major path's time on the
        same inputs; both paths' written columns and amax, and the case's
        own amax, must be the same bits; and the case's own call must have
        launched that path's kernels alone (one cluster launch, or the PE
        and 8 layer kernels)."""
        lib = _build.load_library()
        rayin_, z_ = args[0], args[1]
        kpad, rt, rp = fr.q8_plan(rayin_.shape[0], z_.shape[1], target)
        path, ctas, last = fr.q8_trunk_plan(kpad, rt * kpad)
        if lib.eonerf_q8_trunk_path(kpad, rt * kpad) != fr.Q8_TRUNK_PATHS.index(path):
            raise AssertionError(f"the library's int8 trunk path differs from the plan {path}")
        launched = q8_trunk_launched(call)
        want = ({"q8_trunk_cluster_kernel": 1, "q8_pe_kernel": 0, "q8_layer_kernel": 0}
                if path == "cluster" else
                {"q8_trunk_cluster_kernel": 0, "q8_pe_kernel": 1, "q8_layer_kernel": 8})
        if launched != want:
            raise AssertionError(f"int8 call on the {path} path launched {launched}")
        runs = {p: fr.q8_trunk(kw, q8w, rayin_, z_, target, camera, write_all, p)
                for p in dict.fromkeys((path, "layer_major"))}
        same = all(torch.equal(a, runs[path][1]) and torch.equal(
            fr.q8_stream_written(st, write_all), fr.q8_stream_written(runs[path][0], write_all))
            for st, a in runs.values()) and torch.equal(runs[path][1], amax)
        del runs
        ms = time_ms(torch, lambda: fr.q8_trunk(kw, q8w, rayin_, z_, target, camera, write_all),
                     10)
        lm_ms = time_ms(torch, lambda: fr.q8_trunk(kw, q8w, rayin_, z_, target, camera, write_all,
                                                   "layer_major"), 10)
        cols = sum(b - a for a, b in fr.q8_stream_cols(write_all))
        ops_ms = 2.0 * trunk_macs * n_valid / PEAK_INT8_OPS * 1e3
        bytes_ms = (rayin_.numel() * 4 + z_.numel() * 4 + rp * kpad * cols * 2) / PEAK_BYTES * 1e3
        res = {"path": path, "group_rows": rt * kpad, "cluster_ctas": ctas, "last_cta_rows": last,
               "active_clusters": (lib.eonerf_q8_trunk_active_clusters(ctas)
                                   if path == "cluster" else None),
               "ms": ms, "layer_major_ms": lm_ms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "same_bits_as_layer_major": same, "launched": launched}
        if not same:
            raise AssertionError(f"int8 trunk at {rayin_.shape[0]} x {z_.shape[1]}: the {path} "
                                 f"path differs from the layer-major one or from the call's amax")
        return res

    def q8_row(name, k, n_valid, macs, passes_int8, passes_bf16, nbytes, ms, plain_ms,
               max_err, tpu_fn, trunk):
        """Least time of an int8 launch: the trunk's multiply-adds of the
        in-cube samples at the int8 peak for the passes that run int8, the
        rest (heads; the bf16 passes) at the bf16 peak, against the bytes."""
        ops_ms = (2.0 * trunk_macs * n_valid * passes_int8 / PEAK_INT8_OPS
                  + 2.0 * n_valid * ((macs - trunk_macs) * passes_int8
                                     + macs * passes_bf16) / PEAK_BF16_FLOPS) * 1e3
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        row = {"name": name, "route": "cuda",
               "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
               "replaces": tpu_kernel_site(tpu_fn, "fused_field.py"), "launches": None,
               "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
               "trunk": trunk}
        record(name, k, row)
        return row

    for name, kern, plain, args, n_valid, macs, tol, nbytes in q8_fwd_cases:
        sk, sp = {}, {}
        got = kern(kw, q8w, *args, stats=sk)
        ref = plain(kw, *args, q8w, 2048, sp)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        errs = {"max_abs": float(err.max()), "mean_abs": float(err.mean())}
        if tol is COARSE_TOL:
            errs["mean_rel"] = errs["mean_abs"] / float(ref.abs().mean())
        amax_k = sk.pop("amax")   # (the stream the kernels wrote goes with sk)
        amax_rel = float(((amax_k - sp["amax"]).abs() / sp["amax"].abs().clamp(min=1e-30)).max())
        finite = bool(torch.isfinite(got).all())
        del sk
        ms = time_ms(torch, lambda: kern(kw, q8w, *args), 10)
        plain_ms = time_ms(torch, lambda: plain(kw, *args, q8w, 2048), 3)
        trunk = q8_trunk_alone(args, n_valid, 2048, name.startswith("camera"), False, amax_k,
                               lambda: kern(kw, q8w, *args))
        row = q8_row(name, args[1].shape[1], n_valid, macs, 1, 0, nbytes, ms, plain_ms,
                     errs["max_abs"], "_trunk_fwd_q8", trunk)
        emit({"phase": "kernels", "name": name, "rays": args[0].shape[0],
              "samples": args[1].shape[1], "groups": int(sp["amax"].shape[0]),
              "valid_samples": n_valid, "errors": errs, "tolerance": tol,
              "amax_max_rel": amax_rel, "amax_tolerance": Q8_AMAX_REL, "finite": finite,
              "ms": ms, "plain_ms": plain_ms, "bound_ms": row["bound_ms"], "trunk": trunk,
              "card": card})
        if not (finite and all(errs[key] <= tol[key] for key in tol)
                and amax_k.shape == sp["amax"].shape and amax_rel <= Q8_AMAX_REL):
            raise AssertionError(f"{name}: kernel disagrees with its plain version ({errs}, "
                                 f"amax {amax_rel}, finite {finite})")
    for name, kern, plain, args, n_valid, macs, full, nbytes in q8_bwd_cases:
        sk, sp = {}, {}
        got = kern(kw, q8w, *args, stats=sk)
        ref = plain(kw, *args, q8w, full, 1024, sp)
        torch.cuda.synchronize()
        rel, max_err = grad_errors(ff, got, ref)
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        amax_rel = {key: float(((sk[key] - sp[key]).abs() / sp[key].abs().clamp(min=1e-30))
                               [:, -1 if key == "gamax" else slice(None)].max()) for key in sp}
        chain = rel[:16] + rel[-1:]     # the trunk's weights and biases, d_rayin
        ok = max(rel) <= BWD_REL_L2
        vs_f32 = None
        if full:
            ref32 = plain(kw32, *args, q8w, full, 1024)
            k32, p32 = grad_errors(ff, got, ref32)[0], grad_errors(ff, ref, ref32)[0]
            vs_f32 = {"kernel_chain_max_rel_l2": max(k32[:16] + k32[-1:]),
                      "plain_chain_max_rel_l2": max(p32[:16] + p32[-1:])}
            ok = (max(rel[16:-1]) <= BWD_REL_L2 and max(chain) <= Q8_FULL_REL_L2
                  and vs_f32["kernel_chain_max_rel_l2"]
                  <= Q8_FULL_F32_RATIO * vs_f32["plain_chain_max_rel_l2"])
        ms = time_ms(torch, lambda: kern(kw, q8w, *args), 10)
        plain_ms = time_ms(torch, lambda: plain(kw, *args, q8w, full, 1024), 3)
        trunk = q8_trunk_alone(args, n_valid, 1024, name.startswith("camera"), True, sk["amax"],
                               lambda: kern(kw, q8w, *args))
        # recompute int8 (and, int8_full, dgrad and wgrad too); the rest bf16
        row = q8_row(name, args[1].shape[1], n_valid, macs, 3 if full else 1, 0 if full else 2,
                     nbytes, ms, plain_ms, max_err, "_trunk_bwd_q8" if full else "_trunk_fwd_q8",
                     trunk)
        emit({"phase": "kernels", "name": name, "rays": nb, "samples": args[1].shape[1],
              "groups": int(sk["amax"].shape[0]), "valid_samples": n_valid,
              "max_rel_l2": max(rel), "rel_l2_d_rayin": rel[-1], "max_abs_err": max_err,
              "chain_max_rel_l2": max(chain), "vs_f32": vs_f32,
              "tolerance_rel_l2": BWD_REL_L2,
              "tolerance_full": {"chain_rel_l2": Q8_FULL_REL_L2, "vs_f32_ratio": Q8_FULL_F32_RATIO},
              "amax_max_rel": amax_rel,
              "amax_tolerance": {"amax": Q8_AMAX_REL, "gamax": Q8_GAMAX_REL},
              "finite": finite, "ms": ms, "plain_ms": plain_ms, "bound_ms": row["bound_ms"],
              "trunk": trunk, "card": card})
        if not (finite and ok and amax_rel["amax"] <= Q8_AMAX_REL
                and amax_rel.get("gamax", 0.0) <= Q8_GAMAX_REL):
            raise AssertionError(f"{name} at K={args[1].shape[1]}: kernel disagrees with its "
                                 f"plain version (rel-L2 {rel}, amax {amax_rel})")

    # int8_full's trunk backward alone at the training shapes: the cotangent
    # chain and the weight gradient, each timed alone on a workspace the
    # whole call filled, against the plain trunk backward on that call's own
    # inputs (its stream's PE and h0..h7, their masks, its g_h7)
    from eonerf_code_tpu_torch.bench import q8_backward as qb

    def q8_bwd_alone(camera, args, g, n_valid):
        call = fr.Q8BackwardCall(camera, True, kw, q8w, *args[:3], None if camera else args[3],
                                 g, 1024)
        call.run()
        torch.cuda.synchronize()
        rows, gr = call.rp * call.kpad, call.group_rows
        lay = call.layout()
        stream = call.act_stream()
        gh7 = call.ws[lay["gh"]:lay["gh"] + rows * 512].view(torch.bfloat16).view(rows, 256)
        gpe = call.ws[lay["gpe"]:lay["gpe"] + rows * 128].view(torch.bfloat16).view(rows, 64)
        pe = stream[:, fr._act_col(5) - 64:fr._act_col(5)]
        hs = [stream[:, fr._act_col(i):fr._act_col(i) + 256] for i in range(8)]
        masks = [(h > 0).to(torch.bfloat16) for h in hs]

        gp = [None] * 36

        def plain_chain():
            return ff.trunk_chain_q8(masks, gh7, q8w, torch.bfloat16, gp, gr)
        g_pe, gamax_p, g8s, col_ss = plain_chain()

        def plain_wgrad():
            ff.trunk_wgrad_q8(pe, hs, g8s, col_ss, gp, gr)
        plain_wgrad()
        torch.cuda.synchronize()
        w_plain = torch.cat([gp[i].t().reshape(-1) for i in range(8)])
        b_plain = torch.cat([gp[8 + i].reshape(-1) for i in range(8)])
        errs = {"gpe_max_abs": float((gpe.float() - g_pe.float()).abs().max()),
                "weights_max_abs": float((call.grads[0][:ff.TRUNK_MAT_ELEMENTS]
                                          - w_plain).abs().max()),
                "gamax_equal": bool(torch.equal(call.gamax, gamax_p)),
                "bias_rel_l2": rel_l2(call.grads[1][:ff.TRUNK_BIAS_ELEMENTS], b_plain)}
        plain_ms = {"chain": time_ms(torch, plain_chain, 3),
                    "wgrad": time_ms(torch, plain_wgrad, 3)}
        ms = {"chain": time_ms(torch, lambda: call.run(1), 10),
              "wgrad": time_ms(torch, lambda: call.run(2), 10)}
        call.run()
        lib_ms = {"chain": time_ms(torch, qb.chain_library(call, q8w), 10),
                  "wgrad": time_ms(torch, qb.wgrad_library(call), 10)}
        bnd = qb.bounds(rows, rows // gr)
        ok = (errs["gpe_max_abs"] == 0.0 and errs["weights_max_abs"] == 0.0
              and errs["gamax_equal"] and errs["bias_rel_l2"] <= Q8_CHAIN_BIAS_REL_L2)
        # the plain halves: fused_field.trunk_chain_q8 (masks, bias sums,
        # quantization, g8 w8^T) and trunk_wgrad_q8 (each group's inp8^T g8,
        # scaled, in group order); the weight gradient's library yardstick
        # is the products alone, not the same function
        library_is = {"chain": "the chain as torch calls, torch._int_mm for g8 w8^T",
                      "wgrad": "the products alone, one torch._int_mm a layer over all rows: "
                               "not the same function (no per-group scales)"}
        for kname, pname, err in (("q8_chain_cluster", "chain", errs["gpe_max_abs"]),
                                  ("q8_wgrad", "wgrad", errs["weights_max_abs"])):
            record(kname, args[1].shape[1], {
                "name": kname, "route": "cuda",
                "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
                "replaces": tpu_kernel_site("_trunk_bwd_q8", "fused_field.py"), "launches": None,
                "max_abs_err": err, "ms": ms[pname], "plain_ms": plain_ms[pname],
                "bound_ms": bnd[pname][0], "bound_by": bnd[pname][1],
                "library_ms": lib_ms[pname], "library_is": library_is[pname]})
        emit({"phase": "kernels", "name": "q8_trunk_bwd_alone", "camera": camera,
              "rays": args[0].shape[0], "samples": args[1].shape[1], "rows": rows,
              "groups": rows // gr, "valid_samples": n_valid, "errors": errs,
              "tolerance": {"gpe_max_abs": 0.0, "weights_max_abs": 0.0,
                            "bias_rel_l2": Q8_CHAIN_BIAS_REL_L2},
              "ms": ms, "bound_ms": {k: v[0] for k, v in bnd.items()},
              "plain_ms": plain_ms,
              "library_ms": lib_ms, "card": card})
        if not ok:
            raise AssertionError(f"int8_full trunk backward alone (camera {camera}) disagrees "
                                 f"with its plain version: {errs}")
        del call

    q8_bwd_alone(True, b_in, gacc, int(mask[:nb].sum()))
    q8_bwd_alone(False, b_sc, ggeo, int(sc_mask[:nb].sum()))
    torch.cuda.empty_cache()

    # the saved-activations pair (bwd_acts="saved", the JAX package's default)
    # at the training shapes: the forward that writes the activation stream
    # against the plain forward with save=True and against the non-saving
    # kernel (the same bits), the backward from that stream against the plain
    # backward from the plain activations and against the recompute kernel
    # (the same bits: the trunk's activations are the recompute's)
    saved_cases = [
        ("camera", b_in, gacc, int(mask[:nb].sum()), camera_macs),
        ("shadow", b_sc, ggeo, int(sc_mask[:nb].sum()), density_macs),
        ("camera", b_in_h, gacc, int(h_mask[:nb].sum()), camera_macs),
    ]
    saved_ops = {
        "camera": (fr.camera_forward, fr.camera_forward_save, fr.camera_forward_reference,
                   fr.camera_backward, fr.camera_backward_saved, fr.camera_backward_reference),
        "shadow": (fr.shadow_forward, fr.shadow_forward_save, fr.shadow_forward_reference,
                   fr.shadow_backward, fr.shadow_backward_saved, fr.shadow_backward_reference)}
    saved_cols = fr.act_stream_cols(False)    # the PE and h0..h7 of a sample row
    pass_rows, dgrad_cycles = {}, {}
    for op, args, gin, n_valid, macs in saved_cases:
        cam = op == "camera"
        fwd, fwd_save, fwd_ref, bwd, bwd_saved, bwd_ref = saved_ops[op]
        k = args[1].shape[1]
        kpad = fr.kpad_of(k)
        sv_before = fr.save_fwd_kernel_launches()
        out_s, stream = fwd_save(kw, *args)
        sv_got = {m: c - sv_before[m] for m, c in fr.save_fwd_kernel_launches().items()}
        if sv_got != {m: int(m == op) for m in sv_got}:
            raise AssertionError(f"{op}_fwd_save: the library counted {sv_got} save-mode "
                                 "launches, not one of its own")
        out_k = fwd(kw, *args)
        ref_out, ref_acts = fwd_ref(kw, *args, save=True)
        got_b = bwd_saved(kw, *args, gin, stream)
        rec_b = bwd(kw, *args, gin)
        ref_b = bwd_ref(kw, *args, gin, acts=ref_acts)
        torch.cuda.synchronize()
        err = (out_s - ref_out).abs()
        fwd_errs = {"max_abs": float(err.max()), "mean_abs": float(err.mean()),
                    "vs_plain_kernel_max_abs": float((out_s - out_k).abs().max()),
                    "acts_rel_l2": float((fr.stream_trunk_acts(stream, cam, nb, k).float()
                                          - ref_acts.float()).norm() / ref_acts.float().norm())}
        rel_b, max_err_b = grad_errors(ff, got_b, ref_b)
        rel_rec, _ = grad_errors(ff, got_b, rec_b)
        rec_row = kernel_rows[f"{op}_bwd"]
        bitwise = all(torch.equal(a, b) for a, b in zip(got_b, rec_b))
        finite = (bool(torch.isfinite(out_s).all())
                  and all(bool(torch.isfinite(t).all()) for t in got_b))
        stream_mib = {"stream_mib": stream.numel() * stream.element_size() / 2 ** 20,
                      "jax_formula_mib": fr.saved_stream_bytes(nb, k, torch.bfloat16) / 2 ** 20}
        ms_f = time_ms(torch, lambda: fwd_save(kw, *args), 10)
        plain_f = time_ms(torch, lambda: fwd_ref(kw, *args, save=True), 3)
        ms_b = time_ms(torch, lambda: bwd_saved(kw, *args, gin, stream), 10)
        plain_b = time_ms(torch, lambda: bwd_ref(kw, *args, gin, acts=ref_acts), 3)
        # least times: the forward's products of the in-cube samples against
        # its inputs, outputs and the stream it writes (the PE and h0..h7 of
        # every row); the saved backward's dgrad and wgrad and the heads'
        # recompute against its inputs (the stream read once) and outputs
        in_bytes = sum(t.numel() * 4 for t in args) + (
            (ff.MAT_ELEMENTS * 2 + ff.BIAS_ELEMENTS * 4) if cam
            else (ff.DENSITY_MAT_ELEMENTS * 2 + ff.DENSITY_BIAS_ELEMENTS * 4))
        stream_bytes = nb * kpad * saved_cols * 2
        grad_bytes = ((ff.MAT_ELEMENTS + ff.BIAS_ELEMENTS) if cam else
                      (ff.DENSITY_MAT_ELEMENTS + ff.DENSITY_BIAS_ELEMENTS)) * 4
        bounds = {
            "fwd": (2.0 * macs * n_valid / PEAK_BF16_FLOPS * 1e3,
                    (in_bytes + out_s.numel() * 4 + stream_bytes) / PEAK_BYTES * 1e3),
            "bwd": (2.0 * n_valid * (2 * macs + macs - trunk_macs) / PEAK_BF16_FLOPS * 1e3,
                    (in_bytes + gin.numel() * 4 + stream_bytes + grad_bytes
                     + nb * fr.RAYIN_COLS * 4) / PEAK_BYTES * 1e3)}
        for part, name, ms, plain_ms, max_err in (
                ("fwd", f"{op}_fwd_save", ms_f, plain_f, fwd_errs["max_abs"]),
                ("bwd", f"{op}_bwd_saved", ms_b, plain_b, max_err_b)):
            ops_ms, bytes_ms = bounds[part]
            record(name, k, {
                "name": name, "route": "cuda", "source": "eonerf_code_tpu_torch/csrc/fused_render.cu",
                "replaces": tpu_kernel_site(f"_{op}_{part}_kernel"), "launches": None,
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
                **stream_mib})
        emit({"phase": "kernels", "name": f"{op}_saved_pair", "rays": nb, "samples": k,
              "valid_samples": n_valid, **stream_mib, "fwd_errors": fwd_errs,
              "fwd_tolerance": {**KERNEL_TOL, "vs_plain_kernel_max_abs": 0.0,
                                "acts_rel_l2": BWD_REL_L2},
              "bwd_max_rel_l2": max(rel_b), "bwd_rel_l2_d_rayin": rel_b[-1],
              "bwd_tolerance_rel_l2": BWD_REL_L2, "bwd_vs_recompute_max_rel_l2": max(rel_rec),
              "bwd_vs_recompute_tolerance": SAVED_REL_L2, "bwd_bitwise_recompute": bitwise,
              "finite": finite, "fwd_ms": ms_f, "fwd_plain_ms": plain_f, "bwd_ms": ms_b,
              "bwd_plain_ms": plain_b,
              "recompute_bwd_ms": next((o["ms"] for o in rec_row.get("other_shapes", [])
                                        if o["samples"] == k), rec_row["ms"]),
              "bound_ms": {part: max(b) for part, b in bounds.items()}, "card": card})
        if not (finite and fwd_errs["max_abs"] <= KERNEL_TOL["max_abs"]
                and fwd_errs["mean_abs"] <= KERNEL_TOL["mean_abs"]
                and fwd_errs["vs_plain_kernel_max_abs"] == 0.0
                and fwd_errs["acts_rel_l2"] <= BWD_REL_L2 and max(rel_b) <= BWD_REL_L2
                and max(rel_rec) <= SAVED_REL_L2):
            raise AssertionError(f"{op} saved pair at K={k}: {fwd_errs}, backward rel-L2 {rel_b},"
                                 f" vs recompute {rel_rec}")
        if op not in pass_rows:
            # the saved backward's four launches one by one (measurement
            # launches, outside the counts), the wgrad pass beside its
            # library yardstick (the same products as torch.mm on the same
            # stream slices) and each launch's bound
            pass_rows[op] = bp.backward_pass_ms(kw, *args[:3], gin, stream,
                                                None if cam else args[3], 10)
            if cam:   # the camera dgrad kernel's phases, from the instrumented copy
                dgrad_cycles.update(bp.dgrad_phases(built=phase_src))
            emit({"phase": "kernels", "name": f"{op}_bwd_saved_passes", "rays": nb,
                  "samples": k, **pass_rows[op],
                  **({"dgrad_phases": dgrad_cycles[op]} if op in dgrad_cycles else {}),
                  "card": card})
        del stream

    # ---- 3. the main path: a 512x512 nadir sweep with shadows ----
    n_rays = rays_np.shape[0]
    n_chunks = -(-n_rays // N_CHUNK)
    fr.camera_forward.launches = 0
    fr.shadow_forward.launches = 0
    stream_before = fr.stream_fwd_kernel_launches()   # the library's own counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sat.render_image(rf, rays_all, cfg, shadows=True, chunk=N_CHUNK,
                           generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stream_launches = stream_launches_since(stream_before)
    launches = {"camera_fwd": fr.camera_forward.launches,
                "shadow_fwd": fr.shadow_forward.launches}
    widths = {"rgb": 3, "albedo_rgb": 3, "ambient_rgb": 3, "shadowless_rgb": 3,
              "opacity_after_surface": 2}
    bad = [k for k in sat.OUTPUT_KEYS
           if tuple(out[k].shape) != (n_rays, widths.get(k, 1))
           or not bool(torch.isfinite(out[k]).all())]
    for name, n in launches.items():
        kernel_rows[name]["launches"] = stream_launches[name]
    # the same 1024 rays through the kernels and through the per-sample path
    few = sat.SatRays(*(x[:1024] for x in rays_all))
    with torch.no_grad():
        a = sat.render_rays(rf, few, cfg, True, torch.Generator(device=dev).manual_seed(3))
        b = sat.render_rays(field, few, cfg, True, torch.Generator(device=dev).manual_seed(3))
    path_err = {"depth_mean_abs": float((a["depth"] - b["depth"]).abs().mean()),
                "rgb_mean_abs": float((a["rgb"] - b["rgb"]).abs().mean())}
    # where a chunk's time goes: the two kernels (timed alone in phase 2, one
    # launch each per chunk) against the whole chunk
    kernel_ms = kernel_rows["camera_fwd"]["ms"] + kernel_rows["shadow_fwd"]["ms"]
    emit({"phase": "render", "rays": n_rays, "chunks": n_chunks, "seconds": seconds,
          "rays_per_s": n_rays / seconds, "ms_per_chunk": seconds * 1e3 / n_chunks,
          "kernel_ms_per_chunk": kernel_ms,
          "kernel_share": kernel_ms * n_chunks / (seconds * 1e3),
          "launches": launches, "stream_fwd_kernel_launches": stream_launches, "bad_keys": bad,
          "depth_range": [float(out["depth"].min()), float(out["depth"].max())],
          "vs_per_sample_path": path_err, "tolerance": PATH_TOL, "card": card})
    if bad:
        raise AssertionError(f"render outputs with wrong shape or non-finite values: {bad}")
    if any(n != n_chunks for n in launches.values()) or stream_launches != {
            "camera_fwd": n_chunks, "shadow_fwd": n_chunks, "coarse_fwd": 0}:
        raise AssertionError(f"kernel launches {launches}, streamed kernel {stream_launches} "
                             f"!= {n_chunks} chunks")
    if any(path_err[k] > PATH_TOL[k] for k in PATH_TOL):
        raise AssertionError(f"kernel path vs per-sample path: {path_err}")

    # ---- 4. DSM on the card and the registered MAE machinery ----
    t0 = time.perf_counter()
    scale = torch.tensor(scene_scale, dtype=torch.float32, device=dev)
    xyz = (rays_all.origins + rays_all.viewdirs * out["depth"]) * scale  # local metres
    res, half = 0.5, 256.0
    size = int(2 * half / res)
    pred = rasterize_pointcloud(xyz[:, 0], xyz[:, 1], xyz[:, 2], -half, half, res,
                                size, size)
    dx, dy = DSM_SHIFT
    gt = torch.full_like(pred, float("nan"))
    # pred[j + dy, i + dx] aligns with gt[j, i] (the registration convention)
    gt[max(0, -dy):size - max(0, dy), max(0, -dx):size - max(0, dx)] = (
        pred[max(0, dy):size - max(0, -dy), max(0, dx):size - max(0, -dx)] - DSM_ZBIAS)
    mae, (fdx, fdy, bias) = device_dsm_mae(pred, gt)
    torch.cuda.synchronize()
    dsm = {"phase": "dsm", "grid": [size, size], "resolution_m": res,
           "filled": float(torch.isfinite(pred).float().mean()),
           "found_shift": [fdx, fdy], "true_shift": [dx, dy], "bias": float(bias),
           "true_bias": -DSM_ZBIAS, "mae_m": float(mae),
           "seconds": time.perf_counter() - t0, "card": card}
    emit(dsm)
    if (fdx, fdy) != (dx, dy) or abs(float(bias) + DSM_ZBIAS) > 1e-3 or not float(mae) < 1e-3:
        raise AssertionError(f"DSM registration did not recover the known shift: {dsm}")

    # ---- 5. the hierarchical sweep: coarse kernel, then camera and shadow ----
    hier_counted = {"coarse_fwd": fr.coarse_forward, "camera_fwd": fr.camera_forward,
                    "shadow_fwd": fr.shadow_forward}
    for fn in hier_counted.values():
        fn.launches = 0
    stream_before = fr.stream_fwd_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_h = sat.render_image(rf, rays_all, cfg_h, shadows=True, chunk=N_CHUNK,
                             generator=torch.Generator(device=dev).manual_seed(4))
    torch.cuda.synchronize()
    seconds_h = time.perf_counter() - t0
    stream_launches_h = stream_launches_since(stream_before)
    launches_h = {n: fn.launches for n, fn in hier_counted.items()}
    kernel_rows["coarse_fwd"]["launches"] = stream_launches_h["coarse_fwd"]
    bad_h = [k for k in sat.OUTPUT_KEYS
             if tuple(out_h[k].shape) != (n_rays, widths.get(k, 1))
             or not bool(torch.isfinite(out_h[k]).all())]
    with torch.no_grad():
        a = sat.render_rays(rf, few, cfg_h, True, torch.Generator(device=dev).manual_seed(6))
        b = sat.render_rays(field, few, cfg_h, True, torch.Generator(device=dev).manual_seed(6))
    path_err_h = {"depth_mean_abs": float((a["depth"] - b["depth"]).abs().mean()),
                  "rgb_mean_abs": float((a["rgb"] - b["rgb"]).abs().mean())}
    emit({"phase": "render_hier", "rays": n_rays, "chunks": n_chunks,
          "samples": {"coarse": cfg_h.n_samples, "fine": cfg_h.n_importance,
                      "shadow": cfg_h.sc_n_samples},
          "seconds": seconds_h, "rays_per_s": n_rays / seconds_h,
          "ms_per_chunk": seconds_h * 1e3 / n_chunks, "launches": launches_h,
          "stream_fwd_kernel_launches": stream_launches_h, "bad_keys": bad_h,
          "pts_per_ray_mean": float(out_h["pts_per_ray"].mean()),
          "depth_range": [float(out_h["depth"].min()), float(out_h["depth"].max())],
          "vs_per_sample_path": path_err_h, "tolerance": PATH_TOL, "card": card})
    if bad_h:
        raise AssertionError(f"hierarchical render outputs wrong or non-finite: {bad_h}")
    if any(n != n_chunks for n in launches_h.values()) or any(
            n != n_chunks for n in stream_launches_h.values()):
        raise AssertionError(f"kernel launches {launches_h}, streamed kernel "
                             f"{stream_launches_h} != {n_chunks} chunks")
    if any(path_err_h[k] > PATH_TOL[k] for k in PATH_TOL):
        raise AssertionError(f"hierarchical kernel path vs per-sample path: {path_err_h}")

    # ---- 6. training steps through the forward and backward kernels ----
    from eonerf_code_tpu_torch.config import TrainConfig
    from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
    from eonerf_code_tpu_torch.train.loop import Trainer, make_loss_fn

    log_root = ROOT / "logs"
    shutil.rmtree(log_root / "chip_smoke", ignore_errors=True)
    cfg_t = TrainConfig(logs_dir=str(log_root), exp_name="chip_smoke", sampler="uniform",
                        occ_enabled=False, bwd_acts="recompute", compute_dtype="bfloat16",
                        batch_size=N_TRAIN, n_samples=128, sc_n_samples=64,
                        first_shadow_step=TRAIN_STEPS // 2, first_beta_step=TRAIN_STEPS // 2,
                        max_train_steps=TRAIN_STEPS, save_freq=10 ** 9, seed=0)
    tr = Trainer(cfg_t, synthetic_ray_pool(N_POOL, N_VIEWS, dev), n_images=N_VIEWS, device=dev)
    if not isinstance(tr.render_field, KernelField):
        raise RuntimeError("the trainer did not pick the kernels for a bf16 8x256 field")
    before = [p.detach().clone() for p in tr.field.parameters()]
    counted = (fr.camera_forward, fr.shadow_forward, fr.camera_backward, fr.shadow_backward)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(max_steps=TRAIN_STEPS, log_every=1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches_t = dict(zip(("camera_fwd", "shadow_fwd", "camera_bwd", "shadow_bwd"),
                          (fn.launches for fn in counted)))
    for name in ("camera_bwd", "shadow_bwd"):
        kernel_rows[name]["launches"] = launches_t[name]
    rows = [json.loads(line) for line in (log_root / "chip_smoke" / "metrics.jsonl").open()]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    moved = sum(not torch.equal(a, p) for a, p in zip(before, tr.field.parameters()))
    shadow_steps = TRAIN_STEPS - TRAIN_STEPS // 2
    expect = {"camera_fwd": TRAIN_STEPS, "camera_bwd": TRAIN_STEPS,
              "shadow_fwd": shadow_steps, "shadow_bwd": shadow_steps}
    # timed steady steps (shadows and beta on)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.run(max_steps=TRAIN_STEPS + TIMED_STEPS, log_every=10 ** 9)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    opt_ms = time_ms(torch, tr.optimizer.step, 10)
    fwd_ms = train_fwd_ms
    bwd_ms = kernel_rows["camera_bwd"]["ms"] + kernel_rows["shadow_bwd"]["ms"]
    # one batch: the whole-step gradient through the kernels vs through the
    # per-sample module path, same sampling draws
    batch = {k: v[:N_TRAIN] for k, v in tr.device_data.items()}
    grads = []
    for rfield in (tr.render_field, tr.field):
        tr.field.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(rfield, tr.rcfg)(batch, 0.0, True, True,
                                                torch.Generator(device=dev).manual_seed(5))
        loss.backward()
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in tr.field.parameters()]))
    grad_rel = float((grads[0] - grads[1]).norm() / grads[1].norm())
    train = {"phase": "train", "steps": TRAIN_STEPS, "batch": N_TRAIN, "pool_rays": N_POOL,
             "views": N_VIEWS, "first_run_s": first_s, "losses_finite": len(losses) == TRAIN_STEPS
             and all(math.isfinite(v) for v in losses), "loss_first_last": [losses[0], losses[-1]],
             "param_tensors_moved": moved, "param_tensors": len(before), "launches": launches_t,
             "expected_launches": expect, "grad_vs_per_sample_rel_l2": grad_rel,
             "tolerance": GRAD_PATH_REL_L2, "rays_per_s": N_TRAIN / (step_ms * 1e-3),
             "ms_per_step": step_ms, "ms_fwd_kernels": fwd_ms, "ms_bwd_kernels": bwd_ms,
             "ms_optimizer": opt_ms, "ms_rest": step_ms - fwd_ms - bwd_ms - opt_ms,
             "card": card}
    emit(train)
    if not train["losses_finite"] or moved == 0:
        raise AssertionError(f"training did not run cleanly: {train}")
    if launches_t != expect:
        raise AssertionError(f"kernel launches {launches_t} != {expect}")
    if not grad_rel <= GRAD_PATH_REL_L2:
        raise AssertionError(f"kernel-path gradient vs per-sample path: rel-L2 {grad_rel}")

    def recording(t):
        """Wrap the trainer's step: record each step's loss (kept on the
        card, read at the end) and whether the sampler got the grid."""
        probe = step_probe(t)
        return probe.losses, probe.tightened

    def branch_result(t, before, losses_a, launches, expect, extra):
        losses_a = [float(v) for v in losses_a]
        moved_a = sum(not torch.equal(x, p) for x, p in zip(before, t.field.parameters()))
        res = {"sampler": t.cfg.sampler, "n_samples": t.cfg.n_samples,
               "n_importance": t.cfg.n_importance, "sc_n_samples": t.cfg.sc_n_samples,
               "steps": len(losses_a), "losses_finite": all(math.isfinite(v) for v in losses_a),
               "loss_first_last": [losses_a[0], losses_a[-1]], "param_tensors_moved": moved_a,
               "launches": launches, "expected_launches": expect, **extra}
        if not res["losses_finite"] or moved_a == 0:
            raise AssertionError(f"{t.cfg.exp_name} did not train cleanly: {res}")
        if launches != expect:
            raise AssertionError(f"{t.cfg.exp_name}: kernel launches {launches} != {expect}")
        return res

    def timed_run(t, max_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.run(max_steps=max_steps, log_every=10 ** 9)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    # ---- 6b. train_saved: phase 6's configuration with bwd_acts="saved" (the
    # JAX package's default): the forwards write the activation stream, the
    # backwards read it; the same seed, so the same weights and draws ----
    pool = tr.device_data
    recompute_losses = losses
    del tr
    saved_counted = {"camera_fwd_save": fr.camera_forward_save,
                     "shadow_fwd_save": fr.shadow_forward_save,
                     "camera_bwd_saved": fr.camera_backward_saved,
                     "shadow_bwd_saved": fr.shadow_backward_saved,
                     "camera_fwd": fr.camera_forward, "shadow_fwd": fr.shadow_forward,
                     "camera_bwd": fr.camera_backward, "shadow_bwd": fr.shadow_backward}
    shutil.rmtree(log_root / "chip_smoke_saved", ignore_errors=True)
    cfg_s = dataclasses.replace(cfg_t, exp_name="chip_smoke_saved", bwd_acts="saved")
    ts = Trainer(cfg_s, pool, n_images=N_VIEWS, device=dev)
    if not (isinstance(ts.render_field, KernelField) and ts.render_field.save_acts):
        raise RuntimeError("the trainer did not pick the saved-activations kernels")
    save_ok = ts.render_field.step_save_ok(N_TRAIN, 127, 63)
    losses_s, _ = recording(ts)
    before_s = [p.detach().clone() for p in ts.field.parameters()]

    def library_saved_launches(dgrad_before, save_before):
        """The library's own counts since `dgrad_before` and `save_before`:
        the dgrad kernel's (every backward's) and the save mode's by op."""
        save_now = fr.save_fwd_kernel_launches()
        return {"dgrad_kernel": fr.dgrad_kernel_launches() - dgrad_before,
                **{f"{m}_fwd_save_kernel": save_now[m] - save_before[m] for m in save_now}}

    for fn in saved_counted.values():
        fn.launches = 0
    dgrad_before = fr.dgrad_kernel_launches()   # the library's own counts
    save_before = fr.save_fwd_kernel_launches()
    ts.run(max_steps=TRAIN_STEPS, log_every=10 ** 9)
    launches_s = {n: fn.launches for n, fn in saved_counted.items()}
    launches_s.update(library_saved_launches(dgrad_before, save_before))
    expect_s = {"camera_fwd_save": TRAIN_STEPS, "shadow_fwd_save": shadow_steps,
                "camera_bwd_saved": TRAIN_STEPS, "shadow_bwd_saved": shadow_steps,
                "camera_fwd": 0, "shadow_fwd": 0, "camera_bwd": 0, "shadow_bwd": 0,
                "dgrad_kernel": TRAIN_STEPS + shadow_steps,
                "camera_fwd_save_kernel": TRAIN_STEPS, "shadow_fwd_save_kernel": shadow_steps}
    saved_res = branch_result(ts, before_s, losses_s, launches_s, expect_s, {"save_ok": save_ok})
    step_ms_s = timed_run(ts, TRAIN_STEPS + TIMED_STEPS) * 1e3 / TIMED_STEPS
    # one batch, shadows and beta on: the whole-step gradient of the saved
    # backward against the recompute backward on the same weights and draws
    batch = {k: v[:N_TRAIN] for k, v in pool.items()}
    grads = []
    for rfield in (ts.render_field, KernelField(ts.field)):
        ts.field.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(rfield, ts.rcfg)(batch, 0.0, True, True,
                                                torch.Generator(device=dev).manual_seed(12))
        loss.backward()
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in ts.field.parameters()]))
    saved_res.update(
        grad_vs_recompute_rel_l2=float((grads[0] - grads[1]).norm() / grads[1].norm()),
        grad_bitwise_recompute=bool(torch.equal(grads[0], grads[1])),
        loss_max_abs_diff_vs_train=max(abs(float(a) - b)
                                       for a, b in zip(losses_s, recompute_losses)),
        ms_per_step=step_ms_s, rays_per_s=N_TRAIN / (step_ms_s * 1e-3),
        recompute_ms_per_step=step_ms)
    for name in ("camera_fwd_save", "shadow_fwd_save", "camera_bwd_saved", "shadow_bwd_saved"):
        kernel_rows[name]["launches_by_path"] = {
            "train_saved": launches_s.get(f"{name}_kernel", launches_s[name])}
    emit({"phase": "train_saved", "batch": N_TRAIN, "pool_rays": N_POOL, **saved_res,
          "tolerance": SAVED_REL_L2, "card": card})
    del ts
    if not (save_ok and saved_res["grad_vs_recompute_rel_l2"] <= SAVED_REL_L2):
        raise AssertionError(f"saved-activations step: {saved_res}")

    # ---- 7. sampler="auto": hierarchical on a wide envelope, tightened on a
    # compact one, the occupancy grid at the JAX package's defaults ----
    auto_counted = {"coarse_fwd": fr.coarse_forward, "density_fwd": ff.density_forward,
                    "camera_fwd": fr.camera_forward, "shadow_fwd": fr.shadow_forward,
                    "camera_bwd": fr.camera_backward, "shadow_bwd": fr.shadow_backward}

    def auto_trainer(name, envelope, **kw):
        """A Trainer at the sampler=auto defaults on the chip_smoke pool."""
        cfg_a = TrainConfig(logs_dir=str(log_root), exp_name=name, sampler="auto",
                            occ_enabled=True, bwd_acts="recompute", compute_dtype="bfloat16",
                            save_freq=10 ** 9, seed=1, **kw)
        shutil.rmtree(log_root / name, ignore_errors=True)
        t = Trainer(cfg_a, pool, n_images=N_VIEWS, device=dev, alt_envelope=envelope)
        if not isinstance(t.render_field, KernelField):
            raise RuntimeError("the trainer did not pick the kernels for a bf16 8x256 field")
        return t

    # wide envelope -> hierarchical: the coarse kernel once per step; the
    # grid is kept up to date (step 0 here) but not sampled from
    tw = auto_trainer("chip_smoke_wide", WIDE_ENVELOPE, first_shadow_step=WIDE_STEPS // 2,
                      first_beta_step=WIDE_STEPS // 2, max_train_steps=WIDE_STEPS)
    if (tw.cfg.sampler, tw.cfg.n_samples, tw.cfg.n_importance) != ("hierarchical", 96, 48):
        raise AssertionError(f"wide envelope resolved to {tw.cfg.sampler} "
                             f"{tw.cfg.n_samples}+{tw.cfg.n_importance}")
    losses_w, _ = recording(tw)
    before_w = [p.detach().clone() for p in tw.field.parameters()]
    for fn in auto_counted.values():
        fn.launches = 0
    point_before = ff.point_fwd_kernel_launches()
    tw.run(max_steps=WIDE_STEPS, log_every=10 ** 9)
    launches_w = {n: fn.launches for n, fn in auto_counted.items()}
    launches_w["density_fwd_library"] = point_launches_since(point_before)["density_fwd"]
    half = WIDE_STEPS - WIDE_STEPS // 2
    expect_w = {"coarse_fwd": WIDE_STEPS, "density_fwd": 0, "camera_fwd": WIDE_STEPS,
                "shadow_fwd": half, "camera_bwd": WIDE_STEPS, "shadow_bwd": half,
                "density_fwd_library": 0}
    wide = branch_result(tw, before_w, losses_w, launches_w, expect_w,
                         {"grid_occupied": float(tw.occ_grid.binaries.float().mean())})
    step_ms_w = timed_run(tw, WIDE_STEPS + TIMED_STEPS) * 1e3 / TIMED_STEPS   # no grid update
    wide.update(ms_per_step=step_ms_w, rays_per_s=N_TRAIN / (step_ms_w * 1e-3))
    del tw

    # compact envelope -> tightening: grid updates (each with the entropy
    # probe through the density kernel) at steps 0 and COMPACT_UPDATE_EVERY
    tc = auto_trainer("chip_smoke_compact", COMPACT_ENVELOPE, first_shadow_step=0,
                      first_beta_step=COMPACT_STEPS // 2, max_train_steps=COMPACT_STEPS,
                      occ_update_every=COMPACT_UPDATE_EVERY, occ_tighten_start_step=1,
                      occ_entropy_max=1.0)
    if tc.cfg.sampler != "tighten" or not tc.rcfg.occ_tighten_shadows:
        raise AssertionError(f"compact envelope resolved to {tc.cfg.sampler}")
    losses_c, tightened = recording(tc)
    before_c = [p.detach().clone() for p in tc.field.parameters()]
    for fn in auto_counted.values():
        fn.launches = 0
    point_before = ff.point_fwd_kernel_launches()
    tc.run(max_steps=1, log_every=10 ** 9)
    # seed the stability gate's history with the first update's fraction
    tc._occ_frac_hist = tc._occ_frac_hist[-1:] * 5
    if tc._occ_for_sampling(step=1) is not tc.occ_grid:
        raise AssertionError(f"the tightening gates stay closed: entropy {tc._entropy_hist}")
    # steps 1 .. COMPACT_UPDATE_EVERY - 1 sample tightened, no grid update
    n_tight = COMPACT_UPDATE_EVERY - 1
    step_ms_c = timed_run(tc, COMPACT_UPDATE_EVERY) * 1e3 / n_tight
    tc.run(max_steps=COMPACT_STEPS, log_every=10 ** 9)
    launches_c = {n: fn.launches for n, fn in auto_counted.items()}
    launches_c["density_fwd_library"] = point_launches_since(point_before)["density_fwd"]
    kernel_rows["density_fwd"]["launches"] = launches_c["density_fwd"]
    n_updates = -(-COMPACT_STEPS // COMPACT_UPDATE_EVERY)
    expect_c = {"coarse_fwd": 0, "density_fwd": n_updates, "camera_fwd": COMPACT_STEPS,
                "shadow_fwd": COMPACT_STEPS, "camera_bwd": COMPACT_STEPS,
                "shadow_bwd": COMPACT_STEPS, "density_fwd_library": n_updates}
    t0 = time.perf_counter()
    tc._occ_update()
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    tc._weight_entropy()
    probe_ms = (time.perf_counter() - t0) * 1e3
    compact = branch_result(tc, before_c, losses_c, launches_c, expect_c,
                            {"grid_updates": n_updates, "gate_history_seeded": True,
                             "tightened_steps": tightened,
                             "weight_entropy": tc._entropy_hist,
                             "occupied_fraction": tc._occ_frac_hist,
                             "ms_per_tightened_step": step_ms_c,
                             "rays_per_s": N_TRAIN / (step_ms_c * 1e-3),
                             "ms_grid_update": update_ms, "ms_entropy_probe": probe_ms})
    emit({"phase": "train_auto", "batch": N_TRAIN, "pool_rays": N_POOL, "n_grid": 128,
          "occ_max_cells": 262144, "wide": wide, "compact": compact, "card": card})
    if tightened[1:COMPACT_UPDATE_EVERY] != [True] * n_tight:
        raise AssertionError(f"tightened steps {tightened}: the grid did not reach the sampler")

    # ---- 8. the per-sample branch: the nadir sweep with ray entropy and the
    # nadir diagnostics, through the per-point field and density kernels ----
    cfg_d = sat.RenderConfig(n_samples=128, sc_n_samples=64, compute_entropy=True,
                             nadir_diagnostics=True)
    point_counted = {"field_fwd": ff.field_forward, "density_fwd": ff.density_forward,
                     "camera_fwd": fr.camera_forward, "shadow_fwd": fr.shadow_forward}
    for fn in point_counted.values():
        fn.launches = 0
    point_before = ff.point_fwd_kernel_launches()   # the library's own counts
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_d = sat.render_image(rf, rays_all, cfg_d, shadows=True, chunk=N_CHUNK,
                             generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    seconds_d = time.perf_counter() - t0
    launches_d = {n: fn.launches for n, fn in point_counted.items()}
    launches_d.update({f"{n}_library": c for n, c in point_launches_since(point_before).items()})
    kernel_rows["field_fwd"]["launches"] = launches_d["field_fwd"]
    kernel_rows["density_fwd"]["launches_by_path"] = {
        "train_auto": kernel_rows["density_fwd"]["launches"],
        "render_diag": launches_d["density_fwd"]}
    expect_d = {"field_fwd": n_chunks, "density_fwd": 3 * n_chunks, "camera_fwd": 0,
                "shadow_fwd": 0, "field_fwd_library": n_chunks,
                "density_fwd_library": 3 * n_chunks}
    bad_d = [k for k in sat.OUTPUT_KEYS
             if tuple(out_d[k].shape) != (n_rays, widths.get(k, 1))
             or not bool(torch.isfinite(out_d[k]).all())]
    entropy, after = out_d["entropy"], out_d["opacity_after_surface"]
    ranges = {"entropy": [float(entropy.min()), float(entropy.max())],
              "opacity_after_surface": [float(after.min()), float(after.max())]}
    in_range = (ranges["entropy"][0] >= 0.0
                and ranges["entropy"][1] <= math.log10(cfg_d.n_samples - 1) + 1e-5
                and ranges["opacity_after_surface"][0] >= 0.0
                and ranges["opacity_after_surface"][1] <= 1.0)
    # the same 1024 rays: depth and rgb against the fused branch (the same
    # draws), the diagnostics against the per-sample module path
    with torch.no_grad():
        a = sat.render_rays(rf, few, cfg_d, True, torch.Generator(device=dev).manual_seed(8))
        b = sat.render_rays(rf, few, cfg, True, torch.Generator(device=dev).manual_seed(8))
        c = sat.render_rays(field, few, cfg_d, True, torch.Generator(device=dev).manual_seed(8))
    path_err_d = {"depth_mean_abs": float((a["depth"] - b["depth"]).abs().mean()),
                  "rgb_mean_abs": float((a["rgb"] - b["rgb"]).abs().mean())}
    diag_err = {"entropy_mean_abs": float((a["entropy"] - c["entropy"]).abs().mean()),
                "opacity_after_surface_mean_abs":
                    float((a["opacity_after_surface"] - c["opacity_after_surface"]).abs().mean())}
    # a chunk's kernels timed alone: the field forward once, the density
    # forward three times (the shadow pass and the two probes)
    kernel_ms_d = point_ms["field_fwd_chunk"] + 3 * point_ms["density_fwd_chunk"]
    emit({"phase": "render_diag", "rays": n_rays, "chunks": n_chunks,
          "samples": {"camera": cfg_d.n_samples, "shadow": cfg_d.sc_n_samples,
                      "probe": cfg_d.sc_n_samples},
          "seconds": seconds_d, "rays_per_s": n_rays / seconds_d,
          "ms_per_chunk": seconds_d * 1e3 / n_chunks, "kernel_ms_per_chunk": kernel_ms_d,
          "kernel_share": kernel_ms_d * n_chunks / (seconds_d * 1e3),
          "launches": launches_d, "expected_launches": expect_d, "bad_keys": bad_d,
          "ranges": ranges, "vs_fused_branch": path_err_d, "tolerance": PATH_TOL,
          "diagnostics_vs_per_sample_path": diag_err, "diagnostics_tolerance": DIAG_TOL,
          "card": card})
    if bad_d or not in_range:
        raise AssertionError(f"diagnostics render outputs wrong, non-finite or out of range: "
                             f"{bad_d} {ranges}")
    if launches_d != expect_d:
        raise AssertionError(f"kernel launches {launches_d} != {expect_d}")
    if any(path_err_d[k] > PATH_TOL[k] for k in PATH_TOL):
        raise AssertionError(f"per-sample kernel branch vs fused branch: {path_err_d}")
    if any(diag_err[k] > DIAG_TOL[k] for k in DIAG_TOL):
        raise AssertionError(f"diagnostics vs the per-sample module path: {diag_err}")

    # ---- 9. training steps through the per-sample branch: ray entropy on,
    # make_train_step over the field kernel forward and backward and the
    # density kernel forward and backward ----
    from eonerf_code_tpu_torch.train.loop import make_lr_schedule, make_optimizer, make_train_step

    field_t = EONerfField(N_VIEWS, compute_dtype=torch.bfloat16, device=dev,
                          generator=torch.Generator().manual_seed(3))
    kf = make_render_field(field_t)
    if not isinstance(kf, KernelField):
        raise RuntimeError("make_render_field did not pick the kernels for a bf16 8x256 field")
    cfg_dt = TrainConfig(batch_size=N_TRAIN, n_samples=128, sc_n_samples=64)
    rcfg_t = sat.RenderConfig(n_samples=128, sc_n_samples=64, compute_entropy=True)
    opt_t = make_optimizer(field_t.parameters(), cfg_dt)
    flags = {"has_depth": "depth_prior" in pool, "has_conf": "conf_prior" in pool,
             "has_shadow": "shadow_prior" in pool}
    step_fn = make_train_step(kf, opt_t, make_lr_schedule(cfg_dt, N_POOL // N_TRAIN), rcfg_t,
                              **flags)
    gen_t = torch.Generator(device=dev).manual_seed(9)
    w_depth = cfg_dt.depth_weight

    def diag_steps(first, last):
        """Steps first..last-1 on random batches of the pool; shadows and the
        beta loss from step TRAIN_STEPS // 2. The losses stay on the card."""
        out = []
        for i in range(first, last):
            idx = torch.randint(0, N_POOL, (N_TRAIN,), generator=gen_t, device=dev)
            on = i >= TRAIN_STEPS // 2
            out.append(step_fn({k: v[idx] for k, v in pool.items()}, i, w_depth, on, on,
                               gen_t)["loss"])
        return out

    diag_counted = {"field_fwd": ff.field_forward, "field_bwd": ff.field_backward,
                    "density_fwd": ff.density_forward, "density_bwd": ff.density_backward,
                    "camera_fwd": fr.camera_forward, "camera_bwd": fr.camera_backward,
                    "shadow_fwd": fr.shadow_forward, "shadow_bwd": fr.shadow_backward}
    before_t = [p.detach().clone() for p in field_t.parameters()]
    for fn in diag_counted.values():
        fn.launches = 0
    point_before = ff.point_fwd_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses_d = [float(v) for v in diag_steps(0, TRAIN_STEPS)]
    first_d = time.perf_counter() - t0
    launches_td = {n: fn.launches for n, fn in diag_counted.items()}
    launches_td.update({f"{n}_library": c
                        for n, c in point_launches_since(point_before).items()})
    for name in ("field_bwd", "density_bwd"):
        kernel_rows[name]["launches"] = launches_td[name]
    kernel_rows["density_fwd"]["launches_by_path"]["train_diag"] = launches_td["density_fwd"]
    moved_d = sum(not torch.equal(a, p) for a, p in zip(before_t, field_t.parameters()))
    shadow_steps = TRAIN_STEPS - TRAIN_STEPS // 2
    expect_td = {"field_fwd": TRAIN_STEPS, "field_bwd": TRAIN_STEPS, "density_fwd": shadow_steps,
                 "density_bwd": shadow_steps, "camera_fwd": 0, "camera_bwd": 0, "shadow_fwd": 0,
                 "shadow_bwd": 0, "field_fwd_library": TRAIN_STEPS,
                 "density_fwd_library": shadow_steps}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    diag_steps(TRAIN_STEPS, TRAIN_STEPS + TIMED_STEPS)
    torch.cuda.synchronize()
    step_ms_d = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
    # one batch: the whole-step gradient through the kernels vs through the
    # per-sample module path, same sampling draws
    batch = {k: v[:N_TRAIN] for k, v in pool.items()}
    # per-sample path, and both against the module in float32 (the same
    # weights): how far each bf16 path lies from the f32 gradient
    field_32 = EONerfField(N_VIEWS, compute_dtype=torch.float32, device=dev)
    field_32.load_state_dict(field_t.state_dict())
    grads = []
    for rfield, owner in ((kf, field_t), (field_t, field_t), (field_32, field_32)):
        owner.zero_grad(set_to_none=True)
        loss, _ = make_loss_fn(rfield, rcfg_t, **flags)(
            batch, 0.0, True, True, torch.Generator(device=dev).manual_seed(10))
        loss.backward()
        grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                .float().flatten() for p in owner.parameters()]))

    def rel_d(a, b):
        return float((grads[a] - grads[b]).norm() / grads[b].norm())

    grad_rel_d = rel_d(0, 1)
    grad_f32 = {"kernel_vs_f32": rel_d(0, 2), "module_bf16_vs_f32": rel_d(1, 2)}
    fwd_ms_d = point_ms["field_fwd_batch"] + point_ms["density_fwd_batch"]
    bwd_ms_d = kernel_rows["field_bwd"]["ms"] + kernel_rows["density_bwd"]["ms"]
    train_d = {"phase": "train_diag", "steps": TRAIN_STEPS, "batch": N_TRAIN,
               "render_config": {"n_samples": 128, "sc_n_samples": 64, "compute_entropy": True},
               "first_run_s": first_d,
               "losses_finite": all(math.isfinite(v) for v in losses_d),
               "loss_first_last": [losses_d[0], losses_d[-1]], "param_tensors_moved": moved_d,
               "param_tensors": len(before_t), "launches": launches_td,
               "expected_launches": expect_td, "grad_vs_per_sample_rel_l2": grad_rel_d,
               "tolerance": GRAD_PATH_DIAG_REL_L2, "grad_vs_f32_module_rel_l2": grad_f32,
               "tolerance_vs_f32": GRAD_PATH_REL_L2, "rays_per_s": N_TRAIN / (step_ms_d * 1e-3),
               "ms_per_step": step_ms_d, "ms_fwd_kernels": fwd_ms_d, "ms_bwd_kernels": bwd_ms_d,
               "ms_rest": step_ms_d - fwd_ms_d - bwd_ms_d, "card": card}
    emit(train_d)
    if not train_d["losses_finite"] or moved_d == 0:
        raise AssertionError(f"diagnostics training did not run cleanly: {train_d}")
    if launches_td != expect_td:
        raise AssertionError(f"kernel launches {launches_td} != {expect_td}")
    if not (grad_rel_d <= GRAD_PATH_DIAG_REL_L2
            and grad_f32["kernel_vs_f32"] <= GRAD_PATH_REL_L2):
        raise AssertionError(f"per-sample kernel-path gradient vs module path: rel-L2 "
                             f"{grad_rel_d}, vs float32 {grad_f32}")

    # ---- 10. the int8 trunk tier on the render path: the nadir sweep through
    # make_render_field(field, TrainConfig(trunk_quant="int8")), uniform and
    # hierarchical, against the bf16 renders of the same weights ----
    rf_q = make_render_field(field, TrainConfig(trunk_quant="int8", bwd_acts="recompute"))
    if not (isinstance(rf_q, KernelField) and rf_q.trunk_quant is True):
        raise RuntimeError("make_render_field did not pick the int8 kernels for trunk_quant=int8")

    # the camera op at int8 against bf16 on the phase-2 chunk
    acc_q = fr.camera_forward_q8(kw, q8w, rayin, z_mid, deltam)
    acc_b = fr.camera_forward(kw, rayin, z_mid, deltam)
    camera_rel = {"depth": rel_l2(acc_q[:, 0], acc_b[:, 0]),
                  "albedo": rel_l2(acc_q[:, 1:4], acc_b[:, 1:4]),
                  "opacity": rel_l2(acc_q[:, 6], acc_b[:, 6])}
    q8_counted = {"camera_fwd_q8": fr.camera_forward_q8, "shadow_fwd_q8": fr.shadow_forward_q8,
                  "coarse_fwd_q8": fr.coarse_forward_q8, "camera_fwd": fr.camera_forward,
                  "shadow_fwd": fr.shadow_forward, "coarse_fwd": fr.coarse_forward}
    render_q8 = {}
    for sampler, cfg_r, seed, ref_out in (("uniform", cfg, 2, out), ("hierarchical", cfg_h, 4,
                                                                     out_h)):
        for fn in q8_counted.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_q = sat.render_image(rf_q, rays_all, cfg_r, shadows=True, chunk=N_CHUNK,
                                 generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches_q = {n: fn.launches for n, fn in q8_counted.items()}
        hier = sampler == "hierarchical"
        expect_q = {"camera_fwd_q8": n_chunks, "shadow_fwd_q8": n_chunks,
                    "coarse_fwd_q8": n_chunks if hier else 0, "camera_fwd": 0, "shadow_fwd": 0,
                    "coarse_fwd": 0}
        bad_q = [k for k in sat.OUTPUT_KEYS
                 if tuple(out_q[k].shape) != (n_rays, widths.get(k, 1))
                 or not bool(torch.isfinite(out_q[k]).all())]
        render_q8[sampler] = {
            "seconds": secs, "rays_per_s": n_rays / secs, "ms_per_chunk": secs * 1e3 / n_chunks,
            "launches": launches_q, "expected_launches": expect_q, "bad_keys": bad_q,
            "vs_bf16_rel_l2": {"depth": rel_l2(out_q["depth"], ref_out["depth"]),
                               "rgb": rel_l2(out_q["rgb"], ref_out["rgb"])}}
        if sampler == "uniform":
            for name in ("camera_fwd_q8", "shadow_fwd_q8"):
                kernel_rows[name]["launches"] = launches_q[name]
        else:
            kernel_rows["coarse_fwd_q8"]["launches"] = launches_q["coarse_fwd_q8"]
    emit({"phase": "render_q8", "trunk_quant": "int8", "rays": n_rays, "chunks": n_chunks,
          "camera_op_vs_bf16_rel_l2": camera_rel, "camera_op_tolerance": Q8_CAMERA_REL_L2,
          **render_q8, "tolerance": Q8_RENDER_REL_L2, "card": card})
    if any(v > Q8_CAMERA_REL_L2 for v in camera_rel.values()):
        raise AssertionError(f"int8 camera op vs bf16: {camera_rel}")
    for sampler, res in render_q8.items():
        if res["bad_keys"] or res["launches"] != res["expected_launches"]:
            raise AssertionError(f"int8 {sampler} render: {res}")
        if any(v > Q8_RENDER_REL_L2 for v in res["vs_bf16_rel_l2"].values()):
            raise AssertionError(f"int8 {sampler} render vs bf16: {res['vs_bf16_rel_l2']}")

    # ---- 11. the int8 tiers on the training path: Trainer.run with
    # trunk_quant int8 and int8_full at the default bwd_acts (the recompute
    # fallback), 20 steps then 10 timed; one batch's gradient against the bf16
    # step's, and the camera op's origin gradient against bf16 ----
    q8_train_counted = {
        "camera_fwd_q8": fr.camera_forward_q8, "shadow_fwd_q8": fr.shadow_forward_q8,
        "camera_bwd_q8": fr.camera_backward_q8, "shadow_bwd_q8": fr.shadow_backward_q8,
        "camera_bwd_q8_full": fr.camera_backward_q8_full,
        "shadow_bwd_q8_full": fr.shadow_backward_q8_full, "camera_fwd": fr.camera_forward,
        "shadow_fwd": fr.shadow_forward, "camera_bwd": fr.camera_backward,
        "shadow_bwd": fr.shadow_backward}
    train_q8 = {}
    coef = torch.randn((N_TRAIN, 7), generator=gen, device=dev)

    def cosine(a, b):
        return float((a * b).sum() / (a.norm() * b.norm()))

    for tier in ("int8", "int8_full"):
        name = f"chip_smoke_{tier}"
        shutil.rmtree(log_root / name, ignore_errors=True)
        cfg_q = TrainConfig(logs_dir=str(log_root), exp_name=name, sampler="uniform",
                            occ_enabled=False, trunk_quant=tier, compute_dtype="bfloat16",
                            batch_size=N_TRAIN, n_samples=128, sc_n_samples=64,
                            first_shadow_step=TRAIN_STEPS // 2, first_beta_step=TRAIN_STEPS // 2,
                            max_train_steps=TRAIN_STEPS, save_freq=10 ** 9, seed=0)
        tq = Trainer(cfg_q, pool, n_images=N_VIEWS, device=dev)
        full = tier == "int8_full"
        if not (isinstance(tq.render_field, KernelField)
                and tq.render_field.trunk_quant == ("full" if full else True)):
            raise RuntimeError(f"the trainer did not pick the {tier} kernels")
        losses_q, _ = recording(tq)
        before_q = [p.detach().clone() for p in tq.field.parameters()]
        for fn in q8_train_counted.values():
            fn.launches = 0
        bwd_before = fr.q8_bwd_kernel_launches()   # the library's own counts
        tq.run(max_steps=TRAIN_STEPS, log_every=10 ** 9)
        torch.cuda.synchronize()
        launches_tq = {n: fn.launches for n, fn in q8_train_counted.items()}
        launches_tq.update({k: n - bwd_before[k] for k, n in fr.q8_bwd_kernel_launches().items()})
        sfx = "_full" if full else ""
        expect_tq = {n: 0 for n in q8_train_counted}
        expect_tq.update({"camera_fwd_q8": TRAIN_STEPS, "shadow_fwd_q8": shadow_steps,
                          f"camera_bwd_q8{sfx}": TRAIN_STEPS,
                          f"shadow_bwd_q8{sfx}": shadow_steps})
        expect_tq.update({k: 0 for k in fr.Q8_BWD_KERNELS})
        if full:   # the cluster chain and the weight gradient once a backward
            backwards = TRAIN_STEPS + shadow_steps
            expect_tq.update({"q8_chain_cluster_kernel": backwards,
                              "q8_wgrad_kernel": backwards, "q8_reduce_kernel": backwards})
            kernel_rows["q8_chain_cluster"]["launches"] = launches_tq["q8_chain_cluster_kernel"]
            kernel_rows["q8_wgrad"]["launches"] = launches_tq["q8_wgrad_kernel"]
        for n in (f"camera_bwd_q8{sfx}", f"shadow_bwd_q8{sfx}"):
            kernel_rows[n]["launches"] = launches_tq[n]
        res = branch_result(tq, before_q, losses_q, launches_tq, expect_tq, {})
        step_ms_q = timed_run(tq, TRAIN_STEPS + TIMED_STEPS) * 1e3 / TIMED_STEPS
        # one batch, shadows and beta on: the whole-step weight gradient of the
        # int8 tier against the bf16 kernels' on the same weights and draws
        batch = {k: v[:N_TRAIN] for k, v in pool.items()}
        grads = []
        for rfield in (tq.render_field, KernelField(tq.field)):
            tq.field.zero_grad(set_to_none=True)
            loss, _ = make_loss_fn(rfield, tq.rcfg)(batch, 0.0, True, True,
                                                    torch.Generator(device=dev).manual_seed(11))
            loss.backward()
            grads.append(torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                    .float().flatten() for p in tq.field.parameters()]))
        # the camera op's origin gradient at the training shapes, int8 vs bf16
        w32 = ff.pack_kernel_weights(pack_params(tq.field), torch.float32)
        origin = []
        for quant in (("full" if full else True), False):
            ray = b_in[0].clone().requires_grad_()
            acc = fr.fused_camera(ff.KernelWeights(w32.mats.detach(), w32.biases.detach()), ray,
                                  b_in[1], b_in[2], torch.bfloat16, quant)
            (acc[:, :7] * coef).sum().backward()
            origin.append(ray.grad[:, 0:3].flatten())
        res.update(ms_per_step=step_ms_q, rays_per_s=N_TRAIN / (step_ms_q * 1e-3),
                   grad_cosine_vs_bf16=cosine(grads[0], grads[1]),
                   origin_grad_cosine_vs_bf16=cosine(origin[0], origin[1]))
        train_q8[tier] = res
        del tq
    emit({"phase": "train_q8", "batch": N_TRAIN, "pool_rays": N_POOL, **train_q8,
          "tolerance": {"grad_cosine": Q8_GRAD_COS, "origin_grad_cosine": Q8_ORIGIN_COS},
          "card": card})
    for tier, res in train_q8.items():
        if not (res["grad_cosine_vs_bf16"] > Q8_GRAD_COS
                and res["origin_grad_cosine_vs_bf16"] > Q8_ORIGIN_COS):
            raise AssertionError(f"{tier} step gradient vs bf16: {res}")

    # ---- 12. data: the hermetic scene on disk and the port's dataset ----
    from eonerf_code_tpu_torch.data.satellite import SatelliteDataset
    from eonerf_code_tpu_torch.data.synthetic import SyntheticSceneSpec, generate_scene

    scene_root = log_root / "chip_smoke_scene"
    shutil.rmtree(scene_root, ignore_errors=True)
    t0 = time.perf_counter()
    info = generate_scene(str(scene_root), SyntheticSceneSpec(n_views=SCENE_VIEWS,
                                                              img_size=SCENE_SIZE))
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = SatelliteDataset(info["root_dir"], info["img_dir"], split="train")
    dataset_s = time.perf_counter() - t0
    n_scene = SCENE_VIEWS * SCENE_SIZE * SCENE_SIZE
    data = {"phase": "data", "views": SCENE_VIEWS, "img_size": SCENE_SIZE,
            "scene_seconds": scene_s, "dataset_seconds": dataset_s,
            "pool_shape": list(ds.all_rays.shape), "expected_pool_shape": [n_scene, 11],
            "alt_envelope": list(ds.alt_envelope()), "expected_envelope": list(SCENE_ENVELOPE),
            "rays_finite": bool(np.isfinite(ds.all_rays).all()),
            "rays_in_cube": float(np.abs(ds.all_rays[:, :3]).max()), "card": card}
    emit(data)
    if not (data["pool_shape"] == data["expected_pool_shape"] and data["rays_finite"]
            and tuple(data["alt_envelope"]) == SCENE_ENVELOPE
            and data["rays_in_cube"] <= 1.0 + 1e-5):
        raise AssertionError(f"the dataset's ray pool is wrong: {data}")
    del ds

    # ---- 13. train_default: the JAX package's default training run through
    # the port on that scene, TrainConfig's defaults (bwd_acts "saved",
    # sampler "auto", the occupancy grid, 8x256, batch 1024, 128 samples) at
    # bf16, the shadow and beta gates cut from epoch 2 (2,560 steps on this
    # scene) to step 10 ----
    shutil.rmtree(log_root / "chip_smoke_default", ignore_errors=True)
    cfg_d0 = TrainConfig(root_dir=info["root_dir"], img_dir=info["img_dir"],
                         compute_dtype="bfloat16", first_shadow_step=TRAIN_STEPS // 2,
                         first_beta_step=TRAIN_STEPS // 2, logs_dir=str(log_root),
                         exp_name="chip_smoke_default", gt_dir=info["gt_dir"],
                         aoi_id=info["aoi_id"], device_eval=True, val_freq=10 ** 9)
    t0 = time.perf_counter()
    td = Trainer(cfg_d0, device=dev)
    trainer_s = time.perf_counter() - t0
    if not (isinstance(td.render_field, KernelField) and td.render_field.save_acts):
        raise RuntimeError("the default configuration did not pick the saved-activations kernels")
    losses_dd, tightened_d = recording(td)
    before_dd = [p.detach().clone() for p in td.field.parameters()]
    for fn in saved_counted.values():
        fn.launches = 0
    dgrad_before = fr.dgrad_kernel_launches()
    save_before = fr.save_fwd_kernel_launches()
    td.run(max_steps=TRAIN_STEPS, log_every=10 ** 9)
    launches_dd = {n: fn.launches for n, fn in saved_counted.items()}
    launches_dd.update(library_saved_launches(dgrad_before, save_before))
    for name in ("camera_fwd_save", "shadow_fwd_save", "camera_bwd_saved", "shadow_bwd_saved"):
        # the save forwards' launches by the library's count of the save mode
        n_l = launches_dd.get(f"{name}_kernel", launches_dd[name])
        kernel_rows[name]["launches"] = n_l
        kernel_rows[name]["launches_by_path"]["train_default"] = n_l
    default_res = branch_result(td, before_dd, losses_dd, launches_dd, expect_s, {
        "steps_per_epoch": td.steps_per_epoch, "n_images": td.n_images,
        "alt_envelope": list(td.alt_envelope), "occ_tighten": td.cfg.occ_tighten,
        "tightened_steps": sum(tightened_d), "trainer_build_s": trainer_s,
        "save_ok": td.render_field.step_save_ok(N_TRAIN, 127, td.cfg.sc_n_samples - 1)})
    step_ms_dd = timed_run(td, TRAIN_STEPS + TIMED_STEPS) * 1e3 / TIMED_STEPS
    default_res.update(ms_per_step=step_ms_dd, rays_per_s=N_TRAIN / (step_ms_dd * 1e-3))
    emit({"phase": "train_default", "batch": td.cfg.batch_size, "pool_rays": td.n_rays,
          "bwd_acts": td.cfg.bwd_acts, **default_res, "card": card})
    if default_res["sampler"] != "tighten" or not default_res["save_ok"]:
        raise AssertionError(f"the default run resolved otherwise: {default_res}")

    # ---- 13b. validate: Trainer.validate on that trainer (val_freq beyond
    # the run, so the timed steps above are the same): the val split's views
    # of 256x256 rendered whole in 1024-ray chunks through the streamed
    # camera and shadow forwards, the beta loss and PSNR, the registered DSM
    # MAE on the card (device_eval=True), the best checkpoint ----
    n_val = min(td.cfg.n_val_images, td.val_ds.num_val_images())
    view_chunks = -(-SCENE_SIZE * SCENE_SIZE // td.cfg.chunk)
    td.validate()    # warm-up
    for fn in saved_counted.values():
        fn.launches = 0
    dgrad_before = fr.dgrad_kernel_launches()
    save_before = fr.save_fwd_kernel_launches()
    stream_before = fr.stream_fwd_kernel_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td.validate()
    torch.cuda.synchronize()
    val_s = time.perf_counter() - t0
    launches_v = {n: fn.launches for n, fn in saved_counted.items()}
    launches_v.update(library_saved_launches(dgrad_before, save_before))
    stream_v = stream_launches_since(stream_before)
    n_val_chunks = n_val * view_chunks
    expect_v = {n: n_val_chunks if n in ("camera_fwd", "shadow_fwd") else 0 for n in launches_v}
    for name in ("camera_fwd", "shadow_fwd"):
        kernel_rows[name]["launches_by_path"] = {"render": kernel_rows[name]["launches"],
                                                 "validate": stream_v[name]}
    with open(pathlib.Path(td.log_dir) / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    logged = {r["tag"]: r["value"] for r in rows if r["tag"].startswith("val/")}
    best = pathlib.Path(td.log_dir) / "ckpts" / "epoch=best"
    # where a view's time goes (view 1): loading it (the RPC ray casting on
    # the host), rendering it; then its MAE on the card and on the host
    # (GeoTIFFs, numpy registration) from one depth render, held to the JAX
    # package's bound (tests/test_device_eval.py: different rasterisation
    # grids)
    t0 = time.perf_counter()
    sample = td.val_ds.get_val_sample(1)
    load_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    td.render_view(sample)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    depth = td.render_view(sample, depth_only=True)
    t0 = time.perf_counter()
    mae_dev = td.val_mae_device(sample, depth)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mae_host = td._val_mae_host(sample, depth)
    host_s = time.perf_counter() - t0
    # one val chunk (the middle 1024 rays of view 1) through the kernels and
    # through the per-sample module path, without jitter
    mid_v = SCENE_SIZE * SCENE_SIZE // 2
    rays_v = torch.as_tensor(sample["rays"][mid_v:mid_v + td.cfg.chunk], device=dev)
    few_v = satrays_from_tensor(rays_v, torch.zeros(rays_v.shape[0], dtype=torch.long,
                                                     device=dev))
    rcfg_np = dataclasses.replace(td.rcfg_eval, perturb=False)
    with torch.no_grad():
        a = sat.render_rays(td.render_field, few_v, rcfg_np, True)
        b = sat.render_rays(td.field, few_v, rcfg_np, True)
    path_err_v = {"depth_mean_abs": float((a["depth"] - b["depth"]).abs().mean()),
                  "rgb_mean_abs": float((a["rgb"] - b["rgb"]).abs().mean())}
    validate = {"phase": "validate", "views": n_val, "view_pixels": SCENE_SIZE * SCENE_SIZE,
                "chunk": td.cfg.chunk, "chunks_per_view": view_chunks, "seconds": val_s,
                "seconds_per_view": val_s / n_val, "val_loss": logged.get("val/loss"),
                "val_psnr": logged.get("val/psnr"), "val_mae_m": logged.get("val/mae"),
                "best_val_mae_m": td.best_val_mae, "logged_best_mae_m": logged.get("val/best_mae"),
                "failure_tags": sorted(t for t in logged
                                       if t in ("val/mae_failed", "val/device_eval_fallback")),
                "best_checkpoint": sorted(p.name for p in best.glob("*")),
                "launches": launches_v, "expected_launches": expect_v,
                "stream_fwd_kernel_launches": stream_v,
                "view1_load_s": load_s, "view1_render_s": render_s,
                "view1_render_rays_per_s": SCENE_SIZE * SCENE_SIZE / render_s,
                "view1_mae_device_m": mae_dev, "view1_mae_host_m": mae_host,
                "view1_mae_diff_m": abs(mae_dev - mae_host),
                "view1_mae_bound_m": max(0.3 * mae_host, 0.5),
                "view1_device_s": dev_s, "view1_host_s": host_s,
                "chunk_vs_per_sample_path": path_err_v, "tolerance": PATH_TOL, "card": card}
    emit(validate)
    if validate["failure_tags"] or launches_v != expect_v or stream_v != {
            "camera_fwd": n_val_chunks, "shadow_fwd": n_val_chunks, "coarse_fwd": 0}:
        raise AssertionError(f"validation fell back, failed or launched otherwise: {validate}")
    if not (all(math.isfinite(logged.get(t, math.nan))
                for t in ("val/loss", "val/psnr", "val/mae", "val/best_mae"))
            and td.best_val_mae == logged["val/best_mae"]
            and validate["best_checkpoint"] == ["occ_sampling.json", "state.pt"]):
        raise AssertionError(f"validation's metrics or best checkpoint are wrong: {validate}")
    if not (math.isfinite(mae_dev) and validate["view1_mae_diff_m"] <
            validate["view1_mae_bound_m"]):
        raise AssertionError(f"device MAE against host MAE: {validate}")
    if any(path_err_v[k] > PATH_TOL[k] for k in PATH_TOL):
        raise AssertionError(f"val chunk: kernel path vs per-sample path {path_err_v}")
    run_id, eval_logs = td.cfg.exp_name, td.cfg.logs_dir
    del td

    # ---- 13c. eval: the port's eval entry points on that run's latest
    # integer checkpoint (the CLI's default): eval_cli --dsm with the
    # orthographic and the pinhole sweep of 256x256 (16 chunks of 4096 rays,
    # shadows on) and the registered MAE against the scene's 2 m GT, then
    # eval_eonerf's report over the 22 roster views ----
    from eonerf_code_tpu_torch.cli import eval_cli
    from eonerf_code_tpu_torch.eval import dsm as eval_dsm
    from eonerf_code_tpu_torch.eval.run import eval_eonerf, load_checkpoint

    eval_root = log_root / "chip_smoke_eval"
    shutil.rmtree(eval_root, ignore_errors=True)
    _, eval_ckpt, eval_state = load_checkpoint(str(pathlib.Path(eval_logs) / run_id))
    eval_counted = dict(saved_counted, coarse_fwd=fr.coarse_forward)
    sweep_chunks = -(-SCENE_SIZE * SCENE_SIZE // N_CHUNK)
    shifts, dsm_pairs = [], []
    compute_shift = eval_dsm.compute_shift_arrays

    def recorded_shift(*args, **kwargs):
        out = compute_shift(*args, **kwargs)
        shifts.append([int(out[0]), int(out[1])])
        dsm_pairs.append(args[:2])      # phase native searches the first again
        return out

    eval_dsm.compute_shift_arrays = recorded_shift

    def eval_run(fn, n_views):
        """fn() timed, with the wrappers' and the library's launch counts."""
        for f in eval_counted.values():
            f.launches = 0
        stream_before = fr.stream_fwd_kernel_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {n: f.launches for n, f in eval_counted.items()}
        n = n_views * sweep_chunks
        expect = {k: n if k in ("camera_fwd", "shadow_fwd") else 0 for k in launches}
        return out, secs, launches, expect, stream_launches_since(stream_before)

    cli_args = [run_id, "--logs_dir", eval_logs, "--output_dir", str(eval_root), "--dsm",
                "--dsm_resolution", str(SyntheticSceneSpec().dsm_resolution)]
    eval_res = {}
    for name, extra in (("ortho", []), ("pinhole", ["--pinhole"])):
        out, secs, launches_e, expect_e, stream_e = eval_run(
            lambda extra=extra: eval_cli(cli_args + extra), 1)
        eval_res[name] = {"seconds": secs, "mae_m": out["mae"], "shift": shifts[-1],
                          "dsm_path": out["dsm_path"], "rdsm_path": out["rdsm_path"],
                          "dsm_exists": pathlib.Path(out["dsm_path"]).exists(),
                          "launches": launches_e, "expected_launches": expect_e,
                          "stream_fwd_kernel_launches": stream_e}
        # the pinhole sweep writes the same files: keep the orthographic ones
        shutil.move(str(eval_root / run_id), str(eval_root / f"{run_id}_{name}"))
    eval_dsm.compute_shift_arrays = compute_shift
    n_roster = SCENE_VIEWS + SyntheticSceneSpec().n_test_views
    report, secs, launches_r, expect_r, stream_r = eval_run(
        lambda: eval_eonerf(run_id, eval_logs, str(eval_root), device="cuda"), n_roster)
    written = sorted(str(p.relative_to(eval_root)) for p in eval_root.rglob("*.tif"))
    eval_res["report"] = {"views": len(report), "seconds": secs, "seconds_per_view": secs / n_roster,
                          "mean_loss": float(np.mean([r["loss"] for r in report])),
                          "mean_psnr": float(np.mean([r["psnr"] for r in report])),
                          "launches": launches_r, "expected_launches": expect_r,
                          "stream_fwd_kernel_launches": stream_r}
    for name in ("camera_fwd", "shadow_fwd"):
        kernel_rows[name]["launches_by_path"]["eval"] = {
            "ortho": eval_res["ortho"]["stream_fwd_kernel_launches"][name],
            "pinhole": eval_res["pinhole"]["stream_fwd_kernel_launches"][name],
            "report": stream_r[name]}
    emit({"phase": "eval", "run": run_id, "checkpoint": pathlib.Path(eval_ckpt).name,
          "checkpoint_step": int(eval_state["step"]), "chunk": N_CHUNK,
          "sweep_chunks": sweep_chunks, **eval_res, "tifs_written": len(written),
          "tifs_written_first": written[:8], "card": card})
    for name, res in eval_res.items():
        n = (n_roster if name == "report" else 1) * sweep_chunks
        if not (res["launches"] == res["expected_launches"] and res["stream_fwd_kernel_launches"]
                == {"camera_fwd": n, "shadow_fwd": n, "coarse_fwd": 0}):
            raise AssertionError(f"eval {name} launched otherwise: {res}")
    for name in ("ortho", "pinhole"):
        if not (math.isfinite(eval_res[name]["mae_m"]) and eval_res[name]["dsm_exists"]):
            raise AssertionError(f"eval {name}: no finite MAE or no DSM: {eval_res[name]}")
    if not (len(report) == n_roster and all(math.isfinite(r["loss"]) and math.isfinite(r["psnr"])
                                            for r in report)):
        raise AssertionError(f"eval report: {report}")

    # ---- 14. variants: the kernel-variant bench (the TPU research kernels'
    # counterparts) through its two entry points at the TPU script's
    # defaults, each variant's kernel against its plain version, and the
    # slab chains against the same chain as library calls ----
    from eonerf_code_tpu_torch.bench import composite as kv_composite
    from eonerf_code_tpu_torch.bench import kernel_variants as kv_bench
    from eonerf_code_tpu_torch.bench import variants as vr

    vr.reset_launches()
    t0 = time.perf_counter()
    bench_ms = kv_bench.main(VARIANT_N, VARIANT_TILE, VARIANT_ITERS, ",".join(vr.VARIANTS),
                             device="cuda")
    bench_ms.update(kv_composite.main("all", VARIANT_N, VARIANT_TILE, VARIANT_ITERS,
                                      device="cuda"))
    bench_s = time.perf_counter() - t0
    launches_v = dict(vr.LAUNCHES)
    unlaunched = {v: c for v, c in launches_v.items() if c != VARIANT_ITERS + 1}
    if unlaunched:
        raise AssertionError(f"bench variants launched other than warm-up + iters: {unlaunched}")
    kw_v, sw_v, pos_v, emb_v, acts_v = kv_bench.bench_inputs(VARIANT_N, dev)
    _, pos_c, sd_c = kv_composite.composite_inputs(VARIANT_N, dev)
    gen_v = torch.Generator(device=dev).manual_seed(2)
    n_v = VARIANT_N
    variant_rows = []
    for v in vr.VARIANTS + vr.COMPOSITES:
        if v in vr.COMPOSITES:
            args = (v, kw_v, pos_c, sd_c, VARIANT_TILE)
            kern = functools.partial(vr.run_composite, *args)
            plain = functools.partial(vr.composite_reference, *args)
        else:
            args = (v, kw_v, sw_v, pos_v, emb_v, acts_v, VARIANT_TILE)
            kern, plain = functools.partial(vr.run, *args), functools.partial(vr.reference, *args)
        if v == "mm_bwd_rec":
            # held against the plain backward on the kernel's own recomputed
            # activations (the stream of the same ReLU-chain kernel), then
            # against the all-plain one, whose recompute may put a ReLU mask
            # on the other side of a kink in a few of the 508 seeded tiles,
            # each weighing as its 2048 identical rows
            got = kern()
            own = vr.run("mm_fwd_save", kw_v, sw_v, pos_v, tile=VARIANT_TILE)[1]
            res = vr.check(v, got, vr.slab_bwd_reference(
                sw_v.w1.t(), pos_v, VARIANT_TILE, own))
            del own
            res["rel_l2_all_plain"] = vr.check(v, got, plain())["rel_l2"]
            res["ok"] &= res["rel_l2_all_plain"] <= vr.REC_ALL_PLAIN_REL_L2
            del got
        else:
            res = vr.check(v, kern(), plain())
        torch.cuda.empty_cache()
        if v in ("reshape", "colscan", "accmm"):
            sigma = vr.run_composite("base", kw_v, pos_c, sd_c, VARIANT_TILE)[:, 0]
            res["epilogue_rel_l2"] = vr.rel_l2(kern(), vr.composite_epilogue(v, sigma, sd_c))
            res["ok"] = res["ok"] and res["epilogue_rel_l2"] <= vr.EPILOGUE_REL_L2
        if v in ("mm_i8", "mm_i8_k512"):
            # the seeded chain is int8(pos) = 0 throughout; time it from a
            # random int8 h0 as well, and hold that against the plain version
            width = 2 * 256 if v == "mm_i8_k512" else 256
            h0 = torch.randint(-127, 128, (n_v, width), generator=gen_v, device=dev).to(
                torch.int8)
            res["random_h0_equal"] = bool(torch.equal(
                vr.run(v, kw_v, sw_v, pos_v, tile=VARIANT_TILE, h0=h0),
                vr.reference(v, kw_v, sw_v, pos_v, tile=VARIANT_TILE, h0=h0)))
            res["ms_random_h0"] = time_ms(
                torch, lambda v=v, h0=h0: vr.run(v, kw_v, sw_v, pos_v, tile=VARIANT_TILE, h0=h0),
                VARIANT_ITERS)
            res["ok"] = res["ok"] and res["random_h0_equal"]
        if v == "mm_bwd_saved":
            # its passes one by one beside their library chains: the
            # cotangent chain on dgemm (slab_dgrad: 8 products g @ W^T) and
            # the weight gradients (slab_wgrad: 8 products A^T G)
            res["pass_ms"] = kv_bench.slab_split_ms(sw_v, pos_v, acts_v, VARIANT_TILE,
                                                    VARIANT_ITERS)
        plain_ms = time_ms(torch, plain, 2)
        lib = vr.library_chain(v, sw_v, pos_v, acts_v, VARIANT_TILE)
        library_ms = time_ms(torch, lib, VARIANT_ITERS) if callable(lib) else None
        bound, bound_by = vr.bound_ms(v, n_v)
        ms = bench_ms[v]
        top, unit = vr.peak(v)
        # beside the baseline of its own design: their difference is the
        # one cost the variant takes out or adds
        base_v = vr.BASELINE_OF.get(v)
        baseline = {} if base_v is None else {
            "baseline": base_v, "baseline_ms": bench_ms[base_v],
            "minus_baseline_ms": ms - bench_ms[base_v]}
        emit({"phase": "variants", "name": v, **baseline, "n": n_v, "tile": VARIANT_TILE,
              "ms": ms,
              "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
              "share_of_bound": bound / ms, "rate": vr.flops(v, n_v) / (ms * 1e-3) / 1e12,
              "unit": unit, "share_of_peak": vr.flops(v, n_v) / (ms * 1e-3) / top,
              "library_ms": library_ms, **({} if callable(lib) else {"library": lib}),
              "cuda_launches_per_call": vr.CUDA_LAUNCHES[v], **res, "card": card})
        if not res["ok"]:
            raise AssertionError(f"variant {v}: kernel disagrees with its plain version: {res}")
        script = "proto_composite.py" if v in vr.COMPOSITES else "bench_kernel_variants.py"
        own = v not in ("full", "trunk", "base")
        kernel_rows[("composite_" if v in vr.COMPOSITES else "variant_") + v] = {
            "name": ("composite_" if v in vr.COMPOSITES else "variant_") + v, "route": "cuda",
            "source": "eonerf_code_tpu_torch/csrc/"
                      + ("kernel_variants.cu" if own else "fused_render.cu"),
            "replaces": tpu_kernel_site(f"kernel_{vr.TPU_BODY.get(v, v)}", script),
            "launches": launches_v[v],
            "max_abs_err": res["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms}
        variant_rows.append(v)
        torch.cuda.empty_cache()
    saved_ms = bench_ms["mm_fwd_save"] + bench_ms["mm_bwd_saved"]
    rec_ms = bench_ms["mm_only"] + bench_ms["mm_bwd_rec"]
    emit({"phase": "variants_decision", "rule": "t(mm_fwd_save) + t(mm_bwd_saved) against "
          "t(mm_only) + t(mm_bwd_rec)", "saved_ms": saved_ms, "recompute_ms": rec_ms,
          "decision": "save" if saved_ms < rec_ms else "recompute", "bench_seconds": bench_s,
          "card": card})

    # ---- 15. quality and 16. bundle_adjust: trained runs on the synthetic
    # scene (the functions above) ----
    quality_phase(torch, dev, card, log_root, kernel_rows)
    bundle_adjust_phase(torch, dev, card, log_root, kernel_rows)

    # ---- 17. data_parallel: the functions above ----
    data_parallel_phase(torch, dev, card, log_root, cli_args, eval_res["ortho"], info)

    # ---- 18. multi_aoi: the functions above ----
    multi_aoi_phase(torch, dev, card, log_root, info, kernel_rows)
    shutil.rmtree(scene_root, ignore_errors=True)

    # ---- 19. vanilla: the function above ----
    vanilla_phase(torch, dev, card, log_root)

    # ---- 20. native and 21. production: the functions above ----
    prod_info = native_phase(card, log_root, dsm_pairs[0])
    production_phase(torch, dev, card, log_root, prod_info, kernel_rows)
    shutil.rmtree(log_root / "chip_smoke_production", ignore_errors=True)

    emit({"kernels": [kernel_rows[n] for n in (
        "camera_fwd", "shadow_fwd", "camera_bwd", "shadow_bwd", "coarse_fwd", "density_fwd",
        "field_fwd", "field_bwd", "density_bwd", "camera_fwd_q8", "shadow_fwd_q8",
        "coarse_fwd_q8", "camera_bwd_q8", "shadow_bwd_q8", "camera_bwd_q8_full",
        "shadow_bwd_q8_full", "q8_chain_cluster", "q8_wgrad", "camera_fwd_save",
        "camera_bwd_saved", "shadow_fwd_save", "shadow_bwd_saved")] + [kernel_rows[("composite_" if v in vr.COMPOSITES else "variant_")
                                            + v] for v in variant_rows]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
