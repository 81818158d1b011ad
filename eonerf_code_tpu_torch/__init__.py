"""eonerf_code_tpu_torch — the EO-NeRF render-and-DSM path and the
single-AOI training step in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

The package mirrors the layout of the JAX package that sits beside it in
this repository (which stays the numerical reference) and imports nothing
from it: what it needs from that package's JAX-free modules is copied here.

Subpackages
-----------
models    the EO-NeRF field (``nn.Module``) and the kernel-backed field
interop   the weight bridge from the JAX package's flax parameter tree
ops       sampling, volume rendering, the fused render kernels (forward
          and backward, as autograd Functions), raster
csrc      the CUDA sources of the fused kernels
data      the (N, 11) satellite ray tensor view, a synthetic ray pool
render    the satellite renderer and the nadir virtual camera
eval      device-side DSM registration and altitude MAE
train     the single-AOI trainer, its checkpoints, a step profiler
utils     the losses and metrics, the metrics logger
config    TrainConfig

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
