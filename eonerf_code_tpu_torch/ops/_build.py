"""Build and load the package's CUDA kernels.

``nvcc`` compiles ``csrc/fused_render.cu`` (the fused render kernels,
forward and backward, with and without the saved activations, the
coarse-weights kernel, the per-point field
and density kernels, forward and backward, and the int8 trunk tier's
kernels) for sm_90a into a shared library
with a plain C interface, on first use, into ``_build/`` beside the package
sources (git-ignored); the file name carries a hash of the source and the
flags, so an edit rebuilds and an unchanged source is reused. ``ctypes``
loads it. Nothing here runs at import time: the CPU tests import every
module of the package on a machine without ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "fused_render.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def build(source=SOURCE):
    """Compile ``source`` unless an up-to-date library exists. Returns
    (library path, compiler log: ptxas register/spill report, empty when
    the library was reused). Raises RuntimeError when nvcc fails."""
    source = Path(source)
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with code {proc.returncode} on {source}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent builder never loads half a file
    return out, proc.stdout + proc.stderr


@functools.cache
def load_library():
    """Build (if needed) and load the fused-render library, with every C
    entry point's argument and result types declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eonerf_weight_layout.argtypes = [p]
    lib.eonerf_weight_layout.restype = None
    lib.eonerf_camera_fwd.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.eonerf_camera_fwd.restype = i
    lib.eonerf_shadow_fwd.argtypes = [p, p, p, p, p, p, p, i, i, p]
    lib.eonerf_shadow_fwd.restype = i
    lib.eonerf_coarse_fwd.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.eonerf_coarse_fwd.restype = i
    lib.eonerf_density_fwd.argtypes = [p, p, p, p, i, p]
    lib.eonerf_density_fwd.restype = i
    lib.eonerf_field_fwd.argtypes = [p, p, p, p, p, i, p]
    lib.eonerf_field_fwd.restype = i
    lib.eonerf_bwd_workspace_bytes.argtypes = [i, i, i]
    lib.eonerf_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.eonerf_camera_bwd.argtypes = [p] * 10 + [i, i, p]
    lib.eonerf_camera_bwd.restype = i
    lib.eonerf_shadow_bwd.argtypes = [p] * 11 + [i, i, p]
    lib.eonerf_shadow_bwd.restype = i
    lib.eonerf_point_bwd_workspace_bytes.argtypes = [i, i]
    lib.eonerf_point_bwd_workspace_bytes.restype = ctypes.c_longlong
    lib.eonerf_field_bwd.argtypes = [p] * 10 + [i, p]
    lib.eonerf_field_bwd.restype = i
    lib.eonerf_density_bwd.argtypes = [p] * 8 + [i, p]
    lib.eonerf_density_bwd.restype = i
    ll = ctypes.c_longlong
    lib.eonerf_act_stream_cols.argtypes = [i]
    lib.eonerf_act_stream_cols.restype = ll
    lib.eonerf_camera_fwd_save.argtypes = [p] * 7 + [i, i, p]
    lib.eonerf_camera_fwd_save.restype = i
    lib.eonerf_shadow_fwd_save.argtypes = [p] * 8 + [i, i, p]
    lib.eonerf_shadow_fwd_save.restype = i
    lib.eonerf_saved_bwd_workspace_bytes.argtypes = [i, i, i]
    lib.eonerf_saved_bwd_workspace_bytes.restype = ll
    lib.eonerf_camera_bwd_saved.argtypes = [p] * 11 + [i, i, p]
    lib.eonerf_camera_bwd_saved.restype = i
    lib.eonerf_shadow_bwd_saved.argtypes = [p] * 12 + [i, i, p]
    lib.eonerf_shadow_bwd_saved.restype = i
    lib.eonerf_q8_fwd_workspace_bytes.argtypes = [i, i, i]
    lib.eonerf_q8_fwd_workspace_bytes.restype = ll
    lib.eonerf_q8_fwd.argtypes = [i] + [p] * 11 + [i, i, ll, p]
    lib.eonerf_q8_fwd.restype = i
    lib.eonerf_q8_bwd_workspace_bytes.argtypes = [i, i, i, i, ll]
    lib.eonerf_q8_bwd_workspace_bytes.restype = ll
    lib.eonerf_q8_bwd.argtypes = [i, i] + [p] * 16 + [i, i, ll, p]
    lib.eonerf_q8_bwd.restype = i
    lib.eonerf_error_string.argtypes = [i]
    lib.eonerf_error_string.restype = ctypes.c_char_p
    return lib


def kernel_weight_layout():
    """(mat elements, bias elements, density-prefix mat elements,
    density-prefix bias elements) as the compiled kernels index them."""
    sizes = (ctypes.c_longlong * 4)()
    load_library().eonerf_weight_layout(ctypes.cast(sizes, ctypes.c_void_p))
    return tuple(sizes)


def check(code, what):
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().eonerf_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
