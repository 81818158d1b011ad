"""Build and load the package's CUDA kernels and its native host library.

``nvcc`` compiles each CUDA source for sm_90a into a shared library with a
plain C interface, on first use, into ``_build/`` beside the package sources
(git-ignored): ``csrc/fused_render.cu`` (the fused render kernels, forward
and backward, with and without the saved activations, the coarse-weights
kernel, the per-point field and density kernels, forward and backward, and
the int8 trunk tier's kernels) and ``csrc/kernel_variants.cu`` (the
kernel-variant bench). Both include ``csrc/tile_common.cuh``. ``g++``
compiles the C++ source ``csrc/geo_native.cpp`` (the host library of
``native/``: RPC localization and projection, the NCC search) the same way,
with the JAX build's flags (:data:`GXX_FLAGS`). The file name carries a
hash of the source, every CUDA header beside it (for a ``.cu``) and the
flags, so an edit rebuilds and an unchanged tree is reused; the library is
written to a temporary name and moved into place, so a concurrent builder
never loads half a file. ``ctypes`` loads it. Nothing here runs at import
time: the CPU tests import every module of the package on a machine
without ``nvcc``.
"""

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "fused_render.cu"
VARIANTS_SOURCE = PACKAGE_DIR / "csrc" / "kernel_variants.cu"
NATIVE_SOURCE = PACKAGE_DIR / "csrc" / "geo_native.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's native build, exactly: no -march=native (FMA contraction
# would move the polynomial sums off the numpy path's bits)
GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


def gxx_path():
    return shutil.which("g++") or "g++"


def _recipe(source):
    """(compiler, flags, the headers hashed with the source) by suffix."""
    if source.suffix == ".cpp":
        return gxx_path(), GXX_FLAGS, []
    return nvcc_path(), NVCC_FLAGS, sorted(source.parent.glob("*.cuh"))


def build(source=None):
    """Compile ``source`` (by default :data:`SOURCE` as it is bound when
    called; a ``.cu`` with nvcc, a ``.cpp`` with g++) unless an up-to-date
    library exists. Returns (library path, compiler log: for nvcc the ptxas
    register/spill report; empty when the library was reused). Raises
    RuntimeError with the compiler's output when it fails or is missing."""
    source = Path(source or SOURCE)
    compiler, flags, headers = _recipe(source)
    h = hashlib.sha256(source.read_bytes())
    for header in headers:
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()
    out = BUILD_DIR / f"{source.stem}-{digest[:16]}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([compiler, *flags, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler} could not run on {source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed with code {proc.returncode} on "
                           f"{source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent builder never loads half a file
    return out, proc.stdout + proc.stderr


def build_all():
    """Both libraries, their two nvcc runs started together. Returns
    {source stem: (library path, compiler log)}."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        done = {src.stem: pool.submit(build, src) for src in (SOURCE, VARIANTS_SOURCE)}
        return {stem: f.result() for stem, f in done.items()}


@functools.cache
def load_library():
    """Build (if needed) and load the fused-render library from
    :data:`SOURCE`, with every C entry point's argument and result types
    declared."""
    path, _ = build(SOURCE)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eonerf_weight_layout.argtypes = [p]
    lib.eonerf_weight_layout.restype = None
    # the plain and per-point forwards end with their workspace, which a
    # build of an older tree (bench/ab_libraries.py) ignores
    lib.eonerf_camera_fwd.argtypes = [p, p, p, p, p, p, i, i, p, p]
    lib.eonerf_camera_fwd.restype = i
    lib.eonerf_shadow_fwd.argtypes = [p, p, p, p, p, p, p, i, i, p, p]
    lib.eonerf_shadow_fwd.restype = i
    lib.eonerf_coarse_fwd.argtypes = [p, p, p, p, p, p, i, i, p, p]
    lib.eonerf_coarse_fwd.restype = i
    lib.eonerf_density_fwd.argtypes = [p, p, p, p, i, p, p]
    lib.eonerf_density_fwd.restype = i
    lib.eonerf_field_fwd.argtypes = [p, p, p, p, p, i, p, p]
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
    # the save forwards end with their workspace too (an older build ignores it)
    lib.eonerf_camera_fwd_save.argtypes = [p] * 7 + [i, i, p, p]
    lib.eonerf_camera_fwd_save.restype = i
    lib.eonerf_shadow_fwd_save.argtypes = [p] * 8 + [i, i, p, p]
    lib.eonerf_shadow_fwd_save.restype = i
    lib.eonerf_saved_bwd_workspace_bytes.argtypes = [i, i, i]
    lib.eonerf_saved_bwd_workspace_bytes.restype = ll
    lib.eonerf_camera_bwd_saved.argtypes = [p] * 11 + [i, i, p]
    lib.eonerf_camera_bwd_saved.restype = i
    lib.eonerf_shadow_bwd_saved.argtypes = [p] * 12 + [i, i, p]
    lib.eonerf_shadow_bwd_saved.restype = i
    # the int8 entries end with the trunk's path (-1: the shape's), which a
    # build of an older tree (bench/ab_libraries.py) ignores
    lib.eonerf_q8_fwd_workspace_bytes.argtypes = [i, i, i, ll, i]
    lib.eonerf_q8_fwd_workspace_bytes.restype = ll
    lib.eonerf_q8_fwd.argtypes = [i] + [p] * 11 + [i, i, ll, p, i]
    lib.eonerf_q8_fwd.restype = i
    lib.eonerf_q8_bwd_workspace_bytes.argtypes = [i, i, i, i, ll, i]
    lib.eonerf_q8_bwd_workspace_bytes.restype = ll
    lib.eonerf_q8_bwd.argtypes = [i, i] + [p] * 16 + [i, i, ll, p, i]
    lib.eonerf_q8_bwd.restype = i
    # the measurement and test entries, which a build of an older tree
    # (bench/ab_libraries.py) may lack
    for name, args, res in (("eonerf_bwd_pass", [i, i] + [p] * 12 + [i, i, p], i),
                            ("eonerf_bwd_stream_layout", [i, i, i, i, p], None),
                            ("eonerf_wgrad_partial_bytes", [i, ll], ll),
                            ("eonerf_wgrad", [i, i, p, p, ll, p, p, p], i),
                            ("eonerf_q8_trunk_path", [i, ll], i),
                            ("eonerf_dgrad_launches", [p], None),
                            ("eonerf_dgrad_plan", [i, i, p], None),
                            ("eonerf_q8_trunk_active_clusters", [i], i),
                            ("eonerf_q8_trunk_launches", [p], None),
                            ("eonerf_q8_trunk_workspace_bytes", [i, i, ll, i], ll),
                            ("eonerf_q8_trunk", [i, p, p, p, ll, i, p, p, p, p, p, i, i, ll, p],
                             i),
                            ("eonerf_q8_bwd_pass", [i, i] + [p] * 16 + [i, i, ll, p, i], i),
                            ("eonerf_q8_bwd_layout", [i, i, i, ll, i, p], None),
                            ("eonerf_q8_bwd_plan", [i, ll, p], None),
                            ("eonerf_q8_chain_active_clusters", [i], i),
                            ("eonerf_q8_bwd_launches", [p], None),
                            ("eonerf_stream_fwd_workspace_bytes", [i, i, i], ll),
                            ("eonerf_stream_fwd_layout", [i, i, i, p], None),
                            ("eonerf_stream_fwd_grid", [], i),
                            ("eonerf_stream_fwd_plan", [i, p, p, i, i, p, p], i),
                            ("eonerf_stream_fwd_launches", [p], None),
                            ("eonerf_point_fwd_workspace_bytes", [i, i], ll),
                            ("eonerf_point_fwd_blocks", [i], i),
                            ("eonerf_point_fwd_launches", [p], None),
                            ("eonerf_save_fwd_workspace_bytes", [i, i, i], ll),
                            ("eonerf_save_fwd_blocks", [i], i),
                            ("eonerf_save_fwd_launches", [p], None)):
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
    lib.eonerf_error_string.argtypes = [i]
    lib.eonerf_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_variants_library():
    """Build (if needed) and load the kernel-variant bench's library, with
    every C entry point's argument and result types declared."""
    path, _ = build(VARIANTS_SOURCE)
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kv_bf16_chain.argtypes = [i, p, p, p, i, p, p, ll, ll, p]
    lib.kv_q_chain.argtypes = [i, i, p, p, p, p, i, p, ll, ll, p]
    lib.kv_dyn_workspace_bytes.argtypes = [ll]
    lib.kv_dyn_workspace_bytes.restype = ll
    lib.kv_i8_dyn.argtypes = [p] * 6 + [ll, ll, ll, p]
    lib.kv_slab_bwd_workspace_bytes.argtypes = [i, ll]
    lib.kv_slab_bwd_workspace_bytes.restype = ll
    lib.kv_slab_bwd.argtypes = [p] * 7 + [ll, ll, p]
    lib.kv_slab_bwd_pass.argtypes = [i] + [p] * 7 + [ll, ll, p]
    lib.kv_trunk_variant.argtypes = [i, p, p, p, p, ll, p]
    lib.kv_composite.argtypes = [i, p, p, p, p, p, ll, p]
    lib.kv_l2_read.argtypes = [i, p, ll, i, i, p, p]
    for name in ("kv_bf16_chain", "kv_q_chain", "kv_i8_dyn", "kv_slab_bwd", "kv_slab_bwd_pass",
                 "kv_trunk_variant", "kv_composite", "kv_l2_read"):
        getattr(lib, name).restype = i
    lib.kv_error_string.argtypes = [i]
    lib.kv_error_string.restype = ctypes.c_char_p
    return lib


def kernel_weight_layout():
    """(mat elements, bias elements, density-prefix mat elements,
    density-prefix bias elements) as the compiled kernels index them."""
    sizes = (ctypes.c_longlong * 4)()
    load_library().eonerf_weight_layout(ctypes.cast(sizes, ctypes.c_void_p))
    return tuple(sizes)


def check(code, what, error_string=None):
    """Raise if a C entry point returned a CUDA error (its message from
    ``error_string``, by default the fused-render library's)."""
    if code != 0:
        msg = (error_string or load_library().eonerf_error_string)(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
