"""The PyTorch port stands alone: importing every module of it pulls in
neither JAX nor the JAX package, and no source of it (nor chip_smoke.py,
nor the multi-AOI and vanilla entry points) names the JAX package."""

import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "eonerf_code_tpu_torch"
JAX_PACKAGE = re.compile(r"eonerf_code_tpu(?!_torch)")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import eonerf_code_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "orbax"))
             or m == "eonerf_code_tpu" or m.startswith("eonerf_code_tpu."))
print(len(names), bad)
"""


def test_importing_the_port_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.split(" ", 1)
    assert int(n_modules) >= 30
    assert bad.strip() == "[]", bad


def test_port_sources_never_name_the_jax_package():
    files = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".cpp")]
    files += [REPO / "chip_smoke.py", REPO / "train_multi_aoi_torch.py",
              REPO / "train_mlp_nerf_torch.py"]
    assert len(files) >= 80
    hits = [f"{p.relative_to(REPO)}:{i}" for p in files
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if JAX_PACKAGE.search(line)]
    assert hits == []
