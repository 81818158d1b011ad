"""``TrainConfig.use_pallas`` in the port against the JAX package: the
render backend ``make_render_field`` picks for None, True and False (the
JAX ``PallasField`` where the port takes ``KernelField``), the shapes and
types that ``use_pallas=True`` refuses rather than falling back, a JAX
``opts.json`` with ``use_pallas=false`` reloaded by the port, and the CLI
flag. The card is stood in for by patching the device the field reports,
as tests/test_torch_trunk_quant.py does."""

import pytest
import torch

from eonerf_code_tpu import cli as jcli
from eonerf_code_tpu.config import TrainConfig as JaxConfig
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.fused import PallasField
from eonerf_code_tpu.models.fused import make_render_field as jax_make_render_field
from eonerf_code_tpu_torch import cli as tcli
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
from eonerf_code_tpu_torch.models import fused as fused_models
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
from eonerf_code_tpu_torch.train import loop as tloop


def _field(depth=8, width=256, dtype=torch.bfloat16):
    return EONerfField(3, net_depth=depth, net_width=width, compute_dtype=dtype, device="cpu")


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_backend_matches_jax_on_the_cpu(use_pallas):
    """On the CPU: None takes the field itself (the JAX auto rule wants a
    TPU, the port's a CUDA device), True the kernel-backed field, False the
    field itself, in both packages."""
    import jax.numpy as jnp

    jf = JaxField(n_images=3, compute_dtype=jnp.bfloat16)
    jgot = jax_make_render_field(jf, JaxConfig(compute_dtype="bfloat16", use_pallas=use_pallas))
    field = _field()
    got = make_render_field(field, TrainConfig(compute_dtype="bfloat16", use_pallas=use_pallas))
    assert isinstance(jgot, PallasField) == isinstance(got, KernelField) == bool(use_pallas)
    if not use_pallas:
        assert got is field


@pytest.mark.parametrize("use_pallas,kernels", [(None, True), (True, True), (False, False)])
def test_backend_on_the_card(monkeypatch, use_pallas, kernels):
    """On a CUDA device a bfloat16 8x256 field takes the kernels unless
    use_pallas is False, which keeps the per-sample path there too; the
    saved-activations and int8 settings ride along."""
    monkeypatch.setattr(fused_models, "_device_of", lambda f: torch.device("cuda"))
    field = _field()
    got = make_render_field(field, TrainConfig(use_pallas=use_pallas))
    assert isinstance(got, KernelField) == kernels
    if kernels:
        assert got.save_acts and got.trunk_quant is False
        q8 = make_render_field(field, TrainConfig(use_pallas=use_pallas, trunk_quant="int8_full",
                                                  bwd_acts="recompute"))
        assert q8.trunk_quant == "full" and not q8.save_acts
    else:
        assert got is field
    # the auto rule keeps float32 and other widths on the per-sample path
    assert not isinstance(make_render_field(_field(dtype=torch.float32), TrainConfig()),
                          KernelField)
    assert not isinstance(make_render_field(_field(2, 32), TrainConfig()), KernelField)


def test_use_pallas_true_refuses_what_the_kernels_do_not_take(monkeypatch):
    """No silent fallback: another trunk shape raises, on the CPU and on
    the card; on the card a dtype other than bfloat16 raises; on the CPU
    the plain versions take float32 too."""
    with pytest.raises(ValueError, match="2x32"):
        make_render_field(_field(2, 32), TrainConfig(use_pallas=True))
    with pytest.raises(ValueError, match="8x128"):
        make_render_field(_field(8, 128), TrainConfig(use_pallas=True))
    assert isinstance(make_render_field(_field(dtype=torch.float32),
                                        TrainConfig(use_pallas=True)), KernelField)
    monkeypatch.setattr(fused_models, "_device_of", lambda f: torch.device("cuda"))
    with pytest.raises(ValueError, match="float32"):
        make_render_field(_field(dtype=torch.float32), TrainConfig(use_pallas=True))
    with pytest.raises(ValueError, match="2x32"):
        make_render_field(_field(2, 32, torch.float32), TrainConfig(use_pallas=True))


@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_jax_opts_json_keeps_use_pallas(tmp_path, monkeypatch, use_pallas):
    """A JAX run's opts.json reloads with its use_pallas: a run that the
    JAX package rendered on its per-sample path (false) keeps it in the
    port, on the card too."""
    path = str(tmp_path / "opts.json")
    JaxConfig(compute_dtype="bfloat16", use_pallas=use_pallas).save(path)
    cfg = TrainConfig.load(path)
    assert cfg.use_pallas is use_pallas
    monkeypatch.setattr(fused_models, "_device_of", lambda f: torch.device("cuda"))
    got = make_render_field(_field(), cfg)
    assert isinstance(got, KernelField) == (use_pallas is not False)


@pytest.mark.parametrize("flag,value", [([], None), (["--use_pallas", "true"], True),
                                        (["--use_pallas", "false"], False),
                                        (["--use_pallas", "False"], False)])
def test_cli_flag_sets_use_pallas(flag, value):
    args = ["--root_dir", "/r", *flag]
    assert tcli.config_from_args(args).use_pallas is value
    assert jcli.config_from_args(args).use_pallas is value


def test_trainer_takes_the_backend_asked_for(tmp_path):
    """Trainer(cfg) on the CPU: use_pallas=True trains through the
    kernel-backed field's plain ops, and a trunk the kernels do not take
    raises before any step."""
    pool = synthetic_ray_pool(256, 2, "cpu")
    base = dict(logs_dir=str(tmp_path), sampler="uniform", occ_enabled=False, n_samples=8,
                sc_n_samples=8, batch_size=32, bwd_acts="recompute")
    tr = tloop.Trainer(TrainConfig(exp_name="k", use_pallas=True, **base), pool, 2, device="cpu")
    assert isinstance(tr.render_field, KernelField)
    stats = tr.run(max_steps=1)
    assert stats["steps"] == 1
    with pytest.raises(ValueError, match="2x32"):
        tloop.Trainer(TrainConfig(exp_name="s", use_pallas=True, net_depth=2, net_width=32,
                                  **base), pool, 2, device="cpu")
    tr = tloop.Trainer(TrainConfig(exp_name="f", use_pallas=False, **base), pool, 2, device="cpu")
    assert tr.render_field is tr.field
