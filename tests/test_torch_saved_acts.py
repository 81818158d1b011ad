"""The saved-activations mode of the port's camera and shadow ops (the JAX
package's default ``bwd_acts="saved"``): the plain saved VJPs against the
recompute ones and against ``jax.vjp`` of the Pallas ops with
``save_acts=True`` (interpret mode, float32), the gate
(``KernelField.step_save_ok`` against ``PallasField.step_save_ok``, the
per-call cap, no stream without a gradient), the int8 fallback, and a
default ``TrainConfig()`` stepping the trainer on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.fused import PallasField
from eonerf_code_tpu.ops.pallas.fused_field import flatten_weights as jax_flatten
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu.ops.pallas.fused_render import make_fused_camera, make_fused_shadow
from eonerf_code_tpu.ops.pallas.fused_render import saved_stream_bytes as jax_stream_bytes
from eonerf_code_tpu.ops.sampling import set_last_valid as jax_set_last_valid
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.synthetic_pool import synthetic_ray_pool
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models import fused as fused_models
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.ops.fused_field import flatten_weights, pack_params, unpad_pe_rows
from eonerf_code_tpu_torch.train import loop as tloop

# the JAX package's pin of the saved mode against the recompute mode
# (tests/test_fused_render.py::TestSavedActs)
SAVED_TOL = dict(rtol=1e-6, atol=1e-7)
# the recompute mode's pins against the Pallas kernels
# (tests/test_torch_fused_render_bwd.py, from tests/test_fused_render.py)
WEIGHT_TOL = dict(rtol=1e-3, atol=1e-5)
CAM_ORIGIN_TOL = dict(rtol=1e-3, atol=1e-4)
SHADOW_ORIGIN_TOL = dict(rtol=1e-3, atol=1e-5)
EMB_TOL = dict(rtol=1e-3, atol=1e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    """8x256 field (flax params and the port's copy), R=10 rays of K=21
    samples, ray 4 with no valid sample, a random cotangent per op."""
    rng = np.random.default_rng(11)
    jf = JaxField(n_images=5)
    params = jf.init(jax.random.PRNGKey(1), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(5, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    r, k = 10, 21
    o = rng.uniform(-0.5, 0.5, (r, 3)).astype(np.float32)
    o[:, 2] = 0.95
    d = np.tile(np.array([0.02, 0.03, -1.0], np.float32), (r, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)).astype(np.float32), axis=1)
    delta = np.diff(z, axis=1, append=2.2).astype(np.float32)
    mask = rng.random((r, k)) > 0.2
    mask[4] = False
    idx = rng.integers(0, 5, r)
    emb = np.asarray(params["params"]["transient_encoder"]["embedding"])[idx]
    rayin = np.hstack([o, d, emb, np.zeros((r, 6), np.float32)]).astype(np.float32)
    deltam_cam = (np.asarray(jax_set_last_valid(jnp.asarray(delta), jnp.asarray(mask), 1e10))
                  * mask).astype(np.float32)
    with torch.no_grad():
        kw = ff.pack_kernel_weights(pack_params(tf), torch.float32)
    return dict(params=params, tf=tf, kw=kw, rayin=rayin, z=z, mask=mask, idx=idx,
                deltam_cam=deltam_cam, deltam_sh=(delta * mask).astype(np.float32),
                gacc=rng.normal(size=(r, fr.ACC_COLS)).astype(np.float32),
                ggeo=rng.normal(size=(r,)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(s, op):
    """The op's inputs after the weights, and its cotangent (torch)."""
    if op == "camera":
        return (_t(s["rayin"]), _t(s["z"]), _t(s["deltam_cam"])), _t(s["gacc"])
    return ((_t(s["rayin"]), _t(s["z"]), _t(s["deltam_sh"]),
             _t(s["mask"].astype(np.float32))), _t(s["ggeo"]))


def _plain_pair(op, kw, args, g):
    """(forward output, saved activations, saved VJP, recompute VJP) of the
    plain versions."""
    fwd = fr.camera_forward_reference if op == "camera" else fr.shadow_forward_reference
    bwd = fr.camera_backward_reference if op == "camera" else fr.shadow_backward_reference
    out, acts = fwd(kw, *args, save=True)
    return out, acts, bwd(kw, *args, g, acts=acts), bwd(kw, *args, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["camera", "shadow"])
def test_saved_vjp_equals_recompute(setup, op, dtype):
    """The saved activations are the recomputed ones, so the saved VJP is the
    recompute VJP (the JAX pin, 1e-6 / 1e-7); the forward keeps its output
    and its stream is (R*K, 2048) of the compute dtype."""
    s = setup
    kw = ff.KernelWeights(s["kw"].mats.to(dtype), s["kw"].biases)
    args, g = _inputs(s, op)
    out, acts, saved, rec = _plain_pair(op, kw, args, g)
    plain = (fr.camera_forward_reference if op == "camera" else fr.shadow_forward_reference)(
        kw, *args)
    assert torch.equal(out, plain)
    assert acts.shape == (s["z"].size, fr.N_TRUNK_ACTS_COLS) and acts.dtype == dtype
    for got, want in zip(saved, rec):
        torch.testing.assert_close(got, want, **SAVED_TOL)


def _field_grads(d_mats, d_biases):
    views = flatten_weights(ff.kernel_views(ff.KernelWeights(d_mats, d_biases)))
    return unpad_pe_rows(views, with_transient=True)


@pytest.mark.parametrize("op", ["camera", "shadow"])
def test_saved_vjp_matches_pallas_saved(setup, op):
    """jax.vjp of the Pallas op with save_acts=True (its forward writes the
    stream, its backward reads it) against the port's saved pair through
    the CPU wrappers, float32, at the recompute mode's pins."""
    s = setup
    args, g = _inputs(s, op)
    make = make_fused_camera if op == "camera" else make_fused_shadow
    jop = make(jnp.float32, interpret=True, save_acts=True)
    w = jax_pack_params(s["params"])
    rest = [jnp.asarray(a.numpy()) for a in args[1:]]
    jout, vjp = jax.vjp(lambda w_, ri: jop(w_, ri, *rest), w, jnp.asarray(s["rayin"]))
    gw, grayin = vjp(jnp.asarray(g.numpy()))
    if op == "camera":
        out, acts = fr.camera_forward_save(s["kw"], *args)
        d_mats, d_biases, d_rayin = fr.camera_backward_saved(s["kw"], *args, g, acts)
    else:
        out, acts = fr.shadow_forward_save(s["kw"], *args)
        d_mats, d_biases, d_rayin = fr.shadow_backward_saved(s["kw"], *args, g, acts)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    for got, ref in zip(_field_grads(d_mats, d_biases), jax_flatten(gw)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, **WEIGHT_TOL)
    grayin = np.asarray(grayin)
    np.testing.assert_allclose(d_rayin[:, 0:6].numpy(), grayin[:, 0:6],
                               **(CAM_ORIGIN_TOL if op == "camera" else SHADOW_ORIGIN_TOL))
    np.testing.assert_allclose(d_rayin[:, 6:10].numpy(), grayin[:, 6:10], **EMB_TOL)
    assert float(d_rayin[4].abs().max()) == 0.0      # no valid sample: no gradient


def _op_grads(s, kf, op):
    """Gradients of (out * cotangent).sum() through KernelField's op, and
    whether the op kept a stream."""
    mats = s["kw"].mats.clone().requires_grad_()
    biases = s["kw"].biases.clone().requires_grad_()
    rayin = _t(s["rayin"]).requires_grad_()
    args, g = _inputs(s, op)
    kw = ff.KernelWeights(mats, biases)
    out = (kf.fused_camera if op == "camera" else kf.fused_shadow)(kw, rayin, *args[1:])
    saved = out.grad_fn.saved
    (out * g).sum().backward()
    return [mats.grad, biases.grad, rayin.grad], saved


@pytest.mark.parametrize("op", ["camera", "shadow"])
def test_cap_falls_back_with_the_same_gradients(setup, op):
    """save_acts_cap_mb=0: the per-call gate refuses the stream and the op
    recomputes, with the saved op's gradients (the JAX package's
    test_camera_cap_falls_back)."""
    s = setup
    got_saved, saved = _op_grads(s, KernelField(s["tf"], save_acts=True), op)
    got_cap, capped = _op_grads(s, KernelField(s["tf"], save_acts=True, save_acts_cap_mb=0), op)
    got_rec, rec = _op_grads(s, KernelField(s["tf"]), op)
    assert (saved, capped, rec) == (True, False, False)
    for a, b, c in zip(got_saved, got_cap, got_rec):
        torch.testing.assert_close(a, c, **SAVED_TOL)
        assert torch.equal(b, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_step_save_ok_matches_pallas(dtype):
    """The step gate and the stream bytes give the JAX package's answers
    over a grid of rays, camera and shadow samples and caps (the JAX
    formula: R x KPAD x 2048 x itemsize)."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jfield = JaxField(n_images=2, compute_dtype=jdt)
    tfield = EONerfField(2, net_depth=2, net_width=32, compute_dtype=dtype, device="cpu")
    for cap in (0, 1, 64, 512, 8192):
        pf = PallasField(jfield, interpret=True, save_acts=True, save_acts_cap_mb=cap)
        kf = KernelField(tfield, save_acts=True, save_acts_cap_mb=cap)
        for r in (1, 7, 1024, 4096, 16384):
            for k_cam in (1, 63, 127, 143):
                assert fr.saved_stream_bytes(r, k_cam, dtype) == jax_stream_bytes(r, k_cam, jdt)
                for k_sc in (0, 31, 63, 127):
                    assert kf.step_save_ok(r, k_cam, k_sc) == pf.step_save_ok(r, k_cam, k_sc)
    assert not KernelField(tfield).step_save_ok(1, 1, 0)      # save_acts off


def test_no_stream_without_a_gradient(setup, monkeypatch):
    """Under torch.no_grad(), or with no input that needs a gradient, the
    ops take the plain forward and keep no stream (the JAX package's
    undifferentiated primal never saves)."""
    s = setup
    calls = []
    for name in ("camera_forward_save", "shadow_forward_save"):
        real = getattr(fr, name)
        monkeypatch.setattr(fr, name, lambda *a, _r=real, _n=name, **k: calls.append(_n) or _r(*a, **k))
    kf = KernelField(s["tf"], save_acts=True)
    cam, _ = _inputs(s, "camera")
    sh, _ = _inputs(s, "shadow")
    with torch.no_grad():
        kf.fused_camera(s["kw"], *cam)
        kf.fused_shadow(s["kw"], *sh)
    out = kf.fused_camera(s["kw"], *cam)               # nothing requires a gradient
    assert out.grad_fn is None and calls == []
    _op_grads(s, kf, "camera")
    _op_grads(s, kf, "shadow")
    assert calls == ["camera_forward_save", "shadow_forward_save"]


def test_int8_keeps_the_recompute_backward(monkeypatch, capsys):
    """bwd_acts="saved" (the default) with an int8 tier: make_render_field
    prints the JAX package's notice and the field recomputes; the pair is
    refused where it is asked for directly."""
    field = EONerfField(3, compute_dtype=torch.bfloat16, device="cpu")
    monkeypatch.setattr(fused_models, "_device_of", lambda f: torch.device("cuda"))
    rf = make_render_field(field, TrainConfig(trunk_quant="int8"))
    assert rf.trunk_quant is True and rf.save_acts is False
    assert "falling back to recompute" in capsys.readouterr().out
    assert not rf.step_save_ok(1024, 127, 63)
    rf = make_render_field(field, TrainConfig())
    assert rf.trunk_quant is False and rf.save_acts is True
    assert rf.step_save_ok(1024, 127, 63)
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="int8"):
        KernelField(field, trunk_quant=True, save_acts=True)


def test_default_config_constructs_and_steps(tmp_path):
    """The JAX package's literal default TrainConfig (float32, bwd_acts
    "saved", sampler "auto", the 8x256 field) constructs a Trainer on the
    CPU and takes a training step: float32 takes the per-sample path, where
    bwd_acts means nothing, as in the JAX package off its Pallas path. The
    step runs on a 64-ray batch of the pool."""
    cfg = TrainConfig(logs_dir=str(tmp_path))
    defaults = TrainConfig()
    assert all(getattr(cfg, f.name) == getattr(defaults, f.name)
               for f in dataclasses.fields(cfg) if f.name != "logs_dir")
    assert cfg.bwd_acts == "saved" and cfg.compute_dtype == "float32"
    pool = synthetic_ray_pool(4096, 4, "cpu")
    tr = tloop.Trainer(cfg, pool, 4, device="cpu", alt_envelope=(-2.0, 32.0))
    assert cfg.sampler == "tighten" and tr.render_field is tr.field
    batch = {k: v[:64] for k, v in tr.device_data.items()}
    before = [p.detach().clone() for p in tr.field.parameters()]
    losses = tr.train_step(batch, 0, 0.0, False, False, tr.generator, None)
    assert np.isfinite(float(losses["loss"]))
    assert any(not torch.equal(a, p) for a, p in zip(before, tr.field.parameters()))
