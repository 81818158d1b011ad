"""The port's int8 trunk tier (trunk_quant "int8" and "int8_full") against the
JAX package's: the weight quantization, the scale groups (``rt_of``), the
camera, shadow and coarse forwards, the camera and shadow backwards of both
tiers (``jax.vjp`` with a fixed cotangent, interpret mode on CPU), and
render_rays through ``KernelField`` against ``PallasField``; then the
tier's dispatch (make_render_field, TrainConfig, check_supported).

The activation scales are per group of rt rays x KPAD samples, padded
samples and zero rays included, so the scene has several groups and a
padded last one: 20 rays of 17 samples (KPAD 24) make 3 forward groups of 8
rays (tile 256; the last holds 4 zero rays) and 2 backward groups of 16
(bwd tile 512; the last holds 12). Measured on CPU, the port against the
JAX package, and the port with ONE group for the whole call against the
JAX package (the difference a wrong grouping gives):

- forwards, max abs on the sigma path (depth, opacity, geo, coarse
  weights): at most 2.7e-6 (float32 and bfloat16); one group 6.5e-4 to
  3.3e-3. Pinned at 1e-5. The camera's heads (albedo, t_s, t_beta) in
  float32: 8.7e-5 at one ray, where the two frameworks' float32 sums in the
  heads round apart; pinned at 2e-4.
- backwards (float32), worst weight-gradient tensor and d_o rel-L2: at most
  6.8e-7; one group 0.12 to 0.22 (weights), 0.13 to 0.15 (d_o). Pinned at
  1e-5.
- render_rays (40 rays, tile 512: 2 groups, the last with 24 zero rays):
  outputs within 2.4e-7, the uncertainty loss's parameter gradient within
  rel-L2 1.3e-7; one group 1.0e-3 and 1.7e-2. Pinned at the JAX package's
  fused-render pins (rtol 3e-5, atol 2e-5) and 1e-4.

The rays are dyadic (origins, directions and depths on a few bits), so
every PE argument o B + (d B) z is exact in float32. Elsewhere the JAX
kernels, run by XLA on the CPU, may contract it into one fused
multiply-add where the port rounds the product and the sum (as its bf16
kernels always have): one ulp apart on a position lane, which can be the
group's amax, re-rounds the whole group, and on random rays that alone
moved the backwards by up to 3e-2. The int8 semantics are what these
tests hold; the rounding of the PE argument is not part of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eonerf_code_tpu.data.rays import satrays_from_tensor as jax_satrays
from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.models.fused import PallasField
from eonerf_code_tpu.ops.pallas.fused_field import _pad_pe_rows
from eonerf_code_tpu.ops.pallas.fused_field import flatten_weights as jax_flatten
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu.ops.pallas.fused_field import quantize_trunk_int8 as jax_quantize
from eonerf_code_tpu.ops.pallas.fused_render import (
    _kpad_of,
    _rt_of,
    make_fused_camera,
    make_fused_coarse,
    make_fused_shadow,
)
from eonerf_code_tpu.ops.sampling import set_last_valid as jax_set_last_valid
from eonerf_code_tpu.render import satellite as jsat
from eonerf_code_tpu.utils import metrics as JM
from eonerf_code_tpu_torch.config import TrainConfig
from eonerf_code_tpu_torch.data.rays import satrays_from_tensor
from eonerf_code_tpu_torch.interop.jax_params import (
    field_state_from_jax,
    jax_params_from_field_state,
)
from eonerf_code_tpu_torch.models import fused as fused_models
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.models.fused import KernelField, make_render_field
from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr
from eonerf_code_tpu_torch.render import satellite as tsat
from eonerf_code_tpu_torch.train.loop import check_supported
from eonerf_code_tpu_torch.utils import metrics as TM

FWD_MAX_ABS = 1e-5        # the sigma path: depth, opacity, geo, coarse weights
HEAD_MAX_ABS = 2e-4       # the camera's albedo, t_s, t_beta
BWD_REL_L2 = 1e-5
RENDER_TOL = dict(rtol=3e-5, atol=2e-5)
RENDER_GRAD_REL_L2 = 1e-4
TILE, BWD_TILE = 256, 512
ONE_GROUP = 10 ** 6       # a target past the call's rows: one group for everything


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    jf = JaxField(n_images=6)
    params = jf.init(jax.random.PRNGKey(0), jnp.zeros((2, 3, 3), jnp.float32),
                     jnp.zeros((2, 3), jnp.float32), jnp.zeros((2,), jnp.int32),
                     method="init_all")
    tf = EONerfField(6, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    r, k = 20, 17
    # dyadic origins, directions and depths: every PE argument is exact in
    # float32 (see the module docstring)
    o = (rng.integers(-32, 33, (r, 3)) / 64.0).astype(np.float32)
    o[:, 2] = 61.0 / 64.0
    d = np.tile(np.array([2.0 / 64.0, -1.0 / 64.0, -1.0], np.float32), (r, 1))
    z = np.sort(rng.choice(256, (r, k), replace=True), axis=1).astype(np.float32) / 128.0
    delta = np.diff(z, axis=1, append=2.2).astype(np.float32)
    mask = rng.random((r, k)) > 0.25
    idx = rng.integers(0, 6, r)
    emb = np.asarray(params["params"]["transient_encoder"]["embedding"])[idx]
    rayin = np.hstack([o, d, emb, np.zeros((r, 6), np.float32)]).astype(np.float32)
    deltam_cam = (np.asarray(jax_set_last_valid(jnp.asarray(delta), jnp.asarray(mask), 1e10))
                  * mask).astype(np.float32)
    with torch.no_grad():
        kw = ff.pack_kernel_weights(ff.pack_params(tf), torch.float32)
    return dict(params=params, tf=tf, kw=kw, q8=ff.quantize_kernel_trunk(kw.mats), rayin=rayin,
                z=z, deltam_cam=deltam_cam, deltam_sh=(delta * mask).astype(np.float32),
                mask=mask.astype(np.float32),
                gacc=rng.normal(size=(r, fr.ACC_COLS)).astype(np.float32),
                ggeo=rng.normal(size=(r,)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_weight_quantization_matches_jax(setup):
    """w8 equal element for element, scales within 1 ulp, and the packed
    Q8Weights hold the same matrices and scales."""
    s = setup
    ref = jax_quantize(_pad_pe_rows(jax_flatten(jax_pack_params(s["params"])),
                                    with_transient=True))
    got = ff.quantize_trunk_int8(ff.pad_pe_rows(ff.flatten_weights(ff.pack_params(s["tf"])),
                                                with_transient=True))
    w8s, scales = ff.q8_views(s["q8"])
    assert len(got) == len(ref) == ff.N_Q8
    for i in range(8):
        assert got[i].dtype == torch.int8
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(ref[i]))
        np.testing.assert_array_equal(w8s[i].numpy(), np.asarray(ref[i]).astype(np.float32))
        np.testing.assert_array_max_ulp(got[8 + i].detach().numpy(), np.asarray(ref[8 + i]), 1)
        np.testing.assert_array_max_ulp(scales[i].numpy(), np.asarray(ref[8 + i]), 1)


def test_rt_of_matches_jax():
    for k in (1, 17, 63, 95, 127, 143, 200):
        for target in (256, 512, 1024, 2048):
            for n in (1, 5, 8, 20, 1000, 1024, 4096):
                kpad = fr.kpad_of(k)
                assert kpad == _kpad_of(k)
                assert fr.rt_of(kpad, target, n) == _rt_of(kpad, target, n), (k, target, n)
                _, rt, rp = fr.q8_plan(n, k, target)
                assert rp % rt == 0 and rp - n < rt


def _forward(s, op, dtype, target):
    kw = ff.KernelWeights(s["kw"].mats.to(dtype), s["kw"].biases)
    rayin, z = _t(s["rayin"]), _t(s["z"])
    if op == "camera":
        return fr.camera_forward_reference(kw, rayin, z, _t(s["deltam_cam"]), s["q8"], target)
    if op == "shadow":
        return fr.shadow_forward_reference(kw, rayin, z, _t(s["deltam_sh"]), _t(s["mask"]),
                                           s["q8"], target)
    return fr.coarse_forward_reference(kw, rayin, z, _t(s["deltam_cam"]), s["q8"], target)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", ["camera", "shadow", "coarse"])
def test_forward_matches_jax(setup, op, dtype):
    s = setup
    jdt = getattr(jnp, dtype)
    w, rayin, z = jax_pack_params(s["params"]), jnp.asarray(s["rayin"]), jnp.asarray(s["z"])
    if op == "camera":
        ref = make_fused_camera(jdt, tile_target=TILE, interpret=True, trunk_quant=True)(
            w, rayin, z, jnp.asarray(s["deltam_cam"]))
    elif op == "shadow":
        ref = make_fused_shadow(jdt, tile_target=TILE, interpret=True, trunk_quant=True)(
            w, rayin, z, jnp.asarray(s["deltam_sh"]), jnp.asarray(s["mask"]))
    else:
        ref = make_fused_coarse(jdt, tile_target=TILE, interpret=True, trunk_quant=True)(
            w, rayin, z, jnp.asarray(s["deltam_cam"]))
    ref = np.asarray(ref)
    stats = {}
    got = _forward(s, op, getattr(torch, dtype), TILE)
    assert got.shape == ref.shape
    sigma_cols = [0, 6] if op == "camera" else slice(None)
    err = np.abs(got.numpy() - ref)
    assert float(err[..., sigma_cols].max()) < FWD_MAX_ABS
    assert float(err.max()) < HEAD_MAX_ABS
    # a wrong grouping is another function: one group fails the pin
    wrong = _forward(s, op, getattr(torch, dtype), ONE_GROUP)
    assert float(np.abs(wrong.numpy() - ref)[..., sigma_cols].max()) > 10 * FWD_MAX_ABS
    # the plain version reports one amax per group and quantization point
    fr.camera_forward_reference(s["kw"], _t(s["rayin"]), _t(s["z"]), _t(s["deltam_cam"]),
                                s["q8"], TILE, stats)
    assert tuple(stats["amax"].shape) == (3, ff.Q8_POINTS)


def _backward(s, op, full, target):
    args = (_t(s["rayin"]), _t(s["z"]))
    if op == "camera":
        return fr.camera_backward_reference(s["kw"], *args, _t(s["deltam_cam"]), _t(s["gacc"]),
                                            s["q8"], full, target)
    return fr.shadow_backward_reference(s["kw"], *args, _t(s["deltam_sh"]), _t(s["mask"]),
                                        _t(s["ggeo"]), s["q8"], full, target)


def _grad_errors(got, gw, grayin, n_tensors):
    """rel-L2 of each nonzero weight-gradient tensor (unpadded, JAX order)
    and of d_o, d_d."""
    views = ff.unpad_pe_rows(ff.flatten_weights(ff.kernel_views(ff.KernelWeights(*got[:2]))),
                             with_transient=True)
    errs = [_rel(a.numpy().reshape(np.shape(b)), b)
            for a, b in zip(views[:n_tensors], jax_flatten(gw)[:n_tensors])]
    return errs + [_rel(got[2][:, 0:6].numpy(), np.asarray(grayin)[:, 0:6])]


@pytest.mark.parametrize("tier", [True, "full"])
@pytest.mark.parametrize("op", ["camera", "shadow"])
def test_backward_matches_jax(setup, op, tier):
    """float32; the trunk's recompute in the backward's groups, then
    straight-through bf16-tier dgrad/wgrad (True) or the int8 chain
    ("full")."""
    s = setup
    w = jax_pack_params(s["params"])
    if op == "camera":
        cam = make_fused_camera(jnp.float32, tile_target=TILE, bwd_tile_target=BWD_TILE,
                                interpret=True, trunk_quant=tier)
        _, vjp = jax.vjp(lambda w_, ri: cam(w_, ri, jnp.asarray(s["z"]),
                                            jnp.asarray(s["deltam_cam"])),
                         w, jnp.asarray(s["rayin"]))
        gw, grayin = vjp(jnp.asarray(s["gacc"]))
    else:
        sh = make_fused_shadow(jnp.float32, tile_target=TILE, bwd_tile_target=BWD_TILE,
                               interpret=True, trunk_quant=tier)
        _, vjp = jax.vjp(lambda w_, ri: sh(w_, ri, jnp.asarray(s["z"]),
                                           jnp.asarray(s["deltam_sh"]), jnp.asarray(s["mask"])),
                         w, jnp.asarray(s["rayin"]))
        gw, grayin = vjp(jnp.asarray(s["ggeo"]))
    n = ff.N_WEIGHTS if op == "camera" else ff.N_DENSITY_WEIGHTS
    full = tier == "full"
    stats = {}
    got = _backward(s, op, full, BWD_TILE)
    assert max(_grad_errors(got, gw, grayin, n)) < BWD_REL_L2
    wrong = _backward(s, op, full, ONE_GROUP)
    assert max(_grad_errors(wrong, gw, grayin, n)) > 100 * BWD_REL_L2
    if op == "camera":
        fr.camera_backward_reference(s["kw"], _t(s["rayin"]), _t(s["z"]), _t(s["deltam_cam"]),
                                     _t(s["gacc"]), s["q8"], full, BWD_TILE, stats)
        assert tuple(stats["amax"].shape) == (2, ff.Q8_POINTS)
        assert ("gamax" in stats) == full


RENDER_CFG = dict(n_samples=17, sc_n_samples=16, perturb=False)


def _render_scene():
    """40 dyadic rays over the cube with their colours: 17 linear samples
    on [0, 2] put the 16 midpoints on multiples of 1/16, so every PE
    argument is exact; 2 groups at tile 512 (the last holds 24 zero
    rays)."""
    rng = np.random.default_rng(31)
    n = 40
    o = np.zeros((n, 3), np.float32)
    o[:, 0:2] = rng.integers(-51, 52, (n, 2)) / 64.0
    o[:, 2] = 63.0 / 64.0
    d = np.tile(np.array([3.0 / 64.0, 1.0 / 64.0, -1.0], np.float32), (n, 1))
    sun = np.tile(np.array([0.3, 0.2, -0.93], np.float32), (n, 1))
    sun /= np.linalg.norm(sun, axis=1, keepdims=True)
    rays = np.hstack([o, d, np.zeros((n, 1), np.float32), 2.0 * np.ones((n, 1), np.float32),
                      sun]).astype(np.float32)
    return rays, rng.integers(0, 6, n).astype(np.int32), rng.random((n, 3)).astype(np.float32)


def _flat(tree):
    leaves = []

    def walk(node):
        for k in sorted(node):
            v = node[k]
            walk(v) if isinstance(v, dict) else leaves.append(np.asarray(v, np.float64).ravel())

    walk(tree)
    return np.concatenate(leaves)


def _port_render(tf, rays, ts, rgbs, tile):
    """render_rays through KernelField(trunk_quant=True), the uncertainty
    loss and the parameter gradient (as a flax-style tree)."""
    tf.zero_grad(set_to_none=True)
    out = tsat.render_rays(KernelField(tf, trunk_quant=True, tile=tile, bwd_tile=tile),
                           satrays_from_tensor(_t(rays), _t(ts)), tsat.RenderConfig(**RENDER_CFG),
                           shadows=False)
    loss = TM.uncertainty_aware_loss(_t(rgbs), out["rgb"], out["beta"])[0]
    loss.backward()
    grads = {n_: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n_, p in tf.named_parameters()}
    return out, _flat(jax_params_from_field_state(grads))


def test_render_rays_matches_jax(setup):
    """render_rays through the kernel-backed field at int8 (plain versions
    on CPU) against PallasField(trunk_quant=True) in interpret mode: every
    output and the uncertainty loss's gradient. Without the shadow pass:
    its origins come from the composited depth, whose PE arguments the two
    frameworks round differently (see the module docstring); the shadow
    op's int8 parity is held above."""
    s = setup
    rays, ts, rgbs = _render_scene()
    pf = PallasField(JaxField(n_images=6), interpret=True, tile=512, bwd_tile=512,
                     trunk_quant=True)
    j_rays = jax_satrays(jnp.asarray(rays), jnp.asarray(ts))
    cfg = jsat.RenderConfig(**RENDER_CFG)
    ref = jsat.render_rays(pf, s["params"], j_rays, jax.random.PRNGKey(7), cfg, shadows=False)

    def loss(p):
        o = jsat.render_rays(pf, p, j_rays, jax.random.PRNGKey(7), cfg, shadows=False)
        return JM.uncertainty_aware_loss(jnp.asarray(rgbs), o["rgb"], o["beta"])[0]

    g_ref = _flat(jax.grad(loss)(s["params"]))
    out, g_got = _port_render(s["tf"], rays, ts, rgbs, 512)
    for k in tsat.OUTPUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), err_msg=k,
                                   **RENDER_TOL)
    assert _rel(g_got, g_ref) < RENDER_GRAD_REL_L2
    out_1, g_1 = _port_render(s["tf"], rays, ts, rgbs, ONE_GROUP)
    assert _rel(g_1, g_ref) > 10 * RENDER_GRAD_REL_L2
    assert not np.allclose(out_1["rgb"].detach().numpy(), np.asarray(ref["rgb"]), **RENDER_TOL)


# ---- dispatch (the JAX package's TestDispatch, on the CPU) ----

def test_make_render_field_reads_trunk_quant(setup, monkeypatch, capsys):
    """make_render_field maps trunk_quant as the JAX package does ("int8" ->
    True, "int8_full" -> "full"); with bwd_acts="saved" an int8 tier prints
    the JAX package's notice and keeps the recompute backward (the port's
    only one). The device check is bypassed: the kernel field is built on
    the CPU and never launched here."""
    field = EONerfField(6, compute_dtype=torch.bfloat16, device="cpu")
    monkeypatch.setattr(fused_models, "_device_of", lambda f: torch.device("cuda"))
    assert make_render_field(field).trunk_quant is False
    rf = make_render_field(field, TrainConfig(trunk_quant="int8", bwd_acts="recompute"))
    assert isinstance(rf, KernelField) and rf.trunk_quant is True
    assert capsys.readouterr().out == ""
    rf = make_render_field(field, TrainConfig(trunk_quant="int8_full"))   # bwd_acts "saved"
    assert rf.trunk_quant == "full"
    assert "falling back to recompute" in capsys.readouterr().out


def test_config_and_check_supported(tmp_path):
    check_supported(TrainConfig(trunk_quant="int8"))           # saved -> recompute fallback
    check_supported(TrainConfig(trunk_quant="int8_full", bwd_acts="recompute"))
    with pytest.raises(NotImplementedError, match="bwd_acts"):
        check_supported(TrainConfig())                         # saved, no int8
    with pytest.raises(ValueError, match="trunk_quant"):
        TrainConfig(trunk_quant="int4")
    cfg = TrainConfig(trunk_quant="int8_full")
    cfg.save(str(tmp_path / "opts.json"))
    assert TrainConfig.load(str(tmp_path / "opts.json")).trunk_quant == "int8_full"


def test_per_point_ops_stay_unquantized(setup):
    """The per-point field and density ops (the per-sample branch, the
    occupancy probe) ignore trunk_quant, as PallasField builds them without
    it: their results and gradients equal the unquantized field's."""
    tf = setup["tf"]
    rng = np.random.default_rng(2)
    pos = _t(rng.uniform(-0.9, 0.9, (3, 10, 3)).astype(np.float32))
    sun = _t(np.tile(np.array([0.3, 0.2, -0.93], np.float32), (3, 1)))
    idx = torch.tensor([0, 2, 5])
    outs = []
    for quant in (False, True, "full"):
        kf = KernelField(tf, trunk_quant=quant)
        tf.zero_grad(set_to_none=True)
        res = kf(pos, sun, idx)
        dens = kf.density(pos)
        (sum(x.sum() for x in res) + dens.sum()).backward()
        outs.append([x.detach() for x in res] + [dens.detach()]
                    + [p.grad.clone() for p in tf.trunk.parameters()])
    for other in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(outs[0], other))
