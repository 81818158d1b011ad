"""The port's vanilla-NeRF path against the JAX package's, on the CPU at
2x32 widths, 17 samples and a 16^3 grid: VanillaNeRF and DNeRF through the
weight bridge, the PNG reader against PIL, the nerf_synthetic loader,
render_blender_rays, the grid update, one training step from a common
state, the learning-rate schedule and eval_psnr. Draws are injected (the
jitter ``u`` from the JAX key; docs/PARITY.md deviation 8)."""

import json
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from eonerf_code_tpu.data.nerf_synthetic import BlenderDataset as JaxDataset
from eonerf_code_tpu.models.dnerf import DNeRF as JaxDNeRF
from eonerf_code_tpu.models.vanilla import VanillaNeRF as JaxVanilla
from eonerf_code_tpu.ops.occupancy import OccupancyGrid as JaxGrid
from eonerf_code_tpu.render.blender import BlenderRenderConfig as JaxRenderConfig
from eonerf_code_tpu.render.blender import render_blender_rays as jax_render
from eonerf_code_tpu.train import train_vanilla as jtv
from eonerf_code_tpu_torch.data.nerf_synthetic import BlenderDataset
from eonerf_code_tpu_torch.interop.jax_params import (
    field_state_from_jax,
    jax_params_from_field_state,
)
from eonerf_code_tpu_torch.io.png import read_png, write_png
from eonerf_code_tpu_torch.models.dnerf import DNeRF
from eonerf_code_tpu_torch.models.vanilla import VanillaNeRF
from eonerf_code_tpu_torch.ops.occupancy import OccupancyGrid
from eonerf_code_tpu_torch.parallel.multi_aoi import load_adam_state
from eonerf_code_tpu_torch.render.blender import BlenderRenderConfig, render_blender_rays
from eonerf_code_tpu_torch.train import train_vanilla as tv

# float32 modules on the same weights: the sums differ only in order
F32_TOL = dict(rtol=1e-6, atol=1e-6)
# DNeRF end to end (test_dnerf_matches_flax says why)
DNERF_TOL = dict(rtol=1e-5, atol=1e-5)
# renders: 16 samples a ray composited, exp and cumsum in two frameworks
RENDER_TOL = dict(rtol=1e-5, atol=1e-5)
# one step from a common state (tests/test_torch_multi_aoi.py's pins):
# the loss, and the gradient and Adam update as rel-L2. Free-running
# trajectories are not compared: Adam's first steps move a parameter by
# about lr whatever its gradient's size, so a component that float32
# rounds to opposite signs on the two sides moves 2 lr apart
LOSS_RTOL = 1e-5
STEP_REL_L2 = 1e-4
PSNR_ATOL_DB = 1e-4
SMALL = dict(net_depth=2, net_width=32)
N_SAMPLES, GRID_RES = 17, 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(state):
    return np.concatenate([np.asarray(state[k], np.float64).ravel() for k in sorted(state)])


# ---- the PNG reader ----

def _pil_image(mode, seed, shape=(29, 37)):
    """Random pixels beside smooth gradients, so the encoder picks more
    than one row filter."""
    rng = np.random.default_rng(seed)
    c = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    smooth = np.stack([(xx * (3 + k) + yy * (5 + 2 * k)) % 256 for k in range(c)], -1)
    noise = rng.integers(0, 256, (*shape, c))
    img = np.where((yy < shape[0] // 2)[..., None], smooth, noise).astype(np.uint8)
    return img[..., 0] if c == 1 else img


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_matches_pil(tmp_path, mode):
    path = str(tmp_path / "im.png")
    Image.fromarray(_pil_image(mode, 0), mode).save(path)
    want = np.asarray(Image.open(path))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(path, img):
    """Write ``img`` (h, w, 4) with row y filtered by filter y % 5 (the
    PNG specification's five, written out in numpy)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        pred = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)][y % 5]
        out.append(bytes([y % 5]) + ((x - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


def test_png_reader_undoes_every_row_filter(tmp_path):
    """PIL's writer uses filters 0, 1, 2 and 4; Average (3) comes from a
    file written here, which PIL decodes the same."""
    img = _pil_image("RGBA", 1, shape=(15, 23))
    path = str(tmp_path / "filters.png")
    _filtered_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_writer_is_read_by_pil(tmp_path, mode):
    img = _pil_image(mode, 2)
    path = str(tmp_path / "w.png")
    write_png(path, img)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(read_png(path), img)


@pytest.mark.parametrize("case", ["I;16", "P", "LA", "interlaced", "crc"])
def test_png_reader_refuses_what_it_does_not_read(tmp_path, case):
    path = str(tmp_path / "bad.png")
    if case in ("I;16", "P", "LA"):
        img = _pil_image("L", 3)
        Image.fromarray(img, "L").convert(case).save(path)
    else:
        write_png(path, _pil_image("RGB", 3))
        data = bytearray(open(path, "rb").read())
        if case == "interlaced":   # IHDR's last byte, then its CRC anew
            data[28] = 1
            data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
        else:
            data[40] ^= 0xFF       # a byte of the image data
        open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        read_png(path)


# ---- the loader ----

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A nerf_synthetic subject written by PIL: 4 train, 2 val and 3 test
    frames of 20x24 random RGBA (alpha over its whole range), cameras on a
    circle of radius 4 looking at the origin."""
    root = str(tmp_path_factory.mktemp("blender"))
    sub = os.path.join(root, "rand")
    os.makedirs(sub)
    rng = np.random.default_rng(7)
    k = 0
    for split, n in (("train", 4), ("val", 2), ("test", 3)):
        frames = []
        for _ in range(n):
            theta = rng.uniform(0, 2 * np.pi)
            pos = np.array([4 * np.sin(theta), rng.uniform(-0.5, 0.5), 4 * np.cos(theta)])
            z = pos / np.linalg.norm(pos)
            x = np.cross([0.0, 1.0, 0.0], z)
            x /= np.linalg.norm(x)
            c2w = np.eye(4)
            c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, np.cross(z, x), z, pos
            name = f"{split}/r_{k}"
            os.makedirs(os.path.join(sub, split), exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (20, 24, 4)).astype(np.uint8)).save(
                os.path.join(sub, name + ".png"))
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
            k += 1
        with open(os.path.join(sub, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.69, "frames": frames}, f)
    return root, "rand"


def _equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("split", ["train", "trainval", "test"])
def test_full_images_match_jax(scene, split):
    root, subject = scene
    jds, tds = JaxDataset(subject, root, split=split), BlenderDataset(subject, root, split=split)
    assert len(tds) == len(jds) and tds.focal == jds.focal
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.camtoworlds, jds.camtoworlds)
    for i in range(len(jds)):
        _equal_dicts(tds.full_image(i), jds.full_image(i))


@pytest.mark.parametrize("bkgd", ["white", "black", "random"])
def test_batches_match_jax(scene, bkgd):
    root, subject = scene
    kw = dict(split="trainval", color_bkgd_aug=bkgd, num_rays=97, seed=5)
    jds, tds = JaxDataset(subject, root, **kw), BlenderDataset(subject, root, **kw)
    assert tds.training and jds.training
    for _ in range(3):
        _equal_dicts(tds.sample_batch(), jds.sample_batch())
    _equal_dicts(tds.sample_batch(31), jds.sample_batch(31))


# ---- the modules and the bridge ----

def _vanilla_pair(seed=0, dtype="float32", **kw):
    jm = JaxVanilla(**kw, compute_dtype=getattr(jnp, dtype))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3, 3)), jnp.zeros((2, 1, 3)))
    tm = VanillaNeRF(**kw, compute_dtype=getattr(torch, dtype), device="cpu")
    tm.load_state_dict(field_state_from_jax(_np(params)))
    return jm, params, tm


def _points(seed, r=6, k=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (r, k, 3)).astype(np.float32)
    d = rng.normal(size=(r, 1, 3)).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("depth,width", [(2, 32), (5, 32)])
def test_vanilla_matches_flax(depth, width):
    """Depth 5 puts the skip after the last trunk layer (a wider head)."""
    jm, params, tm = _vanilla_pair(net_depth=depth, net_width=width)
    x, d = _points(1)
    rgb, sigma = jm.apply(params, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        t_rgb, t_sigma = tm(torch.from_numpy(x), torch.from_numpy(d))
        t_dens = tm.density(torch.from_numpy(x))
    np.testing.assert_allclose(t_rgb.numpy(), np.asarray(rgb), **F32_TOL)
    np.testing.assert_allclose(t_sigma.numpy(), np.asarray(sigma), **F32_TOL)
    np.testing.assert_allclose(t_dens.numpy(),
                               np.asarray(jm.apply(params, jnp.asarray(x), method="density")),
                               **F32_TOL)


def test_dnerf_matches_flax():
    """The warped points and the NeRF on the JAX package's warped points at
    F32_TOL; the whole forward and density at DNERF_TOL: the warped points
    differ by an ulp (3e-7 here) and the degree-10 encoding's 2^9
    frequency carries that into the trunk (outputs 2.3e-6 and sigma 6.3e-6
    apart, measured on the CPU; 6e-8 and 1.3e-7 on the same points)."""
    jm = JaxDNeRF()
    x, d = _points(2)
    t = np.random.default_rng(3).uniform(0, 1, (6, 1, 1)).astype(np.float32)
    jx, jt, jd = (jnp.asarray(a) for a in (x, t, d))
    params = jm.init(jax.random.PRNGKey(4), jx, jt, jd)
    tm = DNeRF(device="cpu")
    tm.load_state_dict(field_state_from_jax(_np(params)))
    warped = np.array(jm.apply(params, jx, jt, method=lambda m, x, t: m._warped(x, t)))
    rgb, sigma = jm.apply(params, jx, jt, jd)
    dens = jm.apply(params, jx, jt, method="density")
    tx, tt, td = (torch.from_numpy(a) for a in (x, t, d))
    with torch.no_grad():
        np.testing.assert_allclose(tm._warped(tx, tt).numpy(), warped, **F32_TOL)
        same = tm.nerf(torch.from_numpy(warped), td)
        for got, want in zip(same, (rgb, sigma)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
        t_rgb, t_sigma = tm(tx, tt, td)
        t_dens = tm.density(tx, tt)
    for got, want in ((t_rgb, rgb), (t_sigma, sigma), (t_dens, dens)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DNERF_TOL)


@pytest.mark.parametrize("model", ["vanilla", "dnerf"])
def test_bridge_round_trips(model):
    if model == "vanilla":
        jm, x0 = JaxVanilla(**SMALL), (jnp.zeros((2, 3, 3)), jnp.zeros((2, 1, 3)))
        tm = VanillaNeRF(**SMALL, device="cpu")
    else:
        jm, x0 = JaxDNeRF(), (jnp.zeros((2, 3, 3)), jnp.zeros((2, 1, 1)), jnp.zeros((2, 1, 3)))
        tm = DNeRF(device="cpu")
    tree = _np(jm.init(jax.random.PRNGKey(0), *x0))
    state = field_state_from_jax(tree)
    assert sorted(state) == sorted(tm.state_dict())
    tm.load_state_dict(state)   # strict: every name and shape
    back = jax_params_from_field_state(tm.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


# ---- rendering, the grid, the step ----

def _jax_grid(binaries=None, occs=None):
    n = GRID_RES ** 3
    return JaxGrid(occs=jnp.zeros((n,), jnp.float32) if occs is None else jnp.asarray(occs),
                   binaries=(jnp.ones((GRID_RES,) * 3, bool) if binaries is None
                             else jnp.asarray(binaries)),
                   resolution=GRID_RES, aabb_min=-1.5, aabb_max=1.5)


def _port_grid(jgrid):
    return OccupancyGrid(occs=torch.from_numpy(np.array(jgrid.occs)),
                         binaries=torch.from_numpy(np.array(jgrid.binaries)),
                         resolution=GRID_RES, aabb_min=-1.5, aabb_max=1.5)


def _batch(scene, n=64, seed=11):
    root, subject = scene
    return JaxDataset(subject, root, split="train", num_rays=n, seed=seed).sample_batch()


def _u(key, n, dtype=jnp.float32):
    """The jitter JAX's render draws from ``key`` (perturb_z_vals)."""
    return np.array(jax.random.uniform(key, (n, N_SAMPLES), dtype))


@pytest.mark.parametrize("with_grid", [False, True])
@pytest.mark.parametrize("train", [True, False])
def test_render_matches_jax(scene, with_grid, train):
    jm, params, tm = _vanilla_pair(**SMALL)
    b = _batch(scene)
    binaries = np.random.default_rng(12).random((GRID_RES,) * 3) < 0.5
    jgrid = _jax_grid(binaries) if with_grid else None
    key = jax.random.PRNGKey(13)
    want = jax_render(jm, params, *(jnp.asarray(b[k]) for k in ("rays_o", "rays_d", "color_bkgd")),
                      key, JaxRenderConfig(n_samples=N_SAMPLES),
                      occ_grid=jgrid, train=train)
    with torch.no_grad():
        got = render_blender_rays(tm, *(torch.from_numpy(b[k]) for k in
                                        ("rays_o", "rays_d", "color_bkgd")),
                                  BlenderRenderConfig(n_samples=N_SAMPLES),
                                  occ_grid=_port_grid(jgrid) if with_grid else None,
                                  train=train, u=torch.from_numpy(_u(key, 64)))
    for k in ("rgb", "opacity", "depth"):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **RENDER_TOL, err_msg=k)
    assert int(got["n_eff_samples"]) == int(want["n_eff_samples"])
    if with_grid:
        assert 0 < int(got["n_eff_samples"]) < 64 * (N_SAMPLES - 1)


def test_grid_update_matches_jax():
    """One whole-grid update from the training grid (occs 0, every cell
    open), then a second from its result."""
    jm, params, tm = _vanilla_pair(**SMALL)
    render_step = (6.0 - 2.0) / (N_SAMPLES - 1)
    jgrid, tgrid = _jax_grid(), tv.make_grid(GRID_RES, "cpu")
    rcfg = BlenderRenderConfig(n_samples=N_SAMPLES)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        u = jax.random.uniform(jax.random.split(key)[1], (GRID_RES ** 3, 3), jnp.float32)
        jgrid = jgrid.update(lambda x: jm.apply(params, x, method="density"), key, render_step)
        tgrid = tv.occ_update(tm, tgrid, rcfg, u=torch.from_numpy(np.asarray(u)))
        np.testing.assert_allclose(tgrid.occs.numpy(), np.asarray(jgrid.occs), **F32_TOL)
        np.testing.assert_array_equal(tgrid.binaries.numpy(), np.asarray(jgrid.binaries))
    assert 0 < int(tgrid.binaries.sum()) < GRID_RES ** 3


def _jax_step(jm, rcfg, optimizer):
    """The JAX package's vanilla step (train/train_vanilla.py:54-63) from
    its public pieces, returning the gradients too."""
    def step(params, opt_state, grid, batch, key):
        def loss_fn(p):
            out = jax_render(jm, p, batch["rays_o"], batch["rays_d"], batch["color_bkgd"],
                             key, rcfg, occ_grid=grid)
            return optax.huber_loss(out["rgb"], batch["pixels"], delta=1.0).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads
    return jax.jit(step)


@pytest.mark.parametrize("dtype,from_step", [("float32", 0), ("float64", 0),
                                              ("float64", 2)])
def test_train_step_matches_jax(scene, dtype, from_step):
    """One port step from the JAX state after ``from_step`` JAX steps
    (max_steps 4: the learning rate is cut at step 2) on one batch, grid and
    jitter. float32, the path as it trains: the loss, the gradients and the
    parameters after the step. Not the step itself: Adam's first steps
    divide each gradient component by its own size, so a component near 0
    whose two float32 sums differ by a ReLU mask (a pre-activation within
    rounding of 0; on this draw's third step one of layer 0 lies at
    1.7e-7) moves apart by up to 2 lr (6.1e-4 rel-L2 at step 0, measured on
    the CPU). Computed in float64 on both sides (float32 parameters and
    Adam), the masks agree and the loss, the gradients and the Adam update
    are held at the float32 step's tolerances."""
    max_steps, lr = 4, 5e-4
    jm, params, tm = _vanilla_pair(dtype=dtype, **SMALL)
    jopt = optax.adam(optax.piecewise_constant_schedule(lr, tv.lr_boundaries(max_steps)))
    opt_state = jopt.init(params)
    rcfg = JaxRenderConfig(n_samples=N_SAMPLES)
    jstep = _jax_step(jm, rcfg, jopt)
    jgrid = _jax_grid().update(lambda x: jm.apply(params, x, method="density"),
                               jax.random.PRNGKey(30), (6.0 - 2.0) / (N_SAMPLES - 1))

    def batch(step):
        b = _batch(scene, seed=40 + step)
        return {k: (v if k == "pixels" else v.astype(dtype)) for k, v in b.items()}

    for s in range(from_step):
        params, opt_state, _, _ = jstep(params, opt_state, jgrid,
                                        {k: jnp.asarray(v) for k, v in batch(s).items()},
                                        jax.random.PRNGKey(50 + s))
    b, key = batch(from_step), jax.random.PRNGKey(50 + from_step)
    new_params, _, loss, grads = jstep(params, opt_state, jgrid,
                                       {k: jnp.asarray(v) for k, v in b.items()}, key)

    tm.load_state_dict(field_state_from_jax(_np(params)))
    topt = tv.make_optimizer(tm, lr)
    adam = opt_state[0]
    load_adam_state(topt, tm, adam.count, field_state_from_jax(_np(adam.mu)),
                    field_state_from_jax(_np(adam.nu)))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    t_loss, n_eff = tv.train_step(tm, topt, _port_grid(jgrid), tv.batch_to(b, "cpu"),
                                  BlenderRenderConfig(n_samples=N_SAMPLES),
                                  tv.learning_rate(lr, max_steps, from_step),
                                  u=torch.from_numpy(_u(key, 64, getattr(jnp, dtype))))
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=LOSS_RTOL)
    assert 0 < int(n_eff) < 64 * (N_SAMPLES - 1)
    t_grads = {n: p.grad for n, p in tm.named_parameters()}
    assert all(g.dtype == torch.float32 for g in t_grads.values())
    assert _rel(_flat(t_grads), _flat(field_state_from_jax(_np(grads)))) < STEP_REL_L2
    want_new = field_state_from_jax(_np(new_params))
    assert _rel(_flat(tm.state_dict()), _flat(want_new)) < STEP_REL_L2
    if dtype == "float64":
        t_upd = _flat(tm.state_dict()) - _flat(before)
        j_upd = _flat(want_new) - _flat(field_state_from_jax(_np(params)))
        assert _rel(t_upd, j_upd) < STEP_REL_L2


@pytest.mark.parametrize("max_steps", [3, 4, 10, 50000])
def test_learning_rate_matches_optax(max_steps):
    sched = optax.piecewise_constant_schedule(5e-4, {max_steps // 2: 0.33,
                                                     max_steps * 3 // 4: 0.33,
                                                     max_steps * 9 // 10: 0.33})
    with jax.enable_x64(False):   # optax in float32, as the JAX package trains
        want = np.asarray(sched(jnp.arange(max_steps)))
    assert want.dtype == np.float32
    got = np.array([tv.learning_rate(5e-4, max_steps, s) for s in range(max_steps)], np.float32)
    np.testing.assert_array_equal(got, want)
    if max_steps == 3:
        np.testing.assert_allclose(got, [5e-4, 1.65e-4, 5.445e-5], rtol=1e-6)


def test_eval_psnr_matches_jax(scene):
    """The mean of per-view PSNRs over the test split, on one set of
    weights and one grid (half the cells open)."""
    root, subject = scene
    jm, params, tm = _vanilla_pair(**SMALL)
    binaries = np.random.default_rng(60).random((GRID_RES,) * 3) < 0.5
    jgrid = _jax_grid(binaries)
    want = jtv.eval_psnr({"model": jm, "params": params, "grid": jgrid,
                          "rcfg": JaxRenderConfig(n_samples=N_SAMPLES)},
                         root_fp=root, subject_id=subject, chunk=200)
    got = tv.eval_psnr({"model": tm, "grid": _port_grid(jgrid),
                        "rcfg": BlenderRenderConfig(n_samples=N_SAMPLES)},
                       root_fp=root, subject_id=subject, chunk=200)
    assert abs(got - want) < PSNR_ATOL_DB, (got, want)
    # the mean of the views' PSNRs, not the PSNR of their mean MSE
    tds = BlenderDataset(subject, root, split="test")
    mses = []
    for i in range(len(tds)):
        view = tds.full_image(i)
        rgb = tv.render_view(tm, _port_grid(jgrid), BlenderRenderConfig(n_samples=N_SAMPLES),
                             view)
        mses.append(float(((rgb - torch.from_numpy(view["pixels"])) ** 2).mean()))
    np.testing.assert_allclose(got, np.mean(-10 * np.log10(mses)), atol=PSNR_ATOL_DB)
    assert abs(got + 10 * np.log10(np.mean(mses))) > 1e-3
