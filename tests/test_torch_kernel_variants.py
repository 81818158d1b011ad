"""The kernel-variant bench's plain versions (eonerf_code_tpu_torch/bench/)
against the research kernels that the JAX package times on the TPU: every
body of scripts/bench_kernel_variants.py and scripts/proto_composite.py,
loaded from its file unchanged and run through pl.pallas_call in interpret
mode with the JAX package's own tile specs, on two 2048-row tiles of a
numpy-seeded input, with the weights of one JAX EONerfField(n_images=10)
carried over by the port's bridge. Then both bench CLIs on the CPU."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from eonerf_code_tpu.models.eonerf import EONerfField as JaxField
from eonerf_code_tpu.ops.pallas.fused_field import (
    _const_spec,
    _pad_pe_rows,
    _tile_spec,
    cast_matrices,
    density_subset,
    flatten_weights,
)
from eonerf_code_tpu.ops.pallas.fused_field import pack_params as jax_pack_params
from eonerf_code_tpu_torch.bench import composite, kernel_variants
from eonerf_code_tpu_torch.bench import variants as vr
from eonerf_code_tpu_torch.interop.jax_params import field_state_from_jax
from eonerf_code_tpu_torch.models.eonerf import EONerfField
from eonerf_code_tpu_torch.ops import fused_field as ff

REPO = pathlib.Path(__file__).resolve().parent.parent
N, TILE = 4096, 2048
# the gates are bench/variants.py's (vr.check)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def setup():
    params = JaxField(n_images=10).init(
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 3)), jnp.zeros((2, 3)),
        jnp.zeros((2,), jnp.int32), method="init_all")
    tf = EONerfField(10, device="cpu")
    tf.load_state_dict(field_state_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        kw = ff.pack_kernel_weights(ff.pack_params(tf), torch.bfloat16)
    w = jax_pack_params(params)
    rng = np.random.default_rng(7)
    acts = torch.from_numpy(rng.normal(size=(N, vr.ACTS_COLS)).astype(np.float32)).to(
        torch.bfloat16)
    return dict(
        bkv=_load("bench_kernel_variants"), pc=_load("proto_composite"), kw=kw,
        sw=vr.slab_weights(kw),
        flat=_pad_pe_rows(cast_matrices(density_subset(w), jnp.bfloat16)),
        flat_full=_pad_pe_rows(cast_matrices(flatten_weights(w), jnp.bfloat16),
                               with_transient=True),
        pos=rng.uniform(-1, 1, (N, 3)).astype(np.float32),
        emb=rng.normal(size=(N, 4)).astype(np.float32),
        sd=(rng.uniform(size=(N // vr.KPAD, vr.KPAD)) * 0.1).astype(np.float32),
        acts=acts)


def _pallas(body, ins, in_specs, out_shape, out_specs):
    return pl.pallas_call(body, out_shape=out_shape, grid=(N // TILE,), in_specs=in_specs,
                          out_specs=out_specs, interpret=True)(*ins)


def _tpu_forward(s, variant):
    full = variant == "full"
    flat = s["flat_full"] if full else s["flat"]
    ins = [jnp.asarray(s["pos"])] + ([jnp.asarray(s["emb"])] if full else []) + flat
    specs = [_tile_spec(TILE, 3)] + ([_tile_spec(TILE, 4)] if full else [])
    n_out = 8 if full else 1
    return [_pallas(getattr(s["bkv"], f"kernel_{variant}"), ins,
                    specs + [_const_spec(x.shape) for x in flat],
                    jax.ShapeDtypeStruct((N, n_out), jnp.float32), _tile_spec(TILE, n_out))]


def _tpu_slab_bwd(s, variant):
    flat, saved = s["flat"], variant == "mm_bwd_saved"
    ins = [jnp.asarray(s["pos"])]
    specs = [_tile_spec(TILE, 3)]
    if saved:
        ins.append(jnp.asarray(s["acts"].float().numpy()).astype(jnp.bfloat16))
        specs.append(_tile_spec(TILE, vr.ACTS_COLS))
    shapes = [jax.ShapeDtypeStruct((N, 1), jnp.float32)]
    out_specs = [_tile_spec(TILE, 1)]
    if variant == "mm_fwd_save":
        shapes.append(jax.ShapeDtypeStruct((N, vr.ACTS_COLS), jnp.bfloat16))
        out_specs.append(_tile_spec(TILE, vr.ACTS_COLS))
    else:
        shapes += [jax.ShapeDtypeStruct((256, 256), jnp.float32)] * 8
        out_specs += [_const_spec((256, 256))] * 8
    outs = _pallas(getattr(s["bkv"], f"kernel_{variant}"), ins + flat,
                   specs + [_const_spec(x.shape) for x in flat], tuple(shapes), tuple(out_specs))
    return list(outs[:2]) if variant == "mm_fwd_save" else [outs[0], jnp.stack(outs[1:])]


def _tpu_composite(s, variant):
    pc, flat = s["pc"], s["flat"]
    ins, specs = [jnp.asarray(s["pos"])], [_tile_spec(TILE, 3)]
    rk = pl.BlockSpec((pc.RT, pc.KPAD), lambda i: (i, 0))
    if variant in ("reshape", "accmm"):
        ins.append(jnp.asarray(s["sd"]))
        specs.append(rk)
    elif variant == "colscan":
        ins.append(jnp.asarray(s["sd"].reshape(N, 1)))
        specs.append(_tile_spec(TILE, 1))
    if variant == "accmm":
        shape = jax.ShapeDtypeStruct((N // pc.KPAD, 8), jnp.float32)
        out_spec = pl.BlockSpec((pc.RT, 8), lambda i: (i, 0))
    else:
        shape, out_spec = jax.ShapeDtypeStruct((N, 1), jnp.float32), _tile_spec(TILE, 1)
    return [_pallas(getattr(pc, f"kernel_{variant}"), ins + flat,
                    specs + [_const_spec(x.shape) for x in flat], shape, out_spec)]


def _port(s, variant):
    pos = torch.from_numpy(s["pos"])
    if variant in vr.COMPOSITES:
        return [vr.run_composite(variant, s["kw"], pos, torch.from_numpy(s["sd"]), TILE)]
    out = vr.run(variant, s["kw"], s["sw"], pos, torch.from_numpy(s["emb"]), s["acts"], TILE)
    return list(out) if isinstance(out, tuple) else [out]


def _torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("variant", vr.VARIANTS + vr.COMPOSITES)
def test_plain_version_matches_the_tpu_body(setup, variant):
    s = setup
    if variant in ("mm_i8", "mm_i8_k512"):
        # int8(pos[tile's first row, 0]) truncates to 0 for |x| < 1, and a
        # chain of zeros would pass any int8 arithmetic: seed both tiles
        # with values that stay non-zero through the chain
        pos = s["pos"].copy()
        pos[0, 0], pos[TILE, 0] = 37.0, -90.0
        s = {**s, "pos": pos}
    if variant in vr.COMPOSITES:
        tpu = _tpu_composite(s, variant)
    elif variant in vr.SLAB_BWD:
        tpu = _tpu_slab_bwd(s, variant)
    else:
        tpu = _tpu_forward(s, variant)
    port = _port(s, variant)
    tpu = [_torch(t) for t in tpu]
    res = vr.check(variant, port, tpu)
    assert res["ok"], (variant, res)
    if variant == "mm_fwd_save":
        # at two tiles the out column is not negligible: held at the gate too
        assert res["out_rel_l2"] <= vr.REL_L2, res
    if variant in ("mm_i8", "mm_i8_k512"):
        assert bool(port[0].any()), res
    if variant in ("reshape", "colscan", "accmm"):
        # the epilogue alone, on the TPU body's own sigma
        sigma = _torch(_tpu_composite(s, "base")[0])[:, 0]
        got = vr.composite_epilogue(variant, sigma, torch.from_numpy(s["sd"]))
        assert vr.rel_l2(got, tpu[0]) <= vr.EPILOGUE_REL_L2


def test_both_clis_run_the_plain_versions_on_the_cpu(capsys):
    ms = kernel_variants.main(N, TILE, 1, ",".join(vr.VARIANTS), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(vr.VARIANTS)
    assert all("on the CPU" in ln for ln in lines) and set(ms) == set(vr.VARIANTS)
    ms = composite.main("all", N, TILE, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == list(vr.COMPOSITES) and set(ms) == set(
        vr.COMPOSITES)
    assert kernel_variants.parse(["8192", "2048", "3", "mm_only,trunk", "--device", "cpu"]) == {
        "n": 8192, "tile": 2048, "iters": 3, "only": "mm_only,trunk", "device": "cpu"}
    assert composite.parse(["accmm", "4096"]) == {"only": "accmm", "n": 4096}
