"""The plain forwards' streamed design without a card: the property its
skip rests on (a sample with deltam = 0 changes no bit of the camera,
shadow or coarse output, whatever its z), the plan that ops/fused_render.py
mirrors (``stream_fwd_plan``: rows only for the samples with deltam != 0,
whole rays a block, rays straddling tiles) on the main path's shapes, the
weight stream's image and the workspace's layout. No JAX and no card; the
whole file runs in about two seconds."""

import numpy as np
import pytest
import torch

from eonerf_code_tpu_torch.ops import fused_field as ff
from eonerf_code_tpu_torch.ops import fused_render as fr

SMS = 132   # an H100 SXM
THREADS = 1024   # fs_scan_kernel's block


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    mats = torch.from_numpy(rng.normal(0.0, 0.06, ff.MAT_ELEMENTS).astype(np.float32))
    biases = torch.from_numpy(rng.normal(0.0, 0.05, ff.BIAS_ELEMENTS).astype(np.float32))
    return ff.KernelWeights(mats.to(torch.bfloat16), biases)


def _cube_rays(r, k, seed, shadow=False):
    """Rays through the unit cube as the render samples them: z on [0, 2]
    from a start above or beside the cube, the cube mask, deltam = delta x
    mask (the camera's last valid sample carries the 1e10 sentinel), some
    rays missing the cube entirely."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.3, 1.3, (r, 3)).astype(np.float32)
    o[:, 2] = 0.2 if shadow else 1.05
    d = rng.normal(size=(r, 3)).astype(np.float32) * np.float32(0.3)
    d[:, 2] = 1.0 if shadow else -1.0   # shadow rays leave toward the sun
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    z = np.sort(rng.uniform(0.0, 2.0, (r, k)), axis=1).astype(np.float32)
    pos = o[:, None, :] + d[:, None, :] * z[..., None]
    mask = (np.abs(pos) <= 1.0).all(axis=-1)
    delta = np.diff(z, axis=1, append=np.float32(2.0)).astype(np.float32)
    if not shadow:   # the sentinel on each ray's last valid sample
        last = k - 1 - np.argmax(mask[:, ::-1], axis=1)
        rows = np.flatnonzero(mask.any(axis=1))
        delta[rows, last[rows]] = 1e10
    emb = rng.normal(size=(r, 4)).astype(np.float32)
    rayin = np.hstack([o, d, emb, np.zeros((r, 6), np.float32)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    return t(rayin), t(z), t(delta * mask), t(mask)


@pytest.mark.parametrize("op", ["camera", "shadow", "coarse"])
def test_samples_with_zero_deltam_change_no_bit(op):
    """The skip's premise: the plain version's output is the same bits when
    the z of every sample with deltam = 0 (outside the cube, padding) is
    drawn anew."""
    kw = _weights()
    rayin, z, deltam, mask = _cube_rays(6, 24, seed=3, shadow=op == "shadow")
    assert 0 < int((deltam == 0).sum()) < deltam.numel()
    z2 = torch.where(deltam == 0, torch.rand(z.shape, generator=torch.Generator().manual_seed(1))
                     * 2.0, z)
    assert not torch.equal(z, z2)
    call = {"camera": lambda zz: fr.camera_forward_reference(kw, rayin, zz, deltam),
            "shadow": lambda zz: fr.shadow_forward_reference(kw, rayin, zz, deltam, mask),
            "coarse": lambda zz: fr.coarse_forward_reference(kw, rayin, zz, deltam)}[op]
    assert torch.equal(call(z), call(z2))


def _composite_all(op, sig, res, z, dm, mask):
    """fused_fwd_kernel's per-ray sums in float32, one ray, every sample
    visited (res[k]: the sample's [sigma, albedo x3, t_s, t_beta])."""
    f = np.float32
    if op == "camera":
        excl, a = f(0), [f(0)] * 7
        for k in range(len(z)):
            sd = f(sig[k] * dm[k])
            wgt = f(np.exp(-excl, dtype=f) * f(f(1) - np.exp(-sd, dtype=f)))
            vals = [z[k], *res[k][1:6], f(1)]
            a = [f(a[c] + f(wgt * vals[c])) for c in range(7)]
            excl = f(excl + sd)
        return a
    if op == "coarse":
        excl, w = f(0), []
        for k in range(len(z)):
            sd = f(sig[k] * dm[k])
            w.append(f(np.exp(-excl, dtype=f) * f(f(1) - np.exp(-sd, dtype=f))))
            excl = f(excl + sd)
        return w
    remaining, ev = f(mask.sum(dtype=f)), f(0)
    for k in range(len(z)):
        if remaining >= 2:
            ev = f(ev + f(sig[k] * dm[k]))
        remaining = f(remaining - mask[k])
    return [np.exp(-ev, dtype=f)]


def _composite_rows(op, rows, res, z, dm, mask):
    """stream_fwd_kernel's per-ray sums: only the ray's rows (its samples
    with deltam != 0, `rows` their sample indices, res their results)."""
    f = np.float32
    if op == "camera":
        excl, a = f(0), [f(0)] * 7
        for i, k in enumerate(rows):
            sd = f(res[i][0] * dm[k])
            wgt = f(np.exp(-excl, dtype=f) * f(f(1) - np.exp(-sd, dtype=f)))
            vals = [z[k], *res[i][1:6], f(1)]
            a = [f(a[c] + f(wgt * vals[c])) for c in range(7)]
            excl = f(excl + sd)
        return a
    if op == "coarse":
        excl, w, i = f(0), [], 0
        for k in range(len(z)):
            wk = f(0)
            if dm[k] != 0:
                sd = f(res[i][0] * dm[k])
                i += 1
                wk = f(np.exp(-excl, dtype=f) * f(f(1) - np.exp(-sd, dtype=f)))
                excl = f(excl + sd)
            w.append(wk)
        return w
    remaining, ev, i = f(mask.sum(dtype=f)), f(0), 0
    for k in range(len(z)):
        if dm[k] != 0:
            if remaining >= 2:
                ev = f(ev + f(res[i][0] * dm[k]))
            i += 1
        remaining = f(remaining - mask[k])
    return [np.exp(-ev, dtype=f)]


@pytest.mark.parametrize("op", ["camera", "shadow", "coarse"])
def test_row_sums_skip_exactly(op):
    """The kernel's per-ray sums over a ray's rows alone give the bits of
    the sums over all its samples (each skipped term an exact zero), rays
    with no row included (camera zeros, shadow 1, coarse weights 0)."""
    rng = np.random.default_rng(7)
    _, z, deltam, mask = _cube_rays(12, 40, seed=11, shadow=op == "shadow")
    z, dm, mask = z.numpy(), deltam.numpy(), mask.numpy().astype(np.float32)
    res = rng.uniform(0.01, 3.0, (12, 40, 6)).astype(np.float32)
    assert (dm == 0).all(axis=1).any() and (dm != 0).any()
    for r in range(12):
        rows = np.flatnonzero(dm[r] != 0)
        want = _composite_all(op, res[r, :, 0], res[r], z[r], dm[r], mask[r])
        got = _composite_rows(op, rows, res[r, rows], z[r], dm[r], mask[r])
        assert np.array_equal(np.array(want, np.float32), np.array(got, np.float32)), r


def _scan_as_the_kernel(counts, blocks):
    """fs_scan_kernel's arithmetic: THREADS segments of ceil(R / THREADS)
    rays, each thread's rays' prefix and the blocks whose first row falls
    in (rows before r - 1, rows before r]."""
    r = len(counts)
    m = -(-r // THREADS)
    prefix = np.zeros(r + 1, np.int64)
    prefix[1:] = np.cumsum(counts)
    total = int(prefix[-1])
    target = max(1, -(-total // blocks))
    ray_start = np.full(blocks + 1, r, np.int64)
    for t in range(THREADS):
        lo, hi = min(r, t * m), min(r, t * m + m)
        run = int(prefix[lo])
        before = run - int(counts[lo - 1]) if lo > 0 else 0
        for ray in range(lo, hi):
            if ray == 0:
                ray_start[0] = 0
            else:
                for b in range(before // target + 1, min(blocks - 1, run // target) + 1):
                    ray_start[b] = ray
            before = run
            run += int(counts[ray])
    return prefix, ray_start


# the main path's calls: a render chunk's camera (K=127, and 143 after
# sample_pdf) and shadow (K=63) rays, a training batch's camera rays
MAIN_SHAPES = [("camera_k127", 4096, 127, False), ("camera_k143", 4096, 143, False),
               ("shadow_k63", 4096, 63, True), ("batch_k127", 1024, 127, False)]


@pytest.mark.parametrize("name,r,k,shadow", MAIN_SHAPES)
def test_plan_on_the_main_path_shapes(name, r, k, shadow):
    """The mirror's plan: rows are the samples with deltam != 0 in ray and
    sample order; the blocks own whole, consecutive rays, together every
    ray once, about the same rows each (at most one ray's samples past the
    share); tiles are 128 rows of a block's range, a ray straddling two
    of them where its rows cross a tile edge; rays with no sample in the
    cube own no row. The scan kernel's own arithmetic gives the same plan."""
    _, z, deltam, _ = _cube_rays(r, k, seed=r + k, shadow=shadow)
    kpad = fr.kpad_of(k)
    dm = torch.nn.functional.pad(deltam, (0, kpad - k))
    plan = fr.stream_fwd_plan(dm, SMS)
    nz = dm != 0
    total = int(nz.sum())
    assert torch.equal(plan["counts"], nz.sum(1))
    assert int(plan["prefix"][-1]) == total == len(plan["meta"])
    assert torch.equal(plan["meta"], nz.nonzero())
    starts = plan["ray_start"]
    assert int(starts[0]) == 0 and int(starts[-1]) == r and bool((starts[1:] >= starts[:-1]).all())
    share = -(-total // SMS)
    assert int(plan["rows"].sum()) == total and int(plan["rows"].max()) <= share + kpad
    assert torch.equal(plan["tiles"], -(-plan["rows"] // 128))
    prefix, ray_start = _scan_as_the_kernel(plan["counts"].numpy(), SMS)
    assert np.array_equal(prefix, plan["prefix"].numpy())
    assert np.array_equal(ray_start, starts.numpy())
    # rays with no row, and rays whose rows straddle a tile edge of their block
    assert bool((plan["counts"] == 0).any())
    straddle = 0
    for b in range(SMS):
        lo, hi = int(starts[b]), int(starts[b + 1])
        base = int(plan["prefix"][lo])
        first = (plan["prefix"][lo:hi] - base) // 128
        last = (plan["prefix"][lo + 1:hi + 1] - base - 1) // 128
        straddle += int(((plan["counts"][lo:hi] > 0) & (last > first)).sum())
    assert straddle > 0
    # the in-cube share the skip leaves: the shadow's about a quarter
    share_in = total / (r * kpad)
    assert (share_in < 0.5) if shadow else (share_in > 0.5)


def test_plan_edges():
    """No row at all (every block empty but the first, which owns every
    ray), fewer rows than blocks, one ray holding every row."""
    empty = fr.stream_fwd_plan(torch.zeros((5, 16)), SMS)
    assert empty["ray_start"].tolist() == [0] + [5] * SMS and int(empty["tiles"].sum()) == 0
    few = torch.zeros((300, 8))
    few[[3, 200], 2] = 1.0
    plan = fr.stream_fwd_plan(few, SMS)
    assert int(plan["rows"].sum()) == 2 and int((plan["rows"] > 0).sum()) == 2
    assert np.array_equal(_scan_as_the_kernel(plan["counts"].numpy(), SMS)[1],
                          plan["ray_start"].numpy())
    one = torch.zeros((4, 1024))
    one[2] = 0.5
    plan = fr.stream_fwd_plan(one, SMS)
    assert int(plan["rows"].max()) == 1024 and int(plan["tiles"].sum()) == 8


def _stream_as_the_kernel(mats, camera):
    """fs_count_kernel's weight-stream arithmetic, vectorized: each 16-byte
    unit's layer, output row and first input."""
    shapes = ff._MAT_SHAPES
    offs = np.concatenate([[0], np.cumsum([a * b for a, b in shapes])])
    kdim = [64, 256, 256, 256, 256, 320, 256, 256, 256, 320, 128, 128, 128]
    wide = [True] * 10 + [False] * 3
    nlayers = 13 if camera else 8
    chunks = [kdim[i] // (32 if wide[i] else 64) for i in range(nlayers)]
    starts = np.concatenate([[0], np.cumsum(chunks)])
    v = np.arange(starts[-1] * 1024)
    q, u = v // 1024, v % 1024
    i = np.searchsorted(starts, q, side="right") - 1
    h, o = u >> 9, (u & 511) * 16
    nl = o >> 6
    kk = ((o & 63) >> 4) ^ ((nl >> 1) & 3)
    kc = q - starts[i]
    w = np.array(wide)[i]
    n = np.where(w, h * 128 + nl, nl)
    k = np.where(w, kc * 32 + kk * 8, kc * 64 + h * 32 + kk * 8)
    kd = np.array(kdim)[i]
    off = np.where(i < 8, offs[np.minimum(i, 7)] + n * kd + k, 0)
    off = np.where(i == 8, offs[9] + n * 256 + k, off)
    off = np.where((i == 9) & (n >= 128), offs[12] + (n - 128) * 320 + k, off)
    off = np.where((i == 9) & (n < 128), offs[10] + n * 256 + k, off)
    off = np.where(i >= 10, offs[13] + (i - 10) * 16384 + n * 128 + k, off)
    zero = (i == 9) & (n < 128) & (k >= 256)
    flat = mats.numpy()
    vals = flat[np.minimum(off[:, None] + np.arange(8), len(flat) - 1)]
    vals[zero] = 0
    return vals.reshape(-1, 8192)


@pytest.mark.parametrize("camera", [True, False])
def test_weight_stream_image(camera):
    """The weight stream the mirror builds is the kernel's arithmetic's, its
    chunk count the library's; every packed weight a layer reads appears
    exactly once a tile (the albedo rows padded with zeros)."""
    mats = torch.arange(1, ff.MAT_ELEMENTS + 1, dtype=torch.float64)
    got = fr.stream_fwd_weights(mats, camera)
    assert got.shape == (fr.STREAM_CHUNKS[camera], 8192)
    assert np.array_equal(got.numpy(), _stream_as_the_kernel(mats, camera))
    seen = got[got > 0].long() - 1
    assert len(torch.unique(seen)) == len(seen)
    sizes = [a * b for a, b in ff._MAT_SHAPES]
    read = sizes[:8] + ([sizes[9], sizes[10], sizes[12], *sizes[13:16]] if camera else [])
    assert len(seen) == sum(read)
    assert int((got == 0).sum()) == (128 * 64 if camera else 0)


def test_workspace_layout():
    """Each part 256-byte aligned and big enough: the stream's chunks, eight
    floats (camera) or one a row of results, a (ray, sample) pair a row."""
    for camera in (True, False):
        for r, kpad in ((4096, 128), (4096, 144), (1021, 64), (1, 8)):
            lay = fr.stream_fwd_layout(camera, r, kpad)
            offs = [lay[k] for k in ("stream", "res", "meta", "cnt", "prefix", "ray_start",
                                     "total")]
            assert all(o % 256 == 0 for o in offs) and offs == sorted(offs)
            rows = r * kpad
            assert lay["res"] - lay["stream"] >= fr.STREAM_CHUNKS[camera] * 16384
            assert lay["meta"] - lay["res"] >= rows * (8 if camera else 1) * 4
            assert lay["cnt"] - lay["meta"] >= rows * 8
            assert lay["total"] - lay["ray_start"] >= (fr.STREAM_MAX_BLOCKS + 1) * 4
