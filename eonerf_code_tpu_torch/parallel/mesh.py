"""Data parallelism over the ray batch, and scene parallelism over
independent AOI models, as the JAX package's parallel/mesh.py lays out its
("scene", "data") mesh.

One process a card. Every process holds the whole ray pool and a replica
of the parameters and the optimizer; each step every rank renders its
contiguous share of the global batch (:func:`shard_rows`, the rows
``P("data")`` gives a device), the gradients and the step's loss values
are summed in one collective over a flat buffer (:meth:`Mesh.all_reduce_`),
the step's only one, and every rank applies the same update. Where GSPMD inserts the psum into
the JAX mesh step, the port calls it.

The "scene" axis (multi-AOI training, parallel/multi_aoi.py: one model an
AOI): ``scene x data`` ranks, rank r in scene group ``r // data`` at data
index ``r % data``. Each scene group's data ranks share a process group,
over which the gradient all-reduce, the broadcasts and ``gather_rows`` run;
the ranks at one data index across the scene groups share another, over
which ``gather_rows(..., axis="scene")`` brings the per-scene values (the
losses, the occupied fractions, a pod checkpoint's state) to every rank.
Every rank creates every group, in the same order. At ``scene = 1`` there
is no group besides the default one, and the data axis is the whole world.

Process groups (:func:`backend_for`, from the device alone): NCCL where
each rank has a card of its own (``device="cuda"``, or one rank on
``"cuda:K"``); gloo on the CPU, and for ranks that share card K
(``"cuda:K"``), which NCCL refuses. Nothing falls back: a group that fails
to form raises, and too few cards for the ranks asked raises
``ValueError``.

:func:`launch` is the entry: under ``torchrun`` it joins the launcher's
group, else it spawns one worker a rank with a ``file://`` rendezvous in a
temporary directory (no TCP port to collide on).
"""

import contextlib
import dataclasses
import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist

# the collective timeout: the other ranks wait at a barrier while rank 0
# validates or checkpoints, which on a real AOI (five views of up to 2048 x
# 2048 rays, registered against the lidar DSM) can outlast PyTorch's
# default of ten minutes
TIMEOUT_S = 3600.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the ("scene", "data") mesh: the axis sizes,
    its rank on the data axis (``rank``) and on the scene axis
    (``scene_rank``), its device, whether a process group stands behind it
    (``distributed``; a world-1 group still runs its collectives, so world 1
    over NCCL is the single-process run through the data-parallel path), and
    the groups of its two axes (None: the default group for the data axis,
    no collective for a scene axis of 1)."""

    shape: dict
    rank: int
    device: torch.device
    distributed: bool = False
    scene_rank: int = 0
    data_group: object = None
    scene_group: object = None

    @classmethod
    def single(cls, device="cpu"):
        return cls({"scene": 1, "data": 1}, 0, torch.device(device))

    @property
    def backend(self):
        return dist.get_backend() if self.distributed else None

    @property
    def world(self):
        return self.shape["data"]

    @property
    def global_rank(self):
        return self.scene_rank * self.shape["data"] + self.rank

    @property
    def is_main(self):
        """Rank 0 of this process's data axis (of its scene group)."""
        return self.rank == 0

    @property
    def is_root(self):
        """Rank 0 of the whole mesh."""
        return self.global_rank == 0

    def barrier(self):
        if not self.distributed:
            return
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    @contextlib.contextmanager
    def main_first(self):
        """Rank 0 runs the block first (it writes the caches the block
        builds), then the other ranks (they read them)."""
        if self.distributed and not self.is_main:
            self.barrier()
        yield
        if self.distributed and self.is_main:
            self.barrier()

    def all_reduce_(self, tensors):
        """Sum ``tensors`` over the data axis in place: one flat buffer and
        one collective for each dtype among them."""
        if not self.distributed:
            return
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.data_group)
            offset = 0
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()

    def broadcast_(self, tensors, src=0):
        """Overwrite ``tensors`` (any dtypes, one device) with data rank
        ``src``'s of this scene group, bit for bit: their bytes in one
        buffer, one collective."""
        if not self.distributed:
            return
        flat = torch.cat([_bytes(t) for t in tensors])
        dist.broadcast(flat, self.scene_rank * self.shape["data"] + src, group=self.data_group)
        offset = 0
        for t in tensors:
            n = t.numel() * t.element_size()
            t.copy_(flat[offset:offset + n].clone().view(t.dtype).view_as(t))
            offset += n

    def gather_rows(self, local, start, n_rows, axis="data"):
        """{key: (n_rows, ...)} on every rank from each rank's ``local``
        {key: (m, ...)} rows placed at ``start``, over the ranks of one
        ``axis`` ("data": this scene group's; "scene": the ranks at this
        data index, one a scene group), bit for bit: each rank writes its
        rows' bytes into a zeroed buffer and the buffers are summed (an
        all-reduce: gloo reduces CUDA tensors but does not gather them).
        Every rank passes the same keys, row shapes and dtypes."""
        keys = sorted(local)
        widths = [math.prod(local[k].shape[1:]) * local[k].element_size() for k in keys]
        buf = torch.zeros(n_rows * sum(widths), dtype=torch.uint8, device=self.device)
        offset = 0
        for k, w in zip(keys, widths):
            v = local[k]
            if v.shape[0]:
                seg = buf[offset:offset + n_rows * w].view(n_rows, w)
                seg[start:start + v.shape[0]] = _bytes(v).view(v.shape[0], w)
            offset += n_rows * w
        if self.distributed and (axis == "data" or self.shape["scene"] > 1):
            dist.all_reduce(buf, group=self.data_group if axis == "data" else self.scene_group)
        out, offset = {}, 0
        for k, w in zip(keys, widths):
            v = local[k]
            out[k] = (buf[offset:offset + n_rows * w].clone().view(v.dtype)
                      .view(n_rows, *v.shape[1:]))
            offset += n_rows * w
        return out


def _bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def shard_rows(x, rank, world):
    """Rank ``rank``'s contiguous rows of ``x`` (the global batch), as
    ``P("data")`` places a batch on a ``world``-device data axis."""
    if x.shape[0] % world:
        raise ValueError(f"{x.shape[0]} rows do not divide over {world} ranks")
    rows = x.shape[0] // world
    return x[rank * rows:(rank + 1) * rows]


def _visible(device):
    return torch.cuda.device_count() if device.type == "cuda" else 1


def resolve_world(data_axis, device="cuda", scene_axis=1):
    """The number of processes a ``scene_axis`` x ``data_axis`` mesh asks for
    on ``device``: ``data_axis`` -1 or 0 takes the visible cards (one on the
    CPU) left to each scene group, at least one. Each rank takes its own
    card under ``device="cuda"``, so more ranks than visible cards raise
    ``ValueError``; ``"cuda:K"`` puts every rank on card K."""
    dev = torch.device(device)
    visible = _visible(dev)
    if scene_axis < 1:
        raise ValueError(f"scene_axis={scene_axis}: a count >= 1")
    n = scene_axis * (max(visible // scene_axis, 1) if data_axis in (-1, 0) else data_axis)
    if n < 1:
        raise ValueError(f"data_axis={data_axis}: -1 or 0 (every visible card) or a count >= 1")
    if dev.type == "cuda" and dev.index is None and n > visible:
        raise ValueError(f"{_axes(n // scene_axis, scene_axis)} but only {visible} CUDA devices "
                         "visible (one process a card; pass device='cuda:0' to share one)")
    return n


def _axes(data_axis, scene_axis):
    """The axes as an error message names them."""
    if scene_axis == 1:
        return f"data_axis={data_axis}"
    return f"scene_axis={scene_axis} x data_axis={data_axis}"


def backend_for(device, world):
    """The process group's backend: NCCL where each rank has a card of its
    own (``"cuda"``, or a world of 1), gloo on the CPU and for ``world`` > 1
    ranks sharing card K (``"cuda:K"``: NCCL takes one card a rank)."""
    dev = torch.device(device)
    if dev.type == "cpu" or (dev.index is not None and world > 1):
        return "gloo"
    return "nccl"


def current(data_axis, device="cuda", scene_axis=1):
    """The mesh a trainer or an eval run at ``data_axis`` (and, multi-AOI,
    ``scene_axis``) works on: world 1 when both are 1; else the process
    group this process belongs to, which must have ``scene_axis`` x
    ``data_axis`` ranks (``data_axis`` -1 and 0 take the rest of the
    group); without a group only a mesh that resolves to one process runs.
    Raises ``ValueError`` otherwise."""
    dev = torch.device(device)
    if data_axis == 1 and scene_axis == 1:
        return Mesh.single(dev)
    if dist.is_initialized():
        world = dist.get_world_size()
        if world % scene_axis or (data_axis not in (-1, 0)
                                  and data_axis * scene_axis != world):
            raise ValueError(f"{_axes(data_axis, scene_axis)} but the process group has {world} "
                             "ranks")
        if dev.type == "cuda" and dist.get_backend() == "nccl" and _visible(dev) < world:
            raise ValueError(f"{_axes(world // scene_axis, scene_axis)} but only {_visible(dev)} "
                             "CUDA devices visible")
        return _group_mesh(dist.get_rank(), world, dev, scene_axis)
    n = resolve_world(data_axis, dev, scene_axis)
    if n != 1:
        raise ValueError(f"{_axes(data_axis, scene_axis)} asks for {n} processes: start them "
                         "with parallel.mesh.launch, torchrun, or --data_axis on the command "
                         "line")
    return Mesh.single(dev)


# the axis groups of the current process group, by (scene, data): created
# once, by every rank, in the same order
_AXIS_GROUPS = {}


def _group_mesh(rank, world, device, scene_axis):
    """The :class:`Mesh` of global rank ``rank`` in a ``world``-rank group
    laid out as ``scene_axis`` scene groups of ``world // scene_axis`` data
    ranks."""
    if world % scene_axis:
        raise ValueError(f"{world} ranks do not divide into {scene_axis} scene groups")
    data = world // scene_axis
    if scene_axis == 1:
        return Mesh({"scene": 1, "data": world}, rank, device, distributed=True)
    key = (scene_axis, data)
    if key not in _AXIS_GROUPS:
        _AXIS_GROUPS[key] = (
            [dist.new_group([s * data + d for d in range(data)]) for s in range(scene_axis)],
            [dist.new_group([s * data + d for s in range(scene_axis)]) for d in range(data)])
    data_groups, scene_groups = _AXIS_GROUPS[key]
    s, d = divmod(rank, data)
    return Mesh({"scene": scene_axis, "data": data}, d, device, distributed=True, scene_rank=s,
                data_group=data_groups[s], scene_group=scene_groups[d])


def setup(rank, world, init_method, device="cuda", local_rank=None, scene_axis=1):
    """Join the process group as ``rank`` of ``world`` and return this
    process's :class:`Mesh` (``scene_axis`` scene groups). ``device="cuda"``
    takes card ``local_rank`` (default ``rank``); an explicit ``"cuda:K"``
    or ``"cpu"`` is kept. The backend is :func:`backend_for` the device
    asked for."""
    backend = backend_for(device, world)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank if local_rank is None else local_rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return _group_mesh(rank, world, dev, scene_axis)


def teardown():
    _AXIS_GROUPS.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def _under_launcher():
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def launch(fn, kwargs, data_axis, device="cuda", scene_axis=1):
    """Run ``fn(device=<the rank's device>, **kwargs)`` on every rank of a
    ``scene_axis`` x ``data_axis`` mesh (:func:`resolve_world`) and return
    {global rank: result} for the ranks this process ran or started.

    - Under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` set): join the
      launcher's group (``env://``), run this rank, return {rank: result}.
    - One process: ``fn`` here, no group.
    - Else spawn one worker a rank (``fn`` and ``kwargs`` are pickled) with
      a ``file://`` rendezvous, after building the native host library
      (and on the card the kernels) here, so the workers do not each run
      g++ or nvcc; every rank's result (on the CPU) comes back. A worker that raises makes this raise."""
    if _under_launcher():
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world % scene_axis or (data_axis not in (-1, 0) and data_axis * scene_axis != world):
            raise ValueError(f"{_axes(data_axis, scene_axis)} but the launcher started {world} "
                             "processes")
        mesh = setup(rank, world, "env://", device,
                     local_rank=int(os.environ.get("LOCAL_RANK", rank)), scene_axis=scene_axis)
        try:
            from eonerf_code_tpu_torch import native
            from eonerf_code_tpu_torch.ops import _build

            with mesh.main_first():
                native.build()
                if mesh.device.type == "cuda":
                    _build.build()
            return {rank: _run_rank(mesh, fn, kwargs)}
        finally:
            teardown()
    n = resolve_world(data_axis, device, scene_axis)
    if n == 1:
        return {0: fn(device=device, **kwargs)}
    from eonerf_code_tpu_torch import native
    from eonerf_code_tpu_torch.ops import _build

    native.build()
    if torch.device(device).type == "cuda":
        _build.build()
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory(prefix="eonerf_dp_") as tmp:
        torch.multiprocessing.start_processes(
            _worker, args=(n, f"file://{os.path.join(tmp, 'rendezvous')}", device, threads,
                           tmp, fn, kwargs, scene_axis),
            nprocs=n, join=True, start_method="spawn")
        return {r: torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu",
                              weights_only=False)
                for r in range(n)}


def _worker(rank, world, init_method, device, threads, out_dir, fn, kwargs, scene_axis=1):
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    mesh = setup(rank, world, init_method, device, scene_axis=scene_axis)
    try:
        torch.save(_run_rank(mesh, fn, kwargs), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        teardown()


def _run_rank(mesh, fn, kwargs):
    """``fn`` on this rank; the group is left only when every rank is done."""
    result = fn(device=mesh.device, **kwargs)
    mesh.barrier()
    return result
