"""Meshes of processes over torch.distributed: a ('data', 'view') mesh
and a ('data', 'space') pipeline mesh.

Axes, as in the reference package's fvp_tpu/parallel/mesh.py and
spatial.py:
  'data'  -- batch (data parallelism; frames are independent)
  'view'  -- cameras (each rank holds a subset of the views' backbone and
             volume sampling; the whole-space volume's view mean becomes an
             all-reduce over this axis)
  'space' -- voxel x-rows (each rank holds a row block of the whole-space
             volume and BEV maps; windowed ops exchange seam rows with the
             neighbouring blocks, parallel/spatial.py)

The reference runs one process per host and lets GSPMD place the
collectives; here each rank is one process, the torch idiom, and the
collectives are explicit (`Mesh.all_reduce_sum`, `all_gather`,
`broadcast`, and spatial.py's row exchange). A `Mesh` holds this rank's
coordinates and one process group per data row (its group along the
second axis) and per column (its 'data' group). Ranks past n_data * n_2
take part in no group's work: they are idle, as the reference's
`make_mesh` leaves the devices past `devices[:n]`.

The collectives run on the group's backend. A gloo group of CUDA ranks
(ranks sharing one card) gets host copies of its tensors, made here
explicitly and counted in `Mesh.staged_bytes` (a gloo group of one rank
copies nothing: its collectives are the identity); NCCL groups take the
card's tensors as they are.

`torch.distributed.device_mesh` is not used: its API differs between
PyTorch releases, and for CUDA it picks NCCL and one card per rank, which
ranks that share one card cannot have.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

# a rank that dies fails its peers' next collective after this long,
# rather than hanging them
TIMEOUT = datetime.timedelta(seconds=120)


def pick_mesh_shape(n_devices: int, num_views: int = 0) -> tuple[int, int]:
    """(data, view) factorization of n_devices. Prefers a view axis that
    divides the camera count; falls back to pure data parallelism."""
    for view in range(min(n_devices, max(num_views, 1)), 0, -1):
        if n_devices % view == 0 and (num_views == 0
                                      or num_views % view == 0):
            return n_devices // view, view
    return n_devices, 1


def free_port() -> int:
    """A TCP port free on 127.0.0.1 now: a coordinator for a job of this
    host's ranks alone."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_backend(device: torch.device, local_ranks: int,
                 n_cards: int) -> str:
    """The process group's backend, from the ranks' device: NCCL for CUDA
    ranks on distinct cards (at most one rank a card on this host), gloo
    for CPU ranks and for CUDA ranks that share a card (NCCL refuses two
    ranks on one GPU; sharding.py then stages CUDA tensors through host
    memory)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_ranks <= n_cards else "gloo"


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device, local_ranks: int = 1) -> str:
    """Join the job of `num_processes` ranks whose rank 0 listens at
    `coordinator` ('host:port'), as rank `process_id`, on `device`, with
    `local_ranks` ranks of the job on this host; the counterpart of the
    reference's jax.distributed.initialize. Returns the backend."""
    device = torch.device(device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = pick_backend(device, local_ranks, n_cards)
    if device.type == "cuda":
        # the kernels launch on the current device's stream
        torch.cuda.set_device(device.index if device.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    return backend


def staged(t: torch.Tensor, group) -> bool:
    """Whether a collective of `group` takes `t` through host memory: a
    CUDA tensor in a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


@dataclasses.dataclass
class Mesh:
    """This rank's place in an (n_data, n) mesh of ranks r = d * n + i,
    its second axis named `axis_names[1]` ('view' or 'space'). `groups`
    maps an axis name to the process group of the ranks that share this
    rank's other coordinate (empty on an idle rank). `staged_bytes` counts
    the bytes that the collectives copied between the card and host
    memory (gloo groups of CUDA ranks)."""

    shape: tuple[int, int]
    rank: int
    groups: dict = dataclasses.field(default_factory=dict)
    axis_names: tuple[str, str] = ("data", "view")
    staged_bytes: int = 0

    @property
    def active(self) -> bool:
        return self.rank < self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple[int, int] | None:
        """(data index, index on the second axis), or None on an idle
        rank."""
        return divmod(self.rank, self.shape[1]) if self.active else None

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along `axis`, in order."""
        d, i = self.coords
        n_data, n = self.shape
        if axis == self.axis_names[1]:
            return [d * n + j for j in range(n)]
        if axis != "data":
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        return [j * n + i for j in range(n_data)]

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def _alone(self, t: torch.Tensor, axis: str) -> bool:
        """Whether a collective of `t` along `axis` is the identity and
        would only copy through host memory: a gloo group of one CUDA
        rank."""
        return self.size(axis) == 1 and staged(t, self.groups[axis])

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of `t` over the ranks of this rank's `axis` group."""
        group = self.groups[axis]
        if self._alone(t, axis):
            return t
        if not staged(t, group):
            t = t.contiguous()
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            return t
        host = t.contiguous().cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        self.staged_bytes += 2 * host.nbytes
        return host.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int,
                   axis: str) -> torch.Tensor:
        """The ranks' `t` of this rank's `axis` group, concatenated along
        `dim` in the group's rank order."""
        group = self.groups[axis]
        if self._alone(t, axis):
            return t
        src = t.contiguous()
        src = src.cpu() if staged(t, group) else src
        parts = [torch.empty_like(src) for _ in range(self.size(axis))]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        if src.device == t.device:
            return out
        self.staged_bytes += src.nbytes + out.nbytes
        return out.to(t.device)

    def broadcast(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The first rank's `t` of this rank's `axis` group, on every
        rank."""
        group = self.groups[axis]
        src = self.axis_ranks(axis)[0]
        if self._alone(t, axis):
            return t
        if not staged(t, group):
            t = t.contiguous()
            dist.broadcast(t, src, group=group)
            return t
        host = t.contiguous().cpu()
        dist.broadcast(host, src, group=group)
        self.staged_bytes += 2 * host.nbytes
        return host.to(t.device)


def _make(n_data: int, n: int, axis_names: tuple[str, str]) -> Mesh:
    """This rank's (n_data, n) mesh over the initialised default group.
    Every rank calls `new_group` for every row and column, in the same
    order, as torch requires, idle ranks included: so one job can build
    several meshes, each rank in the same order."""
    world = dist.get_world_size()
    if world < n_data * n:
        raise ValueError(f"a ({n_data}, {n}) mesh needs {n_data * n} ranks;"
                         f" the job has {world}")
    mesh = Mesh((n_data, n), dist.get_rank(), axis_names=axis_names)
    rows = [dist.new_group([d * n + i for i in range(n)])
            for d in range(n_data)]
    cols = [dist.new_group([d * n + i for d in range(n_data)])
            for i in range(n)]
    if mesh.active:
        d, i = mesh.coords
        mesh.groups = {axis_names[1]: rows[d], "data": cols[i]}
    return mesh


def make_mesh(n_data: int, n_view: int) -> Mesh:
    """This rank's ('data', 'view') mesh of (n_data, n_view) ranks."""
    return _make(n_data, n_view, ("data", "view"))


def make_pipeline_mesh(n_data: int, n_space: int) -> Mesh:
    """This rank's ('data', 'space') mesh for the spatially sharded eval
    pipeline: batch over 'data', whole-space voxel x-rows over 'space'."""
    return _make(n_data, n_space, ("data", "space"))


def make_spatial_mesh(n_blocks: int) -> Mesh:
    """A (1, n_blocks) 'space' mesh: the x-rows over every rank."""
    return make_pipeline_mesh(1, n_blocks)


def spatial_size(mesh: Mesh | None) -> int:
    """Number of voxel-row blocks (the 'space' extent; 1 = not sharded)."""
    if mesh is None or "space" not in mesh.axis_names:
        return 1
    return mesh.size("space")


@dataclasses.dataclass
class Axis:
    """One axis of this rank's mesh, as the modules that reduce over it
    take it (models/blocks.py's train-mode BatchNorms and
    models/faster_voxelpose.py::compute_losses over 'data')."""

    mesh: Mesh
    name: str

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce_sum(t, self.name)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.mesh.all_gather(t, dim, self.name)
