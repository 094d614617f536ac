"""A ('data', 'view') mesh of processes over torch.distributed.

Axes, as in the reference package's fvp_tpu/parallel/mesh.py:
  'data' -- batch (data parallelism; frames are independent)
  'view' -- cameras (each rank holds a subset of the views' backbone and
            volume sampling; the whole-space volume's view mean becomes an
            all-reduce over this axis)

The reference runs one process per host and lets GSPMD place the
collectives; here each rank is one process, the torch idiom, and the
collectives are explicit (sharding.py). A `Mesh` holds this rank's
coordinates and one process group per data row (its 'view' group) and per
view column (its 'data' group). Ranks past n_data * n_view take part in
no group's work: they are idle, as the reference's `make_mesh` leaves the
devices past `devices[:n]`.

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


@dataclasses.dataclass
class Mesh:
    """This rank's place in an (n_data, n_view) mesh of ranks r = d *
    n_view + v. `groups` maps an axis name to the process group of the
    ranks that share this rank's other coordinate (empty on an idle
    rank). `staged_bytes` counts the
    bytes that sharding.py's collectives copied between the card and host
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
        """(data index, view index), or None on an idle rank."""
        return divmod(self.rank, self.shape[1]) if self.active else None

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's group along `axis`, in order."""
        d, v = self.coords
        n_data, n_view = self.shape
        if axis == "view":
            return [d * n_view + i for i in range(n_view)]
        return [i * n_view + v for i in range(n_data)]


def make_mesh(n_data: int, n_view: int) -> Mesh:
    """This rank's (n_data, n_view) mesh over the initialised default
    group. Every rank calls `new_group` for every row and column, in the
    same order, as torch requires, idle ranks included."""
    world = dist.get_world_size()
    n = n_data * n_view
    if world < n:
        raise ValueError(f"a ({n_data}, {n_view}) mesh needs {n} ranks; "
                         f"the job has {world}")
    mesh = Mesh((n_data, n_view), dist.get_rank())
    rows = [dist.new_group([d * n_view + v for v in range(n_view)])
            for d in range(n_data)]
    cols = [dist.new_group([d * n_view + v for d in range(n_data)])
            for v in range(n_view)]
    if mesh.active:
        d, v = mesh.coords
        mesh.groups = {"view": rows[d], "data": cols[v]}
    return mesh
