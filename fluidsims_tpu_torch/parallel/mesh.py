"""Process meshes for domain decomposition, and the collectives of the
sharded runners, over torch.distributed.

Port of fluidsims_tpu.parallel.mesh.  JAX runs one program over a `Mesh`
of devices and gives the body of `shard_map` its collectives; here every
rank of an initialised process group runs the runner's code on its own
part of the state (SPMD), and a `Mesh` names the group's ranks by their
coordinates on named axes.  What each JAX primitive becomes:

* `lax.axis_index(axis)`   -> `Mesh.axis_index(axis)`, a Python int;
* `lax.ppermute(x, axis, perm)` -> `ppermute(x, mesh, axis, perm)`: one
  `dist.batch_isend_irecv` with the pairs mapped to global ranks; a rank
  that no pair sends to gets zeros, as from ppermute;
* `lax.pmax` / `lax.psum`  -> `pmax` / `psum`: one all-reduce (MAX / SUM)
  over the whole group, which is also the max over both axes of a 2-D
  mesh;
* `NamedSharding` placement and its inverse -> `shard(x, mesh, dims)`
  (this rank's block of a global tensor that every rank holds) and
  `gather(x, mesh, dims)` (the global tensor, assembled on every rank).

Backends are named by whoever starts the ranks (parallel/launch.py):
'nccl' moves CUDA tensors between ranks that each own one GPU; 'gloo'
moves CPU tensors, and CUDA tensors through explicit copies to the host
and back (several ranks that share one GPU), since gloo has no send or
receive of CUDA tensors.  The compute stays on the mesh's device either
way.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core.device import resolve_device

__all__ = ["Mesh", "group_mesh", "make_mesh_1d", "mesh_device", "ppermute",
           "pmax", "psum", "all_gather", "shard", "gather"]


@dataclass(frozen=True)
class Mesh:
    """This rank's view of a mesh of `prod(shape)` ranks: axis names
    (major first, as JAX's `Mesh.axis_names`), their sizes, this rank,
    its device and the process group's backend.  Ranks are numbered
    row-major over the axes (the last axis varies fastest), as JAX's mesh
    numbers the devices it is given."""

    axes: tuple
    shape: tuple
    rank: int
    device: torch.device
    backend: str

    def __post_init__(self):
        if len(self.axes) != len(self.shape) or len(set(self.axes)) != len(
                self.axes):
            raise ValueError(f"mesh axes {self.axes} and shape {self.shape} "
                             "must pair up one to one")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axes.index(axis)]

    def _coords(self, rank: int) -> list:
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return out[::-1]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (lax.axis_index)."""
        return self._coords(self.rank)[self.axes.index(axis)]

    def rank_at(self, axis: str, index: int) -> int:
        """The rank whose coordinate on `axis` is `index` and whose other
        coordinates are this rank's."""
        coords = self._coords(self.rank)
        coords[self.axes.index(axis)] = index
        rank = 0
        for c, n in zip(coords, self.shape):
            rank = rank * n + c
        return rank


def mesh_device(backend: str, rank: int, device=None) -> torch.device:
    """The device that a rank computes on: `device` where given, else
    cuda:rank for 'nccl' (one GPU a rank) and the current CUDA device for
    'gloo'.  Raises where the device is absent; a CUDA device always
    carries its index, so that tensors compare equal to it."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    if device is None:
        device = f"cuda:{rank}" if backend == "nccl" else "cuda"
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"backend 'nccl' moves CUDA tensors; device {dev} "
                         "needs 'gloo'")
    return dev


def group_mesh(axes: tuple, shape: tuple, device=None) -> Mesh:
    """This rank's Mesh of `shape` over every rank of the initialised
    process group, whose size must be the shape's."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialised process group "
                           "(parallel/launch.py starts the ranks)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} ranks,"
                         f" the process group has {world}")
    rank = dist.get_rank()
    backend = dist.get_backend()
    return Mesh(axes, shape, rank, mesh_device(backend, rank, device),
                backend)


def make_mesh_1d(n_devices: int | None = None, axis: str = "x",
                 device=None) -> Mesh:
    """A 1-D mesh over every rank of the initialised process group.
    `n_devices`, where given, must be the group's size."""
    if n_devices is None and dist.is_initialized():
        n_devices = dist.get_world_size()
    return group_mesh((axis,), (n_devices or 1,), device)


def _staged(x: torch.Tensor, mesh: Mesh) -> bool:
    """True where gloo must move `x` through the host."""
    return mesh.backend == "gloo" and x.device.type == "cuda"


def _wire(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` as the backend sends it: contiguous, on the host for gloo, and
    bool as uint8 (bytes either way)."""
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    return x.cpu() if _staged(x, mesh) else x


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bool:
        w = w.view(torch.bool)
    return w.to(like.device)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """lax.ppermute over `axis`: for each pair (src, dst) of axis indices,
    the rank at src sends `x` to the rank at dst.  Returns what was sent
    to this rank, or zeros where no pair sends to it.  Every rank of the
    mesh calls it with the same `perm`."""
    n = mesh.axis_size(axis)
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"perm {perm} must pair distinct sources with "
                         f"distinct destinations in [0, {n})")
    me = mesh.axis_index(axis)
    send_to = [mesh.rank_at(axis, d) for s, d in perm if s == me]
    recv_from = [mesh.rank_at(axis, s) for s, d in perm if d == me]
    if send_to == [mesh.rank] and recv_from == [mesh.rank]:
        return x.clone()  # a ring of one
    w = _wire(x, mesh)
    buf = torch.zeros_like(w)
    ops = [dist.P2POp(dist.isend, w, r) for r in send_to]
    ops += [dist.P2POp(dist.irecv, buf, r) for r in recv_from]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _unwire(buf, x)


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    w = _wire(x, mesh)
    if not _staged(x, mesh):
        w = w.clone()  # the all-reduce works in place
    dist.all_reduce(w, op=op)
    return _unwire(w, x)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The elementwise max of `x` over every rank of the mesh (lax.pmax
    over all of its axes); `x` is left as it was."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def psum(x, mesh: Mesh):
    """The elementwise sum over every rank of the mesh (lax.psum) of a
    tensor, or of a tuple of tensors of one dtype, which go over as one
    buffer; the inputs are left as they were."""
    if isinstance(x, torch.Tensor):
        return _all_reduce(x, mesh, dist.ReduceOp.SUM)
    flat = psum(torch.cat([t.reshape(-1) for t in x]), mesh)
    out, k = [], 0
    for t in x:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return tuple(out)


def all_gather(x: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's `x` (one shape on all ranks), in rank order."""
    w = _wire(x, mesh)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w)
    return [_unwire(p, x) for p in parts]


def shard(x: torch.Tensor, mesh: Mesh, dims: dict) -> torch.Tensor:
    """This rank's block of a global tensor that every rank holds: along
    tensor dim `dims[axis]` the `axis_index(axis)`-th of `axis_size(axis)`
    equal parts, for each mesh axis named in `dims`.  A copy, contiguous,
    on the mesh's device."""
    for axis, dim in dims.items():
        n = mesh.axis_size(axis)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split into {n} parts over axis {axis!r}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.axis_index(axis) * size, size)
    return x.to(mesh.device).clone(memory_format=torch.contiguous_format)


def gather(x: torch.Tensor, mesh: Mesh, dims: dict) -> torch.Tensor:
    """The inverse of `shard`: the global tensor, on every rank, from each
    rank's block; along a mesh axis not named in `dims` the blocks are
    replicas and the first is taken."""
    parts = all_gather(x, mesh)
    for axis, n in reversed(list(zip(mesh.axes, mesh.shape))):
        if axis in dims:
            parts = [torch.cat(parts[j:j + n], dim=dims[axis])
                     for j in range(0, len(parts), n)]
        else:
            parts = parts[::n]
    return parts[0]
