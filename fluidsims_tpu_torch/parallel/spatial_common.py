"""What the spatially sharded particle runners share (port of
fluidsims_tpu.parallel.spatial_common): owner buffers, their compaction,
the slab halo of grid arrays and the migration of particles between slab
neighbours.

The spatial decompositions (sph_spatial, flip_spatial, mpm_spatial) cut
the domain into x-slabs, one a rank along a 1-D mesh axis.  A rank keeps
the particles it owns in a buffer of fixed capacity whose empty rows hold
a fill row (the particle's id, in the last column of a payload, is -1
there), and its grid columns between halo pads.  JAX's `lax.ppermute` is
`mesh.ppermute` (zeros where no pair sends) and its `lax.psum` is
`mesh.psum`; the rank's axis index is a Python int, so the edge ranks'
fills are plain branches.
"""

from __future__ import annotations

import math

import torch

from .mesh import Mesh, all_gather, ppermute, psum

__all__ = ["owner_cap", "owner_buffers", "gather_by_id", "compact",
           "make_halo_ops", "migrate"]


def owner_cap(n_particles: int, n_dev: int, slack: float) -> int:
    """A rank's owner-buffer capacity: `slack` times the uniform share,
    rounded up to a multiple of 8 (at least 8).  One definition, so that
    shard_state and make_sharded_run of every spatial module agree."""
    return max(8, int(math.ceil(slack * n_particles / n_dev / 8.0)) * 8)


def owner_buffers(fields, fills, owner: torch.Tensor, mesh: Mesh, axis: str,
                  cap: int, dtype: torch.dtype):
    """This rank's owner buffers of `cap` rows from global per-particle
    `fields` (the same on every rank): the rows of the particles whose
    `owner` is this rank's axis index, in index order, then each field's
    fill.  Returns (buffers, ids int32 (-1 past the particles), the
    particles past any rank's cap as a 0-d int32 tensor)."""
    n_dev, d = mesh.axis_size(axis), mesh.axis_index(axis)
    dev = mesh.device
    mine = torch.nonzero(owner == d)[:cap, 0]
    bufs = []
    for f, fill in zip(fields, fills):
        buf = torch.empty((cap,) + tuple(f.shape[1:]), dtype=dtype,
                          device=dev)
        buf[:] = torch.as_tensor(fill, dtype=dtype, device=dev)
        buf[:len(mine)] = f[mine.to(f.device)].to(device=dev, dtype=dtype)
        bufs.append(buf)
    ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    ids[:len(mine)] = mine.to(device=dev, dtype=torch.int32)
    counts = torch.bincount(owner, minlength=n_dev)
    lost = torch.clamp(counts - cap, min=0).sum().to(device=dev,
                                                     dtype=torch.int32)
    return bufs, ids, lost


def gather_by_id(fields, ids_local: torch.Tensor, n: int, mesh: Mesh) -> list:
    """Each field's rows of every rank's owner buffer, in particle order,
    on every rank (NaN where a particle was lost)."""
    ids = torch.cat(all_gather(ids_local, mesh)).long()
    alive = ids >= 0
    out = []
    for f in fields:
        rows = torch.cat(all_gather(f, mesh))
        full = torch.full((n,) + tuple(f.shape[1:]), float("nan"),
                          dtype=f.dtype, device=f.device)
        full[ids[alive]] = rows[alive]
        out.append(full)
    return out


def compact(vals: torch.Tensor, keep: torch.Tensor, cap: int,
            fill_row: torch.Tensor):
    """The rows of `vals` (P, C) where `keep`, in order, at the front of a
    (cap, C) buffer of `fill_row`; rows past `cap` are dropped.  Returns
    (buffer, rows dropped as a 0-d int64 tensor).  Nothing is read back to
    the host."""
    at = torch.cumsum(keep.to(torch.int64), 0) - 1
    total = at[-1] + 1 if keep.numel() else at.new_zeros(())
    # rows not kept, and kept rows past cap, go to spare rows of their own
    # (one spare row for all of them would serialise their writes on the
    # card), which are dropped
    n = keep.shape[0]
    dst = torch.where(keep & (at < cap), at,
                      cap + torch.arange(n, device=keep.device))
    buf = fill_row.to(vals.dtype).expand(cap + n, vals.shape[1]).clone()
    buf.index_copy_(0, dst, vals)
    return buf[:cap], torch.clamp(total - cap, min=0)


def make_halo_ops(mesh: Mesh, axis: str, W: int, H: int):
    """Halo primitives for grid arrays laid out (..., W + 2H): W owned
    columns between H-wide pads, slabs ordered along the mesh axis.
    Returns (halo_fill, halo_reduce):

      halo_fill(a, fill=0.0): the pads overwritten with the neighbours'
        owned edge columns (the domain's edge ranks put `fill` there, a
        scalar or a tensor of the pad's shape);
      halo_reduce(a): each pad column's partial sums added into the
        neighbour that owns it (the reverse map; the sums are added to the
        padded array, so W < 2H overlaps stay right).
    """
    n_dev = mesh.axis_size(axis)
    d = mesh.axis_index(axis)
    Wp = W + 2 * H
    fwd = [(i, i + 1) for i in range(n_dev - 1)]   # send up (d -> d + 1)
    bwd = [(i + 1, i) for i in range(n_dev - 1)]   # send down

    def halo_fill(a: torch.Tensor, fill=0.0) -> torch.Tensor:
        from_below = ppermute(a[..., W:W + H], mesh, axis, fwd)  # d-1's right
        from_above = ppermute(a[..., H:2 * H], mesh, axis, bwd)  # d+1's left
        out = a.clone()
        out[..., :H] = fill if d == 0 else from_below
        out[..., W + H:] = fill if d == n_dev - 1 else from_above
        return out

    def halo_reduce(a: torch.Tensor) -> torch.Tensor:
        from_below = ppermute(a[..., W + H:Wp], mesh, axis, fwd)  # d-1's pad
        from_above = ppermute(a[..., :H], mesh, axis, bwd)        # d+1's pad
        out = a.clone()
        if d > 0:
            out[..., H:2 * H] = out[..., H:2 * H] + from_below
        if d < n_dev - 1:
            out[..., W:W + H] = out[..., W:W + H] + from_above
        return out

    return halo_fill, halo_reduce


def migrate(payload: torch.Tensor, owner: torch.Tensor, alive: torch.Tensor,
            *, mesh: Mesh, axis: str, mig_cap: int, p_cap: int,
            fill_row: torch.Tensor):
    """Exchange the particles that crossed a slab boundary with the +-1
    slab neighbours and compact the rest to the buffer's front: the
    migration step of the three spatial runners.

    payload   (P, C) rows, the particle's id as a float in the LAST column
              (-1 = empty row)
    owner     each row's owning axis index, from its new position
    alive     the rows holding a particle
    A mover goes one slab a step at most (one further sits out this
    exchange and moves on the next).

    Returns (final (p_cap, C), ids int32 (-1 past the live rows), lost: the
    rows dropped this exchange on every rank, summed over the mesh, a 0-d
    int32 tensor).
    """
    n_dev = mesh.axis_size(axis)
    d = mesh.axis_index(axis)
    delta = torch.clamp(torch.where(alive, owner - d, 0), -1, 1)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]

    up_buf, lost_u = compact(payload, delta == 1, mig_cap, fill_row)
    dn_buf, lost_d = compact(payload, delta == -1, mig_cap, fill_row)
    # every rank takes part in both exchanges; the edge ranks receive none
    got_up = ppermute(up_buf, mesh, axis, fwd)
    got_dn = ppermute(dn_buf, mesh, axis, bwd)
    fill = fill_row.to(payload.dtype).expand(mig_cap, payload.shape[1])
    got_up = fill if d == 0 else got_up
    got_dn = fill if d == n_dev - 1 else got_dn

    keep_buf, lost_k = compact(payload, alive & (delta == 0), p_cap,
                               fill_row)
    merged = torch.cat([keep_buf, got_up, got_dn])
    m_alive = merged[:, -1] >= 0.0
    final, lost_m = compact(merged, m_alive, p_cap, fill_row)
    n_alive = m_alive.sum()
    ids = torch.where(torch.arange(p_cap, device=payload.device) < n_alive,
                      final[:, -1].to(torch.int32), -1)
    lost = psum(torch.stack([lost_u + lost_d + lost_k + lost_m]), mesh)
    return final, ids, lost[0].to(torch.int32)
