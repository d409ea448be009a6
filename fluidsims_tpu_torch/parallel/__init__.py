"""Multi-device runners over torch.distributed (port of
fluidsims_tpu.parallel): the mesh and its collectives (`mesh`), the
driver that starts the ranks (`launch`), halo exchange (`halo`), and one
runner module per JAX runner: `hypersonic2d_sharded` (x-slabs),
`hypersonic2d_sharded2d` (a (y, x) mesh), `hypersonic3d_sharded`
(z-slabs), `periodic_sharded` (Gray–Scott and LBM), `tau_sharded`
(Burgers and shallow water), `mhd_sharded`, `flip_sharded`,
`mpm_sharded` (particles sharded, the grid replicated), `nbody_sharded`
(body rows), `sph_sharded`, `spatial_common`, `sph_spatial`,
`flip_spatial` and `mpm_spatial` (spatial particle slabs),
`stam2d_sharded` (x-slabs) and `stam3d_sharded` (z-slabs); `runners`
names them for the tests and chip_smoke.py."""
