"""Multi-device runners over torch.distributed (port of
fluidsims_tpu.parallel): the mesh and its collectives (`mesh`), the
driver that starts the ranks (`launch`), halo exchange (`halo`), and one
runner module per JAX runner: `hypersonic2d_sharded` (x-slabs),
`hypersonic2d_sharded2d` (a (y, x) mesh), `hypersonic3d_sharded`
(z-slabs), `periodic_sharded` (Gray–Scott and LBM), `tau_sharded`
(Burgers and shallow water), `mhd_sharded`, `flip_sharded`,
`mpm_sharded` (particles sharded, the grid replicated) and
`nbody_sharded` (body rows); `runners` names them for the tests and
chip_smoke.py."""
