"""GPU smoke test of the PyTorch + CUDA port (fluidsims_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and nvcc (found through $CUDA_HOME, $PATH or
/usr/local/cuda).  Imports torch, numpy, the port and, for phase 27,
tests/analytic_gates.py with the numpy Riemann oracles of tests/oracles.
Phases, any failure of which ends the run with a non-zero exit:

1. device  — a CUDA device is present; print its name and power limit.
2. build   — build every kernel from fluidsims_tpu_torch/csrc; print the
             seconds and ptxas' register/spill report.
3. kernels — each kernel against its plain PyTorch version on the same
             inputs, f32 and f64, on a block-aligned (256x128) and a ragged
             (200x75) grid and two against the step kernel's tile (45x13,
             not a multiple of it, and 13x21, narrower than it, each with
             the NaN cell on a tile corner), from a perturbed state with a
             NaN cell and a near-vacuum patch: f64 rel err <= 1e-12, f32
             <= 1e-5 (the Pallas-vs-XLA bar of the JAX package), NaN cells
             in the same places, the wavespeed bitwise equal; the step's
             bitwise-equal calls counted (here and in phase 4).
4. main    — the flagship solver through solvers.hypersonic2d.run: 2048^2
             f32 x 200 steps and 8192x1024 f64 x 50 steps; every step must
             launch both kernels once; rates beside the plain version's;
             then, from each run's final state, both kernels against their
             plain versions at these full shapes (same bars as phase 3).
5. physics — fluid cells finite, min rho >= 1e-25, min p > 0, and a bow
             shock (rho > 1.5) upstream of the body after the 2048^2 run.
6. sph_kernels — the bin alone on its adversarial cases (BIN_CHECK: all
             4,096 particles in one cell, f32 and f64; a cell of 3,000 at
             2^16, more than one sorted chunk of the kernel; 2^20 from
             init on 256^2, whose top is empty), each output bitwise equal
             to the plain version or the script fails, cases counted; then
             the three SPH kernels (bin, density, forces + integrate)
             against their plain PyTorch versions on the same inputs, f32
             and f64, on 4096 particles from init plus seeded velocity
             noise: the binning bitwise, density and forces max|err| /
             max|ref| <= 1e-5 (f32) / 1e-12 (f64), and a second forces
             launch of each of density and forces bitwise equal to the
             first (here and in phase 7); the same on 4096 particles with
             1500 (at least 500 more than the density kernel's chunk)
             packed into one cell, whose 3x3 neighbourhood holds more
             candidates than the density and the forces kernels each
             stage at once (checked from the binning and the kernels'
             reported chunks), so both chunk loops run more than once.
             The kernels have no
             cell capacity: on 512 particles with cell_capacity=8 (cells
             holding more than K particles, which the 'torch' engine
             drops) density and forces + integrate are held, at the same
             bars, to the 'exact' engine's all-pairs functions.  Then 5
             steps of the cuda engine against the same steps through the
             plain versions at f32 (atol 2e-6 pos, 2e-5 vel).
7. sph_main — SPH through solvers.sph.run with engine 'auto', which must
             resolve to 'cuda': 65,536 particles f32 without rain x 200
             steps (bench.py's configuration) and 2^20 particles f32 with
             rain x 50 steps (256 x 256 cells); each kernel launched once
             per substep; M particle-steps/s beside the plain 'torch'
             engine's (which drops the particles past a cell's K slots);
             overflow_count 0 (the cuda engine keeps every pair); physics
             (finite, in the box, mean height below the initial one, tau
             > 0); the bin's two launches as its grid query reports
             them, and the first one's grid syncs as the kernel counted
             them (equal to the query's or the script fails); then, from
             each run's final state, each kernel against its plain
             version at that shape (same bars), per-launch times (the bin
             and density also as torch.profiler's device time) and the
             pair counts.
8. hyp3d_kernels — the three 3-D hypersonic kernels (prologue, cell
             update, masked max wavespeed) against their plain PyTorch
             versions.  The prologue bitwise on every grid below, on 64^3
             and 256^3 and on the sharded runner's z-slab (rank 1 of 4
             on 64^3, its own padded mask), f32 and f64, both outflow
             modes, with NaN and infinite cells in the last column; 3
             steps of 64^3 under torch.cuda.set_sync_debug_mode("error"),
             each launching it once.  The cell update and wavespeed f32 and
             f64, both outflow modes, on a non-cubic 24x40x56 (z, y, x) grid,
             on 32^3 and two against the step kernel's tile (9x13x19, not a
             multiple of it, and 3x7x5, narrower than it in every axis,
             each with the NaN cell on a tile corner), from init u0-seeded
             with seeded noise on every field and a NaN, a
             negative-pressure and an infinite-velocity cell in the padded
             input: step max|err|/max|ref| <= 1e-5 (f32) / 1e-12 (f64)
             with non-finite cells in the same places, the step's
             bitwise-equal calls counted (here and in phase 9), the
             wavespeed bitwise; the wavespeed also bitwise on 9x13x19,
             3x7x5 and 17x31x33 (cell counts no multiple of 4) as tensors
             and as views into larger buffers (all six at one odd offset;
             at offsets that differ), and on 64^3 and 256^3, f32 and f64,
             launched back to back twice in turn (each shape's own
             scratch, the counter left at 0); then 5 steps of the CUDA
             engine against the plain engine at f32 on the first two
             grids (<= 5e-4 relative).
9. hyp3d_main — solvers.hypersonic3d.run with the CUDA engine:
             default_config(64) f32 x 400 steps (bench.py's hypersonic3d_64
             and the reference's size) and default_config(256) f32 x 20;
             each kernel launched once a step (the prologue's device time
             a launch against its bound too); steps/s beside the plain
             engine's (20 steps at 64^3, 1 at 256^3); physics (finite,
             rho > 0, p > 0, t advanced, dtau in [1e-7, 5e-2], solid cells
             unchanged, max u > 0.1 at 64^3); then from each final state
             both kernels against their plain versions at full shape and
             per-launch times.
10. th3cs  — solvers.th3cs.export_4spl at 64^3, 60 frames x 4 steps, CUDA
             engine, into a temporary file, read back with the port's
             read_4spl (magic, dims, frames, pSize, flags, size, CRC, more
             than one index in the last frame); frames/s.
11. stencil_kernels — the Gray–Scott and D2Q9 LBM kernels (one step, K
             steps a launch) against their plain PyTorch versions, f32 and
             f64, from init plus seeded noise, on a ragged 200x75 grid
             (LBM with a radius-8 obstacle), an aligned 256x128 one and,
             for LBM, 200x75 with the top wall row removed and 24x20
             (narrower than the K-step kernel's window), Gray–Scott also
             on 24x20 (narrower than its window): bitwise; K = 1, 3, 16
             and 32 (Gray–Scott), K = 1, 3, 8 and 16 (LBM), each K-step
             launch also bitwise equal to K launches of the one-step
             kernel; the overrides feed=0.04, kill=0.058 and drive=3e-4;
             run(cfg, s, 23) at block_k=8 makes exactly 2 K-step and 7
             one-step launches and equals 23 plain steps.
12. stencil_main — solvers.gray_scott.run and solvers.lbm.run with engine
             'auto', which must resolve to 'cuda': Gray–Scott 2048^2 f32 x
             2000 at block_k 16 and 1 and f64 x 400 (bench.py's size and
             step count); LBM 2048x1024 f32 x 1000 at block_k 8 and 1 and
             f64 x 200 (bench.py's); launch counts n // K and n % K (K = 1:
             the one-step kernel every step); steps/s, Mcell-steps/s or
             MLUPS beside the plain 'torch' engine's (100 and 20 steps);
             physics (Gray–Scott: finite, u and v in [-1e-3, 1 + 1e-3], max
             v > 0.1; LBM: finite, mass summed in f64 within 2e-8 (f32) /
             1e-14 (f64) a step relative to the start (f32 rounding drifts
             by 1.3e-8 a step), max |u| < 0.1, mean x velocity of the fluid
             above its start); then from each final state every kernel
             against its plain version at full shape and per-launch times
             (Gray–Scott also torch.profiler's device time a launch of
             both kernels, and the K-step launch that the library's grid
             query reports).
13. resident_kernels — the Burgers, shallow-water and GLM-MHD K-step
             kernels (one cooperative launch of k whole steps) against their
             plain PyTorch versions, f32 and f64, from init plus seeded
             noise, on a ragged 200x75 and an aligned 256x128 grid: Burgers
             plain, MUSCL, visc_substeps=2 and 3, MUSCL with 9 (two passes)
             and Cole–Hopf (ny=1); shallow water with nu > 0 and nu = 0;
             MHD Brio–Wu and Orszag–Tang with both flux signs; the Burgers
             and shallow-water cases also on 5x3, a grid narrower than the
             tiles' halos; on 200x75 also a NaN cell (Burgers and shallow
             water turn NaN everywhere, MHD reverts every cell, t NaN, as
             the plain step).  k = 1 along three plain steps within 1e-5
             (f32) / 1e-12 (f64) relative; k = 8 against 8 plain steps within
             the JAX suite's resident-kernel bars (f64: 1e-10); k = 8
             bitwise equal to 8 launches of k = 1; run(cfg, s, 23) at
             block_k=8 makes exactly 2 + 7 launches; the Burgers and
             shallow-water launches of k = 8 and k = 1 make K + 1 grid
             syncs (Burgers: K more for each pass past the first) as the
             kernel counts them.
14. resident_main — solvers.burgers.run, solvers.shallow_water.run and
             solvers.mhd.run with engine 'auto', which must resolve to
             'cuda': bench.py's burgers_512x512, shallow_water_512x512 and
             mhd_320x220 (Brio–Wu) f32 x 4000 at the default block_k (16,
             8, 8) and at 1; Burgers and shallow water 4096^2 f32 x 200, MHD
             Orszag–Tang 2048^2 f32 x 200; each reference size f64 x 1000;
             launch counts n // K and n % K; steps/s beside the plain
             'torch' engine's (100 steps, 5 at the large grids); physics
             (Burgers finite, energy decayed after 4000 steps and below 3x
             its start before, see BURGERS_ENERGY_GROWTH_MAX; shallow water h
             > 0, mass within 3e-8 (f32) / 1e-15 (f64) a step, see
             SW_MASS_DRIFT_PER_STEP; MHD finite, rho > 0, p > 0, t
             advanced); then from each final state the kernel against its
             plain version at full shape and per-launch times.
15. stam3d_kernels — the three 3-D stable-fluids kernels (Jacobi sweep,
             exact trilinear advection, set_bnd of four fields) against
             their plain PyTorch versions, f32 and f64, on n=24 and a
             ragged n=37, from init plus seeded noise on all eight fields,
             rings included: one sweep and the ping-pong solve at
             jacobi_iters 12 and 5 with the viscosity, diffusion and
             projection coefficients bitwise; the advection within 1e-6
             (f32) / 1e-13 (f64) relative at two velocity scales; set_bnd
             bitwise; then 5 steps of the cuda engine against the 'torch'
             engine at advect_k=0 within 1e-5 (f32) / 1e-12 (f64)
             relative.
16. stam3d_main — solvers.stam3d.run with engine 'auto', which must
             resolve to 'cuda': Stam3DConfig() (192^3 f32, bench.py's
             stam3d_192) x 100 steps and 192^3 f64 x 20; per step 6 x
             jacobi_iters Jacobi, 4 advect and 6 set_bnd launches; steps/s
             and Mcell-steps/s beside the plain 'torch' engine's (2 steps,
             advect_k=0); physics (every field finite, min d >= 0, max d >
             0) and advect_capped_count at advect_k=2 from the final state
             (the cells JAX's default dense-shift advection would have
             capped); then from each final state every kernel against its
             plain version at full shape and per-launch times.
17. stam2d_kernels — the advection at n = 1, 2 and 3 (ADVECT_CHECK_N's
             first sizes: fields narrower than a warp), one field and the
             velocity pair, f32 and f64, bitwise equal to the plain
             version or the script fails; then the two 2-D stable-fluids
             kernels (the whole
             Jacobi solve in one cooperative launch, the exact bilinear
             advection of one or two fields) against their plain PyTorch
             versions, f32 and f64, at n=512, 200 and 37 on seeded fields
             (the solve also at n=1 and 65): the solve at 40, 7, 1, h and
             h + 1 sweeps (h: sweeps a grid sync) with (a, c) = (1, 4) and
             (0.26, 2.04), x unchanged, bitwise equal and with
             ceil(sweeps / h) - 1 grid syncs as the kernel counts them, or
             the script fails (here and from phase 18's final states); the
             advection of one
             field, two fields and the velocity pair (u0, v0 advected by
             themselves) at two velocity scales, the larger carrying
             back-traces past 16 rows and past the grid edge, within 1e-6
             / 1e-13, bitwise cases counted; then 5 steps of the cuda
             engine against the 'torch' engine at n=128 within 1e-5 /
             1e-12.
18. stam2d_main — solvers.stam2d.run with engine 'auto', which must
             resolve to 'cuda': Stam2DConfig() (512^2 f32, bench.py's
             stam2d_512x512 size and its 400 steps) and 512^2 f64 x 400
             (js_cuda's precision); exactly 5 solve and 2 advection
             launches a step; steps/s beside the plain 'torch' engine's
             (20 steps); physics (every field finite, min d >= -1e-5, ovf
             0) and advect_overflow_count of the final state (the cells
             JAX's banded TPU advection would clamp); then from each final
             state both kernels against their plain versions at full
             shape with the main path's arguments, per-launch times and
             bounds.
19. flip_kernels — the three FLIP/APIC kernels (the P2G, atomic below
             2^18 particles and tiled from there, the whole grid phase in
             one cooperative launch, G2P with the density raster) against
             their plain PyTorch versions, f32 and f64, at n=128, 37, 512
             and 16 with 4 n^2 seeded particles (eight on the walls and
             corners), jacobi 48, 7, 1 and 0, the config's blend and the
             overrides flip=0.5, apic=0.3: P2G, the design the wrapper
             picks and each design, within 1e-5 (f32) / 1e-12 (f64)
             relative to each grid's max (adds land in no fixed order), and
             both designs so on n=128 and 37 with a cell crowded past the
             tiled design's chunk, twelve particles on and past the walls
             and tiles left empty (the tiled launch's stats: a tile past a
             chunk, 3 grid syncs); the tiled design so on two launch shapes
             whose scratch has one size (n=30, 10,007 particles, and n=46),
             launched A, B, A on one stream, and on n=2048 (more tiles than
             a block counts in shared memory, 300,000 particles); the grid
             phase on the kernel's P2G grids bitwise equal or the script
             fails, with max(ceil(jacobi / h), 1) - 1 grid syncs as the
             kernel counts them (h: sweeps a sync); G2P on the kernel's
             fields within the same bars, bitwise cases counted; the
             raster equal to the plain version's and counting every
             particle; then 5 steps of the cuda engine against the
             'scatter' engine at FlipApicConfig() within 5e-4 (f32) / 1e-10
             (f64) relative (FLIP_TRAJ_TOL), the raster equal to the plain
             raster of the cuda positions (and to the scatter engine's
             where the positions are bitwise equal).
20. flip_main — solvers.flip_apic.run with engine 'auto', which must
             resolve to 'cuda': FlipApicConfig() (65,536 particles, 128^2,
             bench.py's flip_65536_mpsps and the CLI default) f32 x 1000
             and f64 x 200, and 2^20 particles on 512^2 f32 x 200; exactly
             one launch of each kernel a step; steps/s and M
             particle-steps/s beside the plain 'scatter' engine's (20
             steps); physics (finite, positions in [0.01, 0.99], the raster
             equal to the plain raster of the positions and summing to the
             particle count, mean y below its start, max |v| <
             50, overflow_count 0) and the fold: the kernel's P2G mass grid
             sums (in f64) to the particles' hat weights (their count away
             from the walls) within 1e-5 (f32) / 1e-12 (f64); then from each
             final state the kernels against their plain versions at full
             shape (the P2G's two designs too), per-launch times by CUDA
             events and the P2G's device time by torch.profiler (each
             design's too), and bounds (FLIP_*_OPS; the P2G's nonzero
             offsets counted from the state).
21. mpm_kernels — the three MLS-MPM kernels (the P2G, atomic below 2^18
             particles and tiled from there, the grid update, G2P) against
             their plain PyTorch versions, f32 and f64, on 96^2, 37x53 (Gx
             != Gy) and 512^2 with 4 Gx Gy seeded particles over the grid
             (eight on its walls and corners, whose targets reach past it),
             F = I + 0.05 N, Jp in [0.5, 1.5], for mud, snow and sand: P2G,
             the design the wrapper picks and each design, within 1e-5
             (f32) / 1e-12 (f64) relative to each grid's max (adds land in
             no fixed order), and both designs so on 96^2 and 37x53 with a
             cell crowded past the tiled design's chunk, twelve particles
             on and past the walls and tiles left empty; the tiled design
             so on two launch shapes whose scratch has one size (30x46,
             10,007 particles, and 46x46), launched A, B, A on one stream,
             and on 2048^2 (more tiles than a block counts in shared
             memory, 300,000 particles); the grid update on the kernel's
             P2G grids and G2P on the kernel's node velocities bitwise
             equal or the script fails, bitwise cases counted; then 5
             steps of the cuda engine against the 'scatter' engine at
             MPMConfig() within 5e-4 (f32) / 1e-10
             (f64) relative (MPM_TRAJ_TOL).
22. mpm_main — solvers.mpm.run with engine 'auto', which must resolve to
             'cuda': MPMConfig() (32,768 snow particles on 96^2, bench.py's
             mpm_32768_mpsps and the CLI default) f32 x 1000 and f64 x 200,
             and 2^20 particles on 512^2 f32 x 200; exactly one launch of
             each kernel a step; steps/s and M particle-steps/s beside the
             plain 'scatter' engine's (20 steps); physics (finite, positions
             in [2dx, (G-3)dx], Jp in [0.05, 20], mean y below its start,
             the P2G mass n * particle_mass within 1e-5 relative,
             overflow_count 0) and the fold: the P2G mass grid's sum (in
             f64) equals particle_mass times the particles' in-grid
             weights within 1e-5 (f32) / 1e-12 (f64); then from each final
             state the kernels against their plain versions at full shape
             (same bars; the P2G's two designs too), per-launch times by
             CUDA events and the P2G's device time by torch.profiler (each
             design's too), and bounds (MPM_*_OPS; the P2G's targets inside
             the grid counted from the state).
23. nbody_kernels — no earlier phase launched the n-body kernel; ptxas's
             registers and spills of the n-body and 3-D wavespeed kernels
             logged; then the
             exact repulsion kernel against its plain PyTorch version,
             f32 and f64, 2-D and 3-D, on n=2, 257 (ragged against the
             tile), 4096 seeded bodies at scale 100 with two
             coincident and the init layout of max_number=8192, every
             target and the rows 1::3: per body, the error over
             sum_j |w_ij| |d_ij| (in f64) of the f64 kernel against the
             f64 plain version <= 1e-12 and of the f32 kernel against the
             f64 plain version of the same f32 positions <= 1e-5 (the f32
             plain version's own error logged beside); the same bars on
             the launch shapes that hit every tail of each dtype's launch
             (nt = threads x targets - 1 and + 1, n = a tile - 1 and + 1,
             rows fewer than a block's threads); at softening 0 the self
             pairs' forces non-finite where the plain version's are, and
             targets off the bodies within the bars; then 5 steps of
             solvers.nbody_graph.run through the kernel (5 launches)
             against 5 through the plain hook at 8192, 2-D and 3-D, f32
             and f64, within 5e-4 / 1e-10 of the layout's extent.
24. nbody_main — solvers.nbody_graph.run with the exact engine on CUDA
             tensors at GraphLayoutConfig(max_number=2^17) (131,072
             bodies, bench.py's nbody_131072_exact size): 2-D f32 x 20
             (bench.py's count), 3-D f32 x 20, 2-D f64 x 10; exactly one
             kernel launch a step; steps/s beside the plain hook's (2
             steps); physics (finite, pos[0] and vel[0] exactly 0, every
             |v| <= max_speed (1 + 1e-6), the extent beside the init
             radius 20 sqrt(n)); from each final state the kernel against
             the plain version at full shape (phase 23's bars), ms a launch
             by CUDA events, device time by torch.profiler, the bound
             (NBODY_OPS_PER_PAIR); then the grid engine, plain PyTorch on
             the card, at 2^17 (far field only) and 2^15 (near field), 2-D
             f32 x 10, with physics, steps/s and no kernel launch; and no
             other module's kernel launched on the n-body path.
25. driver_surface — the CLI's driver surface on the card, every kernel
             counter set to 0 first: (a) each of the 12 grid and particle
             subcommands (DRIVER_CASES, small sizes, --device cuda, the
             K-step solvers at --block-k 2) through cli.main four ways:
             --render --stride 2 --steps 4, --png where JAX's CLI has an
             RGB export (a PNG of the grid's rows), --interactive with a
             non-tty stdin, --save-state then --load-state; each exits 0,
             prints its engine (engine=cuda / impl=cuda) and writes its
             files; nbody --save-state/--load-state and regression
             --write-baseline then verifying; every kernel of the 26
             launched in these runs (the counts go into each kernel line
             as launches_driver_surface); (b) the flagship's 7 views at
             2048^2 f32 after 200 steps against the same functions on a
             CPU copy of the state (masks equal, normalized field within
             DRIVER_VIEW_TOL absolute; render_rgba of two modes within one
             level), the ms of a frame's view + copy, colormap and PNG,
             `hypersonic2d --png f.png --stride 50 --steps 200` at 2048^2
             writing 4 PNGs of 2048x2048 with exactly 200 launches of each
             of its two kernels, its steps/s beside the headless run's;
             (c) resume through the CLI: 100 steps against 50,
             --save-state, --load-state, 50 more: hypersonic2d 2048^2 f32
             bitwise; FLIP 65,536 on 128^2 (its atomic P2G adds in no
             fixed order): 50 steps in memory, saved and loaded on the
             card bitwise, then one step from each within FLIP_STEP_TOL
             relative; and over the CLI's 50 steps on, where the dynamics
             grow the rounding, within FLIP_RESUME_SPREAD times the worst
             relative spread of three straight runs' pairs, its
             checkpoint's load + save on the card bitwise; (d) the
             streamed th3cs 64^3 export (8 frames x 4 steps, each frame
             readable as it lands) and the native writer's file
             byte-identical to export_4spl's, the ms of the Python and
             the native writer at 64^3 x 60 frames, and the hypersonic2d
             serve frame function at 2048^2: 8 frames through
             Stream4splWriter, read back equal.
26. parallel — the sharded runners of fluidsims_tpu_torch/parallel: the
             compute mode (nvidia-smi); p1 (the inflow + wavespeed
             kernel) at inflow columns 0, 2 (rank 0's extended slab) and
             -1 (none) bitwise equal to its plain version; the SPH
             kernels over ranges of receivers and windows of cell
             columns against their plain versions, and the bin on
             counts that share one scratch bitwise; the Stam kernels at
             the sharded runners' shapes, bitwise to their plain versions
             (#9 on the round slabs of 512^2 and a ragged field in turn,
             with their grid syncs; #10 over every rank's column window
             at worlds 2 and 4 with 16, 2 and n / D exchanged columns,
             clamp counts equal and > 0 at 2; #11 over z-slabs of
             192^3 with the global faces inside, on an end slice and
             absent, from even and odd sweeps, and the one-rank z-slab
             solve at halo_k 1-4), timed there (STAM_*), and the x-slab
             runner's clamp runs at world 2 on gloo (512^2, dt = 1, 2
             and 16 exchanged columns: ovf > 0, equal to the plain
             composition's, the states bitwise equal); then (a) every
             runner at world 1 on 'nccl' in this process at the main
             path's widths (PARALLEL_RUNS: the flagship 8192x1024 f64, 3-D
             64^3, Gray–Scott 2048^2 at K = 16, LBM 2048x1024 at K = 8,
             Burgers and shallow water 512^2, MHD 320x220, FLIP 65,536 on
             128^2, MPM 32,768 on 96^2, n-body 2^17, stam2d 512^2, stam3d
             192^3), every counter set to 0 before each sharded run and
             read after it, each equal to the one-device run on the card
             bitwise (FLIP and MPM, whose P2G adds with atomics, within
             FLIP_TRAJ_TOL / MPM_TRAJ_TOL; the n-body layout bitwise where
             two one-device runs are; stam3d to the 'torch' engine at its
             advect_k), every kernel that the runners drive
             (PARALLEL_KERNELS) launched, and the Stam runners' launches
             those their composition implies (PARALLEL_LAUNCHES); (b) the
             1-D runners at world 2 and the 2x2 mesh at world 4 on
             'gloo', the ranks sharing cuda:0 (launch.spawn), with the
             SPH, spatial particle and Stam runners at both (the spatial
             ones from stirred states: particles must change ranks, none
             be lost; stam2d at JAX's calm dt, bitwise), each within its
             bar of PARALLEL_RUNS, every rank's Stam launches as at world
             1;
             a line {"parallel":
             ...} with each run's world, backend, steps, largest relative
             error, bitwise flag, each rank's launches and the host
             clock's steps/s (at world 2 and 4 gloo-staged on one card, no
             scaling figure).  A failed rank fails the run.
27. analytic_gates — the JAX suite's analytic gates on the card
             (tests/analytic_gates.py, ANALYTIC_GATES), each through its
             solver's entry point in the JAX gate's configuration and
             held to the JAX gate's bars, every counter set to 0 first:
             Sod 2-D (600x4 f64 x 300, y-uniform to the bit), the double
             rarefaction (600x4 x 100, mirror symmetric to 1e-12), the
             3-D WENO Sod (256x4x4 f64 x 400, at the accumulated dt,
             y/z-uniform to the bit), the MHD hydro limit (600x6 f64,
             stable_hll, x 600 at block_k 8, B identically 0), the
             shallow-water dam break (600x4 f64, 400 one-step launches, at
             the accumulated dt), the convergence ladder (100 to 1600
             cells, every rate > 1.7), the long-horizon f32 against f64
             drift (128x64 x 1000), Poiseuille (32x34 f32 x 20,000 at
             block_k 8 and 1), Cole–Hopf (256x1 f64 x 200) and the
             standing wave (128x8 f32, 200 one-step launches); each gate
             must launch the kernels it names (#1 and p1; #2 and p2; #8;
             #7 for shallow water; #6 and #5; #7 for Burgers) and no
             other; then the long-horizon comparison at default_config()
             (8192x1024) as a reading beside the bar; a line
             {"analytic_gates": ...} with each gate's errors, bars,
             steps, kernels' launches and seconds.

Every kernel's line in {"kernels": [...]} carries bound_ms, the least time
the card could take for its work at the main path's shape: the larger of
the bytes it must move (inputs read once, outputs written once) over
3.35 TB/s and its operations over 67 TFLOP/s (f32) or 34 TFLOP/s (f64),
the peaks of an H100 SXM at 700 W; bound_by says which.  Operation counts
per cell or pair are counted from the CUDA sources (see *_OPS below);
where the work depends on the data (SPH pairs), this run's pairs are
counted.  The lines of the tiled kernels (#7: Burgers and shallow water;
#8: MHD; #9: the stam2d solve; #17: the FLIP grid phase, at each FLIP
run's grid and dtype) also carry `tiling` at the main runs'
configs, per dtype: the blocks, threads a block, tile, halo and dynamic
shared memory that the library's grid query reports, the grid syncs of
one launch as the kernel counted them, and ptxas's registers, static
shared memory, stack and spills of each instantiation; #7's and #8's
lines carry `ms_one_step`, a k = 1 launch back to back (the host's cost
a call included).  The LBM K-step kernel's line (#6) carries `tiling`
(blocks, threads, tile, halo K and shared memory of the K=8 launch at
2048x1024, per dtype, as the library reports them, and ptxas's report) and
`ms_k_one_step`, K times the one-step kernel's ms a launch in the same
run (f32, and `ms_k_one_step_f64`); the Gray–Scott K-step line (#4)
the same at K=16 on 2048^2, and both Gray–Scott lines (#3, #4)
`ms_device` and `ms_device_f64` (torch.profiler's device time a launch;
on #4 also `ms_device_k_one_step` and `_f64`, K one-step launches' device
time).  The SPH forces kernel's line (#15) carries `block`, for
the main runs' particle counts (f32) and 4096 f64, its threads a block,
lanes a particle, candidates a staged chunk and shared memory a block as
the library reports them, and
`repeat_bitwise`, the forces calls whose second launch repeated the
first one's bits; the SPH density line (#14) the same for its kernel
(`block`, `repeat_bitwise`), `ms_device`, `ms_device_1048576`
(torch.profiler's device time a launch) and `ptxas` (each lane count's
registers and spills); the SPH bin's line (#22) `ms_device` and
`ms_device_1048576` (both launches), `launch` (each main run's launches
as the grid query reports them, and the grid syncs the kernel counted),
`bitwise_cases` (phase 6's BIN_CHECK cases, [bitwise, cases]) and
`ptxas`; the stam2d advection's line (#10) `ptxas` and `bitwise_cases`
(phase 17's cases at n = 1-3).  The lines of the two hypersonic step
kernels
(#1, #2) carry `tiling` at the main
runs' shapes: the blocks, threads a block, tile, halo and dynamic shared
memory that the library's launch query reports, and ptxas's registers,
static shared memory, stack and spills of each instantiation; and
`bitwise_cases`, [step calls bitwise equal to the plain version, step
calls] over phases 3-4 and 8-9, with the calls that were not; the 3-D
wavespeed's line `bitwise_cases` (phase 8's edge and back-to-back cases)
and `ptxas`; the n-body line `tail_cases` (phase 23's tails), `launch`
(threads, targets a thread, blocks and unroll at 2^17,
per dtype, as the library reports them) and `ptxas`.  The two
P2G lines (#16, #19) carry `ms_device` (torch.profiler's device time a
call of the design the wrapper picks, beside `ms`, the CUDA events' time
of the call), `ms_device_atomic` and `ms_device_tiled` (each design), the
same for the f64 and 2^20 runs, `tiling` (the launch the library's grid
query reports at each main run's size: the picked and the tiled design,
and ptxas's report of both kernels) and `edge_cases` (phases 19 and 21's
crowded and wall cases, the two shapes of one scratch size and the grid of
many tiles: rel errs and the tiled launch's stats).  Every line carries
`launches_driver_surface` (phase 25's launches of its kernel),
`launches_parallel` (phase 26's launches at world 1) and
`launches_analytic` (phase 27's), p1's line
`inflow_col_cases` (phase 26's bitwise cases), the Stam lines phase 26's
checks at the sharded shapes (#9 `rect_bitwise_cases`, #10
`window_bitwise_cases`, `window_clamped` and `clamp_runs`, #11
`slab_bitwise_cases`) and `sharded_shapes` (ms, plain ms and bound
there), and the
flagship step's line `driver_surface`: phase 25's ms a frame by part,
steps/s of the strided PNG run and the headless run, and the resume
results.

The line before {"kernels": [...]} is {"analytic_gates": {...}} (phase
27), and the one before it {"parallel": {...}} (phase 26).
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
STEP_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}

# H100 SXM peaks (NVIDIA data sheet), for bound_ms
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
# Operations (each add, multiply, division, square root, log, exp once),
# counted from the CUDA sources:
# hypersonic2d_step.cu per fluid cell, each predict and face counted once
# (the work of the plain step): 2 MUSCL-Hancock predicts (~227 each: 7
# primitive decodes, 5 encodes, 4 limited slopes, 2 fluxes, 2 half steps),
# 2 HLLC solves (~97 each) and ~140 for the ghost, the update, the
# diffusion and the repair; solid cells copy their state.  The kernel's
# tile ring adds (tile_x + 2) / tile_x predicts along x and
# (tile_y + 2) / tile_y along y.
HYP2D_STEP_OPS_PER_FLUID_CELL = 2 * 227 + 2 * 97 + 140
# hypersonic2d_wavespeed.cu per fluid cell: one decode, sound speed, max.
HYP2D_WAVESPEED_OPS_PER_FLUID_CELL = 17
# sph_density.cu: per candidate pair the distance, sqrt, q and the sum
# (9), per pair within 2h the spline (6 more); per particle the
# EOS and p/rho^2 (10).
SPH_DENSITY_OPS = (9, 6, 10)
# sph_forces.cu: per candidate pair the distance test (5), per pair
# within 2h and not self the gradient, pressure term and sums (23, the
# viscosity branch not counted); per particle gravity and the integrate
# with walls (14).
SPH_FORCES_OPS = (5, 23, 14)
# sph_bin.cu per particle: the cell id (2 divisions, 2 floors).
SPH_BIN_OPS_PER_PARTICLE = 4
# hypersonic3d_step.cu per cell, each face counted once (the work of the
# JAX function): per axis 6 fields x ~76 for the WENO pair (~32 per cell
# for the smoothness weights, 3 divisions; ~44 per face for the candidate
# polynomials and the two weighted sums, 2 divisions) + ~12 floors + one
# HLLC (~250), and ~150 for U0, the update, the decode, repair,
# Landau-Teller and sponges.  The kernel's tile ring adds (t + 2) / t of
# the weights and face states and (t + 1) / t of the solves along each
# axis of t cells.
HYP3D_STEP_OPS_PER_CELL = 2300
# hypersonic3d_wavespeed.cu per fluid cell: sound speed (4), three
# |u|+a divided by d (9), two adds, the test.
HYP3D_WAVESPEED_OPS_PER_FLUID_CELL = 17
# hypersonic3d_pad.cu per padded cell: the decode (three exp, three sinh,
# three multiplies by u_ref); the ghost columns' and wall cells' few more
# not counted.
HYP3D_PAD_OPS_PER_CELL = 9
# gray_scott.cuh::gs_cell per cell-step: two Laplacians (3 adds for the
# four neighbours, 4c, the subtraction, x inv_dx2: 6 each), uvv (2), du
# (5), dv (4), the two forward-Euler updates (4).
GS_OPS_PER_CELL = 2 * 6 + 2 + 5 + 4 + 4
# lbm.cuh::lbm_collide per fluid cell-step: rho (8 adds, the floor), the
# two momentum sums (5 each), ux, uy (3), u2 (3), and per direction cu
# (4), feq (8) and the relaxation (3); counted for the fluid cells only
# (solid cells and streaming do none).
LBM_OPS_PER_CELL = 9 + 10 + 3 + 3 + 9 * 15


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s); using {name}")
    log(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build(hk, build) -> None:
    t0 = time.perf_counter()
    hk.load()
    secs = time.perf_counter() - t0
    log(f"[build] kernels built and loaded in {secs:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] ptxas: {line.strip()}")


def perturbed_state(h2, interop, cfg, device, nan_at=None):
    """init() plus seeded noise in the primitives of the fluid cells, one
    NaN cell (at `nan_at`, (y, x), or at (4 ny / 5, nx / 2)) and a
    near-vacuum patch, so the HLLE fallback and the positivity repair
    both run."""
    s = h2.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(SEED)
    U = [f.numpy().astype(np.float64) for f in s.U]
    mask = s.mask.numpy()
    g = cfg.gamma
    rho = U[0]
    u, v = U[1] / rho, U[2] / rho
    p = (g - 1.0) * (U[3] - 0.5 * rho * (u * u + v * v))
    shape = rho.shape
    rho = rho * (1.0 + 0.2 * rng.uniform(-1, 1, shape))
    u = u + 2.0 * rng.standard_normal(shape)
    v = v + 2.0 * rng.standard_normal(shape)
    p = p * (1.0 + 0.2 * rng.uniform(-1, 1, shape))
    ny, nx = shape
    y0, x0 = ny // 5, nx // 3          # near-vacuum patch, away from the body
    rho[y0:y0 + 4, x0:x0 + 5] = 1e-20
    p[y0:y0 + 4, x0:x0 + 5] = 1e-24
    u[y0:y0 + 4, x0:x0 + 5] = 0.0
    v[y0:y0 + 4, x0:x0 + 5] = 0.0
    new = [rho, rho * u, rho * v, p / (g - 1.0) + 0.5 * rho * (u * u + v * v)]
    new = [np.where(mask, old, nw) for old, nw in zip(U, new)]
    yn, xn = nan_at or ((4 * ny) // 5, nx // 2)    # one NaN cell
    if mask[yn, xn]:
        raise AssertionError(f"NaN cell ({yn}, {xn}) lies in the body")
    new[0][yn, xn] = np.nan
    new[3][yn, xn] = np.nan
    return interop.state_from_numpy(new, mask, 0.0, dtype=cfg.torch_dtype,
                                    device=device)


def clone_U(U):
    return type(U)(*(f.clone() for f in U))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def compare(got, ref, what: str, tol: float) -> tuple[float, float]:
    """Max |err|/max(|ref|,1) and max |err| over finite cells; raises on a
    tolerance breach or on non-finite cells in different places."""
    rel = ab = 0.0
    for name, a, b in zip(ref._fields, got, ref):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            raise AssertionError(f"{what}.{name}: non-finite cells differ "
                                 f"({int((~fa).sum())} vs {int((~fb).sum())})")
        d = torch.where(fb, (a - b).abs(), 0)
        scale = torch.where(fb, b.abs().clamp_min(1.0), 1.0)
        rel = max(rel, float((d / scale).max()))
        ab = max(ab, float(d.max()))
    if not rel <= tol:
        raise AssertionError(f"{what}: max rel err {rel:.3e} > {tol:g}")
    return rel, ab


def check_one_call(hk, cfl_dt, cfg, U, mask, what: str, errs: dict) -> float:
    """Both kernels vs their plain versions on copies of the same U: the
    wavespeed and the in-place inflow column bitwise, then the step from
    the same U and dt within STEP_TOL.  Folds the absolute errors into
    `errs`, counts the step's bitwise-equal cases in errs["bitwise"] and
    returns the step's max rel err."""
    a, b = clone_U(U), clone_U(U)
    wk = hk.inflow_wavespeed(cfg, a, mask)
    wp = hk.inflow_wavespeed_plain(cfg, b, mask)
    errs["wavespeed"] = max(errs["wavespeed"], float((wk - wp).abs()))
    if not torch.equal(wk.view(1), wp.view(1)):
        raise AssertionError(f"wavespeed {what}: kernel {float(wk)!r} != "
                             f"plain {float(wp)!r}")
    for fa, fb in zip(a, b):  # the in-place inflow column
        if not same(fa, fb):
            raise AssertionError(f"inflow column writes differ, {what}")
    dt = cfl_dt(wk, cfg.cfl, dx=1.0, nu_max=cfg.nu_max)
    ck = hk.step_core(cfg, a, mask, dt)
    cp = hk.step_core_plain(cfg, a, mask, dt)
    rel, ab = compare(ck, cp, f"step {what}", STEP_TOL[cfg.torch_dtype])
    errs["step"] = max(errs["step"], ab)
    count_bitwise(errs, what, ck, cp)
    return rel


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits, NaN payloads and the sign of zero included."""
    it = torch.int32 if a.element_size() == 4 else torch.int64
    return torch.equal(a.view(it), b.view(it))


def count_bitwise(errs: dict, what: str, got, ref) -> None:
    """Adds the case to errs["bitwise"] ([bitwise-equal cases, cases,
    the cases that are not])."""
    tally = errs.setdefault("bitwise", [0, 0, []])
    tally[1] += 1
    if all(bits_equal(a, b) for a, b in zip(got, ref)):
        tally[0] += 1
    else:
        tally[2].append(what)


# Phase 3's grids (nx, ny): block-aligned, ragged, and two against the
# step kernel's tile: not a multiple of it, and narrower than it in x;
# the last two with the NaN cell on a tile corner (or, narrower than a
# tile, on the corner of its part inside the grid).
HYP2D_KERNEL_GRIDS = ((256, 128), (200, 75), (45, 13), (13, 21))


def tile_corner(launch, nx: int, ny: int) -> tuple[int, int]:
    """(y, x) of the second tile row's first cell in the second tile
    column, clipped to the grid: a tile corner of the step's launch."""
    return (min(launch.tile_y, ny - 1), min(launch.tile_x, nx - 1))


def phase_kernels(h2, hk, interop, cfl_dt, device) -> dict:
    """Each kernel vs its plain version on identical inputs, step by step
    along the kernel path's trajectory, then the two 4-step trajectories."""
    errs = {"step": 0.0, "step_rel": {}, "wavespeed": 0.0}
    for dtype in (torch.float32, torch.float64):
        for nx, ny in HYP2D_KERNEL_GRIDS:
            cfg = h2.default_config(nx=nx, ny=ny,
                                    dtype=str(dtype).split(".")[1])
            plain = {"core": lambda U, m, dt, c=cfg: hk.step_core_plain(c, U, m, dt),
                     "wavespeed": lambda U, m, c=cfg: hk.inflow_wavespeed_plain(c, U, m)}
            corner = (tile_corner(hk.step_launch(ny, nx, dtype), nx, ny)
                      if (nx, ny) in HYP2D_KERNEL_GRIDS[2:] else None)
            sk = perturbed_state(h2, interop, cfg, device, corner)
            sp = h2.Hypersonic2DState(clone_U(sk.U), sk.mask, sk.t.clone())
            worst = 0.0
            for k in range(4):
                worst = max(worst, check_one_call(
                    hk, cfl_dt, cfg, sk.U, sk.mask,
                    f"{nx}x{ny} {dtype} call {k}", errs))
                sk = h2.step(cfg, sk)
                sp = h2.step(cfg, sp, **plain)
            torch.cuda.synchronize()
            rel, ab = compare(sk.U, sp.U, f"4 steps {nx}x{ny} {dtype}",
                              STEP_TOL[dtype])
            worst = max(worst, rel)
            errs["step"] = max(errs["step"], ab)
            n_nan = int((~torch.isfinite(sk.U.rho)).sum())
            if n_nan == 0:
                raise AssertionError("the injected NaN cell vanished")
            key = f"{nx}x{ny} {str(dtype).split('.')[1]}"
            errs["step_rel"][key] = worst
            log(f"[kernels] {key}: step max rel err {worst:.3e} "
                f"(tol {STEP_TOL[dtype]:g}), wavespeed bitwise equal, "
                f"{n_nan} NaN cells in the same places after 4 steps")
    ok, n, differ = errs["bitwise"]
    log(f"[kernels] step kernel bitwise equal to its plain version in {ok} "
        f"of {n} calls; not in {differ}")
    return errs


def time_launches(fn, n: int) -> float:
    """Mean ms per call of fn() over n calls, by CUDA events, after one
    warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int, fragment: str | tuple) -> float | None:
    """Device time a call of fn() by torch.profiler: the kernels whose name
    holds `fragment` (or one of a tuple of them) over n calls, after one
    warm-up call; a profile that recorded no such kernel is taken again,
    up to three times, and None where none did."""
    fragments = (fragment,) if isinstance(fragment, str) else fragment
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(f in e.name for f in fragments)]
        if us:
            return sum(us) / n / 1e3
    return None


def ms_text(v: float | None) -> str:
    """A device time for a log line: "not recorded" where the profiler
    recorded none."""
    return "not recorded" if v is None else f"{v:.4f} ms"


def run_timed(h2, cfg, s, steps, **engine):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = h2.run(cfg, s, steps, **engine)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_physics(h2, regression, cfg, out, steps, bow_shock: bool) -> None:
    U, mask = out.U, out.mask
    fluid = ~mask
    for name, f in zip(U._fields, U):
        if not bool(torch.isfinite(f[fluid]).all()):
            raise AssertionError(f"non-finite {name} in fluid cells")
    snap = regression.compute_snapshot(cfg, out, steps)
    if not (snap["fluid_cells"] > 0 and snap["min_rho"] >= 1e-25
            and snap["min_p"] > 0):
        raise AssertionError(f"physical invariants violated: {snap}")
    msg = (f"[physics] {cfg.nx}x{cfg.ny} {cfg.dtype}: fluid cells finite, "
           f"min_rho {snap['min_rho']:.4g}, min_p {snap['min_p']:.4g}, "
           f"max_mach {snap['max_mach']:.4g}, t {float(out.t):.6f}")
    if bow_shock:
        # upstream of the body: the fluid cells left of each row's first
        # solid cell
        m = mask.cpu().numpy()
        rho = U.rho.cpu().numpy()
        rows = np.flatnonzero(m.any(axis=1))
        first = m[rows].argmax(axis=1)
        up = max(float(rho[r, :c].max()) for r, c in zip(rows, first) if c > 0)
        if not up > 1.5:
            raise AssertionError(f"no bow shock: max rho upstream {up:.4g}")
        msg += f", bow shock: max rho upstream of the body {up:.4g}"
    log(msg)


def phase_main(h2, hk, regression, cfl_dt, device, smi, errs) -> dict:
    hk.reset_launches()
    runs = []
    for nx, ny, dtype, steps, bow in ((2048, 2048, "float32", 200, True),
                                      (8192, 1024, "float64", 50, False)):
        cfg = h2.default_config(nx=nx, ny=ny, dtype=dtype)
        before = dict(hk.LAUNCHES)
        out, wall = run_timed(h2, cfg, h2.init(cfg, device), steps)
        for k in ("step", "wavespeed"):
            if hk.LAUNCHES[k] - before[k] != steps:
                raise AssertionError(
                    f"{k} kernel launched {hk.LAUNCHES[k] - before[k]} times "
                    f"in {steps} steps")
        plain = {"core": lambda U, m, dt, c=cfg: hk.step_core_plain(c, U, m, dt),
                 "wavespeed": lambda U, m, c=cfg: hk.inflow_wavespeed_plain(c, U, m)}
        pl_steps = 20
        _, pl_wall = run_timed(h2, cfg, h2.init(cfg, device), pl_steps, **plain)
        if hk.LAUNCHES["step"] - before["step"] != steps:
            raise AssertionError("the plain version launched a kernel")
        cells = nx * ny
        k_rate, p_rate = steps / wall, pl_steps / pl_wall
        log(f"[main] {nx}x{ny} {dtype} on {smi}: kernels {steps} steps "
            f"{k_rate:.2f} steps/s {cells * k_rate / 1e6:.1f} Mcell-steps/s; "
            f"plain torch {pl_steps} steps {p_rate:.2f} steps/s "
            f"{cells * p_rate / 1e6:.1f} Mcell-steps/s; kernel launches "
            f"step={hk.LAUNCHES['step'] - before['step']} "
            f"wavespeed={hk.LAUNCHES['wavespeed'] - before['wavespeed']}")
        check_physics(h2, regression, cfg, out, steps, bow)
        runs.append((cfg, out))
    launches = dict(hk.LAUNCHES)

    # Both kernels vs their plain versions at the main path's shapes, on
    # the state each run ended in; then per-launch times there.  None of
    # these launches is counted above.
    times = {}
    for cfg, out in runs:
        U, mask = out.U, out.mask
        key = f"{cfg.nx}x{cfg.ny} {cfg.dtype}"
        rel = check_one_call(hk, cfl_dt, cfg, U, mask, key, errs)
        errs["step_rel"][key] = rel
        log(f"[main] {key}: kernels vs plain from the final state: step max "
            f"rel err {rel:.3e} (tol {STEP_TOL[cfg.torch_dtype]:g}), NaN "
            f"cells in the same places, wavespeed and inflow column bitwise "
            f"equal")
        dt = torch.full((), 1e-3, dtype=cfg.torch_dtype, device=device)
        times[key] = {
            "step": time_launches(lambda: hk.step_core(cfg, U, mask, dt), 20),
            "step_plain": time_launches(
                lambda: hk.step_core_plain(cfg, U, mask, dt), 3),
            "wavespeed": time_launches(
                lambda: hk.inflow_wavespeed(cfg, U, mask), 50),
            "wavespeed_plain": time_launches(
                lambda: hk.inflow_wavespeed_plain(cfg, U, mask), 10),
        }
        t = times[key]
        log(f"[main] per launch at {key} on {smi}: step kernel "
            f"{t['step']:.4f} ms vs plain {t['step_plain']:.4f} ms; wavespeed "
            f"kernel {t['wavespeed']:.4f} ms vs plain "
            f"{t['wavespeed_plain']:.4f} ms")
    ok, n, differ = errs["bitwise"]
    log(f"[main] step kernel bitwise equal to its plain version in {ok} of "
        f"{n} calls of phases 3 and 4; not in {differ}")
    return {"launches": launches, "times": times}


def bound(bytes_moved: float, ops: float, dtype) -> tuple[float, str]:
    """(least ms, "bytes" or "operations") for the work on an H100."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def hyp2d_bounds(cfg, mask) -> dict:
    """bound_ms of both hypersonic kernels at cfg's shape."""
    cells = cfg.nx * cfg.ny
    fluid = int((~mask).sum())
    T = torch.finfo(cfg.torch_dtype).bits // 8
    return {"step": bound(cells * (8 * T + 1),
                          fluid * HYP2D_STEP_OPS_PER_FLUID_CELL,
                          cfg.torch_dtype),
            "wavespeed": bound(cells * (4 * T + 1),
                               fluid * HYP2D_WAVESPEED_OPS_PER_FLUID_CELL,
                               cfg.torch_dtype)}


# ---------------------------------- SPH ------------------------------------

def sph_pairs(sk, cfg, b) -> dict:
    """This binning's pair counts: candidates (every particle x every
    member of the 3x3 cells around it, self included: what the pair
    kernels walk) and those within 2h, self excluded."""
    p = sk._params(cfg)
    x, y = b.fields[:, 0], b.fields[:, 1]
    cand = near = 0
    for recv, nbr in sk.pair_chunks(cfg, b):
        cand += recv.numel()
        dx, dy = x[recv] - x[nbr], y[recv] - y[nbr]
        r2 = dx * dx + dy * dy
        near += int(((recv != nbr) & (r2 < p.four_h2) & (r2 > 1e-16)).sum())
    return {"candidates": cand, "near": near}


def sph_bounds(sk, cfg, b) -> dict:
    """bound_ms of the three SPH kernels for this binning."""
    n, g = cfg.n, cfg.grid()
    M = g.Gx * g.Gy
    T = torch.finfo(cfg.torch_dtype).bits // 8
    pr = sph_pairs(sk, cfg, b)
    dc, dn, dp = SPH_DENSITY_OPS
    fc, fn, fp = SPH_FORCES_OPS
    return {
        "bin": bound(n * 4 * T + n * (4 + 4 + 4 + 4 * T) + 4 * (M + 1),
                     n * SPH_BIN_OPS_PER_PARTICLE, cfg.torch_dtype),
        "density": bound(n * 4 * T + 4 * (M + 1) + n * 2 * T,
                         dc * pr["candidates"] + dn * pr["near"] + dp * n,
                         cfg.torch_dtype),
        "forces": bound(n * 6 * T + 4 * (M + 1) + 4 * n + T + n * 4 * T,
                        fc * pr["candidates"] + fn * pr["near"] + fp * n,
                        cfg.torch_dtype),
        "pairs": pr}


def rel_err(got, ref) -> tuple[float, float]:
    """(max |err| / max |ref|, max |err|); raises on non-finite values."""
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(ref).all())):
        raise AssertionError("non-finite values")
    ab = float((got - ref).abs().max())
    return ab / max(float(ref.abs().max()), 1e-300), ab


def check_sph_call(sk, cfg, pos, vel, what: str, errs: dict) -> dict:
    """The three SPH kernels against their plain versions on the same
    inputs: the binning bitwise, then density from the kernel's binning
    and forces + integrate from the kernel's binning and density, all
    pairs kept.  Folds the absolute errors into `errs`; returns the max
    rel errors."""
    tol = STEP_TOL[cfg.torch_dtype]
    b = sk.binning(cfg, pos, vel)
    bp = sk.binning_plain(cfg, pos, vel)
    for name, x, y in zip(b._fields, b, bp):
        if not torch.equal(x, y):
            raise AssertionError(f"bin {what}: {name} differs from the plain "
                                 f"version")
    out = {}
    rp = sk.density(cfg, b)
    rpp = sk.density_plain(cfg, b)
    # the density lanes' sums combine in a fixed order too
    if not bits_equal(rp, sk.density(cfg, b)):
        raise AssertionError(f"density {what}: two launches on the same "
                             "input differ")
    errs["density_repeat_bitwise"] = (
        errs.get("density_repeat_bitwise", 0) + 1)
    out["density"] = max(rel_err(rp[:, k], rpp[:, k])[0] for k in (0, 1))
    errs["density"] = max(errs["density"], float((rp - rpp).abs().max()))
    dt_cfl = cfg.cfl * cfg.h / (cfg.c0 * (1.0 + 2.0 * cfg.visc_alpha))
    dt = torch.full((), dt_cfl, dtype=pos.dtype, device=pos.device)
    pk, vk = sk.forces(cfg, b, rp, dt)
    pp, vp = sk.forces_plain(cfg, b, rp, dt)
    (rp_, ap), (rv_, av) = rel_err(pk, pp), rel_err(vk, vp)
    out["forces"] = max(rp_, rv_)
    errs["forces"] = max(errs["forces"], ap, av)
    for k in ("density", "forces"):
        if not out[k] <= tol:
            raise AssertionError(f"{k} {what}: max rel err {out[k]:.3e} > "
                                 f"{tol:g}")
    # the lanes' sums combine in a fixed order: a second launch repeats
    # the first one's bits
    pk2, vk2 = sk.forces(cfg, b, rp, dt)
    if not (bits_equal(pk, pk2) and bits_equal(vk, vk2)):
        raise AssertionError(f"forces {what}: two launches on the same "
                             "input differ")
    errs["repeat_bitwise"] = errs.get("repeat_bitwise", 0) + 1
    past = int((b.rank >= cfg.grid().K).sum())
    log(f"[sph] {what}: bin bitwise equal ({past} of {cfg.n} past the torch "
        f"engine's K={cfg.grid().K}, all in the pair sums); density max rel "
        f"err {out['density']:.3e}, forces+integrate {out['forces']:.3e} "
        f"(tol {tol:g}); density and forces twice bitwise equal")
    return out


def crowded_pool(sk, ts, cfg, device, rng, crowd: int = 1500):
    """(pos, vel, candidates): init() with `crowd` particles (at least 500
    more than the density kernel's chunk) packed into cell (3, 2) and
    seeded velocity noise; raises unless that cell's 3x3 neighbourhood
    holds more candidates than the density and the forces kernels each
    stage at once (their reported chunks), so that both kernels' chunk
    loops run more than once."""
    chunks = {"density": sk.density_shape(cfg).chunk,
              "forces": sk.forces_shape(cfg).chunk}
    crowd = min(max(crowd, chunks["density"] + 500), cfg.n - 96)
    c = cfg.grid().cell
    pos = ts.init(cfg, torch.device("cpu")).pos.clone()
    for k, at in ((0, 3.5), (1, 2.5)):
        pos[:crowd, k] = torch.tensor(
            at * c + 0.45 * c * rng.uniform(-1, 1, crowd), dtype=pos.dtype)
    vel = torch.tensor(0.5 * rng.standard_normal((cfg.n, 2)),
                       dtype=cfg.torch_dtype)
    b = sk.binning_plain(cfg, pos, vel)
    g = cfg.grid()
    starts = b.starts.long()
    hood = sum(int(starts[y * g.Gx + 5] - starts[y * g.Gx + 2])
               for y in (1, 2, 3))
    for name, chunk in chunks.items():
        if not hood > chunk:
            raise AssertionError(f"crowded pool: {hood} candidates around "
                                 f"cell (3, 2), not more than a {name} "
                                 f"chunk of {chunk}")
    return pos.to(device), vel.to(device), hood


# The bin's adversarial cases (phase 6; tools/tune_tiles_torch.py check
# runs them too): (name, particles, rain, particles packed into cell (3, 2),
# dtypes).  All particles in one cell; a cell of more members than the
# kernel sorts in one chunk at 2^16; 2^20 from init on 256^2, the top of
# the box empty.
BIN_CHECK = (("one cell", 4096, False, 4096, ("float32", "float64")),
             ("crowded 2^16", 65536, False, 3000, ("float32", "float64")),
             ("2^20 rain on 256^2", 1 << 20, True, 0, ("float32",)))


def bin_case(ts, n: int, rain: bool, crowd: int, dtype: str, device, rng):
    """(cfg, pos, vel): init() with `crowd` particles packed into cell (3,
    2) and seeded velocity noise."""
    cfg = ts.SPHConfig(n=n, rain=rain, dtype=dtype)
    pos = ts.init(cfg, torch.device("cpu")).pos.clone()
    c = cfg.grid().cell
    for k, at in ((0, 3.5), (1, 2.5)):
        pos[:crowd, k] = torch.tensor(
            at * c + 0.45 * c * rng.uniform(-1, 1, crowd), dtype=pos.dtype)
    vel = torch.tensor(0.5 * rng.standard_normal((n, 2)),
                       dtype=cfg.torch_dtype)
    return cfg, pos.to(device), vel.to(device)


def check_bin_cases(sk, ts, device, errs) -> None:
    """Each BIN_CHECK case's bin bitwise equal to binning_plain in all five
    outputs, or the script fails; the cases counted in
    errs["bin_bitwise"]."""
    rng = np.random.default_rng(SEED + 22)
    ok = errs.setdefault("bin_bitwise", [0, 0])
    for name, n, rain, crowd, dtypes in BIN_CHECK:
        for dtype in dtypes:
            cfg, pos, vel = bin_case(ts, n, rain, crowd, dtype, device, rng)
            got = sk.binning(cfg, pos, vel)
            ref = sk.binning_plain(cfg, pos, vel)
            for field, x, y in zip(got._fields, got, ref):
                if not bits_equal(x, y):
                    raise AssertionError(f"bin {name} {dtype}: {field} "
                                         "differs from the plain version")
            counts = torch.bincount(ref.cid.long(),
                                    minlength=ref.starts.numel() - 1)
            empty = int((counts == 0).sum())
            if rain and not empty:
                raise AssertionError(f"bin {name}: no empty cell")
            ok[0] += 1
            ok[1] += 1
            g = cfg.grid()
            log(f"[sph] bin {name} {dtype} (n={n}, {g.Gx}x{g.Gy} cells, "
                f"largest {int(counts.max())}, {empty} empty): bitwise equal "
                "to the plain version")


def check_sph_exact(sk, ts, cfg, pos, vel, what: str, errs: dict) -> dict:
    """Density and forces + integrate of the kernels against the 'exact'
    engine's all-pairs functions on the same state (the kernels' density
    is in sorted order).  Same bars as check_sph_call."""
    tol = STEP_TOL[cfg.torch_dtype]
    b = sk.binning(cfg, pos, vel)
    order = b.order.long()
    rp = sk.density(cfg, b)
    _, rho, press = ts._exact_density(cfg, pos)
    ref = torch.stack([rho, press / torch.clamp(rho, min=1e-30) ** 2],
                      -1)[order]
    out = {"density": max(rel_err(rp[:, k], ref[:, k])[0] for k in (0, 1))}
    errs["density"] = max(errs["density"], float((rp - ref).abs().max()))
    dt = torch.full((), 1e-3, dtype=pos.dtype, device=pos.device)
    pk, vk = sk.forces(cfg, b, rp, dt)
    acc = ts._exact_forces(cfg, pos, vel, rho, press)
    pe, ve = ts._integrate(cfg, pos, vel, acc, dt)
    (rp_, ap), (rv_, av) = rel_err(pk, pe), rel_err(vk, ve)
    out["forces"] = max(rp_, rv_)
    errs["forces"] = max(errs["forces"], ap, av)
    for k in ("density", "forces"):
        if not out[k] <= tol:
            raise AssertionError(f"{k} {what} vs exact engine: max rel err "
                                 f"{out[k]:.3e} > {tol:g}")
    past = int((b.rank >= cfg.grid().K).sum())
    log(f"[sph] {what}: {past} of {cfg.n} past K={cfg.grid().K}; kernels vs "
        f"the exact engine: density max rel err {out['density']:.3e}, "
        f"forces+integrate {out['forces']:.3e} (tol {tol:g})")
    return out


def plain_sph_step(sk, ts, cfg):
    """The cuda engine's frame step with each kernel's plain version."""
    def substep(pos, vel, dt_sub):
        b = sk.binning_plain(cfg, pos, vel)
        return sk.forces_plain(cfg, b, sk.density_plain(cfg, b), dt_sub)
    return lambda st: ts._advance(cfg, st, None, substep)


def phase_sph_kernels(sk, ts, device) -> dict:
    errs = {"density": 0.0, "forces": 0.0, "rel": {}}
    check_bin_cases(sk, ts, device, errs)
    rng = np.random.default_rng(SEED)
    for dtype in ("float32", "float64"):
        for n, cap in ((4096, 0), (512, 8)):
            cfg = ts.SPHConfig(n=n, cell_capacity=cap, dtype=dtype)
            st = ts.init(cfg, device)
            vel = torch.tensor(0.5 * rng.standard_normal((n, 2)),
                               dtype=cfg.torch_dtype, device=device)
            key = f"n={n} K={cfg.grid().K} {dtype}"
            errs["rel"][key] = (
                check_sph_exact(sk, ts, cfg, st.pos, vel, key, errs) if cap
                else check_sph_call(sk, cfg, st.pos, vel, key, errs))
        cfg = ts.SPHConfig(n=4096, dtype=dtype)
        pos, vel, hood = crowded_pool(sk, ts, cfg, device, rng)
        key = (f"n=4096 crowded ({hood} candidates around one cell; chunks "
               f"density {sk.density_shape(cfg).chunk}, forces "
               f"{sk.forces_shape(cfg).chunk}) {dtype}")
        errs["rel"][key] = check_sph_call(sk, cfg, pos, vel, key, errs)
    cfg = ts.SPHConfig(n=4096, rain=True, dtau=1e-2)
    a = b = ts.init(cfg, device)
    plain = plain_sph_step(sk, ts, cfg)
    for _ in range(5):
        a, b = ts.step(cfg, a), plain(b)
    torch.cuda.synchronize()
    dp = float((a.pos - b.pos).abs().max())
    dv = float((a.vel - b.vel).abs().max())
    if not (dp <= 2e-6 and dv <= 2e-5):
        raise AssertionError(f"5 steps cuda vs plain: pos {dp:.3e} vel "
                             f"{dv:.3e} (atol 2e-6 / 2e-5)")
    log(f"[sph] 5 steps n=4096 f32 rain, cuda engine vs plain versions: max "
        f"|d pos| {dp:.3e} (atol 2e-6), |d vel| {dv:.3e} (atol 2e-5)")
    errs["trajectory"] = {"pos": dp, "vel": dv}
    return errs


def check_sph_physics(ts, cfg, st0, out) -> dict:
    pos = out.pos
    if not (bool(torch.isfinite(pos).all())
            and bool(torch.isfinite(out.vel).all())):
        raise AssertionError("non-finite SPH state")
    inside = ((pos[:, 0] >= 0) & (pos[:, 0] <= cfg.box_x)
              & (pos[:, 1] >= 0) & (pos[:, 1] <= cfg.box_y))
    if not bool(inside.all()):
        raise AssertionError(f"{int((~inside).sum())} particles outside the box")
    y0, y1 = float(st0.pos[:, 1].mean()), float(pos[:, 1].mean())
    if not y1 < y0:
        raise AssertionError(f"mean height {y1:.6f} not below initial {y0:.6f}")
    if not float(out.tau) > 0:
        raise AssertionError(f"tau {float(out.tau)} not > 0")
    ov = int(ts.overflow_count(cfg, out))
    if ov != 0:
        raise AssertionError(f"overflow_count {ov}: the cuda engine drops "
                             "no pair")
    past = int(ts.overflow_count(cfg.replace(engine="torch"), out))
    log(f"[physics] sph n={cfg.n}: finite, all in the box, mean height "
        f"{y0:.6f} -> {y1:.6f}, tau {float(out.tau):.6f}, t {float(out.t):.6f}; "
        f"overflow_count 0 (every pair kept; {past} of {cfg.n} particles are "
        f"past the torch engine's K={cfg.grid().K})")
    return {"overflow": ov, "past_k": past, "mean_y0": y0, "mean_y": y1}


# (n, rain, steps): bench.py's configuration, and 2^20 with the CLI's rain
SPH_RUNS = ((65536, False, 200), (1 << 20, True, 50))


def phase_sph_main(sk, ts, device, smi, errs, runs=SPH_RUNS) -> dict:
    res = {}
    for n, rain, steps in runs:
        cfg = ts.SPHConfig(n=n, rain=rain)
        engine = ts.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"engine auto resolved to {engine!r}")
        st0 = ts.init(cfg, device)
        ts.run(cfg, st0, 1)   # warm-up, not counted
        sk.reset_launches()
        out, wall = run_timed(ts, cfg, st0, steps)
        launches = dict(sk.LAUNCHES)
        want = steps * cfg.visc_substeps
        if any(v != want for v in launches.values()):
            raise AssertionError(f"launches {launches} in {steps} steps, "
                                 f"want {want} each")
        # the plain engine: 20 steps at 65,536; one step (one substep) at
        # 2^20, whose dense pair blocks take GBs
        pcfg = cfg.replace(engine="torch")
        p_steps = 20 if n <= 65536 else 1
        _, p_wall = run_timed(ts, pcfg, st0, p_steps)
        if sk.LAUNCHES != launches:
            raise AssertionError("the plain engine launched a kernel")
        rate, p_rate = cfg.n * steps / wall / 1e6, cfg.n * p_steps / p_wall / 1e6
        log(f"[sph] n={cfg.n} f32 rain={cfg.rain} engine={engine} on {smi}: "
            f"{steps} steps in {wall:.3f} s, {rate:.2f} M particle-steps/s "
            f"({steps / wall:.1f} steps/s); plain torch engine {p_steps} "
            f"step(s) {p_rate:.3f} M particle-steps/s; launches {launches}")
        phys = check_sph_physics(ts, cfg, st0, out)
        g = cfg.grid()
        shape = sk.bin_launch(cfg.n, g.Gx * g.Gy, cfg.torch_dtype,
                              device.index)
        syncs = sk.bin_grid_syncs(cfg, cfg.torch_dtype, device)
        if syncs != shape.grid_syncs:
            raise AssertionError(f"bin n={n}: the kernel counted {syncs} "
                                 f"grid syncs, want {shape.grid_syncs}")
        log(f"[sph] bin n={cfg.n}: a cooperative and a plain launch a call "
            f"{shape.asdict()}, {syncs} grid syncs as the kernel counted "
            "them")

        key = f"n={cfg.n} final state f32"
        errs["rel"][key] = check_sph_call(sk, cfg, out.pos, out.vel, key,
                                          errs)
        b = sk.binning(cfg, out.pos, out.vel)
        rp = sk.density(cfg, b)
        dt = ts._frame_dt(cfg, out, None)
        big = n > 65536
        times = {
            "bin": time_launches(lambda: sk.binning(cfg, out.pos, out.vel), 20),
            "bin_plain": time_launches(
                lambda: sk.binning_plain(cfg, out.pos, out.vel), 10),
            "density": time_launches(lambda: sk.density(cfg, b), 20),
            "density_plain": time_launches(lambda: sk.density_plain(cfg, b),
                                           2 if big else 5),
            "forces": time_launches(lambda: sk.forces(cfg, b, rp, dt), 20),
            "forces_plain": time_launches(lambda: sk.forces_plain(cfg, b, rp, dt),
                                          2 if big else 5),
            "density_device": device_ms(lambda: sk.density(cfg, b), 20,
                                        "density_kernel"),
            "bin_device": device_ms(
                lambda: sk.binning(cfg, out.pos, out.vel), 20,
                ("bin_kernel", "bin_rank_kernel")),
        }
        bounds = sph_bounds(sk, cfg, b)
        log(f"[sph] per launch at n={cfg.n} f32 on {smi}: " + ", ".join(
            f"{k} {times[k]:.4f} ms vs plain {times[k + '_plain']:.4f} ms "
            f"(bound {bounds[k][0]:.4f} ms, {bounds[k][1]})"
            for k in ("bin", "density", "forces")) + f"; pairs {bounds['pairs']}")
        res[n] = {"launches": launches, "times": times, "bounds": bounds,
                  "rate": rate, "plain_rate": p_rate, "physics": phys,
                  "bin_launch": {**shape.asdict(),
                                 "grid_syncs_counted": syncs}}
    return res


# ------------------------------- 3-D hypersonic -----------------------------

def hyp3d_state(h3, interop, cfg, device, seed):
    """init() with u0 = 0.05 in the fluid cells (the transmissive outlet's
    reversed-flow branch is then well determined) and seeded noise on
    every log field of the fluid cells."""
    s = h3.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    fl = ~s.solid.numpy()
    f = [x.numpy().astype(np.float64) for x in s[:6]]
    f[1][fl] = np.arcsinh(0.05 / cfg.u_ref)
    for k, amp in enumerate((0.3, 0.05, 0.05, 0.05, 0.3, 0.3)):
        f[k] = f[k] + np.where(fl, amp * rng.standard_normal(f[k].shape), 0.0)
    return interop.hyp3d_state_from_numpy(*f, s.solid.numpy(), cfg.t0,
                                          cfg.dtau0, dtype=cfg.torch_dtype,
                                          device=device)


def rel_fields(got, ref, what: str, tol: float) -> tuple[float, float]:
    """max over fields of max|err| / max|ref| (finite cells), and max|err|;
    raises on a breach or on non-finite cells in different places."""
    rel = ab = 0.0
    for name, a, b in zip(ref._fields, got, ref):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            raise AssertionError(f"{what}.{name}: non-finite cells differ "
                                 f"({int((~fa).sum())} vs {int((~fb).sum())})")
        if not bool(fb.any()):
            continue
        d = float((a[fb] - b[fb]).abs().max())
        rel = max(rel, d / max(float(b[fb].abs().max()), 1e-300))
        ab = max(ab, d)
    if not rel <= tol:
        raise AssertionError(f"{what}: max rel err {rel:.3e} > {tol:g}")
    return rel, ab


def check_hyp3d_call(h3, hk3, cfg, s, what: str, errs: dict,
                     inject: bool, nan_at=None) -> float:
    """Both 3-D kernels vs their plain versions on the same inputs: the
    step from the padded prims of `s` (with a NaN, a negative-pressure and
    an infinite-velocity cell when `inject`; the NaN at interior cell
    `nan_at`, (z, y, x), or at (nz / 4, ny / 5, nx / 6)) at the state's
    CFL dt, then the wavespeed of its result (with a NaN cell) bitwise.
    Folds the absolute errors into `errs` and counts the step's
    bitwise-equal cases in errs["bitwise"]; returns the step's max rel
    err."""
    dev = s.xi.device
    sp = h3.solid_pad_of(cfg, dev)
    q = h3._decode(cfg, *s[:6])
    qp = h3.PrimT(*(f.clone() for f in h3._padded_prims(cfg, q, sp)))
    if inject:
        nz, ny, nx = cfg.nz, cfg.ny, cfg.nx
        zn, yn, xn = nan_at or (nz // 4, ny // 5, nx // 6)
        qp.r[3 + zn, 3 + yn, 3 + xn] = float("nan")
        qp.p[3 + nz // 2, 3 + ny // 7, 3 + (3 * nx) // 4] = -0.5
        qp.u[3 + (3 * nz) // 4, 3 + ny // 3, 3 + nx - 2] = float("inf")
    dt = torch.div(torch.full((), cfg.cfl, dtype=cfg.torch_dtype, device=dev),
                   hk3.wavespeed_plain(cfg, q, s.solid))
    gain = torch.full((), 0.6, dtype=cfg.torch_dtype, device=dev)
    ck = hk3.step_core(cfg, qp, sp, dt, gain)
    cp = hk3.step_core_plain(cfg, qp, sp, dt, gain)
    rel, ab = rel_fields(ck, cp, f"hyp3d step {what}",
                         STEP_TOL[cfg.torch_dtype])
    errs["step"] = max(errs["step"], ab)
    count_bitwise(errs, what, ck, cp)
    q1 = h3.PrimT(*(f.clone() for f in cp))
    fluid = (~s.solid).nonzero()
    q1.v[tuple(fluid[len(fluid) // 2])] = float("nan")
    wk = hk3.wavespeed(cfg, q1, s.solid)
    wp = hk3.wavespeed_plain(cfg, q1, s.solid)
    errs["wavespeed"] = max(errs["wavespeed"], float((wk - wp).abs()))
    if not torch.equal(wk.view(1), wp.view(1)):
        raise AssertionError(f"hyp3d wavespeed {what}: kernel {float(wk)!r} "
                             f"!= plain {float(wp)!r}")
    return rel


def plain3(hk3, cfg) -> dict:
    """run()/step() hooks of the plain engine."""
    return {"core": lambda qp, sp, dt, g: hk3.step_core_plain(cfg, qp, sp,
                                                              dt, g),
            "wavespeed": lambda q1, solid: hk3.wavespeed_plain(cfg, q1, solid),
            "pad": lambda s, sp: hk3.pad_plain(cfg, s, sp)}


def slab_case(h3, s, cfg, ranks: int, rank: int):
    """(config, state, padded mask) of `rank`'s extended z-slab of the
    global state `s` as the sharded runner steps it: the rank's slices
    with HALO more from each ring neighbour, and the mask from a ring of
    2 * HALO slices, wrapped in y and padded with False in x
    (hypersonic3d_sharded._solid_pad), gathered here on one device."""
    from dataclasses import replace

    H, nzl = h3.HALO, cfg.nz // ranks
    dev = s.xi.device

    def ring(f, h):
        idx = torch.arange(rank * nzl - h, (rank + 1) * nzl + h, device=dev)
        return f[idx % cfg.nz]

    fields = [ring(f, H) for f in s[:6]]
    sp = ring(s.solid, 2 * H)
    sp = torch.cat([sp[:, -H:, :], sp, sp[:, :H, :]], dim=1)
    zf = torch.zeros((sp.shape[0], sp.shape[1], H), dtype=torch.bool,
                     device=dev)
    sp = torch.cat([zf, sp, zf], dim=2).contiguous()
    st = h3.Hypersonic3DState(*fields, solid=ring(s.solid, H), t=s.t,
                              dtau=s.dtau)
    return replace(cfg, nz=nzl + 2 * H), st, sp


def with_bad_cells(h3, cfg, s):
    """`s` with a NaN and an infinite velocity in the last column (the
    outflow ghosts' source) and a NaN pressure inside."""
    f = [x.clone() for x in s[:6]]
    nz, ny, nx = cfg.nz, cfg.ny, cfg.nx
    f[0][nz // 3, ny // 4, nx - 1] = float("nan")
    f[1][(2 * nz) // 3, ny // 2, nx - 1] = float("inf")
    f[4][nz // 2, ny // 3, nx // 2] = float("nan")
    return h3.Hypersonic3DState(*f, solid=s.solid, t=s.t, dtau=s.dtau)


def check_pad(h3, hk3, cfg, s, sp, what: str) -> None:
    """The prologue kernel bitwise equal to the plain prologue."""
    got = hk3.pad(cfg, s, sp)
    want = hk3.pad_plain(cfg, s, sp)
    for name, a, b in zip(h3.PrimT._fields, got, want):
        if a.shape != b.shape or not bits_equal(a, b):
            n = int((a.view(-1) != b.view(-1)).sum()) \
                if a.shape == b.shape else -1
            raise AssertionError(f"hyp3d pad {what}.{name}: not bitwise "
                                 f"equal to the plain prologue ({n} cells "
                                 "differ)")


def check_pad_cases(h3, hk3, interop, device) -> int:
    """The prologue kernel bitwise equal to its plain version on every
    HYP3D_PAD_GRIDS grid and on the sharded runner's z-slab, f32 and f64,
    both outflow modes, from hyp3d_state with NaN and infinite cells: the
    cases it ran."""
    cases = 0
    for dtype in ("float32", "float64"):
        for outflow in ("transmissive", "characteristic"):
            for nz, ny, nx in HYP3D_PAD_GRIDS:
                cfg = h3.Hypersonic3DConfig(
                    nx=nx, ny=ny, nz=nz, dx=1.0 / nx, dy=1.0 / ny,
                    dz=1.0 / nz, outflow=outflow, dtype=dtype)
                s = with_bad_cells(h3, cfg, hyp3d_state(
                    h3, interop, cfg, device, SEED + cases))
                check_pad(h3, hk3, cfg, s, h3.solid_pad_of(cfg, device),
                          f"{nz}x{ny}x{nx} {dtype} {outflow}")
                cases += 1
            n = HYP3D_PAD_SLAB_N
            cfg = h3.default_config(n, outflow=outflow, dtype=dtype)
            s = hyp3d_state(h3, interop, cfg, device, SEED + cases)
            cfg_ext, st, sp = slab_case(h3, s, cfg, HYP3D_PAD_SLAB_RANKS, 1)
            check_pad(h3, hk3, cfg_ext, st, sp,
                      f"z-slab {tuple(st.xi.shape)} of {n}^3 {dtype} "
                      f"{outflow}")
            cases += 1
    log(f"[hyp3d] prologue kernel bitwise equal to the plain prologue in "
        f"{cases} cases: {HYP3D_PAD_GRIDS} and rank 1's z-slab of "
        f"{HYP3D_PAD_SLAB_N}^3 over {HYP3D_PAD_SLAB_RANKS} ranks, f32/f64, "
        "transmissive/characteristic, NaN and infinite cells")
    return cases


def check_pad_steps(h3, hk3, device, steps: int = 3) -> dict:
    """`steps` steps of default_config(64) under the sync debug mode
    "error" (no step may wait for the device), each launching the
    prologue once."""
    cfg = h3.default_config(64)
    s = h3.init(cfg, device)
    s = h3.step(cfg, s)   # builds the padded mask, loads the library
    torch.cuda.synchronize()
    hk3.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(steps):
            s = h3.step(cfg, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = dict(hk3.LAUNCHES)
    if launches["pad"] != steps:
        raise AssertionError(f"pad launched {launches['pad']} times in "
                             f"{steps} steps")
    log(f"[hyp3d] {steps} steps of 64^3 f32 under sync debug mode 'error': "
        f"no sync; launches {launches}")
    return launches


def pad_times(h3, hk3, cfg, s, smi) -> dict:
    """The prologue of state `s`: the kernel's device time a launch
    (torch.profiler), its wrapper call and the plain prologue's (CUDA
    events), against its bound."""
    sp = h3.solid_pad_of(cfg, s.xi.device)
    T = torch.finfo(cfg.torch_dtype).bits // 8
    cells = cfg.nx * cfg.ny * cfg.nz
    padded = (cfg.nx + 6) * (cfg.ny + 6) * (cfg.nz + 6)
    b = bound(cells * 6 * T + padded * (1 + 6 * T),
              padded * HYP3D_PAD_OPS_PER_CELL, cfg.torch_dtype)
    res = {"device": device_ms(lambda: hk3.pad(cfg, s, sp), 20,
                               "pad3_kernel"),
           "call": time_launches(lambda: hk3.pad(cfg, s, sp), 20),
           "plain": time_launches(lambda: hk3.pad_plain(cfg, s, sp), 5),
           "bound": b}
    log(f"[hyp3d] prologue {cfg.nx}^3 {cfg.dtype} on {smi}: kernel "
        f"{ms_text(res['device'])} of device time a launch, "
        f"{res['call']:.4f} ms a wrapper call (events); plain prologue "
        f"{res['plain']:.4f} ms; bound {b[0]:.4f} ms ({b[1]})")
    return res


# Phase 8's grids (nz, ny, nx): non-cubic, cubic, and two against the
# step kernel's tile: not a multiple of it, and narrower than it in every
# axis; the last two with the NaN cell on a tile corner (the second tile
# of each axis, clipped to the grid).
HYP3D_KERNEL_GRIDS = ((24, 40, 56), (32, 32, 32), (9, 13, 19), (3, 7, 5))
# The prologue kernel's grids (nz, ny, nx): phase 8's kernel grids, 64^3
# and 256^3; then the z-slab of the sharded runner (parallel/
# hypersonic3d_sharded) of rank 1 of HYP3D_PAD_SLAB_RANKS on a
# HYP3D_PAD_SLAB_N^3 grid, with its own padded mask
HYP3D_PAD_GRIDS = HYP3D_KERNEL_GRIDS + ((64, 64, 64), (256, 256, 256))
HYP3D_PAD_SLAB_N, HYP3D_PAD_SLAB_RANKS = 64, 4


def wavespeed_inputs(h3, cfg, device, seed: int, offsets=None):
    """(q1, solid): the prims of init(cfg) on the device with seeded
    multiplicative noise on every field and a NaN velocity at a fluid cell;
    with `offsets` (cells, one for each of r, u, v, w, p and the mask), each
    tensor a contiguous view that starts that many cells into a larger
    buffer."""
    s = h3.init(cfg, device)
    q = h3._decode(cfg, *s[:6])
    gen = torch.Generator(device=device).manual_seed(seed)
    f = [x * (1 + 0.2 * torch.randn(x.shape, generator=gen, device=device,
                                    dtype=x.dtype)) for x in q]
    fluid = (~s.solid).nonzero()
    f[2][tuple(fluid[len(fluid) // 3])] = float("nan")
    solid = s.solid
    if offsets is not None:
        def at(x, o):
            buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=device)
            view = buf[o:o + x.numel()].view(x.shape)
            view.copy_(x)
            return view
        f[:5] = [at(x, o) for x, o in zip(f[:5], offsets[:5])]
        solid = at(solid, offsets[5])
    return h3.PrimT(*f), solid


def check_wavespeed(hk3, cfg, q1, solid, what: str) -> None:
    """The wavespeed kernel bitwise equal to its plain version."""
    wk = hk3.wavespeed(cfg, q1, solid)
    wp = hk3.wavespeed_plain(cfg, q1, solid)
    if not torch.equal(wk.view(1), wp.view(1)):
        raise AssertionError(f"hyp3d wavespeed {what}: kernel {float(wk)!r} "
                             f"!= plain {float(wp)!r}")


# The wavespeed's views (cells into a larger buffer of r, u, v, w, p and
# the mask): all at one odd offset (cells before the first vector), and at
# offsets that differ (no vectors)
WAVESPEED_OFFSETS = ((1, 1, 1, 1, 1, 1), (0, 1, 2, 3, 1, 2))


def check_wavespeed_cases(h3, hk3, device) -> int:
    """The wavespeed kernel bitwise equal to its plain version on grids
    whose cell count is no multiple of 4 (ragged tails) and on views at the
    WAVESPEED_OFFSETS, f32 and f64; then on 64^3 and 256^3, f32 and f64,
    launched back to back twice in turn (each shape and dtype keeps its
    own scratch, and each launch leaves its counter at 0 for the next):
    the cases it ran."""
    cases = 0
    for dtype in ("float32", "float64"):
        for nz, ny, nx in ((9, 13, 19), (3, 7, 5), (17, 31, 33)):
            cfg = h3.Hypersonic3DConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx,
                                        dy=1.0 / ny, dz=1.0 / nz, dtype=dtype)
            for offsets in (None,) + WAVESPEED_OFFSETS:
                q1, solid = wavespeed_inputs(h3, cfg, device, SEED + cases,
                                             offsets)
                check_wavespeed(hk3, cfg, q1, solid,
                                f"{nz}x{ny}x{nx} {dtype} views {offsets}")
                cases += 1
    runs = []
    for n in (64, 256):
        for dtype in ("float32", "float64"):
            cfg = h3.default_config(n, dtype=dtype)
            runs.append((cfg, *wavespeed_inputs(h3, cfg, device, SEED + n)))
    got = [[hk3.wavespeed(cfg, q1, solid) for cfg, q1, solid in runs]
           for _ in range(2)]
    for k, (cfg, q1, solid) in enumerate(runs):
        want = hk3.wavespeed_plain(cfg, q1, solid)
        for rnd in got:
            if not torch.equal(rnd[k].view(1), want.view(1)):
                raise AssertionError(
                    f"hyp3d wavespeed back to back {cfg.nx}^3 "
                    f"{cfg.dtype}: kernel {float(rnd[k])!r} != plain "
                    f"{float(want)!r}")
            cases += 1
    log(f"[hyp3d] wavespeed bitwise equal to its plain version in {cases} "
        "more cases: 9x13x19, 3x7x5, 17x31x33 f32/f64, as tensors and as "
        f"views at offsets {WAVESPEED_OFFSETS}; 64^3 and 256^3 f32/f64 "
        "back to back, twice in turn")
    return cases


def phase_hyp3d_kernels(h3, hk3, interop, device) -> dict:
    errs = {"step": 0.0, "wavespeed": 0.0, "rel": {}, "trajectory": {}}
    for dtype in ("float32", "float64"):
        for outflow in ("transmissive", "characteristic"):
            for nz, ny, nx in HYP3D_KERNEL_GRIDS:
                cfg = h3.Hypersonic3DConfig(
                    nx=nx, ny=ny, nz=nz, dx=1.0 / nx, dy=1.0 / ny,
                    dz=1.0 / nz, outflow=outflow, dtype=dtype)
                key = f"{nz}x{ny}x{nx} {dtype} {outflow}"
                corner = None
                if (nz, ny, nx) in HYP3D_KERNEL_GRIDS[2:]:
                    L = hk3.step_launch(nz, ny, nx, cfg.torch_dtype)
                    corner = (min(L.tile_z, nz - 1), min(L.tile_y, ny - 1),
                              min(L.tile_x, nx - 1))
                s = hyp3d_state(h3, interop, cfg, device, SEED)
                rel = check_hyp3d_call(h3, hk3, cfg, s, key, errs, True,
                                       corner)
                errs["rel"][key] = rel
                log(f"[hyp3d] {key}: step max rel err {rel:.3e} (tol "
                    f"{STEP_TOL[cfg.torch_dtype]:g}), non-finite cells in the "
                    f"same places; wavespeed bitwise equal")
    ok, n, differ = errs["bitwise"]
    log(f"[hyp3d] step kernel bitwise equal to its plain version in {ok} of "
        f"{n} calls; not in {differ}")
    errs["wavespeed_cases"] = check_wavespeed_cases(h3, hk3, device)
    errs["pad_cases"] = check_pad_cases(h3, hk3, interop, device)
    errs["pad_steps"] = check_pad_steps(h3, hk3, device)
    for nz, ny, nx in HYP3D_KERNEL_GRIDS[:2]:
        cfg = h3.Hypersonic3DConfig(nx=nx, ny=ny, nz=nz, dx=1.0 / nx,
                                    dy=1.0 / ny, dz=1.0 / nz)
        a = b = hyp3d_state(h3, interop, cfg, device, SEED + 1)
        for _ in range(5):
            a = h3.step(cfg, a)
            b = h3.step(cfg, b, **plain3(hk3, cfg))
        torch.cuda.synchronize()
        worst = 0.0
        for name in ("xi", "phix", "phiy", "phiz", "lam", "zet"):
            x, y = getattr(a, name), getattr(b, name)
            if not torch.equal(torch.isfinite(x), torch.isfinite(y)):
                raise AssertionError(f"5 steps: non-finite {name} differ")
            worst = max(worst, float((x - y).abs().max())
                        / max(float(y.abs().max()), 1e-3))
        if not worst <= 5e-4:
            raise AssertionError(f"5 steps cuda vs plain {nz}x{ny}x{nx}: "
                                 f"{worst:.3e} > 5e-4")
        errs["trajectory"][f"{nz}x{ny}x{nx}"] = worst
        log(f"[hyp3d] 5 steps {nz}x{ny}x{nx} f32, cuda engine vs plain "
            f"engine: max rel err {worst:.3e} (tol 5e-4)")
    return errs


def check_hyp3d_physics(h3, cfg, s0, out, key: str) -> dict:
    for name in ("xi", "phix", "phiy", "phiz", "lam", "zet"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"{key}: non-finite {name}")
    rho, p = out.xi.exp(), out.lam.exp()
    if not (bool((rho > 0).all()) and bool((p > 0).all())):
        raise AssertionError(f"{key}: rho or p not positive")
    t, dtau = float(out.t), float(out.dtau)
    if not (t > float(s0.t) and 1e-7 <= dtau <= 5e-2):
        raise AssertionError(f"{key}: t {t} (from {float(s0.t)}), dtau {dtau}")
    solid = out.solid
    for name in ("xi", "phix", "phiy", "phiz", "lam", "zet"):
        if not torch.equal(getattr(out, name)[solid], getattr(s0, name)[solid]):
            raise AssertionError(f"{key}: solid cells of {name} changed")
    u_max = float((cfg.u_ref * torch.sinh(out.phix))[~solid].max())
    shock = float(rho[~solid].max()) / cfg.inflow_r
    log(f"[physics] hyp3d {key}: finite, rho > 0, p > 0, t {t:.6e}, dtau "
        f"{dtau:.4e}, solid cells unchanged, max u over the fluid {u_max:.4g}, "
        f"max rho / inflow_r {shock:.4g}")
    return {"t": t, "dtau": dtau, "u_max": u_max, "rho_max_over_inflow": shock}


# (name, n, steps, plain steps): bench.py's hypersonic3d_64 (the reference's
# size), and 256^3
HYP3D_RUNS = (("64", 64, 400, 20), ("256", 256, 20, 1))


def phase_hyp3d_main(h3, hk3, device, smi, errs) -> dict:
    res = {}
    for key, n, steps, p_steps in HYP3D_RUNS:
        cfg = h3.default_config(n)
        s0 = h3.init(cfg, device)
        # warm-up, not counted: builds the padded mask on the host once
        # and makes the allocator's first blocks
        h3.run(cfg, s0, 1)
        hk3.reset_launches()
        out, wall = run_timed(h3, cfg, s0, steps)
        launches = dict(hk3.LAUNCHES)
        if any(v != steps for v in launches.values()):
            raise AssertionError(f"launches {launches} in {steps} steps")
        _, p_wall = run_timed(h3, cfg, s0, p_steps, **plain3(hk3, cfg))
        if hk3.LAUNCHES != launches:
            raise AssertionError("the plain engine launched a kernel")
        cells = n ** 3
        rate, p_rate = steps / wall, p_steps / p_wall
        log(f"[hyp3d] {n}^3 f32 on {smi}: cuda engine {steps} steps in "
            f"{wall:.3f} s, {rate:.2f} steps/s {cells * rate / 1e6:.1f} "
            f"Mcell-steps/s; plain engine {p_steps} step(s) {p_rate:.3f} "
            f"steps/s {cells * p_rate / 1e6:.2f} Mcell-steps/s; launches "
            f"{launches}")
        phys = check_hyp3d_physics(h3, cfg, s0, out, f"{n}^3 f32 x {steps}")
        if n == 64 and not phys["u_max"] > 0.1:
            raise AssertionError(f"max u {phys['u_max']} <= 0.1 at 64^3")
        rel = check_hyp3d_call(h3, hk3, cfg, out, f"{n}^3 final state", errs,
                               False)
        errs["rel"][f"{n}^3 final state f32"] = rel
        sp = h3.solid_pad_of(cfg, device)
        qp = h3._padded_prims(cfg, h3._decode(cfg, *out[:6]), sp)
        dt = torch.full((), 1e-6, device=device)
        g = torch.full((), 1.0, device=device)
        q1 = hk3.step_core(cfg, qp, sp, dt, g)
        big = n > 64
        times = {
            "step": time_launches(
                lambda: hk3.step_core(cfg, qp, sp, dt, g), 10 if big else 50),
            "step_plain": time_launches(
                lambda: hk3.step_core_plain(cfg, qp, sp, dt, g),
                1 if big else 5),
            "wavespeed": time_launches(
                lambda: hk3.wavespeed(cfg, q1, out.solid), 50),
            "wavespeed_plain": time_launches(
                lambda: hk3.wavespeed_plain(cfg, q1, out.solid), 10),
        }
        times["pad"] = pad_times(h3, hk3, cfg, out, smi)
        bounds = hyp3d_bounds(cfg, out.solid)
        log(f"[hyp3d] {n}^3 f32 final state: kernels vs plain: step max rel "
            f"err {rel:.3e}, wavespeed bitwise; per launch on {smi}: step "
            f"{times['step']:.4f} ms vs plain {times['step_plain']:.4f} ms "
            f"(bound {bounds['step'][0]:.4f} ms, {bounds['step'][1]}), "
            f"wavespeed {times['wavespeed']:.4f} ms vs plain "
            f"{times['wavespeed_plain']:.4f} ms (bound "
            f"{bounds['wavespeed'][0]:.4f} ms, {bounds['wavespeed'][1]})")
        res[key] = {"launches": launches, "times": times, "bounds": bounds,
                    "rate": rate, "plain_rate": p_rate, "physics": phys}
    ok, n, differ = errs["bitwise"]
    log(f"[hyp3d] step kernel bitwise equal to its plain version in {ok} of "
        f"{n} calls of phases 8 and 9; not in {differ}")
    return res


def hyp_tiling(hk, hk3, build) -> dict:
    """The tiling of the two hypersonic step kernels at the main runs'
    shapes, as this run's library reports it: the launch query's blocks,
    threads a block, tile, halo and dynamic shared memory a block (the
    launch's own make_launch), and ptxas's registers, static shared
    memory, stack and spills of each instantiation in this run's build."""
    out = {"hypersonic2d_step": {"ptxas": build.ptxas_usage("11step_kernel")},
           "hypersonic3d_step": {"ptxas": build.ptxas_usage("12step3_kernel")}}
    for nx, ny, dtype in ((2048, 2048, torch.float32),
                          (8192, 1024, torch.float64)):
        out["hypersonic2d_step"][f"{nx}x{ny} {str(dtype)[6:]}"] = \
            hk.step_launch(ny, nx, dtype).asdict()
    for n, dtype in ((64, torch.float32), (256, torch.float32),
                     (64, torch.float64)):
        out["hypersonic3d_step"][f"{n}^3 {str(dtype)[6:]}"] = \
            hk3.step_launch(n, n, n, dtype).asdict()
    for name, d in out.items():
        log(f"[build] {name} tiling: {d}")
    return out


def hyp3d_bounds(cfg, solid) -> dict:
    """bound_ms of both 3-D kernels at cfg's shape: the step reads six
    halo-3 padded fields and the padded mask and writes six fields, and
    computes every cell; the wavespeed reads five fields and the mask."""
    cells = cfg.nx * cfg.ny * cfg.nz
    padded = (cfg.nx + 6) * (cfg.ny + 6) * (cfg.nz + 6)
    fluid = int((~solid).sum())
    T = torch.finfo(cfg.torch_dtype).bits // 8
    return {"step": bound(padded * (6 * T + 1) + cells * 6 * T,
                          cells * HYP3D_STEP_OPS_PER_CELL, cfg.torch_dtype),
            "wavespeed": bound(cells * (5 * T + 1),
                               fluid * HYP3D_WAVESPEED_OPS_PER_FLUID_CELL,
                               cfg.torch_dtype)}


def phase_th3cs(h3, hk3, th3cs, fourspl, device, smi) -> dict:
    """The .4spl export at 64^3, 60 frames x 4 steps, read back."""
    import tempfile
    import zlib
    from pathlib import Path

    cfg = h3.default_config(64)
    frames, spf = 60, 4
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "th3cs_64.4spl"
        hk3.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        th3cs.export_4spl(path, cfg, frames=frames, steps_per_frame=spf,
                          device=device, engine="cuda")
        wall = time.perf_counter() - t0
        launches = dict(hk3.LAUNCHES)
        if any(v != frames * spf for v in launches.values()):
            raise AssertionError(f"th3cs launches {launches}, want "
                                 f"{frames * spf} each")
        data = path.read_bytes()
        v = fourspl.read_4spl(path)
    n = cfg.nx
    size = 32 + 256 * 48 + frames * n ** 3 + 16
    if not (len(data) == size and (v.width, v.height, v.depth) == (n, n, n)
            and v.frames == frames and v.p_size == 256
            and v.flags == fourspl.FLAG_F32_PRECISION):
        raise AssertionError(f"th3cs file: {len(data)} bytes (want {size}), "
                             f"dims {(v.width, v.height, v.depth)}, frames "
                             f"{v.frames}, pSize {v.p_size}, flags {v.flags}")
    magic = int.from_bytes(data[:4], "little")
    crc = int.from_bytes(data[-16:-12], "little")
    if magic != fourspl.MAGIC or crc != zlib.crc32(v.indices.tobytes()):
        raise AssertionError("th3cs file: bad magic or CRC")
    n_idx = len(np.unique(v.indices[-1]))
    if not n_idx > 1:
        raise AssertionError("th3cs: the last frame uses one index")
    fps = frames / wall
    log(f"[th3cs] {n}^3 {frames} frames x {spf} steps, cuda engine, on {smi}: "
        f"{wall:.3f} s, {fps:.2f} frames/s ({fps * spf:.1f} steps/s); read "
        f"back: {len(data)} bytes, magic, dims, frames, pSize 256, flags "
        f"0x4 and CRC ok; {n_idx} indices in the last frame; launches "
        f"{launches}")
    return {"frames_per_s": fps, "launches": launches, "last_frame_indices":
            n_idx}


# ------------------------- Gray–Scott and D2Q9 LBM ---------------------------

def gs_state(gs, cfg, device, seed):
    """init() plus seeded normal noise (0.05) on u and v."""
    s = gs.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    return gs.GrayScottState(*(
        (f + torch.tensor(0.05 * rng.standard_normal(f.shape),
                          dtype=f.dtype)).to(device) for f in s))


def lbm_state(lbm, cfg, device, seed, top_wall=True):
    """init() with the populations scaled by 1 + 0.05 x seeded normal
    noise; without the top wall row if `top_wall` is False."""
    s = lbm.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)
    f = s.f * (1.0 + torch.tensor(0.05 * rng.standard_normal(s.f.shape),
                                  dtype=s.f.dtype))
    solid = s.solid.clone()
    if not top_wall:
        solid[-1] = False
    return lbm.LBMState(f=f.contiguous().to(device), solid=solid.to(device))


def stencil_err(got, ref, what: str, tol: float) -> tuple[float, float]:
    """(max |err| / max |ref|, max |err|) over the fields of two states;
    raises on non-finite values in different places or a breach of tol
    (0: bitwise, NaN in the same places)."""
    rel = ab = 0.0
    for name, a, b in zip(ref._fields, got, ref):
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: {name} differs")
            continue
        if tol == 0.0:
            if not same(a, b):
                raise AssertionError(
                    f"{what}.{name}: not bitwise equal (max |err| "
                    f"{float((a - b).abs().nan_to_num(0).max()):.3e})")
            continue
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            raise AssertionError(f"{what}.{name}: non-finite cells differ")
        d = float((a[fb] - b[fb]).abs().max())
        rel = max(rel, d / max(float(b[fb].abs().max()), 1e-300))
        ab = max(ab, d)
    if not rel <= tol:
        raise AssertionError(f"{what}: max rel err {rel:.3e} > {tol:g}")
    return rel, ab


def check_stencil_call(kmod, solver, cfg, s, k, what, errs, tol,
                       **over) -> float:
    """One kernel of `solver` ("gs" or "lbm": the one-step kernel if k is
    None, else the K-step kernel) against its plain version on the same
    state; folds max |err| into errs["<solver>_step" / "_multistep"]."""
    name = f"{solver}_{'step' if k is None else 'multistep'}"
    args = () if k is None else (k,)
    got = getattr(kmod, name)(cfg, s, *args, **over)
    ref = getattr(kmod, f"{name}_plain")(cfg, s, *args, **over)
    torch.cuda.synchronize()
    rel, ab = stencil_err(got, ref, what, tol)
    errs[name] = max(errs[name], ab)
    return rel


def check_run23(mod, kmod, cfg, s, what: str, tol: float) -> None:
    """run(cfg, s, 23) at block_k=8: 2 K-step and 7 one-step launches,
    equal to 23 plain steps."""
    cfg = cfg.replace(block_k=8)
    kmod.reset_launches()
    out = mod.run(cfg, s, 23)
    if kmod.LAUNCHES != {"step": 7, "multistep": 2}:
        raise AssertionError(f"{what}: run(23) at block_k=8 launched "
                             f"{kmod.LAUNCHES}, want step 7, multistep 2")
    ref = s
    for _ in range(23):
        ref = mod.step(cfg, ref)
    torch.cuda.synchronize()
    stencil_err(out, ref, f"{what} run(23)", tol)


def phase_stencil_kernels(gs, lbm, gk, lk, device) -> dict:
    errs = {"gs_step": 0.0, "gs_multistep": 0.0, "lbm_step": 0.0,
            "lbm_multistep": 0.0, "rel": {}}
    for dtype in ("float32", "float64"):
        dt = getattr(torch, dtype)
        for nx, ny in ((200, 75), (256, 128), (24, 20)):
            cfg = gs.GrayScottConfig(nx=nx, ny=ny, dtype=dtype)
            key = f"gray_scott {nx}x{ny} {dtype}"
            s = gs_state(gs, cfg, device, SEED)
            for over in ({}, {"feed": 0.04, "kill": 0.058}):
                for k in GS_CHECK_K:
                    check_stencil_call(gk, "gs", cfg, s, k,
                                       f"{key} K={k} {over}", errs, 0.0,
                                       **over)
                    if k is not None:
                        check_k_one_steps(gk, "gs", cfg, s, k,
                                          f"{key} K={k} {over}", **over)
            check_run23(gs, gk, cfg, s, key, 0.0)
            errs["rel"][key] = 0.0
            windows = {k: gk.launch_shape(cfg, k).asdict()
                       for k in GS_CHECK_K if k is not None}
            log(f"[stencil] {key}: one-step and K-step (K={GS_CHECK_K[1:]}; "
                f"default and feed=0.04 kill=0.058) bitwise equal to the "
                f"plain version, each K-step launch bitwise equal to K "
                f"one-step launches; run(23) at block_k=8: 2 + 7 launches, "
                f"bitwise equal to 23 plain steps; K-step launches {windows}")
        for nx, ny, top, radius in ((200, 75, True, 8.0),
                                    (256, 128, True, 8.0),
                                    (200, 75, False, 8.0),
                                    (24, 20, True, 4.0)):
            cfg = lbm.LBMConfig(nx=nx, ny=ny, dtype=dtype,
                                obstacle_radius=radius)
            key = (f"lbm {nx}x{ny} {dtype}"
                   + ("" if top else " no top wall"))
            s = lbm_state(lbm, cfg, device, SEED, top)
            for over in ({}, {"drive": 3e-4}):
                for k in LBM_CHECK_K:
                    check_stencil_call(lk, "lbm", cfg, s, k,
                                       f"{key} K={k} {over}", errs, 0.0,
                                       **over)
                    if k is not None:
                        check_k_one_steps(lk, "lbm", cfg, s, k,
                                          f"{key} K={k} {over}", **over)
            check_run23(lbm, lk, cfg, s, key, 0.0)
            errs["rel"][key] = 0.0
            windows = {k: lk.launch_shape(cfg, k).asdict()
                       for k in LBM_CHECK_K if k is not None}
            log(f"[stencil] {key}: one-step and K-step (K={LBM_CHECK_K[1:]}; "
                f"default and drive=3e-4) bitwise equal to the plain "
                f"version, each K-step launch bitwise equal to K one-step "
                f"launches; run(23) at block_k=8: 2 + 7 launches, bitwise "
                f"equal to 23 plain steps; K-step launches {windows}")
    return errs


# The kernels of phase 11: the one-step kernel (None) and the K-step
# kernel at these K.
GS_CHECK_K = (None, 1, 3, 16, 32)
LBM_CHECK_K = (None, 1, 3, 8, 16)


def check_k_one_steps(kmod, solver, cfg, s, k: int, what: str,
                      **over) -> None:
    """A K-step launch of `solver` ("gs" or "lbm") bitwise equal, the sign
    of zero included, to k plain steps and to k launches of the one-step
    kernel."""
    got = getattr(kmod, f"{solver}_multistep")(cfg, s, k, **over)
    one = s
    for _ in range(k):
        one = getattr(kmod, f"{solver}_step")(cfg, one, **over)
    plain = getattr(kmod, f"{solver}_multistep_plain")(cfg, s, k, **over)
    torch.cuda.synchronize()
    for ref, name in ((plain, f"{k} plain steps"),
                      (one, f"{k} one-step launches")):
        for field, a, b in zip(ref._fields, got, ref):
            if a.dtype != torch.bool and not bits_equal(a, b):
                raise AssertionError(f"{what}: the K-step launch's {field} "
                                     f"differs from {name}")


def check_gs_physics(out, key: str) -> dict:
    u, v = out.u, out.v
    if not (bool(torch.isfinite(u).all()) and bool(torch.isfinite(v).all())):
        raise AssertionError(f"{key}: non-finite u or v")
    lo = min(float(u.min()), float(v.min()))
    hi = max(float(u.max()), float(v.max()))
    vmax = float(v.max())
    if not (lo >= -1e-3 and hi <= 1.0 + 1e-3 and vmax > 0.1):
        raise AssertionError(f"{key}: u, v in [{lo}, {hi}], max v {vmax}")
    frac = float((v > 0.1).double().mean())
    log(f"[physics] {key}: finite, u in [{float(u.min()):.4f}, "
        f"{float(u.max()):.4f}], v in [{float(v.min()):.4f}, {vmax:.4f}], "
        f"share of cells with v > 0.1 {frac:.4f}")
    return {"u_min": float(u.min()), "u_max": float(u.max()),
            "v_min": float(v.min()), "v_max": vmax, "v_gt_0.1": frac}


def lbm_observables(lbm, cfg, s) -> dict:
    """Total mass (f64 sum), max |u| and mean ux over the fluid cells."""
    _, ux, uy = lbm.macroscopic(s.f)
    fluid = ~s.solid
    return {"mass": float(s.f.double().sum()),
            "u_max": float(torch.sqrt(ux * ux + uy * uy)[fluid].max()),
            "ux_mean": float(ux[fluid].double().mean())}


# Relative mass drift allowed per step.  BGK with the shifted equilibrium
# and bounce-back conserve mass exactly; what remains is rounding, which
# at f32 is biased: the plain engine drifts by +1.3e-8 a step on the CPU
# (linear in steps, the same at 512x256 and 1024x512, with and without
# drive or obstacle; 1.3e-5 over 1000 steps), at f64 by ~1e-16.
LBM_MASS_DRIFT_PER_STEP = {torch.float32: 2e-8, torch.float64: 1e-14}


def check_lbm_physics(lbm, cfg, s0, out, key: str, steps: int) -> dict:
    if not bool(torch.isfinite(out.f).all()):
        raise AssertionError(f"{key}: non-finite f")
    a, b = lbm_observables(lbm, cfg, s0), lbm_observables(lbm, cfg, out)
    drift = abs(b["mass"] - a["mass"]) / a["mass"]
    bar = LBM_MASS_DRIFT_PER_STEP[cfg.torch_dtype] * steps
    if not (drift <= bar and b["u_max"] < 0.1
            and b["ux_mean"] > a["ux_mean"]):
        raise AssertionError(f"{key}: mass drift {drift:.3e} (bar "
                             f"{bar:.1e}), start {a}, end {b}")
    log(f"[physics] {key}: finite, mass {a['mass']:.9g} -> {b['mass']:.9g} "
        f"(rel drift {drift:.3e}, bar {bar:.1e}), max |u| "
        f"{b['u_max']:.5f}, mean ux of the "
        f"fluid {a['ux_mean']:.4e} -> {b['ux_mean']:.4e}")
    return {"mass_drift": drift, "u_max": b["u_max"],
            "ux_mean_start": a["ux_mean"], "ux_mean": b["ux_mean"]}


def stencil_bounds(cfg, k: int, lbm_fluid: int | None) -> dict:
    """bound_ms of the one-step and the K-step kernel at cfg's shape: each
    launch reads the state once and writes it once (LBM: and reads the
    solid mask); the K-step kernel does k steps of work."""
    cells = cfg.nx * cfg.ny
    T = torch.finfo(cfg.torch_dtype).bits // 8
    if lbm_fluid is None:
        nbytes, ops = cells * 4 * T, cells * GS_OPS_PER_CELL
    else:
        nbytes, ops = cells * (18 * T + 1), lbm_fluid * LBM_OPS_PER_CELL
    return {"step": bound(nbytes, ops, cfg.torch_dtype),
            "multistep": bound(nbytes, k * ops, cfg.torch_dtype)}


# (solver, nx, ny, dtype, steps, block_k, plain steps): bench.py's
# gray_scott (2048^2 x 2000) and lbm (2048x1024 x 1000) at their default
# block_k and at 1, and each at f64
STENCIL_RUNS = (("gs", 2048, 2048, "float32", 2000, 16, 100),
                ("gs", 2048, 2048, "float32", 2000, 1, 100),
                ("gs", 2048, 2048, "float64", 400, 16, 100),
                ("lbm", 2048, 1024, "float32", 1000, 8, 20),
                ("lbm", 2048, 1024, "float32", 1000, 1, 20),
                ("lbm", 2048, 1024, "float64", 200, 8, 20))


def phase_stencil_main(gs, lbm, gk, lk, device, smi, errs,
                       runs=STENCIL_RUNS) -> dict:
    res = {}
    launches = {"gs": {"step": 0, "multistep": 0},
                "lbm": {"step": 0, "multistep": 0}}
    for solver, nx, ny, dtype, steps, k, p_steps in runs:
        mod, kmod = (gs, gk) if solver == "gs" else (lbm, lk)
        cfg = (gs.GrayScottConfig if solver == "gs" else lbm.LBMConfig)(
            nx=nx, ny=ny, dtype=dtype, block_k=k)
        key = f"{solver} {nx}x{ny} {dtype} K={k}"
        engine = mod.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"{key}: engine auto resolved to {engine!r}")
        s0 = mod.init(cfg, device)
        mod.run(cfg, s0, k + 1)   # warm-up, not counted: both kernels
        kmod.reset_launches()
        out, wall = run_timed(mod, cfg, s0, steps)
        got = dict(kmod.LAUNCHES)
        want = ({"step": steps % k, "multistep": steps // k} if k > 1
                else {"step": steps, "multistep": 0})
        if got != want:
            raise AssertionError(f"{key}: launches {got}, want {want}")
        for name in got:
            launches[solver][name] += got[name]
        _, p_wall = run_timed(mod, cfg.replace(engine="torch"), s0, p_steps)
        if kmod.LAUNCHES != got:
            raise AssertionError(f"{key}: the plain engine launched a kernel")
        cells = nx * ny
        rate, p_rate = steps / wall, p_steps / p_wall
        unit = "Mcell-steps/s" if solver == "gs" else "MLUPS"
        log(f"[stencil] {key} on {smi}: cuda engine {steps} steps in "
            f"{wall:.4f} s, {rate:.2f} steps/s {cells * rate / 1e6:.1f} "
            f"{unit}; plain torch engine {p_steps} steps {p_rate:.3f} "
            f"steps/s {cells * p_rate / 1e6:.2f} {unit}; launches {got}")
        phys = (check_gs_physics(out, key) if solver == "gs"
                else check_lbm_physics(lbm, cfg, s0, out, key, steps))

        # from the final state: each kernel vs its plain version at full
        # shape, then per-launch times (none of these launches is counted)
        # (K = 1 runs check and time the K-step kernel at K = 2)
        tol = 0.0 if solver == "gs" else STEP_TOL[cfg.torch_dtype]
        kk = max(k, 2)
        rel = max(check_stencil_call(kmod, solver, cfg, out, None,
                                     f"{key} final state step", errs, tol),
                  check_stencil_call(kmod, solver, cfg, out, kk,
                                     f"{key} final state K", errs, tol))
        errs["rel"][f"{key} final state"] = rel
        fns = {name: getattr(kmod, f"{solver}_{name}") for name in
               ("step", "step_plain", "multistep", "multistep_plain")}
        times = {
            "step": time_launches(lambda: fns["step"](cfg, out), 100),
            "step_plain": time_launches(
                lambda: fns["step_plain"](cfg, out), 5),
            "multistep": time_launches(
                lambda: fns["multistep"](cfg, out, kk), 20),
            "multistep_plain": time_launches(
                lambda: fns["multistep_plain"](cfg, out, kk),
                1 if dtype == "float64" else 2),
        }
        if solver == "gs":  # device time a launch, by torch.profiler
            times["step_device"] = device_ms(
                lambda: fns["step"](cfg, out), 100, "gs_step_kernel")
            times["multistep_device"] = device_ms(
                lambda: fns["multistep"](cfg, out, kk), 20,
                "gs_multistep_kernel")
        fluid = None if solver == "gs" else int((~out.solid).sum())
        bounds = stencil_bounds(cfg, kk, fluid)
        log(f"[stencil] {key} final state: kernels vs plain max rel err "
            f"{rel:.3e} (0 = bitwise); per launch on {smi}: one-step "
            f"{times['step']:.4f} ms vs plain {times['step_plain']:.4f} ms "
            f"(bound {bounds['step'][0]:.4f} ms, {bounds['step'][1]}); "
            f"K-step (K={kk}) {times['multistep']:.4f} "
            f"ms vs plain {times['multistep_plain']:.4f} ms (bound "
            f"{bounds['multistep'][0]:.4f} ms, {bounds['multistep'][1]})")
        if solver == "gs":
            one = times["step_device"]
            log(f"[stencil] {key} final state: device time a launch "
                f"(torch.profiler) one-step {ms_text(one)}, "
                f"K-step (K={kk}) {ms_text(times['multistep_device'])}, "
                f"{kk} one-step launches "
                f"{ms_text(None if one is None else kk * one)}; K-step "
                f"launch {gk.launch_shape(cfg, kk).asdict()}")
        res[key] = {"launches": got, "times": times, "bounds": bounds,
                    "rate": rate, "plain_rate": p_rate, "k": kk,
                    "physics": phys}
    res["launches"] = launches
    return res


def gs_tiling(gk, gs, build) -> dict:
    """The Gray–Scott K-step launch at the main runs' grid (2048^2, K=16),
    per dtype, as the library reports it, and ptxas's report of the
    kernel."""
    out = {"ptxas": build.ptxas_usage("gs_multistep_kernel")}
    for dtype in ("float32", "float64"):
        cfg = gs.GrayScottConfig(nx=2048, ny=2048, dtype=dtype)
        out[dtype] = gk.launch_shape(cfg, cfg.block_k).asdict()
    log(f"[build] gs_multistep tiling: {out}")
    return out


def lbm_tiling(lk, lbm, build) -> dict:
    """The LBM K-step launch at the main runs' grid (2048x1024, K=8), per
    dtype, as the library reports it, and ptxas's report of the kernel."""
    out = {"ptxas": build.ptxas_usage("lbm_multistep_kernel")}
    for dtype in ("float32", "float64"):
        cfg = lbm.LBMConfig(nx=2048, ny=1024, dtype=dtype)
        out[dtype] = lk.launch_shape(cfg, cfg.block_k).asdict()
    log(f"[build] lbm_multistep tiling: {out}")
    return out


def stencil_kernel_lines(res, errs, gs_design, lbm_design) -> list:
    """The {"kernels": [...]} entries of the four stencil kernels: times
    and bounds from the final state of the f32 run at the default
    block_k, the f64 run's beside them; launches summed over the three
    runs of each solver.  The K-step lines carry their tiling and K times
    the one-step kernel's time; the Gray–Scott lines also their device
    time a launch (torch.profiler)."""
    out = []
    for solver, src, lines, k32, k64 in (
            ("gs", "gray_scott", (30, 130),
             "gs 2048x2048 float32 K=16", "gs 2048x2048 float64 K=16"),
            ("lbm", "lbm", (50, 158),
             "lbm 2048x1024 float32 K=8", "lbm 2048x1024 float64 K=8")):
        a, b = res[k32], res[k64]
        for name, line in zip(("step", "multistep"), lines):
            entry = {
                "name": f"{src}_{name}", "route": "cuda",
                "source": f"fluidsims_tpu_torch/csrc/{src}_{name}.cu",
                "replaces": f"fluidsims_tpu/kernels/{src}_pallas.py:{line}",
                "launches": res["launches"][solver][name],
                "max_abs_err": errs[f"{solver}_{name}"],
                "ms": a["times"][name],
                "plain_ms": a["times"][name + "_plain"],
                "bound_ms": a["bounds"][name][0],
                "bound_by": a["bounds"][name][1], "library_ms": None,
                "ms_f64": b["times"][name],
                "plain_ms_f64": b["times"][name + "_plain"],
                "bound_ms_f64": b["bounds"][name][0],
                "bound_by_f64": b["bounds"][name][1]}
            if name == "multistep":
                entry["k"] = a["k"]
            if name == "multistep":
                entry["tiling"] = lbm_design if solver == "lbm" else gs_design
                entry["ms_k_one_step"] = a["k"] * a["times"]["step"]
                entry["ms_k_one_step_f64"] = b["k"] * b["times"]["step"]
            if solver == "gs":
                entry["ms_device"] = a["times"][name + "_device"]
                entry["ms_device_f64"] = b["times"][name + "_device"]
                if name == "multistep":
                    entry["ms_device_k_one_step"] = (
                        a["k"] * a["times"]["step_device"])
                    entry["ms_device_k_one_step_f64"] = (
                        b["k"] * b["times"]["step_device"])
            out.append(entry)
    return out

# ------------------ Burgers, shallow water and GLM-MHD ----------------------
#
# One K-step kernel each (TPU kernels #7, instantiated twice, and #8).
# `kmod` below is the wrapper module, `mod` the solver.

RESIDENT = ("burgers", "sw", "mhd")


def resident_mods(bg, swm, mhd, bk, swk, mk) -> dict:
    """solver name -> (solver module, wrapper module, kernel fn, plain fn,
    config class)."""
    return {"burgers": (bg, bk, bk.burgers_multistep,
                        bk.burgers_multistep_plain, bg.BurgersConfig),
            "sw": (swm, swk, swk.sw_multistep, swk.sw_multistep_plain,
                   swm.ShallowWaterConfig),
            "mhd": (mhd, mk, mk.mhd_multistep, mk.mhd_multistep_plain,
                    mhd.MHDConfig)}


def resident_fields(s) -> list:
    """(name, tensor) of a Burgers, shallow-water or MHD state, the clock
    scalars included."""
    if hasattr(s, "U"):
        return list(zip(s.U._fields, s.U)) + [("t", s.t)]
    return list(zip(s._fields, s))


def resident_err(got, ref, what: str, bars: dict) -> tuple[float, float]:
    """Field by field: non-finite values in the same places, and within
    the bar of `bars` for the field's name (or "*"): ("rel", tol) for
    max |err| / max(max |ref|, floor) <= tol, ("close", rtol, atol) for
    |err| <= atol + rtol |ref| everywhere; tol 0 means bitwise.  Returns
    (max |err| / max |ref|, max |err|) over the fields."""
    rel = ab = 0.0
    for (name, a), (_, b) in zip(resident_fields(got), resident_fields(ref)):
        bar = bars.get(name, bars["*"])
        if bar == ("rel", 0.0):
            if not same(a, b):
                raise AssertionError(f"{what}.{name}: not bitwise equal")
            continue
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        if not torch.equal(fa, fb):
            raise AssertionError(f"{what}.{name}: non-finite cells differ "
                                 f"({int((~fa).sum())} vs {int((~fb).sum())})")
        if not bool(fb.any()):
            continue
        d = (a[fb] - b[fb]).abs()
        dmax, scale = float(d.max()), float(b[fb].abs().max())
        rel = max(rel, dmax / max(scale, 1e-300))
        ab = max(ab, dmax)
        if bar[0] == "rel":
            floor = bar[2] if len(bar) > 2 else 1e-300
            if not dmax / max(scale, floor) <= bar[1]:
                raise AssertionError(f"{what}.{name}: max rel err "
                                     f"{dmax / max(scale, floor):.3e} > "
                                     f"{bar[1]:g}")
        else:
            excess = float((d - (bar[2] + bar[1] * b[fb].abs())).max())
            if not excess <= 0.0:
                raise AssertionError(f"{what}.{name}: beyond rtol {bar[1]:g} "
                                     f"atol {bar[2]:g} by {excess:.3e} (max "
                                     f"|err| {dmax:.3e})")
    return rel, ab


def step_bars(dtype) -> dict:
    """One step, kernel vs plain: max |err| / max |ref| within STEP_TOL."""
    return {"*": ("rel", STEP_TOL[dtype])}


def k_bars(solver: str, dtype) -> dict:
    """K steps, kernel vs plain: the JAX suite's bars for its resident
    Pallas kernels against the XLA path at f32 (tests/test_burgers_sw_
    stam.py:200-252, tests/test_mhd_stam3d.py:292-310); at f64 1e-10."""
    if dtype == torch.float64:
        return {"*": ("close", 1e-10, 1e-12)} if solver != "mhd" else \
            {"*": ("rel", 1e-10, 1e-3)}
    clock = {"t": ("close", 1e-6, 0.0), "tau": ("close", 1e-6, 0.0)}
    if solver == "burgers":
        return {"*": ("close", 1e-4, 1e-5), **clock}
    if solver == "sw":
        return {"*": ("close", 1e-5, 1e-6), "sigma": ("close", 1e-7, 1e-6),
                **clock}
    return {"*": ("rel", 5e-5, 1e-3), **clock}


BITWISE = {"*": ("rel", 0.0)}


def resident_state(mod, cfg, device, seed, nan: bool):
    """init() plus seeded noise; with `nan`, one NaN cell."""
    s = mod.init(cfg, torch.device("cpu"))
    rng = np.random.default_rng(seed)

    def noise(f, amp):
        return f + torch.tensor(amp * rng.standard_normal(tuple(f.shape)),
                                dtype=f.dtype)

    y, x = cfg.ny // 2, cfg.nx // 3
    if hasattr(s, "U"):
        U = s.U
        rho = U.rho * (1.0 + 0.02 * torch.tensor(
            rng.uniform(-1, 1, tuple(U.rho.shape)), dtype=U.rho.dtype))
        U = U._replace(rho=rho, mx=noise(U.mx, 0.02), my=noise(U.my, 0.02),
                       By=noise(U.By, 0.02))
        if nan:
            U.rho[y, x] = float("nan")
        s = s._replace(U=U)
    elif hasattr(s, "sigma"):
        s = s._replace(sigma=noise(s.sigma, 1e-3), u=noise(s.u, 0.5),
                       v=noise(s.v, 0.5))
        if nan:
            s.u[y, x] = float("nan")
    else:
        s = s._replace(phi_u=noise(s.phi_u, 0.1), phi_v=noise(s.phi_v, 0.1))
        if nan:
            s.phi_u[y, x] = float("nan")
    return type(s)(*(f.to(device) if not isinstance(f, tuple) else
                     type(f)(*(g.to(device) for g in f)) for f in s))


def check_resident_case(name, mods, cfg, s, key, errs) -> float:
    """Phase 13's checks of one kernel on one state: k = 1 three times
    along the plain trajectory within STEP_TOL, k = 8 against 8 plain steps
    within the JAX bars, k = 8 bitwise equal to 8 launches of k = 1, and
    run(23) at block_k = 8 = 2 + 7 launches within the same bars."""
    mod, kmod, kern, plain, _ = mods[name]
    dt = cfg.torch_dtype
    worst, st = 0.0, s
    for i in range(3):
        rel, ab = resident_err(kern(cfg, st, 1), plain(cfg, st, 1),
                               f"{key} k=1 step {i}", step_bars(dt))
        worst, errs[name] = max(worst, rel), max(errs[name], ab)
        st = plain(cfg, st, 1)
    got8 = kern(cfg, s, 8)
    if name in TILED:
        check_tiled_syncs(name, kmod, cfg, s, 8, key)
    rel, ab = resident_err(got8, plain(cfg, s, 8), f"{key} k=8",
                           k_bars(name, dt))
    worst, errs[name] = max(worst, rel), max(errs[name], ab)
    one = s
    for _ in range(8):
        one = kern(cfg, one, 1)
    if name in TILED:
        check_tiled_syncs(name, kmod, cfg, s, 1, key)
    resident_err(got8, one, f"{key} k=8 vs 8 x k=1", BITWISE)
    c8 = cfg.replace(block_k=8)
    kmod.reset_launches()
    out = mod.run(c8, s, 23)
    if kmod.LAUNCHES != {"step": 7, "multistep": 2}:
        raise AssertionError(f"{key}: run(23) at block_k=8 launched "
                             f"{kmod.LAUNCHES}, want step 7, multistep 2")
    resident_err(out, plain(cfg, s, 23), f"{key} run(23)", k_bars(name, dt))
    torch.cuda.synchronize()
    return worst


# The tiled K-step kernels (#7, #8), which count their grid syncs.
TILED = ("burgers", "sw", "mhd")


def tiled_syncs_want(name, kmod, cfg, k: int) -> int:
    """The grid syncs a launch of k steps makes by the sources' notes: K +
    1, and for Burgers K more for each pass past the first (MHD: K + 1)."""
    extra = len(kmod.plan(cfg)[2]) - 1 if name == "burgers" else 0
    return k + 1 + extra * k


def check_tiled_syncs(name, kmod, cfg, s, k: int, key: str) -> int:
    """The grid syncs of the launch of k steps just made on s's device, as
    the kernel counted them: tiled_syncs_want's, or the script fails."""
    got = kmod.grid_syncs(cfg, resident_fields(s)[0][1].device)
    want = tiled_syncs_want(name, kmod, cfg, k)
    if got != want:
        raise AssertionError(f"{key} k={k}: the kernel made {got} grid "
                             f"syncs, want {want}")
    return got


def resident_cases(bg, swm, mhd, nx, ny, dtype):
    """(solver, config, NaN cell?) of phase 13 on one grid.  On 5x3, a grid
    narrower than every tile's halo, Burgers and shallow water only."""
    cases = [("burgers", bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype,
                                          dtau=1e-2), False),
             ("burgers", bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype,
                                          dtau=1e-2, muscl=True), False),
             ("burgers", bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype,
                                          dtau=1e-2, visc_substeps=2), False),
             ("burgers", bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype,
                                          dtau=1e-2, visc_substeps=3), False),
             # MUSCL with 9 substeps: halo 8, a second pass of 3 substeps
             ("burgers", bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype,
                                          dtau=1e-2, muscl=True,
                                          visc_substeps=9), False),
             ("burgers", bg.BurgersConfig(nx=nx, ny=1, dtype=dtype,
                                          colehopf=True, dtau=1e-3), False),
             ("sw", swm.ShallowWaterConfig(nx=nx, ny=ny, dtype=dtype,
                                           dtau=1e-3), False),
             ("sw", swm.ShallowWaterConfig(nx=nx, ny=ny, dtype=dtype,
                                           dtau=1e-3, nu=0.0), False)]
    if (nx, ny) == (5, 3):
        return cases
    for problem in ("briowu", "orszag-tang"):
        for stable in (False, True):
            cases.append(("mhd", mhd.MHDConfig(nx=nx, ny=ny, dtype=dtype,
                                               problem=problem,
                                               stable_hll=stable), False))
    if (nx, ny) == (200, 75):
        cases += [("burgers", bg.BurgersConfig(nx=nx, ny=ny, dtype=dtype),
                   True),
                  ("sw", swm.ShallowWaterConfig(nx=nx, ny=ny, dtype=dtype),
                   True),
                  ("mhd", mhd.MHDConfig(nx=nx, ny=ny, dtype=dtype), True)]
    return cases


def phase_resident_kernels(mods, bg, swm, mhd, device) -> dict:
    errs = {name: 0.0 for name in RESIDENT}
    errs["rel"] = {}
    for dtype in ("float32", "float64"):
        for nx, ny in ((200, 75), (256, 128), (5, 3)):
            for name, cfg, nan in resident_cases(bg, swm, mhd, nx, ny, dtype):
                mod = mods[name][0]
                s = resident_state(mod, cfg, device, SEED, nan)
                opts = {k: v for k, v in cfg.asdict().items() if k in (
                    "muscl", "visc_substeps", "colehopf", "nu", "problem",
                    "stable_hll") and v != mod_default(mods[name][4], k)}
                key = (f"{name} {cfg.nx}x{cfg.ny} {dtype} {opts}"
                       + (" NaN cell" if nan else ""))
                worst = check_resident_case(name, mods, cfg, s, key, errs)
                if nan:
                    check_nan_case(name, mods, cfg, s, key)
                errs["rel"][key] = worst
                syncs = "" if name not in TILED else (
                    ", grid syncs as the kernel counted them " + " and ".join(
                        f"{tiled_syncs_want(name, mods[name][1], cfg, k)} "
                        f"(k={k})" for k in (8, 1)))
                log(f"[resident] {key}: k=1 max rel err {worst:.3e} (tol "
                    f"{STEP_TOL[cfg.torch_dtype]:g}), k=8 within the JAX "
                    f"bars, k=8 bitwise equal to 8 x k=1, run(23) = 2 + 7 "
                    f"launches{syncs}")
    return errs


def mod_default(cls, field: str):
    return {f.name: f.default for f in dataclasses.fields(cls)}[field]


def check_nan_case(name, mods, cfg, s, key) -> None:
    """The NaN max makes dt NaN: Burgers and shallow water turn NaN
    everywhere; MHD reverts every cell and its t turns NaN."""
    out = mods[name][2](cfg, s, 1)
    if name == "mhd":
        if not (torch.isnan(out.t) and all(same(a, b) for a, b in
                                           zip(out.U, s.U))):
            raise AssertionError(f"{key}: MHD did not revert every cell")
    elif not all(bool(torch.isnan(f).all()) for _, f in
                 resident_fields(out)[:-2]):
        raise AssertionError(f"{key}: the NaN did not reach every cell")


# The reference's Burgers is in conservative form ((u^2/2)_x + (uv)_y), which
# adds u div(v) to the advective form: at its default field the kinetic
# energy first grows, to 2.0x its start near step 1000 at 512^2, then
# decays below the start by step ~3500 (the plain torch engine on the CPU,
# f32; JAX's XLA step likewise).  So decay is required after 4000 steps
# and, before, the energy must stay below this multiple of its start.
BURGERS_ENERGY_GROWTH_MAX = 3.0

# Relative shallow-water mass drift allowed per step.  The HLL update
# conserves mass; what remains is the rounding of the exp/log round trip
# of sigma each step, which CUDA's f32 expf/logf bias: 1.79e-8 a step over
# 4000 steps at 512^2 on the H100 (the kernel and the plain step give the
# same bits), 3.6e-10 a step on the CPU's libm.  f64: 1e-15 a step.
SW_MASS_DRIFT_PER_STEP = {torch.float32: 3e-8, torch.float64: 1e-15}


def resident_physics(name, mod, cfg, s0, out, key, steps, plain_out,
                     plain_steps) -> dict:
    """Burgers: finite, energy decayed after 4000 steps (bounded before);
    shallow water: h > 0, mass within SW_MASS_DRIFT_PER_STEP a step (the
    plain engine's run beside it); MHD: finite, rho > 0, p > 0, t
    advanced."""
    fields = [f for _, f in resident_fields(out)]
    if name == "burgers":
        if not all(bool(torch.isfinite(f).all()) for f in fields[:2]):
            raise AssertionError(f"{key}: non-finite phi")
        e0, e1 = (float(sum((f.double() ** 2).sum() for f in
                            mod.velocities(cfg, x))) for x in (s0, out))
        bar = e0 if steps >= 4000 else BURGERS_ENERGY_GROWTH_MAX * e0
        if not e1 < bar:
            raise AssertionError(f"{key}: energy {e0:.6g} -> {e1:.6g} (bar "
                                 f"{bar:.6g})")
        log(f"[physics] {key}: finite, energy {e0:.6g} -> {e1:.6g}, t "
            f"{float(out.t):.6g}, tau {float(out.tau):.6g}")
        return {"energy_start": e0, "energy_end": e1}
    if name == "sw":
        h0, h1 = mod.depth(s0).double(), mod.depth(out).double()

        def drift(h):
            return abs(float(h.sum()) - float(h0.sum())) / float(h0.sum())

        d, d_plain = drift(h1), drift(mod.depth(plain_out).double())
        bar = SW_MASS_DRIFT_PER_STEP[cfg.torch_dtype] * steps
        if not (bool(torch.isfinite(h1).all()) and float(h1.min()) > 0
                and d <= bar):
            raise AssertionError(f"{key}: min h {float(h1.min())}, mass "
                                 f"drift {d:.3e} (bar {bar:.1e})")
        log(f"[physics] {key}: h in [{float(h1.min()):.6g}, "
            f"{float(h1.max()):.6g}], mass drift {d:.3e} = {d / steps:.3e} "
            f"a step (bar {bar:.1e}; the plain engine {d_plain:.3e} over "
            f"{plain_steps} steps = {d_plain / plain_steps:.3e} a step), max "
            f"|u| {float(out.u.abs().max()):.4g}")
        return {"mass_drift": d, "mass_drift_per_step": d / steps,
                "plain_mass_drift_per_step": d_plain / plain_steps,
                "h_min": float(h1.min())}
    # The pressure of cons_to_prim before its floor, in its order of
    # operations: E - ek - em cancels, so at f32 another order can read
    # a few 1e-7 below zero where this one reads just above EPS_P (the
    # step's revert keeps this one above EPS_P in every cell).
    U = out.U
    rho = torch.clamp_min(U.rho, mod.EPS_RHO)
    u, v = U.mx / rho, U.my / rho
    raw_p = (cfg.gamma - 1.0) * (U.E - 0.5 * rho * (u * u + v * v)
                                 - 0.5 * (U.Bx * U.Bx + U.By * U.By))
    ok = (all(bool(torch.isfinite(f).all()) for f in U)
          and float(U.rho.min()) > 0 and float(raw_p.min()) > 0
          and float(out.t) > float(s0.t) and bool(torch.isfinite(out.t)))
    if not ok:
        raise AssertionError(f"{key}: rho min {float(U.rho.min())}, p min "
                             f"{float(raw_p.min())}, t {float(out.t)}")
    log(f"[physics] {key}: finite, rho in [{float(U.rho.min()):.4g}, "
        f"{float(U.rho.max()):.4g}], min p {float(raw_p.min()):.4g}, t "
        f"{float(out.t):.6g}")
    return {"rho_min": float(U.rho.min()), "p_min": float(raw_p.min()),
            "t": float(out.t)}


# Operations a cell-step (each add, multiply, division, square root, exp,
# log, sinh, asinh, hypot, min, max once), each face counted once (the work
# of the plain step; the kernels solve each face from both its cells),
# counted from the CUDA sources at the main path's options:
# burgers_multistep.cu, no MUSCL, one viscosity substep: decode (4),
# wavespeed (6), the x and y Rusanov faces (20 each), the convective
# update (16), the viscosity (24), encode (4).
BURGERS_OPS_PER_CELL = 4 + 6 + 2 * 20 + 16 + 24 + 4
# shallow_water_multistep.cu, nu > 0: exp, sound speed and wavespeed (8),
# the x and y HLL faces (~55 each: 2 sqrt, speeds, 6 fluxes, 3 mids and
# selects), the update, floor, 2 divisions and log (27), viscosity (25).
SW_OPS_PER_CELL = 8 + 2 * 55 + 27 + 25
# mhd_multistep.cu, which computes each MC slope and each face once:
# primitives, hypot and both fast speeds (45); per axis 7 MC slopes (22
# each), the face states (21), one HLL face (~172: 2 primitive decodes, 2
# fast speeds, 2 GLM fluxes, 7 HLL mixes and selects) and the band mask
# (7); the pair update, damping, the new primitives, the revert test and
# select (76).
MHD_OPS_PER_CELL = 45 + 2 * (7 * 22 + 21 + 172 + 7) + 76
RESIDENT_OPS = {"burgers": BURGERS_OPS_PER_CELL, "sw": SW_OPS_PER_CELL,
                "mhd": MHD_OPS_PER_CELL}
RESIDENT_STATE_FIELDS = {"burgers": 2, "sw": 3, "mhd": 7}


def resident_bound(name, cfg, k: int) -> tuple[float, str]:
    """bound_ms of one launch of k steps: the state read and written once,
    k x cells x the operations of a cell-step."""
    cells = cfg.nx * cfg.ny
    T = torch.finfo(cfg.torch_dtype).bits // 8
    return bound(cells * 2 * RESIDENT_STATE_FIELDS[name] * T,
                 k * cells * RESIDENT_OPS[name], cfg.torch_dtype)


# (solver, config fields, steps, block_k, plain steps): bench.py's
# reference sizes (burgers_512x512, shallow_water_512x512, mhd_320x220; 4000
# steps) at the default block_k and at 1, one large grid each (f32 x 200),
# and each reference size at f64 x 1000
RESIDENT_RUNS = (
    ("burgers", dict(nx=512, ny=512), 4000, 16, 100),
    ("burgers", dict(nx=512, ny=512), 4000, 1, 100),
    ("burgers", dict(nx=4096, ny=4096), 200, 16, 5),
    ("burgers", dict(nx=512, ny=512, dtype="float64"), 1000, 16, 100),
    ("sw", dict(nx=512, ny=512), 4000, 8, 100),
    ("sw", dict(nx=512, ny=512), 4000, 1, 100),
    ("sw", dict(nx=4096, ny=4096), 200, 8, 5),
    ("sw", dict(nx=512, ny=512, dtype="float64"), 1000, 8, 100),
    ("mhd", dict(nx=320, ny=220), 4000, 8, 100),
    ("mhd", dict(nx=320, ny=220), 4000, 1, 100),
    ("mhd", dict(nx=2048, ny=2048, problem="orszag-tang"), 200, 8, 5),
    ("mhd", dict(nx=320, ny=220, dtype="float64"), 1000, 8, 100))


def resident_key(name, cfg, k) -> str:
    extra = f" {cfg.problem}" if name == "mhd" else ""
    return f"{name} {cfg.nx}x{cfg.ny}{extra} {cfg.dtype} K={k}"


def phase_resident_main(mods, device, smi, errs,
                        runs=RESIDENT_RUNS) -> dict:
    res = {"launches": {name: {"step": 0, "multistep": 0}
                        for name in RESIDENT}}
    for name, fields, steps, k, p_steps in runs:
        mod, kmod, kern, plain, cls = mods[name]
        cfg = cls(**fields, block_k=k)
        key = resident_key(name, cfg, k)
        engine = mod.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"{key}: engine auto resolved to {engine!r}")
        s0 = mod.init(cfg, device)
        mod.run(cfg, s0, k + 1)   # warm-up, not counted
        kmod.reset_launches()
        out, wall = run_timed(mod, cfg, s0, steps)
        got = dict(kmod.LAUNCHES)
        want = ({"step": steps % k, "multistep": steps // k} if k > 1
                else {"step": steps, "multistep": 0})
        if got != want:
            raise AssertionError(f"{key}: launches {got}, want {want}")
        for n in got:
            res["launches"][name][n] += got[n]
        p_out, p_wall = run_timed(mod, cfg.replace(engine="torch"), s0,
                                  p_steps)
        if kmod.LAUNCHES != got:
            raise AssertionError(f"{key}: the plain engine launched a kernel")
        cells = cfg.nx * cfg.ny
        rate, p_rate = steps / wall, p_steps / p_wall
        log(f"[resident] {key} on {smi}: cuda engine {steps} steps in "
            f"{wall:.4f} s, {rate:.2f} steps/s {cells * rate / 1e6:.1f} "
            f"Mcell-steps/s; plain torch engine {p_steps} steps "
            f"{p_rate:.3f} steps/s; launches {got}")
        phys = resident_physics(name, mod, cfg, s0, out, key, steps, p_out,
                                p_steps)

        # from the final state: the kernel vs its plain version at full
        # shape (k = 1 and k = K, K = 2 for the K = 1 runs), then times a
        # launch; none of these launches is counted above
        kk = max(k, 2)
        rel, ab = resident_err(kern(cfg, out, 1), plain(cfg, out, 1),
                               f"{key} final state k=1",
                               step_bars(cfg.torch_dtype))
        rel_k, ab_k = resident_err(kern(cfg, out, kk), plain(cfg, out, kk),
                                   f"{key} final state k={kk}",
                                   k_bars(name, cfg.torch_dtype))
        errs[name] = max(errs[name], ab, ab_k)
        errs["rel"][f"{key} final state"] = rel
        big = cells > 4_000_000
        times = {"ms": time_launches(lambda: kern(cfg, out, kk),
                                     5 if big else 50),
                 "plain_ms": time_launches(lambda: plain(cfg, out, kk),
                                           1 if big else 3)}
        if k == 1:  # back to back, so the host's cost a call shows too
            times["ms_one_step"] = time_launches(lambda: kern(cfg, out, 1),
                                                 200)
        bnd = resident_bound(name, cfg, kk)
        log(f"[resident] {key} final state: kernel vs plain max rel err "
            f"k=1 {rel:.3e}, k={kk} {rel_k:.3e}; per launch of {kk} steps on "
            f"{smi}: {times['ms']:.4f} ms vs plain {times['plain_ms']:.4f} ms "
            f"(bound {bnd[0]:.4f} ms, {bnd[1]})")
        res[key] = {"launches": got, "times": times, "bound": bnd,
                    "rate": rate, "plain_rate": p_rate, "k": kk,
                    "physics": phys}
    return res


def tiled_design(bk, swk, mk, s2k, bg, swm, mhd, build, device) -> dict:
    """The tiling of the redesigned kernels at the main runs' configs
    (Burgers 512^2 at block_k 16, shallow water 512^2 at 8, MHD 320x220 at
    8, the stam2d solve at 512^2 and 40 sweeps), per dtype, as this run's
    library reports it: the grid query's blocks (`grid`), threads a block,
    tile, halo and dynamic shared memory a block (the launch's own
    make_args); the grid syncs of one launch as the kernel counted them
    (held to K + 1 and ceil(40 / h) - 1); and ptxas's registers, static
    shared memory, stack and spills of each instantiation in this run's
    build."""
    out = {}
    for name, kname in (("burgers", "burgers_multistep_kernel"),
                        ("sw", "sw_multistep_kernel"),
                        ("mhd", "mhd_multistep_kernel"),
                        ("lin_solve", "lin_solve_kernel")):
        d = {"ptxas": build.ptxas_usage(kname)}
        for dtype in ("float32", "float64"):
            if name == "lin_solve":
                dt = torch.float32 if dtype == "float32" else torch.float64
                shape = s2k.solve_launch(512, dt, device.index)
                x, b = stam2d_fields(512, dt, device, SEED, 2)
                s2k.lin_solve(x, b, 1.0, 4.0, 40)
                syncs = check_solve_syncs(s2k, x, 40, f"512^2 {dtype}")
            else:
                mod, kmod, kern, cls, nx, ny = {
                    "burgers": (bg, bk, bk.burgers_multistep,
                                bg.BurgersConfig, 512, 512),
                    "sw": (swm, swk, swk.sw_multistep,
                           swm.ShallowWaterConfig, 512, 512),
                    "mhd": (mhd, mk, mk.mhd_multistep, mhd.MHDConfig, 320,
                            220)}[name]
                cfg = cls(nx=nx, ny=ny, dtype=dtype)
                shape = kmod.launch_shape(cfg, device.index)
                s = mod.init(cfg, device)
                kern(cfg, s, cfg.block_k)
                syncs = check_tiled_syncs(name, kmod, cfg, s, cfg.block_k,
                                          f"{name} {nx}x{ny} {dtype}")
            d[dtype] = {**shape.asdict(), "grid_syncs_per_launch": syncs}
        out[name] = d
        log(f"[build] {name} tiling: {d}")
    return out


def resident_kernel_lines(res, errs, design) -> list:
    """The {"kernels": [...]} entries of the three K-step kernels: time
    and bound a launch at the reference size f32 and default block_k, the
    large grid's and f64's beside them; launches summed over each
    solver's four runs."""
    out = []
    for name, src, replaces, ref, large, f64 in (
            ("burgers", "burgers_multistep",
             "fluidsims_tpu/kernels/resident_multistep.py:38",
             "burgers 512x512 float32 K=16", "burgers 4096x4096 float32 K=16",
             "burgers 512x512 float64 K=16"),
            ("sw", "shallow_water_multistep",
             "fluidsims_tpu/kernels/resident_multistep.py:38",
             "sw 512x512 float32 K=8", "sw 4096x4096 float32 K=8",
             "sw 512x512 float64 K=8"),
            ("mhd", "mhd_multistep",
             "fluidsims_tpu/kernels/mhd_resident_pallas.py:76",
             "mhd 320x220 briowu float32 K=8",
             "mhd 2048x2048 orszag-tang float32 K=8",
             "mhd 320x220 briowu float64 K=8")):
        a, b, c = res[ref], res[large], res[f64]
        launches = res["launches"][name]
        out.append({
            "name": src, "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/{src}.cu",
            "replaces": replaces,
            "launches": launches["step"] + launches["multistep"],
            "max_abs_err": errs[name],
            "ms": a["times"]["ms"], "plain_ms": a["times"]["plain_ms"],
            "bound_ms": a["bound"][0], "bound_by": a["bound"][1],
            "library_ms": None, "k": a["k"],
            "launches_k_steps": launches["multistep"],
            "launches_one_step": launches["step"],
            "ms_large": b["times"]["ms"],
            "plain_ms_large": b["times"]["plain_ms"],
            "bound_ms_large": b["bound"][0], "bound_by_large": b["bound"][1],
            "ms_f64": c["times"]["ms"], "plain_ms_f64": c["times"]["plain_ms"],
            "bound_ms_f64": c["bound"][0], "bound_by_f64": c["bound"][1],
            "steps_per_s": {key: res[key]["rate"] for key in res
                            if key.startswith(name + " ")},
            **({"ms_one_step": res[ref.split(" K=")[0] + " K=1"]["times"]
                ["ms_one_step"], "tiling": design[name]}
               if name in design else {})})
    out[-1]["max_rel_err"] = errs["rel"]
    return out


# ---------------------------- 3-D stable fluids -----------------------------
#
# Three kernels (TPU kernels #11-#13), kernels/stam3d_cuda.py; `sc` below is
# the wrapper module, `s3` the solver.

ADVECT_TOL = {torch.float32: 1e-6, torch.float64: 1e-13}
# stam3d_jacobi.cu per interior cell: the 5 adds of sum6, a * sum, + x0,
# / c.
STAM3D_JACOBI_OPS_PER_CELL = 8
# stam3d_advect.cu per interior cell: per axis the backtrace (2), the clamp
# (2), floor, the conversion and the fraction (3); 7 lerps of 4 (a
# subtraction, 2 multiplies, an add).
STAM3D_ADVECT_OPS_PER_CELL = 3 * 7 + 7 * 4
# stam3d_set_bnd.cu: a negation per reflected face cell (3 fields x 2
# faces x n^2); the other face cells are copies.
STAM3D_SET_BND_OPS_PER_FACE_CELL = 1
# (n, dtype, steps): Stam3DConfig()'s 192^3 f32 (bench.py's stam3d_192)
# and the same at f64
STAM3D_RUNS = ((192, "float32", 100), (192, "float64", 20))


def stam3d_state(s3, cfg, device, seed, amp=0.3):
    """init() plus seeded noise on all eight fields, rings included."""
    s = s3.init(cfg, device)
    rng = np.random.default_rng(seed)
    return s3.Stam3DState(*[
        f + torch.tensor(amp * rng.standard_normal(tuple(f.shape)),
                         dtype=f.dtype, device=device) for f in s[:8]],
        s.step_idx)


def stam3d_coeffs(cfg) -> tuple:
    """(a, c) of the viscosity, diffusion and projection solves."""
    out = []
    for coeff in (cfg.visc, cfg.diff):
        a = cfg.dt * coeff * cfg.n * cfg.n
        out.append((a, 1.0 + 6.0 * a))
    return (*out, (1.0, 6.0))


def check_stam3d_call(sc, s3, cfg, s, what: str, errs: dict) -> float:
    """The three kernels against their plain versions on the state's
    fields: one Jacobi sweep and the ping-pong solve at jacobi_iters 12 and
    5 with each solve's (a, c), bitwise; the advection at velocity scales
    1 and 6 within ADVECT_TOL relative; set_bnd of the four fields
    bitwise.  Folds the absolute errors into `errs`; returns the advection's
    max rel error."""
    for a, c in stam3d_coeffs(cfg):
        got, ref = s.w0.clone(), s.w0.clone()
        sc.jacobi(s.u, s.v, got, a, c)
        sc.jacobi_plain(s.u, s.v, ref, a, c)
        if not same(got, ref):
            raise AssertionError(f"jacobi {what} (a={a:g}): differs from the "
                                 "plain version")
        for iters in (12, 5):
            icfg = cfg.replace(jacobi_iters=iters)
            if not same(sc.lin_solve(icfg, s.u0, s.u, a, c),
                        s3._lin_solve(icfg, s.u0, s.u, a, c)):
                raise AssertionError(f"jacobi {what} (a={a:g}, {iters} "
                                     "sweeps): differs from the plain solve")
    rel = 0.0
    for scale in (1.0, 6.0):
        vel = [f * scale for f in (s.u, s.v, s.w)]
        r, ab = rel_err(sc.advect(cfg, s.d, *vel),
                        sc.advect_plain(cfg, s.d, *vel))
        rel = max(rel, r)
        errs["advect"] = max(errs["advect"], ab)
    tol = ADVECT_TOL[cfg.torch_dtype]
    if not rel <= tol:
        raise AssertionError(f"advect {what}: max rel err {rel:.3e} > {tol:g}")
    check_set_bnd(sc, [s.u, s.v, s.w, s.d], what, errs)
    log(f"[stam3d] {what}: jacobi sweep and solves (12 and 5 sweeps, 3 "
        f"coefficient pairs) bitwise equal; advect max rel err {rel:.3e} (tol "
        f"{tol:g}); set_bnd bitwise equal")
    return rel


def check_set_bnd(sc, fields, what: str, errs: dict) -> None:
    """set_bnd of the four fields (copies) against its plain version, the
    same bits or the script fails; counted in errs["set_bnd_bitwise"]."""
    got = [f.clone() for f in fields]
    ref = [f.clone() for f in got]
    sc.set_bnd(*got)
    sc.set_bnd_plain(*ref)
    if not all(bits_equal(x, y) for x, y in zip(got, ref)):
        raise AssertionError(f"set_bnd {what}: differs from the plain version")
    errs["set_bnd_bitwise"] += 1


# Phase 15's set_bnd sizes (also tools/tune_tiles_torch.py check's):
# fewer cells a face than a block's row, the solver's cases, and the main
# runs' 192^3
SET_BND_CHECK_N = (1, 2, 3, 24, 37, 192)


def check_set_bnd_cases(sc, device, errs) -> None:
    """set_bnd at SET_BND_CHECK_N, f32 and f64, on seeded fields with -0.0
    and NaN cells, each bitwise equal to the plain version or the script
    fails."""
    for dtype in (torch.float32, torch.float64):
        for n in SET_BND_CHECK_N:
            rng = np.random.default_rng(SEED + n)
            fields = [torch.tensor(rng.standard_normal((n + 2,) * 3),
                                   dtype=dtype, device=device)
                      for _ in range(4)]
            fields[0].view(-1)[::5] = -0.0
            fields[3].view(-1)[::7] = float("nan")
            check_set_bnd(sc, fields, f"n={n} {dtype}", errs)
    log(f"[stam3d] set_bnd at n = {SET_BND_CHECK_N}, f32 and f64, with -0.0 "
        f"and NaN cells: bitwise equal to the plain version")


def phase_stam3d_kernels(sc, s3, device) -> dict:
    errs = {"jacobi": 0.0, "advect": 0.0, "set_bnd": 0.0, "rel": {},
            "set_bnd_bitwise": 0}
    check_set_bnd_cases(sc, device, errs)
    log(f"[stam3d] set_bnd launch at n=192: "
        f"{sc.set_bnd_launch(192).asdict()}")
    for dtype in ("float32", "float64"):
        for n in (24, 37):
            cfg = s3.Stam3DConfig(n=n, dtype=dtype)
            key = f"n={n} {dtype}"
            errs["rel"][key] = check_stam3d_call(
                sc, s3, cfg, stam3d_state(s3, cfg, device, SEED + n), key,
                errs)
    fields = ("u", "v", "w", "u0", "v0", "w0", "d", "d0")
    for dtype in ("float32", "float64"):
        cfg = s3.Stam3DConfig(n=37, dtype=dtype, advect_k=0)
        if s3.resolve_engine(cfg, device) != "cuda":
            raise AssertionError("engine auto did not resolve to cuda")
        a = b = stam3d_state(s3, cfg, device, SEED, amp=0.1)
        pcfg = cfg.replace(engine="torch")
        for _ in range(5):
            a, b = s3.step(cfg, a), s3.step(pcfg, b)
        rel = max(rel_err(getattr(a, f), getattr(b, f))[0] for f in fields)
        tol = STEP_TOL[cfg.torch_dtype]
        if not rel <= tol:
            raise AssertionError(f"5 steps cuda vs torch {dtype}: max rel "
                                 f"err {rel:.3e} > {tol:g}")
        log(f"[stam3d] 5 steps n=37 {dtype}, cuda engine vs torch engine at "
            f"advect_k=0: max rel err {rel:.3e} over the eight fields (tol "
            f"{tol:g})")
        errs["rel"][f"5 steps n=37 {dtype}"] = rel
    return errs


def check_stam3d_physics(s3, cfg, out) -> dict:
    for name in ("u", "v", "w", "u0", "v0", "w0", "d", "d0"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"stam3d: non-finite {name}")
    dmin, dmax = float(out.d.min()), float(out.d.max())
    if not (dmin >= 0.0 and dmax > 0.0):
        raise AssertionError(f"stam3d density min {dmin} max {dmax}")
    capped = int(s3.advect_capped_count(
        cfg.replace(engine="torch", advect_k=2), out))
    log(f"[physics] stam3d {cfg.n}^3 {cfg.dtype}: every field finite, d in "
        f"[{dmin:.6g}, {dmax:.6g}]; {capped} of {cfg.n ** 3} cells past 2 "
        "cells of backtrace (JAX's default advect_k=2 would cap them)")
    return {"d_min": dmin, "d_max": dmax, "capped_at_k2": capped}


def stam3d_bounds(cfg) -> dict:
    """bound_ms of the three kernels at cfg's shape: every input cell each
    kernel must read once and every cell it writes."""
    n, dtype = cfg.n, cfg.torch_dtype
    T = torch.finfo(dtype).bits // 8
    return {
        "jacobi": bound((3 * n ** 3 + 6 * n ** 2) * T,
                        STAM3D_JACOBI_OPS_PER_CELL * n ** 3, dtype),
        "advect": bound((3 * n ** 3 + 2 * (n + 2) ** 3) * T,
                        STAM3D_ADVECT_OPS_PER_CELL * n ** 3, dtype),
        "set_bnd": bound(4 * 6 * n ** 2 * 2 * T,
                         STAM3D_SET_BND_OPS_PER_FACE_CELL * 6 * n ** 2,
                         dtype)}


def phase_stam3d_main(sc, s3, device, smi, errs,
                      runs=STAM3D_RUNS) -> dict:
    res = {}
    for n, dtype, steps in runs:
        cfg = s3.Stam3DConfig(n=n, dtype=dtype)
        engine = s3.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"engine auto resolved to {engine!r}")
        st0 = s3.init(cfg, device)
        s3.run(cfg, st0, 1)   # warm-up, not counted
        sc.reset_launches()
        out, wall = run_timed(s3, cfg, st0, steps)
        launches = dict(sc.LAUNCHES)
        want = {"jacobi": 6 * cfg.jacobi_iters * steps, "advect": 4 * steps,
                "set_bnd": 6 * steps}
        if launches != want:
            raise AssertionError(f"launches {launches} in {steps} steps, "
                                 f"want {want}")
        pcfg = cfg.replace(engine="torch", advect_k=0)
        p_steps = 2
        _, p_wall = run_timed(s3, pcfg, st0, p_steps)
        if dict(sc.LAUNCHES) != launches:
            raise AssertionError("the plain engine launched a kernel")
        rate, p_rate = steps / wall, p_steps / p_wall
        cells = cfg.n ** 3
        log(f"[stam3d] {cfg.n}^3 {dtype} engine={engine} on {smi}: {steps} "
            f"steps in {wall:.3f} s, {rate:.2f} steps/s, "
            f"{cells * rate / 1e6:.1f} Mcell-steps/s; plain torch engine "
            f"(advect_k=0) {p_steps} steps {p_rate:.3f} steps/s, "
            f"{cells * p_rate / 1e6:.2f} Mcell-steps/s; launches {launches}")
        phys = check_stam3d_physics(s3, cfg, out)

        key = f"{cfg.n}^3 {dtype} final state"
        errs["rel"][key] = check_stam3d_call(sc, s3, cfg, out, key, errs)
        a, c = stam3d_coeffs(cfg)[2]
        buf = out.w0.clone()
        bnd = [f.clone() for f in (out.u, out.v, out.w, out.d)]
        times = {
            "jacobi": time_launches(
                lambda: sc.jacobi(out.u, out.v, buf, a, c), 50),
            "jacobi_plain": time_launches(
                lambda: sc.jacobi_plain(out.u, out.v, buf, a, c), 20),
            "advect": time_launches(
                lambda: sc.advect(cfg, out.d, out.u, out.v, out.w), 50),
            "advect_plain": time_launches(
                lambda: sc.advect_plain(cfg, out.d, out.u, out.v, out.w), 10),
            "set_bnd": time_launches(lambda: sc.set_bnd(*bnd), 50),
            "set_bnd_device": device_ms(lambda: sc.set_bnd(*bnd), 50,
                                        "set_bnd_kernel"),
            "set_bnd_plain": time_launches(lambda: sc.set_bnd_plain(*bnd),
                                           20),
        }
        bounds = stam3d_bounds(cfg)
        log(f"[stam3d] per launch at {cfg.n}^3 {dtype} on {smi}: " + ", ".join(
            f"{k} {times[k]:.4f} ms vs plain {times[k + '_plain']:.4f} ms "
            f"(bound {bounds[k][0]:.4f} ms, {bounds[k][1]})"
            for k in ("jacobi", "advect", "set_bnd"))
            + f"; set_bnd {times['set_bnd_device']} ms of device time")
        res[dtype] = {"launches": launches, "times": times, "bounds": bounds,
                      "rate": rate, "plain_rate": p_rate,
                      "mcells": cells * rate / 1e6,
                      "plain_mcells": cells * p_rate / 1e6, "physics": phys}
    return res


def stam3d_kernel_lines(res, errs) -> list:
    """The {"kernels": [...]} entries of the three stam3d kernels: times
    and bounds from the final state of the 192^3 f32 run, the f64 run's
    beside them; launches summed over both runs."""
    a, b = res["float32"], res["float64"]
    out = []
    for name, line in (("jacobi", 74), ("advect", 247), ("set_bnd", 296)):
        out.append({
            "name": f"stam3d_{name}", "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/stam3d_{name}.cu",
            "replaces": f"fluidsims_tpu/kernels/stam3d_pallas.py:{line}",
            "launches": a["launches"][name] + b["launches"][name],
            "max_abs_err": errs[name],
            "ms": a["times"][name], "plain_ms": a["times"][name + "_plain"],
            "bound_ms": a["bounds"][name][0], "bound_by": a["bounds"][name][1],
            "library_ms": None,
            "launches_f32": a["launches"][name],
            "launches_f64": b["launches"][name],
            "ms_f64": b["times"][name],
            "plain_ms_f64": b["times"][name + "_plain"],
            "bound_ms_f64": b["bounds"][name][0],
            "bound_by_f64": b["bounds"][name][1]})
    out[-1].update(device_ms=a["times"]["set_bnd_device"],
                   device_ms_f64=b["times"]["set_bnd_device"],
                   bitwise_cases=errs["set_bnd_bitwise"],
                   max_rel_err=errs["rel"])
    return out


# ---------------------------- 2-D stable fluids -----------------------------
#
# Two kernels (TPU kernels #9-#10), kernels/stam2d_cuda.py; `s2k` below is
# the wrapper module, `s2` the solver.

# stam2d_lin_solve.cu per cell and sweep: the 3 adds of sum4, a * sum,
# + b, / c.
STAM2D_SOLVE_OPS_PER_CELL_SWEEP = 6
# stam2d_advect.cu per cell: per axis the back-trace (3), the shift and
# scale to cells (3), the clamp (2), floor, the conversion and the
# fraction (3); s0 and t0 (2); per field the blend (6 multiplies, 3 adds).
STAM2D_ADVECT_OPS = (2 * 11 + 2, 9)
# (dtype, steps, plain steps): Stam2DConfig() = 512^2 f32 (bench.py's
# stam2d_512x512 size and steps) and the same at f64 (js_cuda's precision)
STAM2D_RUNS = (("float32", 400, 20), ("float64", 400, 20))


def stam2d_fields(n, dtype, device, seed, k):
    """k seeded (n, n) fields: uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.random((n, n)), dtype=dtype, device=device)
            for _ in range(k)]


def stam2d_coeffs(cfg) -> tuple:
    """(a, c) of the viscosity, diffusion and pressure solves."""
    out = []
    for coeff in (cfg.visc, cfg.diff):
        a = cfg.dt * coeff * cfg.n * cfg.n
        out.append((a, 1.0 + 4.0 * a))
    return (*out, (1.0, 4.0))


def check_stam2d_solve(s2k, x, b, a, c, iters, what, errs) -> tuple:
    """The solve kernel against its plain version from the same x and b:
    bitwise equal (the kernel runs the plain version's operations in its
    order), x unchanged: (max rel err, bitwise equal)."""
    keep = x.clone()
    got = s2k.lin_solve(x, b, a, c, iters)
    check_solve_syncs(s2k, x, iters, what)
    ref = s2k.lin_solve_plain(x, b, a, c, iters)
    if not torch.equal(x, keep):
        raise AssertionError(f"lin_solve {what}: the kernel wrote x")
    rel, ab = rel_err(got, ref)
    errs["lin_solve"] = max(errs["lin_solve"], ab)
    if not same(got, ref):
        raise AssertionError(f"lin_solve {what} (a={a:g}, c={c:g}, {iters} "
                             f"sweeps): not bitwise equal to the plain "
                             f"version (max rel err {rel:.3e})")
    return rel, True


def check_solve_syncs(s2k, x, iters: int, what: str) -> int:
    """The grid syncs of the solve just launched on x's shape, as the
    kernel counted them: ceil(iters / h) - 1 for h sweeps a sync (the grid
    query's halo), or the script fails."""
    n = x.shape[0]
    h = s2k.solve_launch(n, x.dtype, x.device.index).halo
    got = s2k.solve_grid_syncs(n, x.dtype, x.device)
    if got != -(-iters // h) - 1:
        raise AssertionError(f"lin_solve {what}, {iters} sweeps, {h} a "
                             f"sync: the kernel made {got} grid syncs, want "
                             f"{-(-iters // h) - 1}")
    return got


def check_stam2d_advect(s2k, cfg, qs, uu, vv, what, errs) -> tuple:
    """The advection kernel against its plain version on the same fields
    (one or two), within ADVECT_TOL relative: (max rel err, bitwise
    equal)."""
    got = s2k.advect(cfg, qs, uu, vv)
    ref = s2k.advect_plain(cfg, qs, uu, vv)
    worst, bit = 0.0, True
    for g, r in zip(got, ref):
        rel, ab = rel_err(g, r)
        errs["advect"] = max(errs["advect"], ab)
        worst = max(worst, rel)
        bit = bit and same(g, r)
    tol = ADVECT_TOL[cfg.torch_dtype]
    if not worst <= tol:
        raise AssertionError(f"advect {what} ({len(qs)} fields): max rel "
                             f"err {worst:.3e} > {tol:g}")
    return worst, bit


# The advection's bitwise cases (phase 17 runs the ragged ones, 1-3; the
# rest are phase 17's own sizes; tools/tune_tiles_torch.py check runs
# them all).
ADVECT_CHECK_N = (1, 2, 3, 37, 200, 512)


def check_advect_cases(s2k, s2, device, errs, sizes=ADVECT_CHECK_N) -> None:
    """The advection of one field and of the velocity pair at each n of
    `sizes`, f32 and f64, on seeded fields with back-traces past the edge,
    bitwise equal to the plain version or the script fails; the cases
    counted in errs["advect_bitwise"]."""
    ok = errs.setdefault("advect_bitwise", 0)
    for n in sizes:
        for dtype in ("float32", "float64"):
            cfg = s2.Stam2DConfig(n=n, dtype=dtype)
            q, u, v = stam2d_fields(n, cfg.torch_dtype, device, SEED + 10 * n,
                                    3)
            uu, vv = (2.0 * (2.0 * f - 1.0) for f in (u, v))
            for qs in ((q,), (uu, vv)):
                got = s2k.advect(cfg, qs, uu, vv)
                ref = s2k.advect_plain(cfg, qs, uu, vv)
                if not all(bits_equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"advect n={n} {dtype} ({len(qs)} "
                                         "fields): not bitwise equal to the "
                                         "plain version")
                ok += 1
    errs["advect_bitwise"] = ok
    log(f"[stam2d] advect n = {sizes}, f32 and f64, one field and the "
        "velocity pair: bitwise equal to the plain version")


def stam2d_reach(s2, cfg, vv) -> tuple[int, int]:
    """(cells whose back-trace moves past 16 rows, cells whose back-trace
    leaves the grid before the clamp) for row velocity vv."""
    m = s2.metric(cfg, vv)
    t = (m.eta[:, None] - cfg.dt * vv / m.yp[:, None]
         - cfg.eta_min) / s2._deta(cfg) + 0.5
    rows = torch.arange(1, cfg.n + 1, dtype=vv.dtype,
                        device=vv.device)[:, None]
    return (int((torch.floor(t) - rows).abs().gt(16).sum()),
            int(((t < 0.5) | (t > cfg.n + 0.5)).sum()))


def phase_stam2d_kernels(s2k, s2, device) -> dict:
    errs = {"lin_solve": 0.0, "advect": 0.0, "rel": {}}
    check_advect_cases(s2k, s2, device, errs, sizes=(1, 2, 3))
    for dtype in ("float32", "float64"):
        # the solve alone on a 1-cell field and on a ragged 65^2 one (more
        # tiles than a block row), at 1, h and h + 1 sweeps (h: sweeps a
        # grid sync) and the default 40: a phase shorter than h, exactly
        # h, and one more phase of a single sweep
        h = s2k.solve_launch(1, s2.Stam2DConfig(dtype=dtype).torch_dtype,
                             device.index).halo
        for n in (1, 65):
            x, b = stam2d_fields(n, s2.Stam2DConfig(n=n, dtype=dtype)
                                 .torch_dtype, device, SEED + n, 2)
            for iters in (1, h, h + 1, 40):
                for a, c in ((1.0, 4.0), (0.26, 2.04)):
                    check_stam2d_solve(s2k, x, b, a, c, iters,
                                       f"n={n} {dtype}", errs)
        log(f"[stam2d] lin_solve n=1 and 65 {dtype} at 1, {h}, {h + 1} and "
            "40 sweeps, (a, c) = (1, 4) and (0.26, 2.04): bitwise equal to "
            "the plain version, x unchanged, ceil(sweeps / h) - 1 grid "
            "syncs as the kernel counted them")
        for n in (512, 200, 37):
            cfg = s2.Stam2DConfig(n=n, dtype=dtype)
            key = f"n={n} {dtype}"
            x, b, q, q2 = stam2d_fields(n, cfg.torch_dtype, device,
                                        SEED + n, 4)
            solves = [check_stam2d_solve(s2k, x, b, a, c, iters, key, errs)
                      for iters in (40, 7, 1, h, h + 1)
                      for a, c in ((1.0, 4.0), (0.26, 2.04))]
            advects, reach = [], []
            for scale in (0.05, 2.0):
                uu, vv = (scale * (2.0 * f - 1.0) for f in stam2d_fields(
                    n, cfg.torch_dtype, device, SEED + n + 1, 2))
                reach.append(stam2d_reach(s2, cfg, vv))
                advects += [check_stam2d_advect(s2k, cfg, qs, uu, vv, key,
                                                errs)
                            for qs in ((q,), (q, q2), (uu, vv))]
            if not (reach[1][0] > 0 and reach[1][1] > 0):
                raise AssertionError(f"stam2d advect {key}: no back-trace "
                                     f"past 16 rows and the edge: {reach}")
            rel_s = max(r for r, _ in solves)
            rel_a = max(r for r, _ in advects)
            bits = sum(bit for _, bit in solves + advects)
            cases = len(solves) + len(advects)
            errs["rel"][key] = {"lin_solve": rel_s, "advect": rel_a}
            log(f"[stam2d] {key}: lin_solve (40, 7, 1, {h} and {h + 1} "
                f"sweeps, (a, c) = (1, 4) and (0.26, 2.04); each bitwise or "
                f"the script fails) and advect (1, 2 fields and the "
                f"velocity pair; back-traces past 16 rows / past the edge "
                f"{reach[0]} at scale 0.05, {reach[1]} at 2.0) vs plain: "
                f"{bits} of {cases} cases bitwise; max rel err lin_solve "
                f"{rel_s:.3e}, advect {rel_a:.3e} (tol "
                f"{ADVECT_TOL[cfg.torch_dtype]:g}); x unchanged")
    for dtype in ("float32", "float64"):
        cfg = s2.Stam2DConfig(n=128, dtype=dtype)
        if s2.resolve_engine(cfg, device) != "cuda":
            raise AssertionError("engine auto did not resolve to cuda")
        a = b = s2.init(cfg, device)
        pcfg = cfg.replace(engine="torch")
        for _ in range(5):
            a, b = s2.step(cfg, a), s2.step(pcfg, b)
        rel = max(rel_err(getattr(a, f), getattr(b, f))[0]
                  for f in ("u", "v", "u0", "v0", "d", "d0"))
        bit = all(same(x, y) for x, y in zip(a[:6], b[:6]))
        tol = STEP_TOL[cfg.torch_dtype]
        if not rel <= tol:
            raise AssertionError(f"stam2d 5 steps cuda vs torch {dtype}: max "
                                 f"rel err {rel:.3e} > {tol:g}")
        log(f"[stam2d] 5 steps n=128 {dtype}, cuda engine vs torch engine: "
            f"max rel err {rel:.3e} over the six fields (tol {tol:g})"
            f"{', bitwise equal' if bit else ''}")
        errs["rel"][f"5 steps n=128 {dtype}"] = rel
    return errs


def check_stam2d_physics(s2, cfg, out) -> dict:
    for name in ("u", "v", "u0", "v0", "d", "d0"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"stam2d: non-finite {name}")
    dmin, dmax = float(out.d.min()), float(out.d.max())
    if not (dmin >= -1e-5 and dmax > 0.0):
        raise AssertionError(f"stam2d density min {dmin} max {dmax}")
    if int(out.ovf) != 0:
        raise AssertionError(f"stam2d ovf {int(out.ovf)}, want 0")
    over = int(s2.advect_overflow_count(cfg, out))
    log(f"[physics] stam2d {cfg.n}^2 {cfg.dtype}: every field finite, d in "
        f"[{dmin:.6g}, {dmax:.6g}], ovf 0; advect_overflow_count {over} of "
        f"{cfg.n ** 2} cells (back-traces past advect_band="
        f"{cfg.advect_band} rows that JAX's banded engine would clamp)")
    return {"d_min": dmin, "d_max": dmax, "advect_overflow_count": over}


def stam2d_bounds(cfg) -> dict:
    """bound_ms of both kernels at cfg's shape: a solve reads x and b and
    writes its result, with jacobi_iters sweeps of operations; an
    advection reads its distinct inputs (the velocity pair: u0 and v0,
    which are also its sources; the density: u, v and d0) and the three
    1-D axes, and writes its fields."""
    n, dtype = cfg.n, cfg.torch_dtype
    T = torch.finfo(dtype).bits // 8
    ops0, ops_field = STAM2D_ADVECT_OPS
    return {
        "lin_solve": bound(3 * n * n * T, STAM2D_SOLVE_OPS_PER_CELL_SWEEP
                           * cfg.jacobi_iters * n * n, dtype),
        "advect": bound((4 * n * n + 3 * n) * T,
                        (ops0 + 2 * ops_field) * n * n, dtype),
        "advect1": bound((4 * n * n + 3 * n) * T,
                         (ops0 + ops_field) * n * n, dtype)}


def phase_stam2d_main(s2k, s2, device, smi, errs,
                      runs=STAM2D_RUNS) -> dict:
    res = {}
    for dtype, steps, p_steps in runs:
        cfg = s2.Stam2DConfig(dtype=dtype)
        engine = s2.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"engine auto resolved to {engine!r}")
        st0 = s2.init(cfg, device)
        s2.run(cfg, st0, 1)   # warm-up, not counted
        s2k.reset_launches()
        out, wall = run_timed(s2, cfg, st0, steps)
        launches = dict(s2k.LAUNCHES)
        want = {"lin_solve": 5 * steps, "advect": 2 * steps}
        if launches != want:
            raise AssertionError(f"launches {launches} in {steps} steps, "
                                 f"want {want}")
        _, p_wall = run_timed(s2, cfg.replace(engine="torch"), st0, p_steps)
        if dict(s2k.LAUNCHES) != launches:
            raise AssertionError("the plain engine launched a kernel")
        rate, p_rate = steps / wall, p_steps / p_wall
        cells = cfg.n ** 2
        shape = s2k.solve_launch(cfg.n, cfg.torch_dtype, device.index)
        log(f"[stam2d] {cfg.n}^2 {dtype} engine={engine} on {smi}: {steps} "
            f"steps in {wall:.3f} s, {rate:.2f} steps/s, "
            f"{cells * rate / 1e6:.1f} Mcell-steps/s; plain torch engine "
            f"{p_steps} steps {p_rate:.2f} steps/s; launches {launches}; "
            f"a solve's launch {shape.asdict()}")
        phys = check_stam2d_physics(s2, cfg, out)

        # both kernels against their plain versions at the main path's
        # shapes and arguments, from the final state
        key = f"{cfg.n}^2 {dtype} final state"
        solves = [check_stam2d_solve(s2k, x, b_, a, c, cfg.jacobi_iters, key,
                                     errs)
                  for (a, c), x, b_ in zip(stam2d_coeffs(cfg),
                                           (out.u0, out.d0, out.u),
                                           (out.u, out.d, out.v))]
        advects = [check_stam2d_advect(s2k, cfg, (out.u0, out.v0), out.u0,
                                       out.v0, key, errs),
                   check_stam2d_advect(s2k, cfg, (out.d0,), out.u, out.v,
                                       key, errs)]
        errs["rel"][key] = {"lin_solve": max(r for r, _ in solves),
                            "advect": max(r for r, _ in advects)}
        bits = sum(bit for _, bit in solves + advects)
        log(f"[stam2d] {key}: the 3 solves' (a, c) at {cfg.jacobi_iters} "
            f"sweeps and both advections vs plain: {bits} of 5 bitwise, max "
            f"rel err {errs['rel'][key]}")

        a, c = stam2d_coeffs(cfg)[2]
        it = cfg.jacobi_iters
        times = {
            "lin_solve": time_launches(
                lambda: s2k.lin_solve(out.u, out.v, a, c, it), 50),
            "lin_solve_plain": time_launches(
                lambda: s2k.lin_solve_plain(out.u, out.v, a, c, it), 5),
            "advect": time_launches(lambda: s2k.advect(
                cfg, (out.u0, out.v0), out.u0, out.v0), 100),
            "advect_plain": time_launches(lambda: s2k.advect_plain(
                cfg, (out.u0, out.v0), out.u0, out.v0), 20),
            "advect1": time_launches(lambda: s2k.advect(
                cfg, (out.d0,), out.u, out.v), 100),
            "advect1_plain": time_launches(lambda: s2k.advect_plain(
                cfg, (out.d0,), out.u, out.v), 20),
        }
        bounds = stam2d_bounds(cfg)
        log(f"[stam2d] per launch at {cfg.n}^2 {dtype} on {smi}: " + ", ".join(
            f"{k} {times[k]:.4f} ms vs plain {times[k + '_plain']:.4f} ms "
            f"(bound {bounds[k][0]:.5f} ms, {bounds[k][1]})"
            for k in ("lin_solve", "advect", "advect1"))
            + " (advect: the velocity pair; advect1: the density)")
        res[dtype] = {"launches": launches, "times": times, "bounds": bounds,
                      "rate": rate, "plain_rate": p_rate,
                      "mcells": cells * rate / 1e6, "physics": phys}
    return res


def stam2d_kernel_lines(res, errs, design) -> list:
    """The {"kernels": [...]} entries of the two stam2d kernels: times and
    bounds from the final state of the 512^2 f32 run (the advection's: the
    velocity pair), the f64 run's beside them; launches summed over both
    runs."""
    a, b = res["float32"], res["float64"]
    out = []
    for name, src, line in (("lin_solve", "stam2d_lin_solve.cu", 59),
                            ("advect", "stam2d_advect.cu", 118)):
        out.append({
            "name": f"stam2d_{name}", "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/{src}",
            "replaces": f"fluidsims_tpu/kernels/stam2d_pallas.py:{line}",
            "launches": a["launches"][name] + b["launches"][name],
            "max_abs_err": errs[name],
            "ms": a["times"][name], "plain_ms": a["times"][name + "_plain"],
            "bound_ms": a["bounds"][name][0], "bound_by": a["bounds"][name][1],
            "library_ms": None,
            "launches_f32": a["launches"][name],
            "launches_f64": b["launches"][name],
            "ms_f64": b["times"][name],
            "plain_ms_f64": b["times"][name + "_plain"],
            "bound_ms_f64": b["bounds"][name][0],
            "bound_by_f64": b["bounds"][name][1]})
    out[0]["tiling"] = design["lin_solve"]
    adv = out[-1]
    for k, r in (("f32", a), ("f64", b)):
        adv[f"ms_density_{k}"] = r["times"]["advect1"]
        adv[f"plain_ms_density_{k}"] = r["times"]["advect1_plain"]
        adv[f"bound_ms_density_{k}"] = r["bounds"]["advect1"][0]
    adv["max_rel_err"] = errs["rel"]
    return out


# --------------------------------- FLIP/APIC --------------------------------
#
# Three kernels (TPU kernels #16-#18), kernels/flip_cuda.py; `fk` below is
# the wrapper module, `fa` the solver.

# flip_p2g.cu: per particle the scaled coordinates and floors (4) and per
# row of offsets gy - j, the hat weight and ry (6, 3 rows); per offset gx -
# i, the hat weight and wt (5, 9 offsets); per offset of nonzero weight rx
# (2), the two APIC velocities (10), the two momenta (2) and three atomic
# adds (3).  The nonzero offsets are counted from this run's particles.
FLIP_P2G_OPS = (4 + 3 * 6, 5, 17)
# flip_grid.cu: per cell the normalize, gravity and clamps (5); per
# interior cell the divergence (4), each Jacobi sweep (5) and the
# projection of both components (8).
FLIP_GRID_OPS = (5, 4, 5, 8)
# flip_g2p.cu per particle: six two-field samples (30 each: the scaled,
# clipped coordinates, floors, fractions, 9 per field blend), the +-h
# coordinates (4), the FLIP/PIC blend (10), the affine terms (12), the
# advection (4), the walls (10), the raster index (2) and its atomic add.
FLIP_G2P_OPS_PER_PARTICLE = 6 * 30 + 4 + 10 + 12 + 4 + 10 + 2 + 1
# 5 cuda steps against 5 scatter steps: the atomics' order reaches every
# field through the grid, so the trajectories agree to rounding carried
# through 5 steps, not bitwise; f32 at the port's f32 bar against JAX.
FLIP_TRAJ_TOL = {torch.float32: 5e-4, torch.float64: 1e-10}
# (particles, grid, dtype, steps, plain steps): FlipApicConfig() (bench.py's
# flip_65536_mpsps, the CLI default) in f32 and f64, and 2^20 particles on
# 512^2 (4 a cell as at the default; the 64 MiB particle state is past L2)
FLIP_RUNS = ((65536, 128, "float32", 1000, 20),
             (65536, 128, "float64", 200, 20),
             (1 << 20, 512, "float32", 200, 20))


def flip_particles(n_p, dtype, device, seed):
    """Seeded (pos, vel, affine_x, affine_y): positions uniform in [0,
    1]^2 with the first eight on the walls, corners and the walls of the
    advection's clip, velocities and affine matrices standard normal."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_p, 2))
    pos[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.01, 0.99], [0.99, 0.01],
               [0.5, 0], [1, 0.5]]
    return [torch.tensor(a, dtype=dtype, device=device) for a in
            (pos, *(rng.standard_normal((n_p, 2)) for _ in range(3)))]


def transfer_rel(got, ref, what: str, tol: float, errs: dict, name: str,
                 bitwise: bool = False):
    """max |err| / max |ref| of each float pair within tol, and every pair
    equal where `bitwise`; each int32 pair (FLIP's raster) equal;
    errs[name] keeps the largest max |err|.  `what` names the solver and
    the case.  Returns (max rel err, all bitwise equal)."""
    worst, bit = 0.0, True
    for g, r in zip(got, ref):
        if g.dtype == torch.int32:
            if not torch.equal(g, r):
                raise AssertionError(
                    f"{what} {name}: {int((g != r).sum())} raster cells "
                    f"differ from the plain version's")
            continue
        rel, ab = rel_err(g, r)
        errs[name] = max(errs[name], ab)
        worst = max(worst, rel)
        bit = bit and same(g, r)
    if not worst <= tol or (bitwise and not bit):
        raise AssertionError(f"{what} {name}: max rel err {worst:.3e} (tol "
                             f"{tol:g}), bitwise {bit} (required {bitwise})")
    return worst, bit


# The P2G's two designs (kernels/_common.py P2G_DESIGNS): the wrappers take
# the tiled one from FST_P2G_TILED_FROM particles (csrc/p2g_tiles.cuh); their
# private `_p2g` forces one.
P2G_DESIGNS = ("atomic", "tiled")


def check_p2g_designs(kmod, cfg, parts, ref, label, tol, errs,
                      **kw) -> dict:
    """Each P2G design on `parts` against the plain version's grids `ref`,
    within tol relative to each grid's max: {"p2g_<design>": (rel,
    bitwise)}."""
    return {f"p2g_{d}": transfer_rel(kmod._p2g(cfg, *parts, **kw, design=d),
                                     ref, f"{label} {d}", tol, errs, "p2g")
            for d in P2G_DESIGNS}


def check_flip_call(fk, cfg, parts, what, errs, flip=None, apic=None):
    """The three kernels against their plain versions: P2G on the
    particles (the design the wrapper picks, and each design); the grid
    phase on the kernel's P2G grids; G2P on the kernel's grid-phase fields;
    each within STEP_TOL relative, the raster equal.  Returns {kernel:
    (rel, bitwise)} and the kernel's grids."""
    pos, vel, ax, ay = parts
    tol = STEP_TOL[pos.dtype]
    label = f"flip {what}"
    out = {}
    grids = fk.p2g(cfg, pos, vel, ax, ay, apic)
    plain = fk.p2g_plain(cfg, pos, vel, ax, ay, apic)
    out["p2g"] = transfer_rel(grids, plain, label, tol, errs, "p2g")
    out.update(check_p2g_designs(fk, cfg, parts, plain, label, tol, errs,
                                 apic=apic))
    fields = fk.grid_phase(cfg, *grids)
    plain = fk.grid_phase_plain(cfg, *grids)
    out["grid"] = transfer_rel(fields, plain, label, tol, errs, "grid",
                               bitwise=True)
    if not all(bits_equal(a, b) for a, b in zip(fields, plain)):
        raise AssertionError(f"{label} grid: equal values, other bits (the "
                             f"sign of a zero)")
    check_flip_syncs(fk, cfg, pos.device, label)
    out["g2p"] = check_g2p_call(fk, cfg, pos, vel, fields, flip, label,
                                errs)
    return out, grids


def check_g2p_call(fk, cfg, pos, vel, fields, flip, label, errs,
                   bitwise=False):
    """G2P against its plain version on the same grid-phase fields: within
    STEP_TOL relative, the raster equal and counting every particle, the
    same bits where `bitwise`; the case and whether its bits were equal
    counted in errs["g2p_bitwise"].  Returns (rel, bitwise)."""
    got = fk.g2p(cfg, pos, vel, *fields, flip)
    ref = fk.g2p_plain(cfg, pos, vel, *fields, flip)
    rel, _ = transfer_rel(got, ref, label, STEP_TOL[pos.dtype], errs, "g2p")
    bit = all(bits_equal(a, b) for a, b in zip(got, ref))
    if bitwise and not bit:
        raise AssertionError(f"{label} g2p: equal values, other bits")
    if int(got[4].sum()) != pos.shape[0]:
        raise AssertionError(f"{label} g2p: the raster counts "
                             f"{int(got[4].sum())} of {pos.shape[0]}")
    errs["g2p_bitwise"][0] += bit
    errs["g2p_bitwise"][1] += 1
    return rel, bit


def g2p_positions(kind: str, n: int, n_p: int, rng) -> np.ndarray:
    """G2P positions of n_p particles on an (n, n) grid, the one generator
    of phase 19, tools/tune_tiles_torch.py check and the CPU tests:
    "uniform"; exactly on nodes ("nodes"); +-h across nodes ("crossing":
    node +- h (1 + eps), where rounding puts some floors of the +-h
    samples two nodes from the centre's, past the kernel's window); on and
    past the walls ("walls": 16 corner, wall and far-out points, then half
    the particles on or one node past a wall in x); 2,000 in one cell
    ("crowded", the raster's grouped adds; one cell up to n = 2048)."""
    h = 1.0 / (n - 1)
    if kind == "uniform":
        return rng.random((n_p, 2))
    nodes = rng.integers(0, n, (n_p, 2)) * h
    if kind == "nodes":
        return nodes
    if kind == "crossing":
        eps = rng.choice([-3e-7, -1e-7, 0.0, 1e-7, 3e-7, -1e-15, 1e-15],
                         (n_p, 2))
        return nodes + rng.choice([-1, 1], (n_p, 2)) * h * (1 + eps)
    pos = rng.random((n_p, 2))
    if kind == "walls":
        pos[:16] = [[0, 0], [1, 1], [0, 1], [1, 0], [-0.1, 0.5], [1.2, 0.5],
                    [0.5, -3], [0.5, 7], [h, h], [1 - h, 1 - h],
                    [0.5 * h, 1 - 0.5 * h], [1e-30, 1 - 1e-7], [0.01, 0.99],
                    [0.99, 0.01], [-1e9, 1e9], [1 + h, -h]]
        pos[16:n_p // 2, 0] = rng.choice([0.0, 1.0, -h, 1 + h], n_p // 2 - 16)
    elif kind == "crowded":
        pos[:2000] = [0.3, 0.4] + 1e-4 * rng.random((2000, 2))
    else:
        raise ValueError(f"no G2P position kind {kind!r}")
    return pos


# Phase 19's G2P cases beside check_flip_call's (also tools/
# tune_tiles_torch.py check's): (n, position kind), each with 4 n^2
# particles, seeded grids, the config's blend and flip 0.5
G2P_CHECK = ((16, "walls"), (37, "nodes"), (37, "crossing"), (37, "walls"),
             (128, "nodes"), (128, "crossing"), (128, "walls"),
             (128, "crowded"), (512, "crossing"), (512, "walls"),
             (2048, "uniform"))


def check_g2p_cases(fk, fa, device, errs) -> None:
    """G2P_CHECK's cases, each bitwise equal to the plain version or the
    script fails."""
    for dtype in ("float32", "float64"):
        for n, kind in G2P_CHECK:
            cfg = fa.FlipApicConfig(particles=4 * n * n, grid=n, dtype=dtype)
            rng = np.random.default_rng(SEED + 5 * n)
            pos = g2p_positions(kind, n, cfg.particles, rng)
            t = [torch.tensor(a, dtype=cfg.torch_dtype, device=device)
                 for a in (pos, rng.standard_normal((cfg.particles, 2)),
                           *(rng.standard_normal((n, n)) for _ in range(4)))]
            for flip in (None, 0.5):
                check_g2p_call(fk, cfg, t[0], t[1], t[2:], flip,
                               f"flip n={n} {kind} {dtype} flip={flip}",
                               errs, bitwise=True)
    log(f"[flip] g2p {G2P_CHECK}, f32 and f64, the config's blend and flip "
        f"0.5: bitwise equal to the plain version, every raster counting "
        f"its particles; G2P bitwise in {errs['g2p_bitwise'][0]} of "
        f"{errs['g2p_bitwise'][1]} cases of phase 19 so far")


def edge_positions(rng, n_p: int, X: float, Y: float, crowd: int):
    """Seeded positions over [0, 0.5 X] x [0, Y] (tiles right of the bulk
    empty), `crowd` of them in one cell, and twelve on and past the walls
    and corners (MPM drops their out-of-grid targets, FLIP clips them)."""
    pos = rng.random((n_p, 2)) * [0.5 * X, Y]
    pos[12:12 + crowd] = ([0.3 * X, 0.4 * Y]
                          + 1e-3 * X * rng.random((crowd, 2)))
    pos[:12] = [[0, 0], [X, Y], [0, Y], [X, 0], [-0.02 * X, 0.5 * Y],
                [1.03 * X, 0.5 * Y], [0.5 * X, -0.05 * Y],
                [0.3 * X, 1.1 * Y], [-X, -Y], [5 * X, 5 * Y],
                [0.999 * X, 0.001 * Y], [0.001 * X, 0.999 * Y]]
    return pos


def check_p2g_edges(kmod, cfg, n_p, parts, label, errs) -> dict:
    """Both P2G designs on particles with one cell crowded past the tiled
    design's chunk and twelve on and past the walls, against the plain
    version within STEP_TOL; the tiled launch's stats (a tile past a chunk,
    its grid syncs as the query says).  Returns the stats."""
    dt = parts[0].dtype
    ref = kmod.p2g_plain(cfg, *parts)
    rels = check_p2g_designs(kmod, cfg, parts, ref, label, STEP_TOL[dt],
                             errs)
    size = (cfg.gx, cfg.gy) if hasattr(cfg, "gx") else (cfg.grid,)
    launch = kmod.p2g_launch(n_p, *size, dt, parts[0].device.index, "tiled")
    stats = kmod.p2g_stats(cfg, n_p, dt, parts[0].device, "tiled")
    if (stats["most_in_tile"] <= launch.chunk
            or stats["grid_syncs"] != launch.grid_syncs):
        raise AssertionError(f"{label}: tiled launch {stats}, chunk "
                             f"{launch.chunk}, grid syncs "
                             f"{launch.grid_syncs}")
    log(f"[p2g] {label}: a cell crowded past the chunk, twelve particles "
        f"on and past the walls, tiles left empty: (rel err, bitwise) "
        f"{rels} (tol {STEP_TOL[dt]:g}); tiled launch {stats}")
    return {"rel": {k: v[0] for k, v in rels.items()}, **stats}


def check_p2g_scratch_shapes(kmod, case, sizes, n_p, label, errs) -> dict:
    """Two tiled P2G launch shapes whose scratch has one size (the second
    grid's particles found near n_p by the grid query), launched A, B, A
    on one stream, each against the plain version within STEP_TOL: a
    launch leaves its tile counts at 0 for the next one on its scratch,
    and the two shapes lay their scratch out differently, so they must not
    share it.  `case(particles, size)` gives (cfg, parts).  Returns each
    launch's particles, grid, scratch words and rel err."""
    cfg, parts = case(n_p, sizes[0])
    dt, dev = parts[0].dtype, parts[0].device

    def words(m, size):
        return kmod.p2g_launch(m, *size, dt, dev.index, "tiled").scratch_ints

    want = words(n_p, sizes[0])
    n_b = next((m for m in range(n_p - 512, n_p + 512)
                if words(m, sizes[1]) == want), None)
    if n_b is None:
        raise AssertionError(f"{label}: no particle count on {sizes[1]} "
                             f"near {n_p} takes {want} scratch words")
    shapes = [(n_p, sizes[0]), (n_b, sizes[1]), (n_p, sizes[0])]
    out = []
    for m, size in shapes:
        cfg, parts = case(m, size)
        rel = transfer_rel(kmod._p2g(cfg, *parts, design="tiled"),
                           kmod.p2g_plain(cfg, *parts),
                           f"{label} {m} on {size}", STEP_TOL[dt], errs,
                           "p2g")[0]
        out.append({"particles": m, "grid": list(size), "rel": rel,
                    "scratch_ints": words(m, size)})
    log(f"[p2g] {label}: tiled launches of two shapes with {want} scratch "
        f"words each, back to back on one stream: {out} (tol "
        f"{STEP_TOL[dt]:g})")
    return {"shapes": out}


def p2g_shared_tiles() -> int:
    """kP2GSharedTiles of csrc/p2g_tiles.cuh: past this many tiles a tiled
    P2G launch counts its particles a tile by global adds, not in shared
    memory."""
    from fluidsims_tpu_torch.kernels import _build
    src = (_build.CSRC / "p2g_tiles.cuh").read_text()
    found = re.search(r"constexpr int kP2GSharedTiles = (\d+);", src)
    if found is None:
        raise AssertionError("kP2GSharedTiles not found in p2g_tiles.cuh")
    return int(found.group(1))


def check_p2g_many_tiles(kmod, case, size, n_p, label, errs) -> dict:
    """The tiled P2G on a grid of more tiles than kP2GSharedTiles (phase
    1's count by global adds) against the plain version within STEP_TOL,
    with the grid syncs the query says.  Returns the tiles and rel err."""
    cfg, parts = case(n_p, size)
    dt, dev = parts[0].dtype, parts[0].device
    launch = kmod.p2g_launch(n_p, *size, dt, dev.index, "tiled")
    tiles = (-(-(size[0] + 2) // launch.tile_x)
             * -(-(size[-1] + 2) // launch.tile_y))
    if tiles <= p2g_shared_tiles():
        raise AssertionError(f"{label}: {tiles} tiles, not past "
                             f"{p2g_shared_tiles()}")
    rel = transfer_rel(kmod._p2g(cfg, *parts, design="tiled"),
                       kmod.p2g_plain(cfg, *parts), label, STEP_TOL[dt],
                       errs, "p2g")[0]
    stats = kmod.p2g_stats(cfg, n_p, dt, dev, "tiled")
    if stats["grid_syncs"] != launch.grid_syncs:
        raise AssertionError(f"{label}: tiled launch {stats}, grid syncs "
                             f"{launch.grid_syncs}")
    log(f"[p2g] {label}: {tiles} tiles (counted by global adds past "
        f"{p2g_shared_tiles()}): rel err {rel:.3e} (tol {STEP_TOL[dt]:g}); "
        f"tiled launch {stats}")
    return {"tiles": tiles, "rel": rel, **stats}


def check_flip_syncs(fk, cfg, device, what: str) -> int:
    """The grid syncs of the grid phase just launched at cfg's grid and
    dtype, as the kernel counted them: max(ceil(jacobi / h), 1) - 1 for h
    sweeps a sync (the grid query's halo), or the script fails."""
    h = fk.grid_launch(cfg.grid, cfg.torch_dtype, device.index).halo
    got = fk.grid_syncs(cfg.grid, cfg.torch_dtype, device)
    want = max(-(-cfg.jacobi // h), 1) - 1
    if got != want:
        raise AssertionError(f"{what}: jacobi {cfg.jacobi}, {h} sweeps a "
                             f"sync: the grid phase made {got} grid syncs, "
                             f"want {want}")
    return got


# (n, jacobi) of phase 19's grid-phase cases
FLIP_CHECK_N = (128, 37, 512, 16)
FLIP_CHECK_JACOBI = (48, 7, 1, 0)


def phase_flip_kernels(fk, fa, device) -> dict:
    errs = {"p2g": 0.0, "grid": 0.0, "g2p": 0.0, "rel": {},
            "grid_bitwise": [0, 0], "g2p_bitwise": [0, 0], "edges": {}}
    check_g2p_cases(fk, fa, device, errs)
    for dtype in ("float32", "float64"):
        for n in FLIP_CHECK_N:
            cfg = fa.FlipApicConfig(particles=4 * n * n, grid=n, dtype=dtype)
            parts = flip_particles(cfg.particles, cfg.torch_dtype, device,
                                   SEED + n)
            key = f"n={n} {dtype}"
            cases = [check_flip_call(fk, cfg.replace(jacobi=jac), parts,
                                     key, errs, flip, apic)[0]
                     for jac in FLIP_CHECK_JACOBI
                     for flip, apic in ((None, None), (0.5, 0.3))]
            worst = {k: max(c[k][0] for c in cases) for k in cases[0]}
            bits = {k: sum(c[k][1] for c in cases) for k in cases[0]}
            errs["rel"][key] = worst
            errs["grid_bitwise"][0] += bits["grid"]
            errs["grid_bitwise"][1] += len(cases)
            log(f"[flip] {key}, {cfg.particles} particles (8 on the walls), "
                f"jacobi {FLIP_CHECK_JACOBI}, blend (config) and (flip 0.5, "
                f"apic 0.3): kernels vs plain max rel err {worst} (tol "
                f"{STEP_TOL[cfg.torch_dtype]:g}; the grid phase bitwise); "
                f"bitwise cases of {len(cases)}: {bits}; grid phase "
                f"{fk.grid_launch(n, cfg.torch_dtype, device.index).asdict()}")
        for n in (128, 37):
            cfg = fa.FlipApicConfig(particles=4 * n * n, grid=n, dtype=dtype)
            chunk = fk.p2g_launch(cfg.particles, n, cfg.torch_dtype,
                                  device.index, "tiled").chunk
            rng = np.random.default_rng(SEED + 3 * n)
            pos = edge_positions(rng, cfg.particles, 1.0, 1.0, 3 * chunk)
            parts = [torch.tensor(a, dtype=cfg.torch_dtype, device=device)
                     for a in (pos, *(rng.standard_normal(
                         (cfg.particles, 2)) for _ in range(3)))]
            errs["edges"][f"n={n} {dtype}"] = check_p2g_edges(
                fk, cfg, cfg.particles, parts, f"flip p2g n={n} {dtype}",
                errs)

        def case(m, size, dtype=dtype):
            cfg = fa.FlipApicConfig(particles=m, grid=size[0], dtype=dtype)
            return cfg, flip_particles(m, cfg.torch_dtype, device, SEED + m)

        errs["edges"][f"scratch {dtype}"] = check_p2g_scratch_shapes(
            fk, case, ((30,), (46,)), 10007, f"flip p2g {dtype}", errs)
        errs["edges"][f"n=2048 {dtype}"] = check_p2g_many_tiles(
            fk, case, (2048,), 300000, f"flip p2g n=2048 {dtype}", errs)
    for dtype in ("float32", "float64"):
        cfg = fa.FlipApicConfig(dtype=dtype)
        if fa.resolve_engine(cfg, device) != "cuda":
            raise AssertionError("engine auto did not resolve to cuda")
        a = b = fa.init(cfg, device)
        pcfg = cfg.replace(engine="scatter")
        for _ in range(5):
            a, b = fa.step(cfg, a), fa.step(pcfg, b)
        rel = max(rel_err(x, y)[0] for x, y in zip(a[:4], b[:4]))
        tol = FLIP_TRAJ_TOL[cfg.torch_dtype]
        if not rel <= tol:
            raise AssertionError(f"flip 5 steps cuda vs scatter {dtype}: max "
                                 f"rel err {rel:.3e} > {tol:g}")
        # The kernel's raster is exactly the plain raster of its own
        # positions, and the scatter engine's where the positions agree.
        own = fa._raster(cfg.grid, a.pos[:, 0], a.pos[:, 1])
        if not torch.equal(a.density, own):
            raise AssertionError(
                f"flip 5 cuda steps {dtype}: {int((a.density != own).sum())} "
                f"raster cells differ from the raster of the cuda positions")
        cells = int((a.density != b.density).sum())
        if same(a.pos, b.pos) and cells:
            raise AssertionError(f"flip 5 steps {dtype}: equal positions, "
                                 f"{cells} raster cells differ")
        log(f"[flip] 5 steps n=128 {dtype}, cuda engine vs scatter engine: "
            f"max rel err {rel:.3e} over pos, vel, affine_x, affine_y (tol "
            f"{tol:g}); raster equal to the plain raster of the cuda "
            f"positions; positions bitwise {same(a.pos, b.pos)}, {cells} "
            f"raster cells differ from the scatter engine's")
        errs["rel"][f"5 steps n=128 {dtype}"] = rel
    return errs


def flip_nonzero_offsets(cfg, pos) -> int:
    """(particle, offset) pairs of nonzero hat weight: the P2G's atomic
    transfers for these positions."""
    n = cfg.grid
    g = pos * (n - 1)
    base = torch.floor(g).long()
    w = []
    for axis in (0, 1):
        w.append(torch.stack([
            (1 - (g[:, axis] - (base[:, axis] + o).clamp(0, n - 1)).abs())
            .clamp_min(0) for o in (-1, 0, 1)], 1))
    return int(((w[1][:, :, None] * w[0][:, None, :]) > 0).sum())


def flip_bounds(cfg, pos) -> dict:
    """bound_ms of the three kernels at cfg's shape: P2G reads the four
    particle fields and writes three grids; the grid phase reads three
    grids and writes four, its operations for cfg.jacobi sweeps; G2P reads
    pos, vel and the four grids and writes four particle fields and the
    int32 raster."""
    n, n_p, dtype = cfg.grid, cfg.particles, cfg.torch_dtype
    T = torch.finfo(dtype).bits // 8
    cells, inner = n * n, (n - 2) ** 2
    p0, p1, p2 = FLIP_P2G_OPS
    g0, g1, g2, g3 = FLIP_GRID_OPS
    nz = flip_nonzero_offsets(cfg, pos)
    return {
        "p2g": bound(8 * n_p * T + 3 * cells * T,
                     p0 * n_p + p1 * 9 * n_p + p2 * nz, dtype),
        "grid": bound(7 * cells * T,
                      g0 * cells + (g1 + g2 * cfg.jacobi + g3) * inner,
                      dtype),
        "g2p": bound(12 * n_p * T + 4 * cells * T + 4 * cells,
                     FLIP_G2P_OPS_PER_PARTICLE * n_p, dtype),
        "nonzero_offsets": nz}


def flip_weight_sum(fa, cfg, pos) -> float:
    """The sum over particles of their hat weights wt > 0 over the 9
    clipped targets, in float64: the P2G mass grid's sum (the particle
    count where no particle is within a cell of a wall)."""
    n = cfg.grid
    g = pos.double() * (n - 1)
    base = torch.floor(g).long()
    w = [torch.stack([fa._w1(g[:, a] - (base[:, a] + o).clamp(0, n - 1))
                      for o in (-1, 0, 1)], 1) for a in (0, 1)]
    wt = w[1][:, :, None] * w[0][:, None, :]
    return float(wt[wt > 0].sum())


def check_flip_fold(fk, fa, cfg, out) -> dict:
    """The kernel's P2G mass grid on the final state sums (in float64) to
    the particles' hat weights, within STEP_TOL; their count beside it."""
    mass = fk.p2g(cfg, out.pos, out.vel, out.affine_x, out.affine_y)[0]
    total = float(mass.double().sum())
    want = flip_weight_sum(fa, cfg, out.pos)
    tol = STEP_TOL[cfg.torch_dtype]
    if not abs(total - want) <= tol * want:
        raise AssertionError(f"flip fold: P2G mass {total}, weights {want}")
    log(f"[physics] flip {cfg.particles} on {cfg.grid}^2 {cfg.dtype}: P2G "
        f"mass sum {total!r}, the hat weights' {want!r} (rel "
        f"{abs(total - want) / want:.3e}, tol {tol:g}), particles "
        f"{cfg.particles}")
    return {"mass_sum": total, "weights": want,
            "rel": abs(total - want) / want}


def check_flip_physics(fa, cfg, st0, out) -> dict:
    """Finite; positions within the walls' clip; the raster equal to the
    plain raster of the final positions (every particle in it once); the
    blob lower than at the start; max |v| < 50; overflow_count 0."""
    for name in ("pos", "vel", "affine_x", "affine_y"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"flip: non-finite {name}")
    lo = torch.tensor(0.01, dtype=out.pos.dtype)
    hi = torch.tensor(0.99, dtype=out.pos.dtype)
    pmin, pmax = float(out.pos.min()), float(out.pos.max())
    if not (pmin >= float(lo) and pmax <= float(hi)):
        raise AssertionError(f"flip: positions in [{pmin}, {pmax}]")
    own = fa._raster(cfg.grid, out.pos[:, 0], out.pos[:, 1])
    if not torch.equal(out.density, own):
        raise AssertionError(f"flip: {int((out.density != own).sum())} raster "
                             "cells differ from the raster of the positions")
    count = int(out.density.sum())
    y0, y1 = float(st0.pos[:, 1].mean()), float(out.pos[:, 1].mean())
    vmax = float(out.vel.abs().max())
    over = int(fa.overflow_count(cfg, out))
    if count != cfg.particles or not y1 < y0 or not vmax < 50.0 or over:
        raise AssertionError(f"flip physics: raster {count} of "
                             f"{cfg.particles}, mean y {y0} -> {y1}, max |v| "
                             f"{vmax}, overflow {over}")
    occupied = int((out.density > 0).sum())
    log(f"[physics] flip {cfg.particles} on {cfg.grid}^2 {cfg.dtype}: all "
        f"finite, pos in [{pmin:.6g}, {pmax:.6g}], raster equal to the "
        f"plain raster of the positions, raster sum {count}, mean "
        f"y {y0:.6f} -> {y1:.6f}, max |v| {vmax:.4f}, overflow_count 0, "
        f"occupied {occupied}, peak_cell {int(out.density.max())}")
    return {"mean_y": [y0, y1], "max_abs_v": vmax, "occupied": occupied}


def phase_flip_main(fk, fa, device, smi, errs, runs=FLIP_RUNS) -> dict:
    res = {}
    for n_p, n, dtype, steps, p_steps in runs:
        cfg = fa.FlipApicConfig(particles=n_p, grid=n, dtype=dtype)
        engine = fa.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"engine auto resolved to {engine!r}")
        st0 = fa.init(cfg, device)
        fa.run(cfg, st0, 1)   # warm-up, not counted
        fk.reset_launches()
        out, wall = run_timed(fa, cfg, st0, steps)
        launches = dict(fk.LAUNCHES)
        want = {"p2g": steps, "grid": steps, "g2p": steps}
        if launches != want:
            raise AssertionError(f"launches {launches} in {steps} steps, "
                                 f"want {want}")
        _, p_wall = run_timed(fa, cfg.replace(engine="scatter"), st0, p_steps)
        if dict(fk.LAUNCHES) != launches:
            raise AssertionError("the plain engine launched a kernel")
        rate, p_rate = steps / wall, p_steps / p_wall
        key = f"{n_p} {n}^2 {dtype}"
        log(f"[flip] {key} engine={engine} on {smi}: {steps} steps in "
            f"{wall:.3f} s, {rate:.2f} steps/s, {n_p * rate / 1e6:.3f} M "
            f"particle-steps/s; plain scatter engine {p_steps} steps "
            f"{p_rate:.2f} steps/s ({n_p * p_rate / 1e6:.3f} M); launches "
            f"{launches}; the grid phase's launch "
            f"{fk.grid_launch(n, cfg.torch_dtype, device.index).asdict()}")
        phys = check_flip_physics(fa, cfg, st0, out)
        phys["fold"] = check_flip_fold(fk, fa, cfg, out)

        # the kernels against their plain versions from the final state
        parts = (out.pos, out.vel, out.affine_x, out.affine_y)
        checks, grids = check_flip_call(fk, cfg, parts, key + " final state",
                                        errs)
        errs["grid_bitwise"][0] += checks["grid"][1]
        errs["grid_bitwise"][1] += 1
        errs["rel"][key + " final state"] = {k: v[0]
                                             for k, v in checks.items()}
        log(f"[flip] {key} final state: kernels vs plain (rel err, "
            f"bitwise) {checks}")

        fields = fk.grid_phase(cfg, *grids)
        times = {
            "p2g": time_launches(lambda: fk.p2g(cfg, *parts), 100),
            **p2g_device_times(fk, cfg, parts),
            "p2g_plain": time_launches(lambda: fk.p2g_plain(cfg, *parts), 5),
            "grid": time_launches(lambda: fk.grid_phase(cfg, *grids), 50),
            "grid_plain": time_launches(
                lambda: fk.grid_phase_plain(cfg, *grids), 3),
            "g2p": time_launches(lambda: fk.g2p(cfg, out.pos, out.vel,
                                                *fields), 100),
            "g2p_device": device_ms(lambda: fk.g2p(cfg, out.pos, out.vel,
                                                   *fields), 100,
                                    "::g2p_kernel"),
            "g2p_plain": time_launches(lambda: fk.g2p_plain(
                cfg, out.pos, out.vel, *fields), 5),
        }
        bounds = flip_bounds(cfg, out.pos)
        log(f"[flip] per launch at {key} on {smi}: " + ", ".join(
            f"{k} {times[k]:.4f} ms vs plain {times[k + '_plain']:.4f} ms "
            f"(bound {bounds[k][0]:.5f} ms, {bounds[k][1]})"
            for k in ("p2g", "grid", "g2p"))
            + f"; {bounds['nonzero_offsets']} nonzero P2G offsets; "
            + p2g_device_line(times)
            + f"; G2P {times['g2p_device']} ms of device time, launch "
            f"{fk.g2p_launch(n_p, cfg.torch_dtype).asdict()}")
        res[key] = {"launches": launches, "times": times, "bounds": bounds,
                    "rate": rate, "plain_rate": p_rate,
                    "mpsteps": n_p * rate / 1e6,
                    "plain_mpsteps": n_p * p_rate / 1e6, "physics": phys}
    return res


def p2g_device_times(kmod, cfg, parts) -> dict:
    """The P2G's device time a call by torch.profiler on `parts`: the
    design the wrapper picks, and each design."""
    out = {"p2g_device": device_ms(lambda: kmod.p2g(cfg, *parts), 100,
                                   "p2g")}
    for d in P2G_DESIGNS:
        out[f"p2g_device_{d}"] = device_ms(
            lambda: kmod._p2g(cfg, *parts, design=d), 100, "p2g")
    return out


def p2g_tiling(kmod, kind: str, runs, build, device) -> dict:
    """The P2G's launch at each main run's particles, grid and dtype as
    this run's library reports it (the design the wrapper picks, and the
    tiled design: blocks, threads, tile, chunk, shared memory, grid syncs,
    scratch), and ptxas's report of both designs' kernels."""
    out = {"ptxas": [u for u in build.ptxas_usage("p2g_")
                     if kind in u["kernel"]]}
    for n_p, n, dtype, _, _ in runs:
        size = (n, n) if kind == "MPMParticles" else (n,)
        dt = getattr(torch, dtype)
        out[f"{n_p} {n}^2 {dtype}"] = {
            d or "picked": kmod.p2g_launch(n_p, *size, dt, device.index,
                                           d).asdict()
            for d in (None, "tiled")}
    log(f"[build] {kind} p2g tiling: {out}")
    return out


def flip_tiling(fk, fa, build, device) -> dict:
    """The grid phase's tiling at each FLIP run's grid and dtype, as this
    run's library reports it (blocks, threads a block, tile, halo = sweeps
    a grid sync, dynamic shared memory), the grid syncs of one launch at
    the config's 48 sweeps as the kernel counted them (held to
    max(ceil(48 / h), 1) - 1), and ptxas's report of the kernel."""
    out = {"ptxas": build.ptxas_usage("11grid_kernel")}
    for n_p, n, dtype, _, _ in FLIP_RUNS:
        cfg = fa.FlipApicConfig(particles=n_p, grid=n, dtype=dtype)
        grids = [torch.zeros((n, n), dtype=cfg.torch_dtype, device=device)
                 for _ in range(3)]
        fk.grid_phase(cfg, *grids)
        syncs = check_flip_syncs(fk, cfg, device, f"flip {n}^2 {dtype}")
        out[f"{n}^2 {dtype}"] = {
            **fk.grid_launch(n, cfg.torch_dtype, device.index).asdict(),
            "grid_syncs_per_launch": syncs}
    log(f"[build] flip grid phase tiling: {out}")
    return out


def p2g_device_line(times: dict) -> str:
    """The P2G's device times beside its events time, for a log line."""
    return (f"P2G {times['p2g']:.4f} ms by events, "
            f"{ms_text(times['p2g_device'])} of device time (atomic design "
            f"{ms_text(times['p2g_device_atomic'])}, tiled "
            f"{ms_text(times['p2g_device_tiled'])})")


def transfer_kernel_lines(solver: str, runs, lines: dict, res, errs,
                          fused=None) -> list:
    """The {"kernels": [...]} entries of a particle solver's kernels
    (csrc/{solver}_{kernel}.cu), one for each TPU kernel of `lines`, which
    gives its line in fluidsims_tpu/kernels/{solver}_pallas.py: times and
    bounds from the final state of its first run (f32 at the default
    size), those of the f64 and 2^20 runs beside them; launches summed
    over the three runs.  `fused` maps a TPU kernel to the port's kernel
    that does its work in the same launch: its entry carries that
    kernel's source, launches, times and bound."""
    fused = fused or {}
    keys = [f"{n_p} {n}^2 {dtype}" for n_p, n, dtype, _, _ in runs]
    a = res[keys[0]]
    out = []
    for tpu, line in lines.items():
        name = fused.get(tpu, tpu)
        entry = {
            "name": f"{solver}_{tpu}", "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/{solver}_{name}.cu",
            "replaces": f"fluidsims_tpu/kernels/{solver}_pallas.py:{line}",
            "launches": sum(res[k]["launches"][name] for k in keys),
            "max_abs_err": errs[name],
            "ms": a["times"][name], "plain_ms": a["times"][name + "_plain"],
            "bound_ms": a["bounds"][name][0], "bound_by": a["bounds"][name][1],
            "library_ms": None}
        if name != tpu:
            entry["fused_into"] = f"{solver}_{name}"
        if name == "p2g":
            entry.update({f"ms_{k.removeprefix('p2g_')}": a["times"][k]
                          for k in a["times"] if k.startswith("p2g_device")})
        if name + "_device" in a["times"]:
            entry["device_ms"] = a["times"][name + "_device"]
        for k, tag in zip(keys[1:], ("f64", "1048576")):
            r = res[k]
            entry.update({f"launches_{tag}": r["launches"][name],
                          f"ms_{tag}": r["times"][name],
                          f"plain_ms_{tag}": r["times"][name + "_plain"],
                          f"bound_ms_{tag}": r["bounds"][name][0],
                          f"bound_by_{tag}": r["bounds"][name][1]})
            if name == "p2g":
                entry.update({f"ms_{t.removeprefix('p2g_')}_{tag}":
                              r["times"][t] for t in r["times"]
                              if t.startswith("p2g_device")})
            if name + "_device" in r["times"]:
                entry[f"device_ms_{tag}"] = r["times"][name + "_device"]
        out.append(entry)
    out[-1]["max_rel_err"] = errs["rel"]
    return out


# Two kernels for the three TPU kernels #19-#21, kernels/mpm_cuda.py: the
# P2G (#19) and the G2P that updates each node it gathers (#20 and #21 in
# one launch); `mk` below is the wrapper module, `mp` the solver.

# mpm_p2g.cu: per particle the two base nodes and fractions (8), the two
# weight triples (18), snow's clamp of Fe (6), the stress (33: det and its
# floor, the hardening exp, mu and lambda with the material's factor, the
# log term, Fe Fe^T and the scale), the two momenta (2) and the three
# x offsets (6); per offset inside the grid w, dposy, the force (6), the
# three weighted values (5) and three atomic adds (3).  The offsets inside
# the grid are counted from this run's particles.
MPM_P2G_OPS = (8 + 18 + 6 + 33 + 2 + 6, 17)
# mpm_g2p.cu's grid update (mpm.cuh mpm_node_velocity), counted once a
# node though the kernel forms a node's velocity at each of its gathers:
# per node the mass test (1); per node with mass the floor, two
# divisions, gravity and the two sticky-band tests (8).
MPM_GRID_OPS = (1, 8)
# mpm_g2p.cu per particle: base nodes and fractions (8), weights (18), the
# x offsets (6), per offset (9) w, dposy, w g (2), v (2) and C (12), then
# Fe (6), I + dt C (6), the new F (12), oldJ and newJ (8), mud's shear (2),
# Jp (4) and the two clipped positions (8).
MPM_G2P_OPS_PER_PARTICLE = 8 + 18 + 6 + 9 * 19 + 6 + 6 + 12 + 8 + 2 + 4 + 8
# 5 cuda steps against 5 scatter steps: the atomics' order reaches every
# field through the grid, so the trajectories agree to rounding carried
# through 5 steps, not bitwise; f32 at the port's f32 bar against JAX.
MPM_TRAJ_TOL = {torch.float32: 5e-4, torch.float64: 1e-10}
MPM_MASS_TOL = 1e-5
# (particles, grid, dtype, steps, plain steps): MPMConfig() (32,768 snow
# particles on 96^2, bench.py's mpm_32768_mpsps and the CLI default) in
# f32 and f64, and 2^20 particles on 512^2 f32 (~19 a cell as at 96^2; the
# 36 MiB particle state read and written each step is past L2)
MPM_RUNS = ((32768, 96, "float32", 1000, 20),
            (32768, 96, "float64", 200, 20),
            (1 << 20, 512, "float32", 200, 20))


def mpm_particles(cfg, device, seed):
    """Seeded (pos, vel, F, Jp): positions uniform over the grid's extent
    [0, (Gx-1)dx] x [0, (Gy-1)dx], the first eight on its walls and corners
    and at the box's corner (their 3x3 targets reach past the grid),
    velocities standard normal, F = I + 0.05 N, Jp in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    n = cfg.n
    X, Y = (cfg.gx - 1) * cfg.dx, (cfg.gy - 1) * cfg.dx
    pos = rng.random((n, 2)) * [X, Y]
    pos[:8] = [[0, 0], [X, Y], [0, Y], [X, 0], [0, 0.5 * Y], [X, 0.5 * Y],
               [0.5 * X, 0], [cfg.box_x, cfg.box_y]]
    F = np.eye(2) + 0.05 * rng.standard_normal((n, 2, 2))
    return [torch.tensor(a, dtype=cfg.torch_dtype, device=device) for a in
            (pos, rng.standard_normal((n, 2)), F, rng.uniform(0.5, 1.5, n))]


def mpm_synthetic_grids(cfg, device, seed):
    """Seeded P2G-like grids: mass uniform in [0, 3) with a third of the
    nodes empty (beside particles that gather them), momenta 50 N, so
    that every sticky band holds outward and inward velocities."""
    rng = np.random.default_rng(seed)
    shape = (cfg.gy, cfg.gx)
    return [torch.tensor(a, dtype=cfg.torch_dtype, device=device) for a in (
        rng.uniform(0.0, 3.0, shape) * (rng.random(shape) > 0.33),
        50.0 * rng.standard_normal(shape), 50.0 * rng.standard_normal(shape))]


def mpm_cell_order(cfg, pos):
    """The particles' order by base cell, row by row (base clipped to one
    cell past each wall): the particles of a G2P block then gather a
    compact box of nodes, which the kernel forms in a window in shared
    memory, where particles in no order make its blocks form each node
    where a particle gathers it."""
    base = torch.floor(pos * (1.0 / cfg.dx) - 0.5).long()
    key = (base[:, 1].clamp(-1, cfg.gy) * (cfg.gx + 2)
           + base[:, 0].clamp(-1, cfg.gx))
    return torch.argsort(key, stable=True)


def check_mpm_call(mk, cfg, parts, what, errs):
    """The two kernels against their plain versions: P2G on the particles
    (the design the wrapper picks, and each design) within STEP_TOL
    relative to each grid's max; the G2P, which updates the nodes it
    gathers, bitwise equal to g2p_plain (the G2P of grid_update_plain's
    node velocities) on the kernel's P2G grids and on synthetic grids,
    for the particles in their order and sorted by base cell (both of the
    kernel's paths).  Returns {kernel: (rel, bitwise)} and the kernel's
    P2G grids."""
    pos, vel, F, Jp = parts
    tol = STEP_TOL[pos.dtype]
    label = f"mpm {what}"
    out = {}
    grids = mk.p2g(cfg, pos, vel, F, Jp)
    plain = mk.p2g_plain(cfg, pos, vel, F, Jp)
    out["p2g"] = transfer_rel(grids, plain, label, tol, errs, "p2g")
    out.update(check_p2g_designs(mk, cfg, parts, plain, label, tol, errs))
    syn = mpm_synthetic_grids(cfg, pos.device, cfg.n + cfg.gx)
    order = mpm_cell_order(cfg, pos)
    srt = [t[order].contiguous() for t in (pos, F, Jp)]
    for key, g2p_parts, g in (("g2p", (pos, F, Jp), grids),
                              ("g2p_synthetic", (pos, F, Jp), syn),
                              ("g2p_sorted", srt, grids),
                              ("g2p_sorted_synthetic", srt, syn)):
        out[key] = transfer_rel(mk.g2p(cfg, *g2p_parts, *g),
                                mk.g2p_plain(cfg, *g2p_parts, *g),
                                f"{label} ({key})", tol, errs, "g2p",
                                bitwise=True)
        errs["g2p_bitwise"][0] += out[key][1]
        errs["g2p_bitwise"][1] += 1
    return out, grids


def phase_mpm_kernels(mk, mp, device) -> dict:
    errs = {"p2g": 0.0, "g2p": 0.0, "rel": {}, "edges": {},
            "g2p_bitwise": [0, 0]}
    for dtype in ("float32", "float64"):
        for gx, gy in ((96, 96), (37, 53)):
            cfg = mp.MPMConfig(n=4 * gx * gy, gx=gx, gy=gy, dtype=dtype)
            chunk = mk.p2g_launch(cfg.n, gx, gy, cfg.torch_dtype,
                                  device.index, "tiled").chunk
            rng = np.random.default_rng(SEED + 5 * gx)
            pos = edge_positions(rng, cfg.n, (gx - 1) * cfg.dx,
                                 (gy - 1) * cfg.dx, 3 * chunk)
            F = np.eye(2) + 0.05 * rng.standard_normal((cfg.n, 2, 2))
            parts = [torch.tensor(a, dtype=cfg.torch_dtype, device=device)
                     for a in (pos, rng.standard_normal((cfg.n, 2)), F,
                               rng.uniform(0.5, 1.5, cfg.n))]
            errs["edges"][f"{gx}x{gy} {dtype}"] = check_p2g_edges(
                mk, cfg, cfg.n, parts, f"mpm p2g {gx}x{gy} {dtype}", errs)

        def case(m, size, dtype=dtype):
            cfg = mp.MPMConfig(n=m, gx=size[0], gy=size[1], dtype=dtype)
            return cfg, mpm_particles(cfg, device, SEED + m)

        errs["edges"][f"scratch {dtype}"] = check_p2g_scratch_shapes(
            mk, case, ((30, 46), (46, 46)), 10007, f"mpm p2g {dtype}", errs)
        errs["edges"][f"2048x2048 {dtype}"] = check_p2g_many_tiles(
            mk, case, (2048, 2048), 300000, f"mpm p2g 2048x2048 {dtype}",
            errs)
        for gx, gy in ((96, 96), (37, 53), (512, 512)):
            cases = []
            for material in ("mud", "snow", "sand"):
                cfg = mp.MPMConfig(n=4 * gx * gy, gx=gx, gy=gy,
                                   material=material, dtype=dtype)
                parts = mpm_particles(cfg, device, SEED + gx + gy)
                cases.append(check_mpm_call(mk, cfg, parts,
                                            f"{gx}x{gy} {material} {dtype}",
                                            errs)[0])
            key = f"{gx}x{gy} {dtype}"
            worst = {k: max(c[k][0] for c in cases) for k in cases[0]}
            bits = {k: sum(c[k][1] for c in cases) for k in cases[0]}
            errs["rel"][key] = worst
            log(f"[mpm] {key}, {4 * gx * gy} particles (8 on the walls), "
                f"mud, snow and sand: kernels vs plain max rel err {worst} "
                f"(tol {STEP_TOL[cfg.torch_dtype]:g}; the G2P with its grid "
                f"update bitwise required, on the P2G grids and on "
                f"synthetic ones); bitwise cases of {len(cases)}: {bits}")
    for dtype in ("float32", "float64"):
        cfg = mp.MPMConfig(dtype=dtype)
        if mp.resolve_engine(cfg, device) != "cuda":
            raise AssertionError("engine auto did not resolve to cuda")
        a = b = mp.init(cfg, device)
        pcfg = cfg.replace(engine="scatter")
        for _ in range(5):
            a, b = mp.step(cfg, a), mp.step(pcfg, b)
        rel = max(rel_err(x, y)[0] for x, y in zip(a, b))
        tol = MPM_TRAJ_TOL[cfg.torch_dtype]
        if not rel <= tol:
            raise AssertionError(f"mpm 5 steps cuda vs scatter {dtype}: max "
                                 f"rel err {rel:.3e} > {tol:g}")
        log(f"[mpm] 5 steps MPMConfig() {dtype}, cuda engine vs scatter "
            f"engine: max rel err {rel:.3e} over pos, vel, F, Jp (tol "
            f"{tol:g}); positions bitwise {same(a.pos, b.pos)}")
        errs["rel"][f"5 steps 96^2 {dtype}"] = rel
    return errs


def mpm_offsets_in_grid(cfg, pos) -> int:
    """(particle, offset) pairs whose target lies inside the grid: the
    P2G's atomic transfers for these positions."""
    base = torch.floor(pos * (1.0 / cfg.dx) - 0.5).long()
    counts = []
    for axis, g in ((0, cfg.gx), (1, cfg.gy)):
        t = base[:, axis:axis + 1] + torch.arange(3, device=pos.device)
        counts.append(((t >= 0) & (t < g)).sum(1))
    return int((counts[0] * counts[1]).sum())


def mpm_bounds(cfg, pos, mass) -> dict:
    """bound_ms of the two kernels at cfg's shape: P2G reads pos, vel, F
    and Jp and writes three grids; G2P reads pos, F, Jp and the three
    grids and writes pos, vel, F and Jp, its operations the G2P's a
    particle and the grid update's once a node."""
    n_p, dtype = pos.shape[0], cfg.torch_dtype
    T = torch.finfo(dtype).bits // 8
    cells = cfg.gx * cfg.gy
    nz = mpm_offsets_in_grid(cfg, pos)
    p0, p1 = MPM_P2G_OPS
    g0, g1 = MPM_GRID_OPS
    massive = int((mass > 0).sum())
    return {
        "p2g": bound(9 * n_p * T + 3 * cells * T, p0 * n_p + p1 * nz, dtype),
        "g2p": bound(16 * n_p * T + 3 * cells * T,
                     MPM_G2P_OPS_PER_PARTICLE * n_p + g0 * cells
                     + g1 * massive, dtype),
        "offsets_in_grid": nz, "nodes_with_mass": massive}


def mpm_weight_sum(mp, cfg, pos) -> float:
    """particle_mass times the sum over particles of their B-spline weights
    at the targets inside the grid, in float64: the P2G mass grid's sum."""
    Xp = pos.double() * (1.0 / cfg.dx)
    base = torch.floor(Xp - 0.5)
    frac = Xp - base
    axes = []
    for a, g in ((0, cfg.gx), (1, cfg.gy)):
        w = mp._bspline_w(frac[:, a])
        axes.append(sum(w[o] * ((base[:, a] + o >= 0)
                                & (base[:, a] + o < g)) for o in range(3)))
    return cfg.particle_mass * float((axes[0] * axes[1]).sum())


def check_mpm_physics(mk, mp, cfg, st0, out) -> dict:
    """Finite; positions within [2dx, (G-3)dx]; Jp within [0.05, 20]; the
    block lower than at the start; the P2G mass n * particle_mass (every
    target inside the grid once positions are clipped); overflow_count
    0."""
    for name in ("pos", "vel", "F", "Jp"):
        if not bool(torch.isfinite(getattr(out, name)).all()):
            raise AssertionError(f"mpm: non-finite {name}")
    dt = out.pos.dtype
    lo = torch.tensor(2.0 * cfg.dx, dtype=dt).item()
    hx = torch.tensor((cfg.gx - 3.0) * cfg.dx, dtype=dt).item()
    hy = torch.tensor((cfg.gy - 3.0) * cfg.dx, dtype=dt).item()
    pmin = float(out.pos.min())
    xmax, ymax = float(out.pos[:, 0].max()), float(out.pos[:, 1].max())
    if not (pmin >= lo and xmax <= hx and ymax <= hy):
        raise AssertionError(f"mpm: positions min {pmin}, max x {xmax}, max "
                             f"y {ymax} outside [{lo}, {hx} / {hy}]")
    jmin, jmax = float(out.Jp.min()), float(out.Jp.max())
    if not (jmin >= torch.tensor(0.05, dtype=dt).item() and jmax <= 20.0):
        raise AssertionError(f"mpm: Jp in [{jmin}, {jmax}]")
    mass = mk.p2g(cfg, out.pos, out.vel, out.F, out.Jp)[0]
    total = float(mass.double().sum())
    want = cfg.n * cfg.particle_mass
    y0, y1 = float(st0.pos[:, 1].mean()), float(out.pos[:, 1].mean())
    over = int(mp.overflow_count(cfg, out))
    vmax = float(out.vel.abs().max())
    if not abs(total - want) <= MPM_MASS_TOL * want or not y1 < y0 or over:
        raise AssertionError(f"mpm physics: P2G mass {total} of {want}, mean "
                             f"y {y0} -> {y1}, overflow {over}")
    fold = mpm_weight_sum(mp, cfg, out.pos)
    ftol = STEP_TOL[out.pos.dtype]
    if not abs(total - fold) <= ftol * fold:
        raise AssertionError(f"mpm fold: P2G mass {total}, particle_mass x "
                             f"the in-grid weights {fold}")
    log(f"[physics] mpm {cfg.n} on {cfg.gx}^2 {cfg.material} {cfg.dtype}: "
        f"all finite, pos in [{pmin:.6g}, {max(xmax, ymax):.6g}], Jp in "
        f"[{jmin:.6g}, {jmax:.6g}], P2G mass {total!r} of {want:g} "
        f"(rel {abs(total - want) / want:.3e}); particle_mass x the in-grid "
        f"weights {fold!r} (rel {abs(total - fold) / fold:.3e}, tol "
        f"{ftol:g}), mean y {y0:.6f} -> {y1:.6f}, max |v| {vmax:.4f}, "
        f"overflow_count 0")
    return {"mean_y": [y0, y1], "jp": [jmin, jmax], "max_abs_v": vmax,
            "mass_rel_err": abs(total - want) / want,
            "fold": {"mass_sum": total, "weights": fold,
                     "rel": abs(total - fold) / fold}}


def phase_mpm_main(mk, mp, device, smi, errs, runs=MPM_RUNS) -> dict:
    res = {}
    for n_p, g, dtype, steps, p_steps in runs:
        cfg = mp.MPMConfig(n=n_p, gx=g, gy=g, dtype=dtype)
        engine = mp.resolve_engine(cfg, device)
        if engine != "cuda":
            raise AssertionError(f"engine auto resolved to {engine!r}")
        st0 = mp.init(cfg, device)
        mp.run(cfg, st0, 1)   # warm-up, not counted
        mk.reset_launches()
        out, wall = run_timed(mp, cfg, st0, steps)
        launches = dict(mk.LAUNCHES)
        want = {"p2g": steps, "g2p": steps}
        if launches != want:
            raise AssertionError(f"launches {launches} in {steps} steps, "
                                 f"want {want}")
        _, p_wall = run_timed(mp, cfg.replace(engine="scatter"), st0, p_steps)
        if dict(mk.LAUNCHES) != launches:
            raise AssertionError("the plain engine launched a kernel")
        rate, p_rate = steps / wall, p_steps / p_wall
        key = f"{n_p} {g}^2 {dtype}"
        log(f"[mpm] {key} snow engine={engine} on {smi}: {steps} steps in "
            f"{wall:.3f} s, {rate:.2f} steps/s, {n_p * rate / 1e6:.3f} M "
            f"particle-steps/s; plain scatter engine {p_steps} steps "
            f"{p_rate:.2f} steps/s ({n_p * p_rate / 1e6:.3f} M); launches "
            f"{launches}")
        phys = check_mpm_physics(mk, mp, cfg, st0, out)

        # the kernels against their plain versions from the final state
        parts = (out.pos, out.vel, out.F, out.Jp)
        checks, grids = check_mpm_call(mk, cfg, parts, key + " final state",
                                       errs)
        errs["rel"][key + " final state"] = {k: v[0]
                                             for k, v in checks.items()}
        log(f"[mpm] {key} final state: kernels vs plain (rel err, bitwise) "
            f"{checks}")

        g2p_in = (out.pos, out.F, out.Jp, *grids)
        times = {
            "p2g": time_launches(lambda: mk.p2g(cfg, *parts), 100),
            **p2g_device_times(mk, cfg, parts),
            "p2g_plain": time_launches(lambda: mk.p2g_plain(cfg, *parts), 5),
            "g2p": time_launches(lambda: mk.g2p(cfg, *g2p_in), 100),
            "g2p_device": device_ms(lambda: mk.g2p(cfg, *g2p_in), 100,
                                    "mpm_g2p_kernel"),
            "g2p_plain": time_launches(lambda: mk.g2p_plain(cfg, *g2p_in),
                                       5),
        }
        bounds = mpm_bounds(cfg, out.pos, grids[0])
        log(f"[mpm] per launch at {key} on {smi}: " + ", ".join(
            f"{k} {times[k]:.4f} ms vs plain {times[k + '_plain']:.4f} ms "
            f"(bound {bounds[k][0]:.5f} ms, {bounds[k][1]})"
            for k in ("p2g", "g2p"))
            + f"; G2P with the grid update {ms_text(times['g2p_device'])} "
            f"of device time"
            + f"; {bounds['offsets_in_grid']} P2G offsets inside the grid, "
            f"{bounds['nodes_with_mass']} nodes with mass; "
            + p2g_device_line(times))
        res[key] = {"launches": launches, "times": times, "bounds": bounds,
                    "rate": rate, "plain_rate": p_rate,
                    "mpsteps": n_p * rate / 1e6,
                    "plain_mpsteps": n_p * p_rate / 1e6, "physics": phys}
    return res


# -------------------------------- n-body layout -------------------------------
#
# One kernel, kernels/nbody_cuda.py (no TPU kernel: JAX computes the exact
# repulsion as plain XLA); `nk` below is the wrapper module, `ng` the
# solver.

# The function's operations a pair, as the plain version writes them
# (solvers/nbody_graph.py::_repulsion_exact): the differences (dims), the
# squares and their sum (2 dims - 1), the softening (1), rsqrt (1), inv^3
# (2), the repulsion factor (1), w d (dims) and the sums (dims).  The
# kernel issues fewer (fused multiply-adds, the repulsion once a target);
# the bound counts the function's, so that every design of the kernel is
# held to one bound.
NBODY_OPS_PER_PAIR = {2: 14, 3: 19}
# per body, normalized by sum_j |w_ij| |d_ij| in f64: the f64 kernel
# against the f64 plain version, the f32 kernel against the f64 plain
# version of the same f32 positions
NBODY_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# whole runs, of the layout's extent
NBODY_TRAJ_TOL = {torch.float32: 5e-4, torch.float64: 1e-10}
NBODY_RUNS = ((2, "float32", 20), (3, "float32", 20), (2, "float64", 10))
NBODY_MAX_NUMBER = 1 << 17


def nbody_body_err(nk, cfg, got, ref64, pos, rows) -> float:
    """max over targets of |got_i - ref_i|_inf / sum_j |w_ij| |d_ij|, the
    scale in f64 on the positions the forces were computed from."""
    scale = nk.term_scale(cfg, pos.double(),
                          None if rows is None else rows.double())
    err = (got.double() - ref64).abs().amax(dim=-1)
    return float((err / scale.clamp_min(1e-300)).max())


def check_nbody_call(nk, cfg, pos, rows, what: str, errs: dict,
                     plain_too: bool = True) -> dict:
    """The kernel (in cfg's dtype) against the f64 plain version of the
    same positions, within NBODY_TOL, and (`plain_too`) the plain version
    in cfg's dtype beside it; every value finite."""
    dt = cfg.torch_dtype
    got = nk.repulsion_exact(cfg, pos, rows)
    torch.cuda.synchronize()
    c64 = cfg.replace(dtype="float64")
    ref64 = nk.repulsion_exact_plain(c64, pos.double(),
                                     None if rows is None else rows.double())
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite force")
    err = nbody_body_err(nk, cfg, got, ref64, pos, rows)
    if not err <= NBODY_TOL[dt]:
        raise AssertionError(f"{what}: kernel per-body err {err:.3e} > "
                             f"{NBODY_TOL[dt]:g}")
    out = {"kernel": err}
    if plain_too and dt == torch.float32:
        out["plain_f32"] = nbody_body_err(
            nk, cfg, nk.repulsion_exact_plain(cfg, pos, rows), ref64, pos,
            rows)
    key = "f32" if dt == torch.float32 else "f64"
    errs[key] = max(errs.get(key, 0.0), err)
    errs["cases"] += 1
    return out


def nbody_inputs(ng, cfg, n: int, device, rng):
    """(label, positions) of the checks: n seeded bodies at scale 100 with
    two coincident where n > 3, or the init layout of cfg."""
    if n is None:
        return "init", ng.init(cfg, device).pos
    p = rng.normal(scale=100.0, size=(n, cfg.dims))
    if n > 3:
        p[n // 2] = p[1]
    return f"n={n}", torch.tensor(p, dtype=cfg.torch_dtype, device=device)


def nbody_tail_cases(shape: dict) -> list:
    """(n, nt or None for every body) of the launch shapes that hit each
    tail of the kernel's launch `shape` (threads a block = sources a tile,
    targets a thread): nt a whole block's targets - 1 and + 1, n a tile -
    1 and + 1, and rows fewer than one block's threads."""
    T, K = shape["threads"], shape["targets"]
    return list(dict.fromkeys([(T * K - 1, None), (T * K + 1, None),
                               (T - 1, None), (T + 1, None),
                               (T * K + 1, T // 2 + 1)]))


def check_nbody_tails(nk, ng, device, rng, errs) -> dict:
    """The kernel within NBODY_TOL on nbody_tail_cases of each dtype's
    launch, 2-D and 3-D (seeded bodies, two coincident)."""
    out = {}
    for dtype in ("float32", "float64"):
        shape = nk.repulsion_launch(1, getattr(torch, dtype))
        for dims in (2, 3):
            for n, nt in nbody_tail_cases(shape):
                cfg = ng.GraphLayoutConfig(max_number=max(n, 2), dims=dims,
                                           dtype=dtype)
                _, pos = nbody_inputs(ng, cfg, n, device, rng)
                rows = None if nt is None else pos[:nt].contiguous()
                what = f"{dims}-D {dtype} n={n}" + (
                    "" if rows is None else f" rows :{nt}")
                out[what] = check_nbody_call(nk, cfg, pos, rows, what, errs,
                                             plain_too=False)["kernel"]
    log(f"[nbody] tails (nt = threads x targets +- 1, n = tile +- 1, rows "
        f"fewer than a block's threads) of the launches "
        f"{nk.repulsion_launch(1, torch.float32)} (f32), "
        f"{nk.repulsion_launch(1, torch.float64)} (f64): {len(out)} cases, "
        f"worst per-body err {max(out.values()):.3e}")
    return out


def check_nbody_softening0(nk, ng, device, rng, errs) -> int:
    """At softening 0 a target's self pair (d = 0, rsqrt(0) = inf) makes
    its force non-finite in the plain version: the kernel leaves the same
    targets non-finite, and on targets off the bodies (all finite) stays
    within NBODY_TOL; f32 and f64, 2-D and 3-D.  The cases it ran."""
    cases = 0
    for dtype in ("float32", "float64"):
        for dims in (2, 3):
            cfg = ng.GraphLayoutConfig(max_number=257, dims=dims,
                                       dtype=dtype, softening=0.0)
            _, pos = nbody_inputs(ng, cfg, 257, device, rng)
            got = nk.repulsion_exact(cfg, pos)
            ref = nk.repulsion_exact_plain(cfg, pos)
            if bool(torch.isfinite(ref).any()) or not torch.equal(
                    torch.isfinite(got), torch.isfinite(ref)):
                raise AssertionError(f"softening 0 {dims}-D {dtype}: the "
                                     "kernel's non-finite forces differ "
                                     "from the plain version's")
            off = (pos[:64] + 0.37).contiguous()
            check_nbody_call(nk, cfg, pos, off,
                             f"softening 0 {dims}-D {dtype} off the bodies",
                             errs, plain_too=False)
            cases += 2
    return cases


def phase_nbody_kernels(nk, ng, device) -> dict:
    t_phase = time.perf_counter()
    if any(nk.LAUNCHES.values()):
        raise AssertionError(f"an earlier path launched the n-body kernel: "
                             f"{nk.LAUNCHES}")
    errs = {"cases": 0, "rel": {}}
    from fluidsims_tpu_torch.kernels import _build
    for name in ("nbody_repulsion_kernel", "wavespeed3_kernel"):
        for u in _build.ptxas_usage(name):
            log(f"[build] ptxas {u['kernel']}: {u['registers']} registers, "
                f"{u['static_smem']} bytes static shared memory, stack "
                f"{u['stack']}, spill stores {u['spill_stores']}, spill "
                f"loads {u['spill_loads']}")
    rng = np.random.default_rng(SEED)
    for dims in (2, 3):
        for dtype in ("float32", "float64"):
            for n in (2, 257, 4096, None):
                cfg = ng.GraphLayoutConfig(max_number=8192, dims=dims,
                                           dtype=dtype)
                label, pos = nbody_inputs(ng, cfg, n, device, rng)
                for rows in (None, pos[1::3].contiguous()):
                    what = (f"{dims}-D {dtype} {label}"
                            + ("" if rows is None else " rows 1::3"))
                    errs["rel"][what] = check_nbody_call(nk, cfg, pos, rows,
                                                         what, errs)
    worst32 = max(v.get("plain_f32", 0.0) for v in errs["rel"].values())
    log(f"[nbody] kernel vs the f64 plain version on {errs['cases']} cases "
        f"(2-D/3-D, f32/f64, n=2, 257, 4096 with two coincident, the "
        f"8192 init; all targets and rows 1::3): per-body err / sum|terms| "
        f"f32 {errs['f32']:.3e} (tol 1e-5; the f32 plain version's own "
        f"{worst32:.3e}), f64 {errs['f64']:.3e} (tol 1e-12)")
    errs["tails"] = check_nbody_tails(nk, ng, device, rng, errs)
    errs["softening0"] = check_nbody_softening0(nk, ng, device, rng, errs)
    log(f"[nbody] softening 0: the self pairs non-finite as in the plain "
        f"version, targets off the bodies within the bars "
        f"({errs['softening0']} cases)")

    # 5 steps through the kernel against 5 through the plain hook
    errs["traj"] = {}
    for dims in (2, 3):
        for dtype in ("float32", "float64"):
            cfg = ng.GraphLayoutConfig(max_number=8192, dims=dims,
                                       dtype=dtype)
            s0 = ng.init(cfg, device)
            before = nk.LAUNCHES["repulsion"]
            a = ng.run(cfg, s0, 5)
            if nk.LAUNCHES["repulsion"] - before != 5:
                raise AssertionError("5 steps made "
                                     f"{nk.LAUNCHES['repulsion'] - before} "
                                     "launches")
            b = ng.run(cfg, s0, 5, repulsion=lambda p, c=cfg:
                       nk.repulsion_exact_plain(c, p))
            if nk.LAUNCHES["repulsion"] - before != 5:
                raise AssertionError("the plain hook launched the kernel")
            extent = float(b.pos.abs().max())
            r = float((a.pos - b.pos).abs().max()) / extent
            rv = float((a.vel - b.vel).abs().max()) * cfg.dt / extent
            tol = NBODY_TRAJ_TOL[cfg.torch_dtype]
            if not (r <= tol and rv <= tol):
                raise AssertionError(f"5 steps {dims}-D {dtype}: pos {r:.3e} "
                                     f"vel dt {rv:.3e} of the extent > {tol:g}")
            errs["traj"][f"{dims}-D {dtype}"] = max(r, rv)
    log(f"[nbody] 5 steps at 8192 through the kernel vs the plain hook "
        f"(of the extent; tol 5e-4 f32, 1e-10 f64): {errs['traj']}; phase "
        f"23 took {time.perf_counter() - t_phase:.1f} s")
    return errs


def check_nbody_physics(cfg, out, steps: int) -> dict:
    """Finite; root pinned at exactly 0; every |v| within the clamp; the
    extent beside the init radius 20 sqrt(n)."""
    if not (bool(torch.isfinite(out.pos).all())
            and bool(torch.isfinite(out.vel).all())):
        raise AssertionError("non-finite positions or velocities")
    if bool(out.pos[0].any()) or bool(out.vel[0].any()):
        raise AssertionError(f"root not pinned: {out.pos[0]} {out.vel[0]}")
    vmax = float(torch.linalg.vector_norm(out.vel.double(), dim=-1).max())
    if not vmax <= cfg.max_speed * (1 + 1e-6):
        raise AssertionError(f"max |v| {vmax} past the clamp")
    if int(out.steps) != steps:
        raise AssertionError(f"steps {int(out.steps)}, want {steps}")
    return {"extent": float(out.pos.abs().max()),
            "init_radius": 20.0 * float(np.sqrt(cfg.n_bodies)),
            "max_speed": vmax}


def time_once(fn) -> float:
    """ms of one call of fn() by CUDA events (no warm-up: for the plain
    versions, whose warm-up the runs before have made)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms_each(fn, n: int, fragment: str) -> tuple[float | None, int]:
    """(device ms a launch, launches recorded) by torch.profiler (host and
    device activities) over n calls of fn() that each launch one kernel
    whose name holds `fragment`, after one warm-up call: the mean over the
    launches the profile recorded (profiles of a few long launches have
    been seen to miss some, or all, of them); a profile that recorded none
    is taken again, up to three times, and (None, 0) where none did."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and fragment in e.name]
        if us:
            return sum(us) / len(us) / 1e3, len(us)
    return None, 0


def nbody_bound(cfg, nt: int, n: int) -> tuple[float, str]:
    """bound_ms of a launch of nt targets over n sources."""
    item = 4 if cfg.dtype == "float32" else 8
    bytes_moved = (2 * nt + n) * cfg.dims * item
    return bound(bytes_moved, float(nt) * n * NBODY_OPS_PER_PAIR[cfg.dims],
                 cfg.torch_dtype)


def refuse_plain(*args, **kwargs):
    """Stands in for the plain repulsion while the main path runs: the
    exact engine on CUDA tensors must never reach it."""
    raise AssertionError("the main path called the plain repulsion")


def phase_nbody_main(nk, ng, device, smi, errs, others) -> dict:
    t_phase = time.perf_counter()
    res = {}
    for dims, dtype, steps in NBODY_RUNS:
        cfg = ng.GraphLayoutConfig(max_number=NBODY_MAX_NUMBER, dims=dims,
                                   dtype=dtype)
        key = f"{dims}-D {dtype}"
        s0 = ng.init(cfg, device)
        ng.run(cfg, s0, 1)    # warm-up (the incidence's first build)
        nk.reset_launches()
        plain_fn = ng._repulsion_exact
        ng._repulsion_exact = refuse_plain
        try:
            out, wall = run_timed(ng, cfg, s0, steps)
        finally:
            ng._repulsion_exact = plain_fn
        launches = dict(nk.LAUNCHES)
        if launches != {"repulsion": steps}:
            raise AssertionError(f"{key}: launches {launches} in {steps} "
                                 "steps")
        p_steps = 2
        plain = {"repulsion": lambda p, c=cfg: nk.repulsion_exact_plain(c, p)}
        _, p_wall = run_timed(ng, cfg, s0, p_steps, **plain)
        if dict(nk.LAUNCHES) != launches:
            raise AssertionError("the plain hook launched the kernel")
        rate, p_rate = steps / wall, p_steps / p_wall
        phys = check_nbody_physics(cfg, out, steps)
        log(f"[nbody] {cfg.n_bodies} bodies {key} exact on {smi}: {steps} "
            f"steps in {wall:.3f} s, {rate:.2f} steps/s; plain hook "
            f"{p_steps} steps {p_rate:.3f} steps/s; launches {launches}; "
            f"extent {phys['extent']:.1f} (init radius "
            f"{phys['init_radius']:.1f}), max |v| {phys['max_speed']:.3f}, "
            "root pinned, finite")
        chk = check_nbody_call(nk, cfg, out.pos, None, key + " final state",
                               errs, plain_too=False)
        errs["rel"][key + " final state"] = chk
        pos = out.pos
        dev_ms, recorded = device_ms_each(
            lambda: nk.repulsion_exact(cfg, pos), 5, "nbody_repulsion_kernel")
        times = {
            "repulsion": time_launches(lambda: nk.repulsion_exact(cfg, pos),
                                       5),
            "repulsion_device": dev_ms,
            "repulsion_plain": time_once(
                lambda: nk.repulsion_exact_plain(cfg, pos)),
        }
        bnd = nbody_bound(cfg, cfg.n_bodies, cfg.n_bodies)
        log(f"[nbody] per launch at {key} on {smi}: kernel "
            f"{times['repulsion']:.4f} ms by events, "
            f"{ms_text(times['repulsion_device'])} of device time ({recorded} "
            "of 5 launches recorded), plain "
            f"{times['repulsion_plain']:.4f} ms (bound {bnd[0]:.4f} ms, "
            f"{bnd[1]}); final state per-body err {chk}")
        res[key] = {"launches": launches, "times": times, "bound": bnd,
                    "rate": rate, "plain_rate": p_rate, "physics": phys}

    # the grid engine: plain PyTorch on the card, no kernel launch
    for n, steps in ((NBODY_MAX_NUMBER, 10), (1 << 15, 10)):
        cfg = ng.GraphLayoutConfig(max_number=n, engine="grid")
        s0 = ng.init(cfg, device)
        ng.run(cfg, s0, 1)    # warm-up
        before = dict(nk.LAUNCHES)
        out, wall = run_timed(ng, cfg, s0, steps)
        if dict(nk.LAUNCHES) != before:
            raise AssertionError("the grid engine launched the kernel")
        phys = check_nbody_physics(cfg, out, steps)
        near = "far field only" if n > cfg.near_field_max else "near field"
        log(f"[nbody] grid engine {n} bodies 2-D f32 ({near}) on {smi}: "
            f"{steps} steps {steps / wall:.2f} steps/s, extent "
            f"{phys['extent']:.1f}, no kernel launch")
        res[f"grid {n}"] = {"rate": steps / wall, "physics": phys}
    if any(any(m.LAUNCHES.values()) for m in others):
        raise AssertionError(f"the n-body path launched other kernels: "
                             f"{[dict(m.LAUNCHES) for m in others]}")
    log(f"[nbody] phase 24 took {time.perf_counter() - t_phase:.1f} s")
    return res


def nbody_kernel_line(nk, build, res, errs) -> dict:
    """The {"kernels": [...]} entry of the n-body kernel: times and bound
    from the final state of the 2-D f32 run at 2^17, those of the 3-D f32
    and 2-D f64 runs beside them; launches summed over the three runs; the
    launch at 2^17 and ptxas's report."""
    keys = [f"{d}-D {dt}" for d, dt, _ in NBODY_RUNS]
    a = res[keys[0]]
    entry = {
        "name": "nbody_repulsion", "route": "cuda",
        "source": "fluidsims_tpu_torch/csrc/nbody_repulsion.cu",
        # JAX computes the exact repulsion as plain XLA; no Pallas kernel
        "replaces": "fluidsims_tpu/solvers/nbody_graph.py:209",
        "launches": sum(res[k]["launches"]["repulsion"] for k in keys),
        "max_abs_err": max(errs["f32"], errs["f64"]),
        "ms": a["times"]["repulsion"],
        "plain_ms": a["times"]["repulsion_plain"],
        "bound_ms": a["bound"][0], "bound_by": a["bound"][1],
        "library_ms": None,
        "ms_device": a["times"]["repulsion_device"],
        "steps_per_s": a["rate"], "plain_steps_per_s": a["plain_rate"],
        "max_err_per_body": {"f32": errs["f32"], "f64": errs["f64"]},
        "err_cases": errs["cases"], "traj_err": errs["traj"],
        "tail_cases": errs["tails"],
        "launch": {dt: nk.repulsion_launch(NBODY_MAX_NUMBER,
                                           getattr(torch, dt))
                   for dt in ("float32", "float64")},
        "ptxas": build.ptxas_usage("nbody_repulsion_kernel"),
        "grid_engine_steps_per_s": {k: v["rate"] for k, v in res.items()
                                    if k.startswith("grid")}}
    for k, tag in zip(keys[1:], ("3d_f32", "f64")):
        r = res[k]
        entry.update({f"launches_{tag}": r["launches"]["repulsion"],
                      f"ms_{tag}": r["times"]["repulsion"],
                      f"ms_device_{tag}": r["times"]["repulsion_device"],
                      f"plain_ms_{tag}": r["times"]["repulsion_plain"],
                      f"bound_ms_{tag}": r["bound"][0],
                      f"bound_by_{tag}": r["bound"][1],
                      f"steps_per_s_{tag}": r["rate"],
                      f"plain_steps_per_s_{tag}": r["plain_rate"]})
    return entry


# ------------------------------ driver surface -------------------------------

# Phase 25's runs of every solver subcommand, at small sizes on the card:
# subcommand -> (flags, the rows of its --png frame, or None where JAX's
# CLI has no RGB export).  The K-step solvers take --block-k 2, so that a
# 4-step run launches their K-step kernels as well as the one-step ones.
DRIVER_CASES = {
    "gray-scott": (["--nx", "64", "--ny", "64", "--block-k", "2"], 64),
    "burgers": (["--nx", "64", "--ny", "64", "--block-k", "2"], 64),
    "shallow-water": (["--nx", "64", "--ny", "64", "--block-k", "2"], 64),
    "lbm": (["--nx", "64", "--ny", "32", "--radius", "6", "--block-k", "2"],
            32),
    "hypersonic2d": (["--nx", "256", "--ny", "128"], 128),
    "hypersonic3d": (["--n", "32"], None),
    "mhd": (["--nx", "64", "--ny", "48", "--block-k", "2"], 48),
    "stam2d": (["--n", "64"], 64),
    "stam3d": (["--n", "32", "--cols", "40", "--rows", "12"], None),
    "sph": (["--n", "4096", "--cols", "40", "--rows", "12"], None),
    "flip": (["--particles", "4096", "--grid", "64"], None),
    "mpm": (["--n", "4096", "--gx", "64", "--gy", "64", "--cols", "40",
             "--rows", "12"], None),
}
# kernel line source (csrc file) -> (launch counter module, its counters)
DRIVER_COUNTERS = {
    "hypersonic2d_step.cu": ("hk", ("step",)),
    "hypersonic2d_wavespeed.cu": ("hk", ("wavespeed",)),
    "sph_bin.cu": ("sk", ("bin",)), "sph_density.cu": ("sk", ("density",)),
    "sph_forces.cu": ("sk", ("forces",)),
    "hypersonic3d_step.cu": ("hk3", ("step",)),
    "hypersonic3d_wavespeed.cu": ("hk3", ("wavespeed",)),
    "hypersonic3d_pad.cu": ("hk3", ("pad",)),
    "gray_scott_step.cu": ("gk", ("step",)),
    "gray_scott_multistep.cu": ("gk", ("multistep",)),
    "lbm_step.cu": ("lk", ("step",)), "lbm_multistep.cu": ("lk", ("multistep",)),
    "burgers_multistep.cu": ("bk", ("step", "multistep")),
    "shallow_water_multistep.cu": ("swk", ("step", "multistep")),
    "mhd_multistep.cu": ("mk", ("step", "multistep")),
    "stam3d_jacobi.cu": ("sc", ("jacobi",)),
    "stam3d_advect.cu": ("sc", ("advect",)),
    "stam3d_set_bnd.cu": ("sc", ("set_bnd",)),
    "stam2d_lin_solve.cu": ("s2k", ("lin_solve",)),
    "stam2d_advect.cu": ("s2k", ("advect",)),
    "flip_p2g.cu": ("fk", ("p2g",)), "flip_grid.cu": ("fk", ("grid",)),
    "flip_g2p.cu": ("fk", ("g2p",)),
    "mpm_p2g.cu": ("mpk", ("p2g",)), "mpm_g2p.cu": ("mpk", ("g2p",)),
    "nbody_repulsion.cu": ("nk", ("repulsion",)),
}
DRIVER_VIEW_TOL = 1e-5         # normalized view, card against CPU, absolute
# FLIP resume, one step: a step from the checkpoint loaded on the card
# against a step from the in-memory state it was saved from, relative to
# each float leaf's max; the P2G's atomics round to 1.07e-6 at f32
FLIP_STEP_TOL = 1e-5
# FLIP resume, 50 steps on (a sanity bound): the resumed run may differ
# from a straight one by at most this many times what two straight runs
# differ by (the worst of three pairs, at least the floor), since the
# dynamics grow the atomics' rounding; a resume that lost a field would
# differ by O(1)
FLIP_RESUME_SPREAD = 10.0
FLIP_RESUME_FLOOR = 1e-6
FLIP_STRAIGHT_RUNS = 3


def cli_run(cli, argv: list) -> str:
    """cli.main(argv) with a non-tty stdin; its stdout.  Fails unless it
    returns 0 (or exits with code 0, as `regression` does)."""
    import contextlib
    import io

    out = io.StringIO()
    stdin = sys.stdin
    sys.stdin = io.StringIO()           # isatty() False: no raw mode
    try:
        with contextlib.redirect_stdout(out):
            try:
                rc = cli.main(argv)
            except SystemExit as e:
                rc = e.code
    finally:
        sys.stdin = stdin
    if rc != 0:
        raise AssertionError(f"{' '.join(argv)}: exit {rc}\n{out.getvalue()}")
    return out.getvalue()


def png_size(path) -> tuple[int, int]:
    data = open(path, "rb").read(24)
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    return tuple(int.from_bytes(data[i:i + 4], "big") for i in (16, 20))


def driver_flags(cli, d, smi) -> None:
    """(a): each subcommand four ways on the card; nbody's checkpoint;
    regression write then verify."""
    from pathlib import Path

    for cmd, (flags, rows) in DRIVER_CASES.items():
        base = [cmd, *flags, "--device", "cuda"]
        engine = "impl=cuda" if cmd.startswith("hypersonic") \
            else "engine=cuda"
        t0 = time.perf_counter()
        outs = [cli_run(cli, base + ["--render", "--stride", "2", "--steps",
                                     "4"])]
        name = {"flip": "flip-apic"}.get(cmd, cmd)
        if f"[{name}] step 4/4" not in outs[0]:
            raise AssertionError(f"{cmd} --render --stride 2: no live frame")
        png = Path(d) / f"{cmd}.png"
        if rows:
            outs.append(cli_run(cli, base + ["--steps", "2", "--png",
                                             str(png)]))
            if not png.is_file() or png_size(png)[1] != rows:
                raise AssertionError(f"{cmd} --png wrote no frame of {rows} "
                                     "rows")
        outs.append(cli_run(cli, base + ["--interactive", "--stride", "1",
                                         "--steps", "2"]))
        if "step 2" not in outs[-1]:
            raise AssertionError(f"{cmd} --interactive did not run 2 steps")
        ck = Path(d) / f"{cmd}.npz"
        outs.append(cli_run(cli, base + ["--steps", "2", "--save-state",
                                         str(ck)]))
        outs.append(cli_run(cli, base + ["--steps", "2", "--load-state",
                                         str(ck)]))
        if not ck.is_file() or f"resumed from {ck}" not in outs[-1]:
            raise AssertionError(f"{cmd}: no checkpoint written or resumed")
        for o in outs:
            if engine not in o:
                raise AssertionError(f"{cmd}: a run did not print {engine}:"
                                     f"\n{o}")
        log(f"[driver] {cmd} on {smi}: --render --stride, "
            f"{'--png, ' if rows else ''}--interactive, --save-state and "
            f"--load-state, each exit 0 with {engine}, "
            f"{time.perf_counter() - t0:.2f} s")
    ck = Path(d) / "nbody.npz"
    nb = ["nbody", "--max-number", "4096", "--steps", "2", "--device",
          "cuda"]
    o = cli_run(cli, nb + ["--save-state", str(ck)])
    o += cli_run(cli, nb + ["--load-state", str(ck)])
    if not ck.is_file() or "resumed from" not in o or "engine=exact" not in o:
        raise AssertionError(f"nbody checkpoint:\n{o}")
    base = Path(d) / "baseline.txt"
    reg = ["regression", "--nx", "256", "--ny", "128", "--steps", "8",
           "--baseline", str(base), "--device", "cuda"]
    o = cli_run(cli, reg + ["--write-baseline"])
    o += cli_run(cli, reg)
    if "Failed: 0" not in o:
        raise AssertionError(f"regression verify:\n{o}")
    log(f"[driver] nbody --save-state/--load-state and regression "
        f"--write-baseline then verify on {smi}: each exit 0")


def driver_views(cli, h2, hk, views, d, smi) -> dict:
    """(b): the flagship's views at 2048^2 f32 after 200 steps, card
    against a CPU copy; the strided PNG run's files and launches; the time
    a frame of view + copy + colormap + PNG."""
    from pathlib import Path

    from fluidsims_tpu_torch.core.metrics import device_timer
    from fluidsims_tpu_torch.io.png import write_png
    from fluidsims_tpu_torch.render.colormap import jet

    cfg = h2.default_config(nx=2048, ny=2048)
    st = h2.run(cfg, h2.init(cfg, torch.device("cuda")), 200)
    cpu = h2.Hypersonic2DState(
        U=type(st.U)(*(f.cpu() for f in st.U)), mask=st.mask.cpu(),
        t=st.t.cpu())
    errs = {}
    for mode in views.VIEW_MODES:
        t, solid = views.normalized_to_host(cfg, st, mode)
        tc, solid_c = views.normalized_to_host(cfg, cpu, mode)
        if not np.array_equal(solid, solid_c):
            raise AssertionError(f"view {mode}: the masks differ")
        err = float(np.max(np.abs(t.astype(np.float64) - tc)))
        if not err <= DRIVER_VIEW_TOL:
            raise AssertionError(f"view {mode}: card vs CPU {err:.3e} > "
                                 f"{DRIVER_VIEW_TOL}")
        errs[mode] = {"max_abs_err": err}
        if mode in ("schlieren", "mach"):
            a = views.render_rgba(cfg, st, mode).astype(int)
            b = views.render_rgba(cfg, cpu, mode).astype(int)
            lev = int(np.abs(a - b).max())
            if lev > 1:
                raise AssertionError(f"render_rgba {mode}: {lev} levels off")
            errs[mode]["rgba_levels"] = lev
    log(f"[driver] 2048^2 f32 views after 200 steps, card vs CPU copy: "
        f"masks equal, normalized max abs err "
        f"{max(e['max_abs_err'] for e in errs.values()):.3e} (tol "
        f"{DRIVER_VIEW_TOL:g}), render_rgba (schlieren, mach) within "
        f"{max(e.get('rgba_levels', 0) for e in errs.values())} level(s): "
        f"{errs}")

    # one frame's parts, as the CLI's --png makes it (schlieren), each
    # bracketed by synchronisation
    parts = {"view_copy": [], "colormap": [], "png": []}
    held, dev = {}, torch.device("cuda")
    for i in range(4):
        with device_timer(held, "view_copy", dev):
            t, solid = views.normalized_to_host(cfg, st, "schlieren")
        with device_timer(held, "colormap", dev):
            img = jet(np.clip(t, 0, 1))
            img[solid] = 0
        with device_timer(held, "png", dev):
            write_png(Path(d) / "frame.png", img)
        if i:
            for k in parts:
                parts[k].append(held[k] * 1e3)
    frame_ms = {k: float(np.median(v)) for k, v in parts.items()}

    argv = ["hypersonic2d", "--nx", "2048", "--ny", "2048", "--steps", "200",
            "--device", "cuda"]
    hk.reset_launches()
    png = Path(d) / "flag.png"
    o = cli_run(cli, argv + ["--png", str(png), "--stride", "50"])
    launches = dict(hk.LAUNCHES)
    if launches != {"step": 200, "wavespeed": 200}:
        raise AssertionError(f"--png --stride 50: launches {launches}")
    for i in range(4):
        if png_size(Path(d) / f"flag_{i:04d}.png") != (2048, 2048):
            raise AssertionError(f"flag_{i:04d}.png is not 2048x2048")
    if (Path(d) / "flag_0004.png").exists():
        raise AssertionError("more than 4 PNGs")
    live = float(re.search(r"([0-9.]+) steps/s", o).group(1))
    o = cli_run(cli, argv)
    headless = float(re.search(r"([0-9.]+) steps/s", o).group(1))
    total = sum(frame_ms.values())
    log(f"[driver] hypersonic2d 2048^2 f32 --png f.png --stride 50 --steps "
        f"200 on {smi}: 4 PNGs of 2048x2048, launches {launches}; "
        f"{live:.1f} steps/s with the frames, {headless:.1f} steps/s "
        f"headless; a frame {total:.1f} ms (view + copy "
        f"{frame_ms['view_copy']:.1f}, colormap {frame_ms['colormap']:.1f}, "
        f"PNG {frame_ms['png']:.1f})")
    return {"views": errs, "frame_ms": frame_ms, "frame_ms_total": total,
            "steps_per_s_png_stride_50": live, "steps_per_s_headless":
            headless, "launches_png_run": launches}


def npz_leaves(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def leaf_rel_errs(a: dict, b: dict) -> dict:
    """Per float leaf of two checkpoints: max |a - b| / max |a|."""
    errs = {}
    for k in sorted(a):
        if k.startswith("leaf_") and a[k].dtype.kind == "f":
            scale = max(float(np.max(np.abs(a[k]))), 1e-30)
            errs[k] = float(np.max(np.abs(a[k].astype(np.float64) - b[k])))
            errs[k] /= scale
    return errs


def state_rel_errs(a, b) -> dict:
    """Per float leaf of two states: max |a - b| / max |a|."""
    from fluidsims_tpu_torch.core import checkpoint

    return leaf_rel_errs(
        {f"leaf_{i}": x.cpu().numpy()
         for i, x in enumerate(checkpoint.flatten(a))},
        {f"leaf_{i}": x.cpu().numpy()
         for i, x in enumerate(checkpoint.flatten(b))})


def flip_resume_step(d, smi) -> dict:
    """FLIP's tight resume check: 50 steps in memory, save, load onto the
    card (bitwise to the state saved), then one step from the loaded state
    against one from the in-memory state, within FLIP_STEP_TOL; a second
    step from the in-memory state reads the atomics' own spread."""
    from pathlib import Path

    from fluidsims_tpu_torch.core import checkpoint
    from fluidsims_tpu_torch.solvers import flip_apic as fa

    cfg = fa.FlipApicConfig(particles=65536, grid=128)
    dev = torch.device("cuda")
    mid = fa.run(cfg, fa.init(cfg, dev), 50)
    path = Path(d) / "flip_mem.npz"
    checkpoint.save_state(path, mid)
    loaded = checkpoint.load_state(path, fa.init(cfg, dev))
    for x, y in zip(checkpoint.flatten(mid), checkpoint.flatten(loaded)):
        if not (y.device == x.device and y.dtype == x.dtype
                and torch.equal(x, y)):
            raise AssertionError("flip: the state loaded on the card is not "
                                 "the state saved")
    a, b, c = (fa.step(cfg, s) for s in (mid, loaded, mid))
    errs, noise = state_rel_errs(a, b), state_rel_errs(a, c)
    worst = max(errs.values())
    if not worst <= FLIP_STEP_TOL:
        raise AssertionError(f"flip: one step from the loaded state vs the "
                             f"in-memory one, rel err {worst:.3e} > "
                             f"{FLIP_STEP_TOL:g}: {errs}")
    if int(a.density.sum()) != int(b.density.sum()):
        raise AssertionError("flip: one step from the loaded state rasters "
                             "another particle total")
    moved = int((a.density != b.density).sum())
    log(f"[driver] resume flip 65536 128^2 f32 one step on {smi}: the "
        f"checkpoint loaded on the card bitwise the state saved; a step from "
        f"it vs from the in-memory state max rel err {worst:.3e} (tol "
        f"{FLIP_STEP_TOL:g}), two steps from the in-memory state "
        f"{max(noise.values()):.3e}; {moved} raster cells differ, totals "
        "equal")
    return {"load_bitwise": True, "step_rel_err": errs,
            "step_rel_err_same_state": noise, "step_raster_cells_differ":
            moved}


def driver_resume(cli, d, smi) -> dict:
    """(c): 100 steps straight against 50, --save-state, --load-state, 50.
    The flagship's kernels are bitwise from call to call, so there the two
    files must be equal.  FLIP's P2G adds in no fixed order: its resume is
    held tight over one step (flip_resume_step); over the 50 steps on,
    where the dynamics grow the rounding, the resumed run is held to
    FLIP_RESUME_SPREAD times the spread of straight runs (the worst of
    FLIP_STRAIGHT_RUNS runs' pairs, at least FLIP_RESUME_FLOOR), the
    density rasters to equal particle totals, and the CLI's checkpoint to
    a bitwise load + save on the card."""
    import itertools
    from pathlib import Path

    from fluidsims_tpu_torch.core import checkpoint
    from fluidsims_tpu_torch.solvers import flip_apic as fa

    res = {}
    for key, argv in (
            ("hypersonic2d 2048^2 f32", ["hypersonic2d", "--nx", "2048",
                                         "--ny", "2048"]),
            ("flip 65536 128^2 f32", ["flip", "--particles", "65536",
                                      "--grid", "128"])):
        full, mid, end, again = (Path(d) / f"{k}.npz"
                                 for k in ("full", "mid", "end", "again"))
        base = argv + ["--device", "cuda"]
        cli_run(cli, base + ["--steps", "100", "--save-state", str(full)])
        cli_run(cli, base + ["--steps", "50", "--save-state", str(mid)])
        cli_run(cli, base + ["--steps", "50", "--load-state", str(mid),
                             "--save-state", str(end)])
        a, b = npz_leaves(full), npz_leaves(end)
        if sorted(a) != sorted(b):
            raise AssertionError(f"{key}: the files hold other arrays")
        if key.startswith("hypersonic2d"):
            same = all(np.array_equal(a[k], b[k]) for k in a)
            if not same:
                raise AssertionError(f"{key}: resume not bitwise")
            res[key] = {"bitwise": True}
            log(f"[driver] resume {key} on {smi}: 100 steps == 50 + save + "
                "load + 50, bitwise")
            continue
        res[key] = step = flip_resume_step(d, smi)
        # the CLI checkpoint's round trip through the card is exact
        like = fa.init(fa.FlipApicConfig(particles=65536, grid=128),
                       torch.device("cuda"))
        checkpoint.save_state(again, checkpoint.load_state(mid, like))
        m1, m2 = npz_leaves(mid), npz_leaves(again)
        if not all(np.array_equal(m1[k], m2[k]) for k in m1):
            raise AssertionError(f"{key}: load + save on the card changed "
                                 "the checkpoint")
        straight = [a]
        for _ in range(FLIP_STRAIGHT_RUNS - 1):
            cli_run(cli, base + ["--steps", "100", "--save-state",
                                 str(again)])
            straight.append(npz_leaves(again))
        spreads = [max(leaf_rel_errs(x, y).values())
                   for x, y in itertools.combinations(straight, 2)]
        errs = leaf_rel_errs(a, b)
        dens = "leaf_4"
        moved = int(np.sum(a[dens] != b[dens]))
        if a[dens].sum() != b[dens].sum():
            raise AssertionError(f"{key}: the density rasters count other "
                                 "particle totals")
        worst, ref = max(errs.values()), max(spreads)
        bar = FLIP_RESUME_SPREAD * max(ref, FLIP_RESUME_FLOOR)
        if not worst <= bar:
            raise AssertionError(f"{key}: resume rel err {worst:.3e} > "
                                 f"{bar:.3e} ({FLIP_RESUME_SPREAD:g} x the "
                                 f"straight runs' {ref:.3e}): {errs}")
        step.update({"rel_err": errs, "straight_pairs_rel_err": spreads,
                     "raster_cells_differ": moved,
                     "checkpoint_bitwise": True})
        log(f"[driver] resume {key} on {smi}: 100 steps vs 50 + save + load "
            f"+ 50, max rel err {worst:.3e}; the {len(spreads)} pairs of "
            f"{len(straight)} straight 100-step runs differ by "
            f"{', '.join(f'{x:.3e}' for x in spreads)} (the atomic P2G adds "
            f"in no fixed order; bar {bar:.3e}); {moved} raster cells "
            "differ, particle totals equal; the checkpoint's load + save on "
            "the card bitwise")
    return res


def driver_streams(h2, h3, th3cs, views, d, smi) -> dict:
    """(d): the streamed th3cs export against the batch one; the
    hypersonic2d serve frames through the stream writer, read back."""
    from pathlib import Path

    from fluidsims_tpu_torch.io import fourspl, fourspl_native
    from fluidsims_tpu_torch.io.live4spl import (Stream4splWriter,
                                                 read_4spl_partial)

    t0 = time.perf_counter()
    if not fourspl_native.native_available():
        raise AssertionError("no C compiler built native/fourspl.c")
    build_s = time.perf_counter() - t0
    cfg = h3.default_config(64)
    dev = torch.device("cuda")
    batch, stream = Path(d) / "b.4spl", Path(d) / "s.4spl"
    vid = th3cs.export_4spl(batch, cfg, frames=8, steps_per_frame=4,
                            device=dev)
    fourspl_native.write_4spl_native(Path(d) / "n.4spl", vid)
    if (Path(d) / "n.4spl").read_bytes() != batch.read_bytes():
        raise AssertionError("th3cs: the native writer's file differs from "
                             "export_4spl's")
    seen = []
    th3cs.export_4spl_streamed(
        stream, cfg, frames=8, steps_per_frame=4, device=dev,
        on_frame=lambda i, n: seen.append(read_4spl_partial(stream).frames))
    if seen != list(range(1, 9)):
        raise AssertionError(f"stream published frames {seen}")
    if stream.read_bytes() != batch.read_bytes():
        raise AssertionError("th3cs: the streamed file differs from the batch "
                             "export")
    log(f"[driver] th3cs 64^3 8 frames x 4 steps on {smi}: the streamed "
        "file and the native writer's byte-identical to export_4spl's "
        "(Python writer), each frame readable as it landed")
    writers = time_writers(fourspl, fourspl_native, vid, d)
    log(f"[driver] .4spl writers at th3cs's 64^3 x 60 frames (15.7 MB, "
        f"warm page cache), ms a file, median of 5 (min): Python "
        f"{writers['python_ms']:.2f} ({writers['python_min_ms']:.2f}), "
        f"native {writers['native_ms']:.2f} ({writers['native_min_ms']:.2f}); "
        f"the native writer built in {build_s:.2f} s")

    cfg2 = h2.default_config(nx=2048, ny=2048)
    s0 = h2.init(cfg2, dev)
    frame_fn, (wc, hc) = views.stream_frame_fn(
        cfg2, lambda st, n: h2.run(cfg2, st, n), "schlieren", 4, 256)
    path = Path(d) / "h2.4spl"
    frames = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Stream4splWriter(path, wc, hc, 1, fourspl.heat_palette(256)) as w:
        st = s0
        for _ in range(8):
            st, q = frame_fn(st)
            frames.append(q.cpu().numpy())
            w.append(frames[-1])
    wall = time.perf_counter() - t0
    got = read_4spl_partial(path)
    if got.frames != 8 or got.indices.shape[1:] != (1, hc, wc):
        raise AssertionError(f"hypersonic2d stream: {got.frames} frames of "
                             f"{got.indices.shape[1:]}")
    if not np.array_equal(got.indices, np.stack(frames)):
        raise AssertionError("hypersonic2d stream: frames read back differ")
    if not len(np.unique(got.indices[-1])) > 1:
        raise AssertionError("hypersonic2d stream: a flat last frame")
    log(f"[driver] hypersonic2d 2048^2 serve frames ({wc}x{hc}, 4 steps "
        f"each) on {smi}: 8 frames through Stream4splWriter in {wall:.3f} s, "
        "read back equal")
    return {"th3cs_stream_bitwise": True, "hyp2d_stream_frames": 8,
            "hyp2d_stream_s": wall, "writers": writers,
            "native_build_s": build_s}


def time_writers(fourspl, fourspl_native, vid, d) -> dict:
    """ms a file of the Python and the native .4spl writer on th3cs's
    default 64^3 x 60 frames (`vid`'s frames repeated), alternated, 5
    each; the two files must be equal."""
    from pathlib import Path

    big = fourspl.Splat4DVideo(
        width=vid.width, height=vid.height, depth=vid.depth, frames=60,
        palette=vid.palette, flags=vid.flags,
        indices=np.resize(vid.indices, (60,) + vid.indices.shape[1:]))
    paths = {"python": Path(d) / "wp.4spl", "native": Path(d) / "wn.4spl"}
    fns = {"python": fourspl.write_4spl,
           "native": fourspl_native.write_4spl_native}
    ms = {k: [] for k in fns}
    for _ in range(5):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn(paths[k], big)
            ms[k].append((time.perf_counter() - t0) * 1e3)
    if paths["python"].read_bytes() != paths["native"].read_bytes():
        raise AssertionError("the .4spl writers disagree at 64^3 x 60")
    out = {}
    for k, v in ms.items():
        out[f"{k}_ms"] = float(np.median(v))
        out[f"{k}_min_ms"] = float(min(v))
    return out


def phase_driver_surface(mods: dict, smi) -> dict:
    """Phase 25: the driver surface on the card, (a)-(d); every kernel
    counter set to 0 before and read after."""
    import tempfile

    from fluidsims_tpu_torch import cli
    from fluidsims_tpu_torch.render import views
    from fluidsims_tpu_torch.solvers import hypersonic2d as h2
    from fluidsims_tpu_torch.solvers import hypersonic3d as h3
    from fluidsims_tpu_torch.solvers import th3cs

    t_phase = time.perf_counter()
    for m in mods.values():
        m.reset_launches()
    with tempfile.TemporaryDirectory() as d:
        driver_flags(cli, d, smi)
        launches = launch_counts(mods)
        idle = [src for src, n in launches.items() if n == 0]
        if idle:
            raise AssertionError(f"the driver surface runs launched no "
                                 f"{idle}")
        res = {"launches": launches,
               "views": driver_views(cli, h2, mods["hk"], views, d, smi),
               "resume": driver_resume(cli, d, smi),
               "streams": driver_streams(h2, h3, th3cs, views, d, smi)}
    log(f"[driver] (a) launches by kernel source: {launches}")
    log(f"[driver] phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return res


# Phase 26: the sharded runners of fluidsims_tpu_torch/parallel.  The
# flagship at the reference default (8192x1024 f64, as JAX's multi-device
# dry run), the 3-D solver at 64^3, Gray–Scott at 2048^2 (K = 16) and LBM
# at 2048x1024 (K = 8) with steps past a multiple of K so both of their
# kernels launch, Burgers and shallow water at 512^2, MHD at 320x220,
# FLIP 65,536 on 128^2, MPM 32,768 on 96^2 and the n-body layout at 2^17
# bodies.  runner -> (config fields, steps at world 1, steps at world 2
# (4 for the 2x2 mesh), the bar of world 2 on the largest relative error
# against the one-device run: the CPU tests' bars of the sharded runs
# against JAX's (tests/test_torch_parallel_*.py))
PARALLEL_HYP2D = dict(nx=8192, ny=1024, geom_x0=125.0, geom_cy=512.0,
                      geom_Rb=1024.0 / 12.0, geom_Rn=1024.0 / 24.0,
                      dtype="float64")
PARALLEL_RUNS = {
    "hypersonic2d": (PARALLEL_HYP2D, 20, 5, 2e-6),
    "hypersonic2d_mesh2d": (PARALLEL_HYP2D, 20, 5, 1e-5),
    "hypersonic3d": (dict(nx=64, ny=64, nz=64, dx=1 / 64, dy=1 / 64,
                          dz=1 / 64), 20, 5, 3e-6),
    "gray_scott": (dict(nx=2048, ny=2048), 35, 19, 1e-6),
    "lbm": (dict(nx=2048, ny=1024), 19, 11, 1e-6),
    "burgers": (dict(nx=512, ny=512), 20, 5, 1e-10),
    "shallow_water": (dict(nx=512, ny=512), 20, 5, 1e-10),
    "mhd": (dict(nx=320, ny=220), 20, 5, 1e-10),
    "flip": (dict(particles=65536, grid=128), 5, 5,
             FLIP_TRAJ_TOL[torch.float32]),
    "mpm": (dict(n=32768, gx=96, gy=96), 5, 5, MPM_TRAJ_TOL[torch.float32]),
    "nbody": (dict(max_number=NBODY_MAX_NUMBER), 5, 3, 2e-5),
    # the SPH and spatial particle runners: world 1 at bench.py's
    # sizes (SPH 65,536, with rain for the replicated runner and without
    # for the spatial one, which refuses rain; FLIP 65,536 on 128^2; MPM
    # 32,768 on 96^2), worlds 2 and 4 at PARALLEL_MULTI's; held to
    # PARALLEL_LEAF_BARS, sph bitwise at every world
    "sph": (dict(n=65536), 20, 3, 0.0),
    "sph_spatial": (dict(n=65536, rain=False), 5, 5, None),
    "flip_spatial": (dict(particles=65536, grid=128), 5, 5, None),
    "mpm_spatial": (dict(n=32768, gx=96, gy=96), 5, 30, None),
    # the Stam runners at the default configs' full widths (bench.py's
    # stam2d_512x512 and stam3d_192), bitwise at every world (worlds 2 and
    # 4 at PARALLEL_MULTI's): stam2d to the one-device 'cuda' run, stam3d
    # to the 'torch' run at its advect_k
    "stam2d": (dict(n=512), 20, 5, 0.0),
    "stam3d": (dict(n=192), 5, 3, 0.0),
}
# Worlds 2 and 4 of the SPH and spatial runners: SPH 16,384 and JAX's test
# sizes of FLIP and MPM (tests/test_sharded_particles.py; MPM at the dt of
# tests/test_torch_parallel_spatial.py's migration case)
PARALLEL_MULTI = {
    "sph": dict(n=16384, dtau=1e-2),
    "sph_spatial": dict(n=16384, rain=False, dtau=1e-2),
    "flip_spatial": dict(particles=4096, grid=32, jacobi=8),
    "mpm_spatial": dict(n=4096, gx=48, gy=48, dt=4.0e-4),
    # at JAX's calm dt (tests/test_stam_sharded.py): at dt = 1 the init
    # swirl traces back further than the default's 16 exchanged columns,
    # and at world 4 further than n / D, so clamped cells would part from
    # the one-device run (STAM2D_CLAMP_RUNS hold such runs to the plain
    # composition)
    "stam2d": dict(n=512, dt=0.05),
    "stam3d": dict(n=192),
}
# The runners held bitwise to the one-device run at every world
PARALLEL_EXACT = ("sph", "stam2d", "stam3d")
# The Stam runners' launches a step, as their composition implies: stam2d
# 5 solves of ceil(40 / halo_k) rounds (the runner's default halo_k = 8)
# on #9 and 2 advections on #10; stam3d 6 solves of 12 sweeps on #11 and
# no other stam3d kernel
PARALLEL_LAUNCHES = {
    "stam2d": ("stam2d_cuda", lambda steps: {
        "lin_solve": 5 * -(-40 // 8) * steps, "advect": 2 * steps}),
    "stam3d": ("stam3d_cuda", lambda steps: {
        "jacobi": 6 * 12 * steps, "advect": 0, "set_bnd": 0}),
}
# Worlds 2 and 4 of the spatial runners start from init() with (seeded
# noise of this amplitude, this x drift) added to the velocities, as the
# CPU tests' migration cases do, so that particles change ranks (FLIP's
# flow moves them as it starts): each run must move some
PARALLEL_STIR = {"sph_spatial": (0.5, 0.0), "mpm_spatial": (0.0, 1.0)}
# The absolute bars of each leaf of the gathered state against the
# one-device run (runners.max_abs_errs; None: not held): JAX's test bars
# (tests/test_sharded_particles.py) on the positions (SPH 1e-5; FLIP 2e-5
# with velocities 2e-4 and the affine matrices 2e-2; MPM 2e-6 with
# velocities, F and Jp 2e-4), the SPH velocities at 1e-4 and its clock
# bitwise, the FLIP raster within 4 particles (the replicated FLIP
# runner's bar there: a particle within rounding of a cell's edge may
# count in its neighbour)
PARALLEL_LEAF_BARS = {
    "sph_spatial": (1e-5, 1e-4, 0.0, 0.0, 0.0, 0.0),
    "flip_spatial": (2e-5, 2e-4, 2e-2, 2e-2, 4),
    "mpm_spatial": (2e-6, 2e-4, 2e-4, 2e-4),
}
# The runners held at world 1 to their bar instead of bitwise: FLIP's and
# MPM's one-device runs add with atomics in no fixed order; sph_spatial's
# window has its own blocks, chunks and lanes; flip_spatial's Jacobi adds
# a cell's neighbours in JAX's spatial order; mpm_spatial's P2G sums into
# padded columns.  The n-body springs' index_add_ adds with atomics on the
# card too; it is held bitwise where two one-device runs are bitwise
# equal.
PARALLEL_TO_BAR = ("flip", "mpm", "sph_spatial", "flip_spatial",
                   "mpm_spatial")
# kernel-wrapper module (parallel/runners.KERNEL_MODULES) -> this script's
# short name, as in DRIVER_COUNTERS
PARALLEL_MODS = {"hypersonic2d_cuda": "hk", "sph_cuda": "sk",
                 "hypersonic3d_cuda": "hk3", "gray_scott_cuda": "gk",
                 "lbm_cuda": "lk", "burgers_cuda": "bk",
                 "shallow_water_cuda": "swk", "mhd_cuda": "mk",
                 "stam3d_cuda": "sc", "stam2d_cuda": "s2k", "flip_cuda": "fk",
                 "mpm_cuda": "mpk", "nbody_cuda": "nk"}
# The kernels that the sharded runners drive: each must
# launch at world 1.  #7 and #8 step plainly under the sharded runners;
# the spatial FLIP and MPM runners compose the dense engine's torch ops,
# the stam3d runner its advection (#12's place) and set_bnd (#13's).
PARALLEL_KERNELS = ("hypersonic2d_step.cu", "hypersonic2d_wavespeed.cu",
                    "hypersonic3d_step.cu", "hypersonic3d_wavespeed.cu",
                    "hypersonic3d_pad.cu", "gray_scott_step.cu",
                    "gray_scott_multistep.cu", "lbm_step.cu",
                    "lbm_multistep.cu", "flip_p2g.cu",
                    "flip_grid.cu", "flip_g2p.cu", "mpm_p2g.cu",
                    "mpm_g2p.cu", "nbody_repulsion.cu", "sph_bin.cu",
                    "sph_density.cu", "sph_forces.cu", "stam2d_lin_solve.cu",
                    "stam2d_advect.cu", "stam3d_jacobi.cu")
# The SPH pair kernels over a range of receivers and a window of cell
# columns (the SPH runners'), on 65,536 particles (64 x 64 cells): ranges
# whose r0 is off a block's boundary (16 particles a block at 8 lanes),
# one of a single receiver; windows (gx0, gw) inside and at both walls
SPH_RANGE_N = 65536
SPH_RANGES = ((37, 40000), (16387, 65536), (5, 6), (0, 65535))
SPH_WINDOWS = ((13, 20), (0, 9), (49, 15))
# Particle counts binned in turn on one scratch (each in (2^15, 2^16]), the
# first with ((cell column, row), members) packed into single cells
SPH_BUCKET_NS = (40000, 60000, 33000, 65536)
SPH_BUCKET_CLUSTERS = (((10, 10), 700), ((40, 30), 2500))


def sph_range_inputs(ts, cfg, device, rng):
    """init() with seeded noise on the positions (0.3 h) and the
    velocities (0.5)."""
    pos = ts.init(cfg, torch.device("cpu")).pos.double()
    pos = torch.clamp(pos + 0.3 * cfg.h * torch.from_numpy(
        rng.standard_normal((cfg.n, 2))), 0.0, 1.0)
    vel = torch.from_numpy(0.5 * rng.standard_normal((cfg.n, 2)))
    return (pos.to(device=device, dtype=cfg.torch_dtype),
            vel.to(device=device, dtype=cfg.torch_dtype))


def check_sph_ranges(sk, ts, device) -> dict:
    """#14 and #15 over SPH_RANGES against their plain versions over the
    same ranges (1e-5 / 1e-12 of the largest value) and bitwise against
    the whole launch's rows; #22 over SPH_WINDOWS bitwise against
    binning_plain on the same local set, and #14 and #15 over the windows
    against their plain versions over them; f32 and f64, or the script
    fails.  Returns the largest errors and the cases."""
    rng = np.random.default_rng(SEED + 23)
    out = {"density": 0.0, "forces": 0.0, "bitwise_rows": [0, 0],
           "bin_bitwise": [0, 0], "cases": 0}
    for dtype in ("float32", "float64"):
        cfg = ts.SPHConfig(n=SPH_RANGE_N, rain=False, dtype=dtype)
        tol = STEP_TOL[cfg.torch_dtype]
        pos, vel = sph_range_inputs(ts, cfg, device, rng)
        dt = torch.full((), 1e-3, dtype=pos.dtype, device=device)
        b = sk.binning(cfg, pos, vel)
        full = sk.density(cfg, b)
        fp, fv = sk.forces(cfg, b, full, dt)
        order = b.order.long()

        def held(what, got, ref, key):
            err, ab = max(rel_err(got[:, k], ref[:, k]) for k in (0, 1))
            if not err <= tol:
                raise AssertionError(f"{what} {dtype}: max rel err "
                                     f"{err:.3e} > {tol:g}")
            out[key] = max(out[key], ab)
            out["cases"] += 1

        for r0, r1 in SPH_RANGES:
            what = f"sph range [{r0}, {r1})"
            rp = sk.density(cfg, b, r0, r1)
            held(f"{what} density", rp, sk.density_plain(cfg, b, r0, r1),
                 "density")
            p, v = sk.forces(cfg, b, full, dt, r0, r1)
            pp, vp = sk.forces_plain(cfg, b, full, dt, r0, r1)
            mine = order[r0:r1]
            held(f"{what} forces", torch.cat([p[mine], v[mine]]),
                 torch.cat([pp[mine], vp[mine]]), "forces")
            same = (bits_equal(rp, full[r0:r1]) and bits_equal(p[mine],
                    fp[mine]) and bits_equal(v[mine], fv[mine]))
            if not same:
                raise AssertionError(f"{what} {dtype}: the range's rows "
                                     "differ from the whole launch's")
            out["bitwise_rows"][0] += 1
            out["bitwise_rows"][1] += 1
        g = cfg.grid()
        col = torch.clamp(torch.floor(pos[:, 0] / torch.full(
            (), g.cell, dtype=pos.dtype, device=device)), 0, g.Gx - 1)
        for gx0, gw in SPH_WINDOWS:
            what = f"sph window of columns [{gx0}, {gx0 + gw})"
            keep = ((col >= gx0) & (col < gx0 + gw)).nonzero()[:, 0]
            win = sk.Window(gx0, gw)
            pl, vl = pos[keep].contiguous(), vel[keep].contiguous()
            bw = sk.binning(cfg, pl, vl, win)
            for name, x, y in zip(bw._fields, bw,
                                  sk.binning_plain(cfg, pl, vl, win)):
                if not bits_equal(x, y):
                    raise AssertionError(f"bin {what} {dtype}: {name} "
                                         "differs from the plain version")
            out["bin_bitwise"][0] += 1
            out["bin_bitwise"][1] += 1
            rp = sk.density(cfg, bw, win=win)
            held(f"{what} density", rp, sk.density_plain(cfg, bw, win=win),
                 "density")
            p, v = sk.forces(cfg, bw, rp, dt, win=win)
            pp, vp = sk.forces_plain(cfg, bw, rp, dt, win=win)
            held(f"{what} forces", torch.cat([p, v]), torch.cat([pp, vp]),
                 "forces")
    log(f"[parallel] SPH kernels over ranges and windows at {SPH_RANGE_N} "
        f"particles, f32 and f64: {out['cases']} cases within 1e-5 / 1e-12 "
        f"of the plain versions (largest abs err density "
        f"{out['density']:.3e}, forces {out['forces']:.3e}); range rows "
        f"bitwise to the whole launch's in {out['bitwise_rows'][0]} of "
        f"{out['bitwise_rows'][1]}; the windowed bin bitwise in "
        f"{out['bin_bitwise'][0]} of {out['bin_bitwise'][1]}")
    return out


def check_bin_bucket(sk, ts, device) -> list:
    """#22 on counts that share a scratch (one power of two): first
    SPH_BUCKET_NS[0] particles with SPH_BUCKET_CLUSTERS packed into single
    cells (cells of more than the kernel's 512 members are listed), then
    the other counts, each bin bitwise to binning_plain on the same
    particles, f32 and f64, or the script fails.  Returns [bins bitwise,
    bins]."""
    rng = np.random.default_rng(SEED + 24)
    n = 0
    for dtype in ("float32", "float64"):
        cfg = ts.SPHConfig(n=SPH_RANGE_N, rain=False, dtype=dtype)
        pos, vel = sph_range_inputs(ts, cfg, device, rng)
        cell = cfg.grid().cell
        at = 0
        for (gx, gy), k in SPH_BUCKET_CLUSTERS:
            centre = torch.tensor([(gx + 0.5) * cell, (gy + 0.5) * cell],
                                  dtype=pos.dtype, device=device)
            pos[at:at + k] = centre + 0.2 * cell * (torch.from_numpy(
                rng.random((k, 2))).to(device=device, dtype=pos.dtype) - 0.5)
            at += k
        for m in SPH_BUCKET_NS:
            p, v = pos[:m].contiguous(), vel[:m].contiguous()
            for name, x, y in zip(sk.Binned._fields, sk.binning(cfg, p, v),
                                  sk.binning_plain(cfg, p, v)):
                if not bits_equal(x, y):
                    raise AssertionError(f"bin of {m} particles {dtype} after "
                                         f"a bin of {SPH_BUCKET_NS[0]}: "
                                         f"{name} differs from the plain "
                                         "version")
            n += 1
    log(f"[parallel] bin of {SPH_BUCKET_NS} particles in turn (one scratch; "
        f"the first with cells of {[k for _, k in SPH_BUCKET_CLUSTERS]} "
        f"members), f32 and f64: {n} of {n} bins bitwise to binning_plain")
    return [n, n]


def check_inflow_columns(h2, hk, interop, device) -> list:
    """p1 with the inflow at columns 0, HALO (rank 0's extended slab) and
    -1 (none) against its plain version on copies of the same perturbed
    state, f32 and f64, on 256x128 and 200x75: the wavespeed and every
    field (the in-place column) bitwise, or the script fails.  Returns
    [cases bitwise, cases]."""
    n = 0
    for dtype in ("float32", "float64"):
        for nx, ny in HYP2D_KERNEL_GRIDS[:2]:
            cfg = h2.default_config(nx=nx, ny=ny, dtype=dtype)
            s = perturbed_state(h2, interop, cfg, device)
            for col in (0, 2, -1):
                a, b = clone_U(s.U), clone_U(s.U)
                wk = hk.inflow_wavespeed(cfg, a, s.mask, col)
                wp = hk.inflow_wavespeed_plain(cfg, b, s.mask, col)
                if not (bits_equal(wk, wp) and all(
                        same(fa, fb) for fa, fb in zip(a, b))):
                    raise AssertionError(
                        f"p1 at inflow column {col}, {nx}x{ny} {dtype}: "
                        f"kernel {float(wk)!r} / plain {float(wp)!r}, or "
                        "the fields differ")
                n += 1
    log(f"[parallel] p1 at inflow columns 0, 2, -1: {n} of {n} cases "
        "bitwise equal to the plain version")
    return [n, n]


def stirred_state(runners, name: str, fields: dict, world: int):
    """init() of the runner's solver on the CPU, PARALLEL_STIR's noise
    (seeded) and drift added to the velocities."""
    r = runners.RUNNERS[name]
    st = r.solver.init(r.config(**fields), torch.device("cpu"))
    amp, drift = PARALLEL_STIR[name]
    rng = np.random.default_rng(SEED + 26 + world)
    add = amp * rng.standard_normal(tuple(st.vel.shape)) + [drift, 0.0]
    return st._replace(vel=st.vel + torch.from_numpy(add).to(st.vel.dtype))


def parallel_cases(world: int, runners) -> list:
    """The runs of PARALLEL_RUNS at `world` (1: every runner; 2: the 1-D
    runners; 4: the 2x2 mesh; 2 and 4: the SPH and spatial runners at
    PARALLEL_MULTI's sizes, stirred as PARALLEL_STIR says), each compared
    on rank 0 with the one-device run."""
    out = []
    for name, (fields, n1, n2, _) in PARALLEL_RUNS.items():
        mesh2d = name.endswith("mesh2d")
        if world == 1 or (world == 4) == mesh2d or name in PARALLEL_MULTI:
            if world > 1:
                fields = PARALLEL_MULTI.get(name, fields)
            case = dict(name=name, config=fields,
                        steps=n1 if world == 1 else n2, dense=True,
                        mesh2d=((1, 1) if world == 1 else (2, 2))
                        if mesh2d else None)
            if world > 1 and name in PARALLEL_STIR:
                case["state"] = stirred_state(runners, name, fields, world)
            out.append(case)
    return out


def check_parallel_run(r: dict) -> None:
    """A run's bars: PARALLEL_RUNS' on the largest relative error (sph:
    bitwise at every world), PARALLEL_LEAF_BARS' on each leaf, no particle
    lost, and a spatial run of more than one rank moved particles between
    ranks."""
    name, world = r["name"], r["world"]
    bar = PARALLEL_RUNS[name][3]
    if name in PARALLEL_EXACT and not r["bitwise"]:
        raise AssertionError(f"{name} at world {world}: not bitwise equal "
                             "to the one-device run")
    if name in PARALLEL_LAUNCHES:
        mod, want = PARALLEL_LAUNCHES[name]
        for rank, got in enumerate(r.get("launches_per_rank",
                                         [r["launches"]])):
            if got != {mod: want(r["steps"])}:
                raise AssertionError(
                    f"{name} at world {world}, rank {rank}: launches {got} "
                    f"in {r['steps']} steps, want {{{mod!r}: "
                    f"{want(r['steps'])}}}")
    if bar is not None and r["max_rel_err"] > bar:
        raise AssertionError(f"{name} at world {world}: max rel err "
                             f"{r['max_rel_err']:.3e} > {bar:g}")
    for k, (err, leaf_bar) in enumerate(zip(
            r["max_abs_err"], PARALLEL_LEAF_BARS.get(name, ()))):
        if leaf_bar is not None and not err <= leaf_bar:
            raise AssertionError(f"{name} at world {world}: leaf {k} max abs "
                                 f"err {err!r} > {leaf_bar:g}")
    if r.get("lost", 0):
        raise AssertionError(f"{name} at world {world}: {r['lost']} "
                             "particles lost")
    if "moved" in r and world > 1 and not r["moved"] > 0:
        raise AssertionError(f"{name} at world {world}: no particle changed "
                             "ranks, so the migration carried nothing")


# The Stam kernels at the sharded runners' shapes (phase 26).  #9 on
# (ny, nx) fields, launched in turn on one stream: the x-slab runner's
# round slabs of 512^2 (an edge rank's 512x136 and an inner rank's 512x144
# at world 4, 512x264 at world 2, kb = 8), a ragged 65x9 and the whole
# 512^2, so that a scratch or a grid query shared between shapes would
# show
STAM_RECT_SHAPES = ((512, 136), (512, 144), (65, 9), (512, 264), (512, 512))
# #10 over the column windows of every rank at these worlds of 512^2, with
# these exchanged columns (16: the runner's default; 2: clamps at dt = 1)
# and with n / D, the most the runner takes
STAM_WINDOW_WORLDS = (2, 4)
STAM_WINDOW_HALOS = (16, 2)
# #11 over windows of 192^3 (194 slices, padded to 196 at world 4): (first
# global slice, slices): world 4's rank 0 with 4 exchanged slices (the
# bottom face inside), an inner rank's (no face), the last rank's (the top
# face inside, then padding), the faces on a window's end slice, and the
# whole volume
STAM_SLABS = ((-4, 57), (45, 57), (143, 57), (0, 10), (186, 8), (0, 194))
# The clamp runs of the x-slab runner at world 2 on 512^2 at dt = 1, one
# step: the exchanged columns (2, and the default 16)
STAM2D_CLAMP_RUNS = (dict(advect_halo=2), dict())


def check_stam_rects(s2k, device) -> list:
    """#9 on STAM_RECT_SHAPES in turn, at 1, h, h + 1 and 40 sweeps (h:
    sweeps a grid sync), f32 and f64: bitwise to the plain solve, x
    unchanged, ceil(sweeps / h) - 1 grid syncs as the kernel counted them
    on that shape's slot words, or the script fails.  Returns [cases
    bitwise, cases]."""
    n = 0
    for dtype in (torch.float32, torch.float64):
        inputs = {}
        for k, (ny, nx) in enumerate(STAM_RECT_SHAPES):
            rng = np.random.default_rng(SEED + 90 + k)
            inputs[(ny, nx)] = [torch.tensor(rng.random((ny, nx)),
                                             dtype=dtype, device=device)
                                for _ in range(2)]
        h = s2k.solve_launch(512, dtype, device.index, 136).halo
        for iters in (1, h, h + 1, 40):
            for (ny, nx), (x, b) in inputs.items():
                keep = x.clone()
                got = s2k.lin_solve(x, b, 0.26, 2.04, iters)
                syncs = s2k.solve_grid_syncs(ny, dtype, device, nx)
                ref = s2k.lin_solve_plain(x, b, 0.26, 2.04, iters)
                what = f"lin_solve {ny}x{nx} {dtype} {iters} sweeps"
                if not (bits_equal(got, ref) and torch.equal(x, keep)):
                    raise AssertionError(f"{what}: not bitwise equal to the "
                                         "plain solve, or x written")
                if syncs != -(-iters // h) - 1:
                    raise AssertionError(f"{what}: {syncs} grid syncs, want "
                                         f"{-(-iters // h) - 1}")
                n += 1
    log(f"[parallel] #9 on {STAM_RECT_SHAPES} in turn, 1, h, h + 1 and 40 "
        f"sweeps, f32 and f64: {n} of {n} bitwise to the plain solve, the "
        "grid syncs as counted")
    return [n, n]


def check_stam_windows(s2k, s2, device) -> dict:
    """#10 over the columns of every rank at STAM_WINDOW_WORLDS of 512^2,
    with STAM_WINDOW_HALOS and n / D exchanged columns, one field and the
    velocity pair, on init()'s swirl at dt = 1, f32 and f64: bitwise to the
    plain windowed version, the clamp counts equal, the pair's twice the
    one field's, and some clamped at 2 columns, or the script fails.
    Returns the cases and the clamps counted."""
    import torch.nn.functional as F

    out = {"cases": [0, 0], "clamped": {}}
    for dtype in ("float32", "float64"):
        cfg = s2.Stam2DConfig(n=512, dtype=dtype)
        st = s2.init(cfg, device)
        q, q2 = stam2d_fields(512, cfg.torch_dtype, device, SEED + 91, 2)
        for world in STAM_WINDOW_WORLDS:
            nl = 512 // world
            for h in STAM_WINDOW_HALOS + (nl,):
                pads = [F.pad(f, (h, h)) for f in (q, q2)]
                total = {1: 0, 2: 0}
                for r in range(world):
                    c = slice(r * nl, (r + 1) * nl)
                    uu, vv = st.u[:, c].contiguous(), st.v[:, c].contiguous()
                    win = s2k.Window(r * nl, h)
                    for nf in (1, 2):
                        slabs = tuple(f[:, r * nl:(r + 1) * nl + 2 * h]
                                      .contiguous() for f in pads[:nf])
                        ok, op = (torch.zeros((), dtype=torch.int32,
                                              device=device)
                                  for _ in range(2))
                        got = s2k.advect(cfg, slabs, uu, vv, win, ok)
                        ref = s2k.advect_plain(cfg, slabs, uu, vv, win, op)
                        out["cases"][1] += 1
                        if not (all(bits_equal(a, b)
                                    for a, b in zip(got, ref))
                                and int(ok) == int(op)):
                            raise AssertionError(
                                f"advect window {win} of {nl} columns, "
                                f"{nf} field(s) {dtype}: kernel count "
                                f"{int(ok)}, plain {int(op)}, or the fields "
                                "differ")
                        out["cases"][0] += 1
                        total[nf] += int(ok)
                if total[2] != 2 * total[1] or (h == 2 and total[1] == 0):
                    raise AssertionError(f"advect windows at world {world}, "
                                         f"h={h} {dtype}: clamps {total}")
                out["clamped"][f"world {world} h={h} {dtype}"] = total[1]
    log(f"[parallel] #10 over the windows of worlds {STAM_WINDOW_WORLDS} "
        f"of 512^2, h = {STAM_WINDOW_HALOS} and n / D, one field and the "
        f"pair, f32 "
        f"and f64: {out['cases'][0]} of {out['cases'][1]} bitwise to the "
        f"plain version with equal counts; cells clamped (one field, all "
        f"ranks) {out['clamped']}")
    return out


def check_stam_slabs(sc, s3, s3s, device) -> dict:
    """#11 over STAM_SLABS of 192^3: 4 sweeps of the runner's round
    (stam3d_sharded._sweeps) from an even and from an odd sweep of the
    solve, the kernel against its plain version, bitwise (the bar of
    phase 15's #11 checks); then the runner's rounds at one rank
    (halo_k 1-4, 12 sweeps, the window of zero slices a side) against the
    one-device plain solve, bitwise, f32 and f64, or the script fails.
    Returns [cases bitwise, cases]."""
    from fluidsims_tpu_torch.parallel.mesh import Mesh

    n, Np = 192, 194
    one = Mesh(("x",), (1,), 0, device, "nccl")   # no collective runs
    k = 0
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(SEED + 92)
        x, xe, b = (torch.tensor(rng.standard_normal((Np,) * 3), dtype=dtype,
                                 device=device) for _ in range(3))

        def window(t, g0, w):
            lo, hi = max(g0, 0), min(g0 + w, Np)
            return torch.cat([t.new_zeros((lo - g0, Np, Np)), t[lo:hi],
                              t.new_zeros((g0 + w - hi, Np, Np))])

        for g0, w in STAM_SLABS:
            ring = s3s._ring_mask(g0, w, Np, device)
            args = (window(x, g0, w), window(xe, g0, w), window(b, g0, w),
                    ring, 1.0, 6.0, g0)
            for done in (0, 1):
                got = s3s._sweeps(*args, done, 4, jacobi=sc.jacobi)
                ref = s3s._sweeps(*args, done, 4, jacobi=sc.jacobi_plain)
                if not bits_equal(got, ref):
                    raise AssertionError(f"jacobi slab ({g0}, {w}) {dtype} "
                                         f"from sweep {done}: differs from "
                                         "the plain version")
                k += 1
        cfg = s3.Stam3DConfig(n=n, dtype="float32" if dtype == torch.float32
                              else "float64")
        ref = s3._lin_solve(cfg, x, b, 1.0, 6.0)
        for halo_k in (1, 2, 3, 4):
            got = s3s._lin_solve_sharded(x, b, 1.0, 6.0, 12, halo_k, Np, 0,
                                         one, "x")
            if not bits_equal(got, ref):
                raise AssertionError(f"stam3d solve at one rank, halo_k "
                                     f"{halo_k} {dtype}: differs from the "
                                     "one-device plain solve")
            k += 1
    log(f"[parallel] #11 over slabs {STAM_SLABS} of 192^3 from even and odd "
        f"sweeps, and the one-rank solve at halo_k 1-4, f32 and f64: {k} of "
        f"{k} bitwise to the plain versions")
    return [k, k]


def time_stam_shapes(s2k, s2, sc, s3s, device) -> dict:
    """ms a launch (CUDA events) of the Stam kernels at the sharded
    runners' shapes, f32, beside the plain versions and the bounds: #9 on
    the round slabs of 512^2 (8 sweeps), #10 over a rank's window at
    worlds 2 and 4 (the velocity pair, h = 16), #11 over an inner rank's
    slab and rank 0's of 192^3 at world 4."""
    import torch.nn.functional as F

    dt = torch.float32
    T = 4
    res = {}
    rng = np.random.default_rng(SEED + 93)
    for ny, nx in STAM_RECT_SHAPES[:2] + STAM_RECT_SHAPES[3:4]:
        x, b = (torch.tensor(rng.random((ny, nx)), dtype=dt, device=device)
                for _ in range(2))
        res[f"lin_solve {ny}x{nx} 8 sweeps"] = {
            "ms": time_launches(lambda: s2k.lin_solve(x, b, 1.0, 4.0, 8),
                                50),
            "plain_ms": time_launches(
                lambda: s2k.lin_solve_plain(x, b, 1.0, 4.0, 8), 5),
            "bound": bound(3 * ny * nx * T,
                           STAM2D_SOLVE_OPS_PER_CELL_SWEEP * 8 * ny * nx, dt)}
    cfg = s2.Stam2DConfig(n=512)
    st = s2.init(cfg, device)
    ops0, ops_field = STAM2D_ADVECT_OPS
    for world in STAM_WINDOW_WORLDS:
        nl, h = 512 // world, 16
        c = slice(nl, 2 * nl)
        slabs = tuple(F.pad(f, (h, h))[:, nl:2 * nl + 2 * h].contiguous()
                      for f in (st.u, st.v))
        uu, vv = st.u[:, c].contiguous(), st.v[:, c].contiguous()
        ovf = torch.zeros((), dtype=torch.int32, device=device)
        win = s2k.Window(c.start, h)
        res[f"advect pair, window {nl} of 512 columns, h=16"] = {
            "ms": time_launches(lambda: s2k.advect(cfg, slabs, uu, vv, win,
                                                   ovf), 100),
            "plain_ms": time_launches(lambda: s2k.advect_plain(
                cfg, slabs, uu, vv, win, ovf), 20),
            "bound": bound((2 * 512 * nl + 2 * 512 * (nl + 2 * h)
                            + 2 * 512 * nl + 3 * nl) * T,
                           (ops0 + 2 * ops_field) * 512 * nl, dt)}
    n, Np = 192, 194
    for g0, w in STAM_SLABS[:2]:
        x, x0, out = (torch.tensor(rng.standard_normal((w, Np, Np)),
                                   dtype=dt, device=device) for _ in range(3))
        m = min(w - 2, n - g0) - max(1, 1 - g0) + 1
        res[f"jacobi slab ({g0}, {w}) of 192^3"] = {
            "ms": time_launches(lambda: sc.jacobi(x, x0, out, 1.0, 6.0, g0),
                                50),
            "plain_ms": time_launches(
                lambda: sc.jacobi_plain(x, x0, out, 1.0, 6.0, g0), 20),
            "bound": bound((3 * m * n * n + 2 * n * n + 4 * m * n) * T,
                           STAM3D_JACOBI_OPS_PER_CELL * m * n * n, dt)}
    for key, r in res.items():
        log(f"[parallel] {key} f32: {r['ms']:.4f} ms vs plain "
            f"{r['plain_ms']:.4f} ms (bound {r['bound'][0]:.5f} ms, "
            f"{r['bound'][1]})")
    return res


def stam2d_clamp_ranks(fields: dict, steps: int, runs: tuple, device):
    """On each rank of a gloo group: the x-slab runner on init() of
    Stam2DConfig(**fields) with each options dict of `runs`, once on the
    kernels and once with the wrappers' plain versions in their place (the
    plain composition); rank 0 returns, per run, both gathered clamp
    counts, whether the states are bitwise equal, and the kernels'
    launches."""
    from fluidsims_tpu_torch.kernels import stam2d_cuda as s2k
    from fluidsims_tpu_torch.parallel import mesh as pm
    from fluidsims_tpu_torch.parallel import stam2d_sharded as s2s
    from fluidsims_tpu_torch.solvers import stam2d as s2

    m = pm.make_mesh_1d(device=device)
    cfg = s2.Stam2DConfig(**fields)
    s0 = s2.init(cfg, m.device)
    kernels = (s2k.lin_solve, s2k.advect)
    out = []
    for options in runs:
        got = []
        for plain in (False, True):
            if plain:
                s2k.lin_solve, s2k.advect = (s2k.lin_solve_plain,
                                             s2k.advect_plain)
            try:
                s2k.reset_launches()
                run = s2s.make_sharded_run(cfg, m, steps, **options)
                got.append((s2s.gather_state(run(s2s.shard_state(s0, m)), m),
                            dict(s2k.LAUNCHES)))
            finally:
                s2k.lin_solve, s2k.advect = kernels
        (a, la), (b, lb) = got
        out.append({"options": options, "ovf": int(a.ovf),
                    "ovf_plain": int(b.ovf), "launches": la,
                    "launches_plain": lb,
                    "bitwise": all(bits_equal(x, y) for x, y in zip(a, b))})
    return out if m.rank == 0 else None


def check_stam2d_clamps(device) -> list:
    """STAM2D_CLAMP_RUNS at world 2 on gloo, the ranks sharing the card:
    each run's clamp count equal to the plain composition's, its state
    bitwise equal, and > 0 (at dt = 1 on the init swirl), the kernels
    launched as the composition implies, or the script fails."""
    from fluidsims_tpu_torch.parallel import launch

    res = launch.spawn(stam2d_clamp_ranks, 2, "gloo",
                       args=(dict(n=512), 1, STAM2D_CLAMP_RUNS, device),
                       timeout=300)[0]
    want = PARALLEL_LAUNCHES["stam2d"][1](1)
    for r in res:
        if not (r["ovf"] == r["ovf_plain"] > 0 and r["bitwise"]
                and r["launches"] == want
                and not any(r["launches_plain"].values())):
            raise AssertionError(f"stam2d clamp run at world 2: {r}")
        log(f"[parallel] stam2d 512^2 world 2, dt = 1, options "
            f"{r['options']}: ovf {r['ovf']} (plain composition "
            f"{r['ovf_plain']}), state bitwise equal to the plain "
            f"composition's; launches {r['launches']}")
    return res


def phase_stam_kernels(device) -> dict:
    """Phase 26's checks of #9, #10 and #11 at the sharded runners'
    shapes, their times there, and the stam2d clamp runs."""
    from fluidsims_tpu_torch.kernels import stam2d_cuda as s2k
    from fluidsims_tpu_torch.kernels import stam3d_cuda as sc
    from fluidsims_tpu_torch.parallel import stam3d_sharded as s3s
    from fluidsims_tpu_torch.solvers import stam2d as s2
    from fluidsims_tpu_torch.solvers import stam3d as s3

    return {"rects": check_stam_rects(s2k, device),
            "windows": check_stam_windows(s2k, s2, device),
            "slabs": check_stam_slabs(sc, s3, s3s, device),
            "times": time_stam_shapes(s2k, s2, sc, s3s, device),
            "clamps": check_stam2d_clamps(device)}


def stam_line_fields(stam: dict) -> dict:
    """The fields phase 26 adds to the lines of #9, #10 and #11."""
    t = stam["times"]

    def timed(prefix):
        return {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                    "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
                for k, v in t.items() if k.startswith(prefix)}

    return {
        "stam2d_lin_solve": {"rect_bitwise_cases": stam["rects"],
                             "sharded_shapes": timed("lin_solve")},
        "stam2d_advect": {"window_bitwise_cases": stam["windows"]["cases"],
                          "window_clamped": stam["windows"]["clamped"],
                          "clamp_runs": [
                              {k: r[k] for k in ("options", "ovf",
                                                 "ovf_plain", "bitwise")}
                              for r in stam["clamps"]],
                          "sharded_shapes": timed("advect")},
        "stam3d_jacobi": {"slab_bitwise_cases": stam["slabs"],
                          "sharded_shapes": timed("jacobi")}}


def phase_parallel(hk, h2, sk, ts, interop, device, smi) -> dict:
    """Phase 26: p1's inflow columns; the SPH kernels over ranges and
    windows, and the bin on counts that share a scratch; the Stam kernels
    at the sharded shapes and the stam2d clamp runs (phase_stam_kernels);
    (a) every runner at world 1 on 'nccl' in this process, each
    equal to the one-device run on the card bitwise (PARALLEL_TO_BAR
    within its bar), its kernels' launches counted, its rate beside the
    one-device run's; (b) world 2 (the 1-D runners) and world 4 (the 2x2
    mesh), and both for the SPH and spatial runners, on 'gloo', ranks
    sharing cuda:0 (the collectives staged through the host), within
    PARALLEL_RUNS' and PARALLEL_LEAF_BARS' bars, no particle lost, the
    spatial runners from stirred states, each moving particles between
    ranks.  A failed rank fails the run."""
    import tempfile

    import torch.distributed as dist

    from fluidsims_tpu_torch.parallel import launch, runners

    t_phase = time.perf_counter()
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[parallel] compute mode {mode}; {smi}")
    p1_cases = check_inflow_columns(h2, hk, interop, device)
    sph_ranges = check_sph_ranges(sk, ts, device)
    bin_bucket = check_bin_bucket(sk, ts, device)
    stam = phase_stam_kernels(device)

    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/rdv",
                                rank=0, world_size=1)
        try:
            # the communicator forms at the first collective: not in a run
            dist.all_reduce(torch.zeros(1, device=device))
            torch.cuda.synchronize()
            res_a = runners.run_cases(parallel_cases(1, runners), device)
            next(r for r in res_a if r["name"] == "nbody").update(
                nbody_dense_repeat(runners, device))
        finally:
            dist.destroy_process_group()
    counts = {src: 0 for src in DRIVER_COUNTERS}
    for r in res_a:
        for mod, c in r["launches"].items():
            for src, (m, keys) in DRIVER_COUNTERS.items():
                if m == PARALLEL_MODS[mod]:
                    counts[src] += sum(c.get(k, 0) for k in keys)
    idle = [src for src in PARALLEL_KERNELS if counts[src] == 0]
    if idle:
        raise AssertionError(f"the sharded runners launched no {idle}")
    log_parallel(res_a)
    for r in res_a:
        name = r["name"]
        exact = name not in PARALLEL_TO_BAR and (
            name != "nbody" or r["dense_repeat_bitwise"])
        if exact and not r["bitwise"]:
            raise AssertionError(f"{name} at world 1: not bitwise equal to "
                                 f"the one-device run (max rel err "
                                 f"{r['max_rel_err']:.3e})")
        check_parallel_run(r)

    res_b = []
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = launch.spawn(runners.run_cases, world, "gloo",
                             args=(parallel_cases(world, runners), device),
                             timeout=600)
        log(f"[parallel] world {world} on gloo, ranks sharing {device}: "
            f"{time.perf_counter() - t0:.1f} s with the ranks' start")
        for i, r in enumerate(ranks[0]):
            r["launches_per_rank"] = [rk[i]["launches"] for rk in ranks]
            r["seconds_per_rank"] = [rk[i]["seconds"] for rk in ranks]
        for i, r in enumerate(ranks[0]):
            if "receivers" in r:
                r["receivers_per_rank"] = [rk[i]["receivers"]
                                           for rk in ranks]
        log_parallel(ranks[0])
        for r in ranks[0]:
            check_parallel_run(r)
            res_b.append(r)

    log(f"[parallel] phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return {"counts": counts, "lines": [parallel_line(r)
                                        for r in res_a + res_b],
            "compute_mode": mode, "inflow_col_cases": p1_cases,
            "sph_ranges": sph_ranges, "bin_bucket": bin_bucket,
            "stam": stam_line_fields(stam)}


def parallel_line(r: dict) -> dict:
    """One run's entry of the {"parallel": ...} line."""
    return {
        "runner": r["name"], "world": r["world"], "backend": r["backend"],
        "steps": r["steps"], "max_rel_err": r["max_rel_err"],
        "bitwise": r["bitwise"],
        "launches_per_rank": r.get("launches_per_rank", [r["launches"]]),
        "steps_per_s_host": r["steps"] / max(
            r.get("seconds_per_rank", [r["seconds"]])),
        "steps_per_s_note": ("gloo-staged on one card, no scaling figure"
                             if r["backend"] == "gloo" else
                             "one rank, first calls included"),
        "dense_steps_per_s_host": r["steps"] / r["dense_seconds"],
        "max_abs_err": r["max_abs_err"],
        **{k: r[k] for k in ("dense_repeat_bitwise", "dense_repeat_rel_err",
                             "lost", "moved", "receivers_per_rank")
           if k in r}}


def log_parallel(results: list) -> None:
    for r in results:
        line = parallel_line(r)
        log(f"[parallel] {r['name']} world {r['world']} {r['backend']}: "
            f"{r['steps']} steps, max rel err {r['max_rel_err']:.3e}, "
            f"bitwise {r['bitwise']}, {line['steps_per_s_host']:.2f} "
            f"steps/s (host clock; one device "
            f"{line['dense_steps_per_s_host']:.2f})"
            + (f"; lost {r['lost']}, moved {r['moved']}" if "lost" in r
               else "")
            + (f"; [halo, all] receivers a rank "
               f"{r.get('receivers_per_rank', [r['receivers']])}"
               if "receivers" in r else "")
            + (f"; two one-device runs bitwise {r['dense_repeat_bitwise']}, "
               f"apart {r['dense_repeat_rel_err']:.3e}"
               if "dense_repeat_bitwise" in r else ""))


def nbody_dense_repeat(runners, device) -> dict:
    """Whether two one-device n-body runs of PARALLEL_RUNS' case give the
    same bits (the springs' index_add_ adds with atomics on the card), and
    how far apart their positions are (runners.max_rel_err's measure)."""
    fields, n, _, _ = PARALLEL_RUNS["nbody"]
    r = runners.RUNNERS["nbody"]
    cfg = r.config(**fields)
    a = runners.run_dense("nbody", cfg, r.solver.init(cfg, device), n)
    b = runners.run_dense("nbody", cfg, r.solver.init(cfg, device), n)
    err, same = runners.max_rel_err("nbody", a, b, 1)
    return {"dense_repeat_bitwise": same, "dense_repeat_rel_err": err}


# ------------------------------ analytic gates -------------------------------

# Phase 27: the JAX suite's analytic gates (tests/analytic_gates.py, whose
# docstrings name each JAX gate) on the card, each held to its JAX bars:
# gate -> (its keywords, the kernel sources it must launch and no other).
# The convergence ladder goes on to 800 and 1600 cells; Poiseuille runs
# once on the K-step kernel (block_k 8) and once on the one-step kernel
# (block_k 1).
HYP2D_SOURCES = ("hypersonic2d_step.cu", "hypersonic2d_wavespeed.cu")
ANALYTIC_GATES = {
    "sod_2d": ({}, HYP2D_SOURCES),
    "double_rarefaction": ({}, HYP2D_SOURCES),
    "sod_3d": ({}, ("hypersonic3d_step.cu", "hypersonic3d_wavespeed.cu",
                    "hypersonic3d_pad.cu")),
    "mhd_hydro_limit": ({}, ("mhd_multistep.cu",)),
    "dam_break": ({}, ("shallow_water_multistep.cu",)),
    "convergence": ({"ladder": (100, 200, 400, 800, 1600)}, HYP2D_SOURCES),
    "long_horizon": ({}, HYP2D_SOURCES),
    "poiseuille": ({"block_ks": (8, 1)}, ("lbm_multistep.cu", "lbm_step.cu")),
    "cole_hopf": ({}, ("burgers_multistep.cu",)),
    "standing_wave": ({}, ("shallow_water_multistep.cu",)),
}
# The long-horizon comparison at the flagship's default_config(), a reading
# beside the bar (JAX measured it at 128x64 only)
FULL_WIDTH = {"nx": 8192, "ny": 1024}


def launch_counts(mods: dict) -> dict:
    """Each kernel source's launches so far (DRIVER_COUNTERS)."""
    return {src: sum(mods[m].LAUNCHES[k] for k in keys)
            for src, (m, keys) in DRIVER_COUNTERS.items()}


def run_gate(gate_fn, kw: dict, mods: dict, device) -> tuple:
    """One gate on the card: (the gate, the sources it launched and how
    often, its seconds on the host clock)."""
    before = launch_counts(mods)
    t0 = time.perf_counter()
    gate = gate_fn(device, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {src: n - before[src]
                for src, n in launch_counts(mods).items() if n > before[src]}
    return gate, launched, secs


def gate_line(gate, launched: dict, secs: float) -> dict:
    """One gate's entry of the {"analytic_gates": ...} line."""
    return {"errors": {k: v for k, (v, _, _) in gate.readings.items()},
            "bars": {k: [op, bar] for k, (_, op, bar) in
                     gate.readings.items()},
            "info": gate.info, "steps": gate.steps, "kernels": launched,
            "seconds": secs}


def repo_tests_module(name: str):
    """tests/<name>.py of this checkout.  The checkout's tests/ is a
    namespace package, which an installed regular package named `tests`
    shadows wherever it sits on sys.path, so it is bound as `tests`
    first."""
    import importlib
    import types

    pkg = types.ModuleType("tests")
    pkg.__path__ = [str(pathlib.Path(__file__).resolve().parent / "tests")]
    sys.modules["tests"] = pkg
    return importlib.import_module(f"tests.{name}")


def phase_analytic_gates(mods: dict, device, smi) -> dict:
    """Phase 27: every gate of ANALYTIC_GATES on the card through the
    solvers' entry points; a gate fails the run if it misses a bar,
    launched no time a kernel it names or launched another; then the
    long-horizon comparison at FULL_WIDTH as a reading.  Every counter is
    set to 0 first; the launches of the phase go into each kernel line as
    launches_analytic."""
    ag = repo_tests_module("analytic_gates")
    t_phase = time.perf_counter()
    for m in mods.values():
        m.reset_launches()
    gates = {}
    for name, (kw, sources) in ANALYTIC_GATES.items():
        gate, launched, secs = run_gate(getattr(ag, name), kw, mods, device)
        line = gates[name] = gate_line(gate, launched, secs)
        log(f"[analytic] {name}: {line['errors']} ({gate.steps} steps, "
            f"{secs:.2f} s; launches {launched}; {smi})")
        gate.check()
        idle = [src for src in sources if not launched.get(src)]
        stray = sorted(set(launched) - set(sources))
        if idle or stray:
            raise AssertionError(f"gate {name} launched no {idle} or other "
                                 f"kernels {stray}: {launched}")
    gate, launched, secs = run_gate(ag.long_horizon, FULL_WIDTH, mods,
                                    device)
    full = gate_line(gate, launched, secs)
    full["misses"] = sorted(gate.misses())
    log(f"[analytic] {gate.name} (a reading): {full['errors']}; misses "
        f"{full['misses']} "
        f"({secs:.2f} s; {smi})")
    log(f"[analytic] phase 27 took {time.perf_counter() - t_phase:.1f} s")
    return {"gates": gates, "full_width": full,
            "launches": launch_counts(mods)}


def main() -> int:
    smi = phase_device()
    from fluidsims_tpu_torch import interop, regression
    from fluidsims_tpu_torch.core.clock import cfl_dt
    from fluidsims_tpu_torch.io import fourspl
    from fluidsims_tpu_torch.kernels import _build
    from fluidsims_tpu_torch.kernels import gray_scott_cuda as gk
    from fluidsims_tpu_torch.kernels import hypersonic2d_cuda as hk
    from fluidsims_tpu_torch.kernels import hypersonic3d_cuda as hk3
    from fluidsims_tpu_torch.kernels import lbm_cuda as lk
    from fluidsims_tpu_torch.kernels import sph_cuda as sk
    from fluidsims_tpu_torch.solvers import gray_scott as gs
    from fluidsims_tpu_torch.solvers import hypersonic2d as h2
    from fluidsims_tpu_torch.solvers import hypersonic3d as h3
    from fluidsims_tpu_torch.solvers import lbm
    from fluidsims_tpu_torch.solvers import sph as ts
    from fluidsims_tpu_torch.solvers import th3cs
    from fluidsims_tpu_torch.kernels import burgers_cuda as bk
    from fluidsims_tpu_torch.kernels import mhd_cuda as mk
    from fluidsims_tpu_torch.kernels import shallow_water_cuda as swk
    from fluidsims_tpu_torch.solvers import burgers as bg
    from fluidsims_tpu_torch.solvers import mhd
    from fluidsims_tpu_torch.solvers import shallow_water as swm
    from fluidsims_tpu_torch.kernels import stam3d_cuda as sc
    from fluidsims_tpu_torch.solvers import stam3d as s3
    from fluidsims_tpu_torch.kernels import stam2d_cuda as s2k
    from fluidsims_tpu_torch.solvers import stam2d as s2
    from fluidsims_tpu_torch.kernels import flip_cuda as fk
    from fluidsims_tpu_torch.solvers import flip_apic as fa
    from fluidsims_tpu_torch.kernels import mpm_cuda as mpk
    from fluidsims_tpu_torch.solvers import mpm as mp
    from fluidsims_tpu_torch.kernels import nbody_cuda as nk
    from fluidsims_tpu_torch.solvers import nbody_graph as ng

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build(hk, _build)
    sk.load()
    hk3.load()
    gk.load()
    lk.load()
    bk.load()
    swk.load()
    mk.load()
    sc.load()
    s2k.load()
    fk.load()
    mpk.load()
    nk.load()
    errs = phase_kernels(h2, hk, interop, cfl_dt, device)
    sk.reset_launches()
    main_res = phase_main(h2, hk, regression, cfl_dt, device, smi, errs)
    if any(any(m.LAUNCHES.values()) for m in (sk, s2k, fk)):
        raise AssertionError(f"the hypersonic path launched other kernels: "
                             f"{sk.LAUNCHES} {s2k.LAUNCHES} {fk.LAUNCHES}")
    sph_errs = phase_sph_kernels(sk, ts, device)
    hk.reset_launches()
    sph_res = phase_sph_main(sk, ts, device, smi, sph_errs)
    if any(any(m.LAUNCHES.values()) for m in (hk, s2k, fk)):
        raise AssertionError(f"the SPH path launched other kernels: "
                             f"{hk.LAUNCHES} {s2k.LAUNCHES} {fk.LAUNCHES}")
    hyp3d_errs = phase_hyp3d_kernels(h3, hk3, interop, device)
    hk.reset_launches()
    sk.reset_launches()
    hyp3d_res = phase_hyp3d_main(h3, hk3, device, smi, hyp3d_errs)
    th3cs_res = phase_th3cs(h3, hk3, th3cs, fourspl, device, smi)
    if any(any(m.LAUNCHES.values()) for m in (hk, sk, s2k, fk)):
        raise AssertionError(f"the 3-D path launched other kernels: "
                             f"{hk.LAUNCHES} {sk.LAUNCHES} {s2k.LAUNCHES} "
                             f"{fk.LAUNCHES}")
    stencil_errs = phase_stencil_kernels(gs, lbm, gk, lk, device)
    for m in (hk, sk, hk3):
        m.reset_launches()
    stencil_res = phase_stencil_main(gs, lbm, gk, lk, device, smi,
                                     stencil_errs)
    others = [dict(m.LAUNCHES) for m in (hk, sk, hk3, bk, swk, mk, s2k, fk)]
    if any(any(o.values()) for o in others):
        raise AssertionError(f"the stencil path launched other kernels: "
                             f"{others}")
    mods = resident_mods(bg, swm, mhd, bk, swk, mk)
    resident_errs = phase_resident_kernels(mods, bg, swm, mhd, device)
    for m in (hk, sk, hk3, gk, lk):
        m.reset_launches()
    resident_res = phase_resident_main(mods, device, smi, resident_errs)
    others = [dict(m.LAUNCHES) for m in (hk, sk, hk3, gk, lk, sc, s2k, fk)]
    if any(any(o.values()) for o in others):
        raise AssertionError(f"the resident path launched other kernels: "
                             f"{others}")
    stam3d_errs = phase_stam3d_kernels(sc, s3, device)
    for m in (hk, sk, hk3, gk, lk, bk, swk, mk):
        m.reset_launches()
    stam3d_res = phase_stam3d_main(sc, s3, device, smi, stam3d_errs)
    others = [dict(m.LAUNCHES) for m in (hk, sk, hk3, gk, lk, bk, swk, mk,
                                         s2k, fk)]
    if any(any(o.values()) for o in others):
        raise AssertionError(f"the stam3d path launched other kernels: "
                             f"{others}")
    stam2d_errs = phase_stam2d_kernels(s2k, s2, device)
    for m in (hk, sk, hk3, gk, lk, bk, swk, mk, sc):
        m.reset_launches()
    stam2d_res = phase_stam2d_main(s2k, s2, device, smi, stam2d_errs)
    others = [dict(m.LAUNCHES) for m in (hk, sk, hk3, gk, lk, bk, swk, mk,
                                         sc, fk)]
    if any(any(o.values()) for o in others):
        raise AssertionError(f"the stam2d path launched other kernels: "
                             f"{others}")
    flip_errs = phase_flip_kernels(fk, fa, device)
    for m in (hk, sk, hk3, gk, lk, bk, swk, mk, sc, s2k):
        m.reset_launches()
    flip_res = phase_flip_main(fk, fa, device, smi, flip_errs)
    others = [dict(m.LAUNCHES) for m in (hk, sk, hk3, gk, lk, bk, swk, mk,
                                         sc, s2k)]
    if any(any(o.values()) for o in others):
        raise AssertionError(f"the flip path launched other kernels: "
                             f"{others}")
    mpm_errs = phase_mpm_kernels(mpk, mp, device)
    for m in (hk, sk, hk3, gk, lk, bk, swk, mk, sc, s2k, fk):
        m.reset_launches()
    mpm_res = phase_mpm_main(mpk, mp, device, smi, mpm_errs)
    others = [dict(m.LAUNCHES) for m in (hk, sk, hk3, gk, lk, bk, swk, mk,
                                         sc, s2k, fk)]
    if any(any(o.values()) for o in others):
        raise AssertionError(f"the mpm path launched other kernels: "
                             f"{others}")
    nbody_errs = phase_nbody_kernels(nk, ng, device)
    others = (hk, sk, hk3, gk, lk, bk, swk, mk, sc, s2k, fk, mpk)
    for m in others:
        m.reset_launches()
    nbody_res = phase_nbody_main(nk, ng, device, smi, nbody_errs, others)
    counters = {"hk": hk, "sk": sk, "hk3": hk3, "gk": gk, "lk": lk,
                "bk": bk, "swk": swk, "mk": mk, "sc": sc, "s2k": s2k,
                "fk": fk, "mpk": mpk, "nk": nk}
    driver_res = phase_driver_surface(counters, smi)
    parallel_res = phase_parallel(hk, h2, sk, ts, interop, device, smi)
    analytic_res = phase_analytic_gates(counters, device, smi)

    tiling = hyp_tiling(hk, hk3, _build)
    t = main_res["times"]
    flag, ref = t["2048x2048 float32"], t["8192x1024 float64"]
    hb = {}
    for key, nx, ny, dt in (("flag", 2048, 2048, "float32"),
                            ("ref", 8192, 1024, "float64")):
        cfg = h2.default_config(nx=nx, ny=ny, dtype=dt)
        hb[key] = hyp2d_bounds(cfg, h2.build_mask(cfg, device))
    kernels = [
        {"name": "hypersonic2d_step", "route": "cuda",
         "source": "fluidsims_tpu_torch/csrc/hypersonic2d_step.cu",
         "replaces": "fluidsims_tpu/kernels/hypersonic2d_pallas.py:60",
         "launches": main_res["launches"]["step"],
         "max_abs_err": errs["step"],
         "ms": flag["step"], "plain_ms": flag["step_plain"],
         "bound_ms": hb["flag"]["step"][0], "bound_by": hb["flag"]["step"][1],
         "library_ms": None,
         "ms_8192x1024_f64": ref["step"],
         "plain_ms_8192x1024_f64": ref["step_plain"],
         "bound_ms_8192x1024_f64": hb["ref"]["step"][0],
         "max_rel_err": errs["step_rel"],
         "bitwise_cases": errs["bitwise"][:2],
         "not_bitwise": errs["bitwise"][2],
         "tiling": tiling["hypersonic2d_step"]},
        {"name": "hypersonic2d_inflow_wavespeed", "route": "cuda",
         "source": "fluidsims_tpu_torch/csrc/hypersonic2d_wavespeed.cu",
         # JAX computes this part as plain XLA (max_wavespeed), next to the
         # Pallas step kernel
         "replaces": "fluidsims_tpu/solvers/hypersonic2d.py:401",
         "launches": main_res["launches"]["wavespeed"],
         "max_abs_err": errs["wavespeed"],
         "ms": flag["wavespeed"], "plain_ms": flag["wavespeed_plain"],
         "bound_ms": hb["flag"]["wavespeed"][0],
         "bound_by": hb["flag"]["wavespeed"][1], "library_ms": None,
         "ms_8192x1024_f64": ref["wavespeed"],
         "plain_ms_8192x1024_f64": ref["wavespeed_plain"],
         "bound_ms_8192x1024_f64": hb["ref"]["wavespeed"][0]},
    ]
    a, b = (sph_res[n] for n, _, _ in SPH_RUNS)
    log(f"[build] sph density ptxas: {_build.ptxas_usage('density_kernel')}")
    for name, src, replaces in (
            ("bin", "sph_bin.cu", "fluidsims_tpu/ops/rank_pallas.py:44"),
            ("density", "sph_density.cu",
             "fluidsims_tpu/kernels/sph_pallas.py:80"),
            ("forces", "sph_forces.cu",
             "fluidsims_tpu/kernels/sph_pallas.py:121")):
        kernels.append({
            "name": f"sph_{name}", "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": a["launches"][name] + b["launches"][name],
            "max_abs_err": sph_errs.get(name, 0.0),
            "ms": a["times"][name], "plain_ms": a["times"][name + "_plain"],
            "bound_ms": a["bounds"][name][0], "bound_by": a["bounds"][name][1],
            "library_ms": None,
            **({"block": {f"{n} {dt}": getattr(sk, f"{name}_shape")(
                    ts.SPHConfig(n=n, dtype=dt)).asdict()
                    for n, dt in ((65536, "float32"), (1 << 20, "float32"),
                                  (4096, "float64"))},
                "repeat_bitwise": sph_errs[
                    "repeat_bitwise" if name == "forces"
                    else "density_repeat_bitwise"]}
               if name != "bin" else {}),
            **({"ms_device": a["times"]["density_device"],
                "ms_device_1048576": b["times"]["density_device"],
                "ptxas": _build.ptxas_usage("density_kernel")}
               if name == "density" else {}),
            **({"ms_device": a["times"]["bin_device"],
                "ms_device_1048576": b["times"]["bin_device"],
                "launch": {"65536": a["bin_launch"],
                           "1048576": b["bin_launch"]},
                "bitwise_cases": sph_errs["bin_bitwise"],
                "ptxas": _build.ptxas_usage("sph_bin_cu")}
               if name == "bin" else {}),
            "launches_65536": a["launches"][name],
            "launches_1048576": b["launches"][name],
            "ms_1048576": b["times"][name],
            "plain_ms_1048576": b["times"][name + "_plain"],
            "bound_ms_1048576": b["bounds"][name][0],
            "bound_by_1048576": b["bounds"][name][1]})
    a3, b3 = hyp3d_res["64"], hyp3d_res["256"]
    for name, src, replaces in (
            ("step", "hypersonic3d_step.cu",
             "fluidsims_tpu/kernels/hypersonic3d_pallas.py:46"),
            # JAX computes this part as a masked jnp.max in XLA, next to the
            # Pallas step kernel
            ("wavespeed", "hypersonic3d_wavespeed.cu",
             "fluidsims_tpu/solvers/hypersonic3d.py:913")):
        kernels.append({
            "name": f"hypersonic3d_{name}", "route": "cuda",
            "source": f"fluidsims_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": a3["launches"][name],
            "max_abs_err": hyp3d_errs[name],
            "ms": a3["times"][name], "plain_ms": a3["times"][name + "_plain"],
            "bound_ms": a3["bounds"][name][0],
            "bound_by": a3["bounds"][name][1], "library_ms": None,
            "launches_256": b3["launches"][name],
            "launches_th3cs": th3cs_res["launches"][name],
            "ms_256": b3["times"][name],
            "plain_ms_256": b3["times"][name + "_plain"],
            "bound_ms_256": b3["bounds"][name][0],
            "bound_by_256": b3["bounds"][name][1]})
    kernels[-1]["bitwise_cases"] = hyp3d_errs["wavespeed_cases"]
    kernels[-1]["ptxas"] = _build.ptxas_usage("wavespeed3_kernel")
    kernels[-2]["max_rel_err"] = hyp3d_errs["rel"]
    kernels[-2]["bitwise_cases"] = hyp3d_errs["bitwise"][:2]
    kernels[-2]["not_bitwise"] = hyp3d_errs["bitwise"][2]
    kernels[-2]["tiling"] = tiling["hypersonic3d_step"]
    pad64, pad256 = a3["times"]["pad"], b3["times"]["pad"]
    kernels.append({
        "name": "hypersonic3d_pad", "route": "cuda",
        "source": "fluidsims_tpu_torch/csrc/hypersonic3d_pad.cu",
        # JAX forms the prologue in XLA, ahead of the Pallas step kernel
        "replaces": "fluidsims_tpu/solvers/hypersonic3d.py:905",
        "launches": a3["launches"]["pad"],
        "bitwise_cases": hyp3d_errs["pad_cases"],
        "ms": pad64["call"], "ms_device": pad64["device"],
        "plain_ms": pad64["plain"], "bound_ms": pad64["bound"][0],
        "bound_by": pad64["bound"][1], "library_ms": None,
        "launches_256": b3["launches"]["pad"],
        "launches_th3cs": th3cs_res["launches"]["pad"],
        "ms_256": pad256["call"], "ms_device_256": pad256["device"],
        "plain_ms_256": pad256["plain"], "bound_ms_256": pad256["bound"][0],
        "bound_by_256": pad256["bound"][1],
        "ptxas": _build.ptxas_usage("pad3_kernel")})
    kernels.extend(stencil_kernel_lines(stencil_res, stencil_errs,
                                        gs_tiling(gk, gs, _build),
                                        lbm_tiling(lk, lbm, _build)))
    kernels[-1]["max_rel_err"] = stencil_errs["rel"]
    design = tiled_design(bk, swk, mk, s2k, bg, swm, mhd, _build, device)
    kernels.extend(resident_kernel_lines(resident_res, resident_errs, design))
    kernels.extend(stam3d_kernel_lines(stam3d_res, stam3d_errs))
    kernels[-1]["launch"] = {"192^3": sc.set_bnd_launch(192).asdict(),
                             "ptxas": _build.ptxas_usage("set_bnd_kernel")}
    kernels.extend(stam2d_kernel_lines(stam2d_res, stam2d_errs, design))
    kernels[-1]["ptxas"] = _build.ptxas_usage("stam2d_advect_cu")
    kernels[-1]["bitwise_cases"] = stam2d_errs["advect_bitwise"]
    kernels.extend(transfer_kernel_lines(
        "flip", FLIP_RUNS, {"p2g": 82, "grid": 126, "g2p": 171}, flip_res,
        flip_errs))
    kernels[-2]["tiling"] = flip_tiling(fk, fa, _build, device)
    kernels[-2]["bitwise_cases"] = flip_errs["grid_bitwise"]
    kernels[-1]["bitwise_cases"] = flip_errs["g2p_bitwise"]
    kernels[-1]["launch"] = {
        **{f"{n_p} {dt}": fk.g2p_launch(n_p, getattr(torch, dt)).asdict()
           for n_p, _, dt, *_ in FLIP_RUNS},
        "ptxas": _build.ptxas_usage("10g2p_kernel")}
    kernels[-3]["tiling"] = p2g_tiling(fk, "FlipParticles", FLIP_RUNS,
                                       _build, device)
    kernels[-3]["edge_cases"] = flip_errs["edges"]
    kernels.extend(transfer_kernel_lines(
        "mpm", MPM_RUNS, {"p2g": 42, "grid": 78, "g2p": 101}, mpm_res,
        mpm_errs, fused={"grid": "g2p"}))
    kernels[-3]["tiling"] = p2g_tiling(mpk, "MPMParticles", MPM_RUNS,
                                       _build, device)
    kernels[-3]["edge_cases"] = mpm_errs["edges"]
    kernels[-1]["bitwise_cases"] = mpm_errs["g2p_bitwise"]
    kernels[-1]["ptxas"] = _build.ptxas_usage("mpm_g2p_kernel")
    kernels.append(nbody_kernel_line(nk, _build, nbody_res, nbody_errs))
    if len(kernels) != 26:
        raise AssertionError(f"{len(kernels)} kernel lines, want 26")
    for line in kernels:
        src = line["source"].rsplit("/", 1)[1]
        line["launches_driver_surface"] = driver_res["launches"][src]
        line["launches_parallel"] = parallel_res["counts"][src]
        line["launches_analytic"] = analytic_res["launches"][src]
    kernels[1]["inflow_col_cases"] = parallel_res["inflow_col_cases"]
    for line in kernels:
        line.update(parallel_res["stam"].get(line["name"], {}))
    ranges = parallel_res["sph_ranges"]
    for line in kernels:
        name = line["name"][4:]
        if line["name"] not in ("sph_bin", "sph_density", "sph_forces"):
            continue
        if name == "bin":
            line["window_bitwise_cases"] = ranges["bin_bitwise"]
            line["bucket_bitwise_cases"] = parallel_res["bin_bucket"]
        else:
            line["max_abs_err"] = max(line["max_abs_err"], ranges[name])
            line["range_rows_bitwise_cases"] = ranges["bitwise_rows"]
    kernels[0]["driver_surface"] = {
        k: driver_res["views"][k] for k in (
            "frame_ms", "frame_ms_total", "steps_per_s_png_stride_50",
            "steps_per_s_headless")}
    kernels[0]["driver_surface"]["resume"] = driver_res["resume"]
    log(f"[hyp3d] steps/s: 64^3 f32 {a3['rate']:.2f} (plain "
        f"{a3['plain_rate']:.3f}), 256^3 f32 {b3['rate']:.2f} (plain "
        f"{b3['plain_rate']:.4f}); th3cs 64^3 "
        f"{th3cs_res['frames_per_s']:.2f} frames/s")
    f32, f64 = stam3d_res["float32"], stam3d_res["float64"]
    log(f"[stam3d] steps/s: 192^3 f32 {f32['rate']:.2f} (plain "
        f"{f32['plain_rate']:.4f}), 192^3 f64 {f64['rate']:.2f} (plain "
        f"{f64['plain_rate']:.4f})")
    f32, f64 = stam2d_res["float32"], stam2d_res["float64"]
    log(f"[stam2d] steps/s: 512^2 f32 {f32['rate']:.2f} (plain "
        f"{f32['plain_rate']:.2f}), 512^2 f64 {f64['rate']:.2f} (plain "
        f"{f64['plain_rate']:.2f})")
    log("[flip] M particle-steps/s: " + ", ".join(
        f"{k} {r['mpsteps']:.3f} (plain {r['plain_mpsteps']:.4f})"
        for k, r in flip_res.items()))
    log("[mpm] M particle-steps/s: " + ", ".join(
        f"{k} {r['mpsteps']:.3f} (plain {r['plain_mpsteps']:.4f})"
        for k, r in mpm_res.items()))
    log(f"[sph] M particle-steps/s: n=65536 {a['rate']:.3f} (plain "
        f"{a['plain_rate']:.4f}), n=1048576 {b['rate']:.3f} (plain "
        f"{b['plain_rate']:.4f}); pairs {a['bounds']['pairs']} / "
        f"{b['bounds']['pairs']}")
    log("[nbody] steps/s at 131072 bodies: " + ", ".join(
        f"{k} {r['rate']:.2f} (plain {r['plain_rate']:.3f})"
        for k, r in nbody_res.items() if not k.startswith("grid"))
        + "; grid engine " + ", ".join(
            f"{k.split()[1]} {r['rate']:.2f}" for k, r in nbody_res.items()
            if k.startswith("grid")))
    print(json.dumps({"parallel": {
        "compute_mode": parallel_res["compute_mode"], "card": smi,
        "runs": parallel_res["lines"]}}))
    print(json.dumps({"analytic_gates": {
        "card": smi, **analytic_res["gates"],
        "long_horizon_full_width": analytic_res["full_width"]}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
