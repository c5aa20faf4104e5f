#!/usr/bin/env python3
"""Chip smoke test of meshfem_tpu_torch on one CUDA card.

Run from the repository root with ``python3 chip_smoke.py``.  Phases, each
of which raises on failure:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``meshfem_tpu_torch/csrc`` (timed); then set
   up the main path's problem: ``grid_tet(36,36,36)`` P2 (279,936 tets,
   1,167,051 dofs), ``Material.isotropic(3, 200, 0.3)``, the x = 0 face
   clamped and the far face loaded in -y (``bench.py:397-404``), its dense
   routed operator and the factored one (built as ``bench.py:363``);
3. hold each kernel against its plain PyTorch version at the main path's
   shapes: A in planes at 3 and 1 planes and in rows at 3 and 18 values a
   node, from node rows and from planes (exact), B in float32 (1e-5 of
   max|y|) and float64 (1e-12), bit-identical across two runs, B in rows
   equal bit for bit to B in planes on the same contributions (f32 at 3
   and 18 values a node through the operator's two plans, f64 through the
   EBE plan) and to 1e-5 / 1e-12 of max|y| of its plain version, C (1e-5
   of max|y|),
   D (1e-5 of max|y|, and 5e-6 against C on the same inputs), C and D
   also in element-major node rows (1e-5 of max|y| against plain, and bit
   for bit against themselves in planes), E (1e-5 of
   max|Ke| against its plain version and against the simulator's float64
   Ke, whose error the plain one-product form's is printed beside, and
   within one float32 ulp of each entry of that float64 Ke, since the
   kernel sums in float64; again at the same size on seeded random
   gradients and volumes, which excite every term of the product where a
   Kuhn grid's few distinct gradients do not, with the isotropic and a
   seeded anisotropic material, the ulp check against the float64 Ke of
   the same inputs);
4. the main path: ``sim.routed_kernel()`` (the dense operator, whose
   float32 ``Ke`` kernel E assembles) and ``sim.solve(operator="routed",
   tol=1e-10)``, float32 routed CG inside float64 iterative refinement.
   Launch counts are zeroed just before the two and read just after; every
   routed apply must have launched kernel A in rows (one ``gather_rows``
   each) and no kernel in planes; the float64 relative residual through
   the port's EBE operator must be <= 1e-10;
5. the factored backend: its apply against the dense apply (<= 5e-6 of
   max|y|), then the same solve with ``MESHFEM_FACTORED=1`` (the
   reference's switch), counted the same way: every apply in node rows (A
   and B in rows, kernel C once in rows, no kernel in planes);
   a small clamped bar solved on the card (routed) against the port's
   float64 EBE solve on the CPU (u and von Mises to 1e-8);
6. the assembly path composed by hand as ``bench.py:266,320`` does (the
   package's own is ``routed_kernel``, counted in phases 4 and 7): the
   float32 ``Ke`` of the bench mesh from ``kernels.element_stiffness``,
   handed to ``RoutedEBE.build``; its apply against an operator built from
   the float64 ``Ke`` cast to float32 (<= 5e-6 of max|y|), launches counted;
7. the homogenization path at full width: ``homogenize(mesh,
   Material.isotropic(3, 200, 0.3), tol=1e-10)`` on ``grid_tet(36,36,36)``
   P2 with a spherical void of radius 0.3 (about 248k tets, 1.0 M dofs
   after periodic identification), run three times with the launch counts
   zeroed before each: dense (A and B in rows, ``bmm``; every block apply
   in rows, none in planes), ``MESHFEM_FACTORED=1`` (C) and
   ``MESHFEM_FACTORED=1 MESHFEM_FACTORED_TQ=1`` (D), each block apply in
   node rows too: A and B in rows, ONE launch of C or D over the 6
   columns, no kernel in planes.  Gates:
   the block's float64 relative residual through the EBE operator,
   translations projected, <= 1e-10 in the whole-block norm; ``Ch``
   finite, symmetric, positive definite, softer than ``D``, under the
   Voigt bound; the three ``Ch`` equal to 1e-7; then a small periodic cell
   with a soft inclusion (``MaterialField``) solved routed on the card
   against the float64 EBE block solve on the CPU (w and Ch to 1e-8);
8. the probe path: kernel F (``route_window``) at the shapes of
   ``experiments/probe_route.py`` (NV = 7,530, NT = 2,797, CHAIN = 4, its
   seed), counted, against its plain version (exact);
9. the stage table: the dense block apply (periodic cell, 6 columns) and
   the dense single apply (bench mesh) in node rows as the package runs
   them (A, ``bmm``, B), beside the component-planes layout the dense
   applies ran in before, composed by hand from the planes kernels, a
   component-major copy of ``KeP`` and the layout copies it made; then
   the factored block apply (cell, 6 columns) and single apply (bench
   mesh, kernel C) in node rows as the package runs them (A, ONE launch
   of C, B) beside the planes composition they ran in before (A and B in
   planes, C per column on copies of the columns, the stack); each stage
   timed with CUDA events (warm L2, as inside CG), and the whole apply;
   the two layouts' results agree to 1e-6 of max|y| (dense) and bit for
   bit (factored: the same contributions in the same order, and the
   package's apply equal to its stages);
10. the structured multigrid, the path ``solve()`` takes by default on
   Kuhn grids (reference ``physics/elasticity.py:475-502``): with TF32
   checked off, the default call ``sim.solve(tol=1e-10)`` on the clamped
   bench problem (counts zeroed just before, read just after) must build a
   float32 ``StructuredMG`` and solve inside float64 refinement, launching
   kernel A (the shell correction's gather) and kernel B (its sum in
   float32, the EBE residual in float64); its f64 relative residual through
   the EBE operator <= 1e-10 and ``max|u - u_routed| / max|u_routed|``
   against phase 4's routed solution <= 1e-6; the same grid with a 1000:1
   spherical inclusion (``MaterialField``) through ``VarStructuredMG`` to
   <= ``FIELD_RELRES_GATE`` (3e-10: its float64 refinement stalls near
   2e-10), beside an extended-precision witness (host long double): the
   residual of its u, and u refined three more rounds with the same
   multigrid and residuals in long double, which must reach <= 1e-12 and
   lie within 1e-10 of max|u| of u, then rounded back to float64 and read
   both ways; a clamped
   grid_tet(8) solved on the card against the port's float64 CPU solve
   (1e-7); the card's float32 apply against the float64
   apply on the CPU at full size (1e-5 of max|y|); A (exact) and B (1e-5 of
   max|y|) at the shell's shapes against their plain versions; build,
   solve, rounds and MG-PCG iterations printed beside the reference's 24 in
   float64 on the CPU; the conv, the shell correction, the whole apply, a
   P1-level apply and one V-cycle timed with CUDA events, the conv beside
   its bound (the stencil's nonzero multiply-adds) and the dense conv's
   operations; the device kernels and busy share of one V-cycle and of one
   inner MG-PCG solve (``torch.profiler``);
11. boundary conditions, the rigid-motion projection and warm starts, each
   path counted (counts zeroed just before, read just after, its kernels
   required): (a) the quick start's regions at bench size through
   ``parse_bc`` (a ``dirichlet`` region on x = 0, the force [0, 0, -10] on
   x = 1), ``sim.solve(tol=1e-10)`` taking the structured multigrid
   (A and B), relative residual <= 1e-10, energy balance, and the clamp's
   ``report_region_surface_forces`` equal to (0, 0, 10) to 1e-8; (c) on
   the same problem, ``solve(operator="routed", x0=u)`` in 0 refinement
   rounds and from u/2 to 1e-10 (A, B, E), its inner iterations beside a
   cold routed solve's, and ``operator="structured"`` with ``x0`` raising
   ValueError; (b) a free body (``no_rigid_motion``, forces [-1, 0, 0] and
   [1, 0, 0] on the two x faces) solved by ``solve(tol=1e-10)`` through
   the routed dense operator (A, B, E) and, in a fresh simulator under
   ``MESHFEM_FACTORED=1``, the factored one (A and B in rows, C once an
   apply in rows, no kernel in planes): the
   projected float64 relative residual <= 1e-10, every element's average
   stress (1, 0, 0, 0, 0, 0) to 1e-6, u equal to (x, -0.3 y, -0.3 z) / 200
   to 1e-6 relative with the rigid modes removed from both, and the rigid
   share |Q^T u| / |u| printed, the float32 rigid projection of the inner
   CG timed alone beside the dense routed apply; (d) the README quick start
   (``bar_tet(12,3,3)``, 648 tets) on the card, which takes the refined
   EBE branch (kernel B in float and double), against the float64 CPU
   solve (1e-8), with kernel B held on that branch's own two plans (float
   and double rows, bit for bit against B in planes and the CPU's plain
   sum, to 1e-5 / 1e-12 of max against the card's plain); the host
   seconds of the boundary-condition matching and of the rigid modes
   printed;
12. voxel homogenization, the orthotropic cell, the two-level
   preconditioner and SIMP topology optimization, each path counted
   (counts zeroed just before, read just after), and kernels A and B held
   against their plain versions on every plan those paths launch them on
   (bit for bit against B in planes and the CPU's plain sum, 1e-5 / 1e-12
   of max against the card's plain): (a) ``homogenize_voxels`` on the
   cross lattice of ``examples/homogenize_voxels.py`` at 36^3 (279,936
   tets, 373,248 periodic nodes, 1,119,744 unknowns x 6 columns, float64,
   void 1e-6, tol 1e-9) through the periodic torus multigrid: block CG
   iterations < 60, ``Ch`` symmetric positive definite, the normal
   moduli's relative spread <= 1e-6, every column's float64 relative
   residual through the periodic simulator's EBE operator <= 1e-8, B
   float64 on that operator's plan, the torus operator against it on a
   seeded field <= 1e-12, the card's ``Ch`` against the CPU's at 6^3 <=
   1e-8; then the same cell by its parts, ``PeriodicVarMG.build`` and
   ``solve_cell_problems_grid(sim, mg=mg)`` timed apart, ms per block
   iteration and peak memory printed; (b)
   ``homogenize_orthotropic(precond="multigrid")`` on ``grid_tet(36)``
   over [0, 0.5]^3 with a 1000:1 sphere: ``Ch`` SPD, its non-orthotropic
   entries 0 (true by construction of the reconstruction), w nonzero,
   each probe's float64 relative residual through the EBE operator with
   that probe's pins <= 1e-9, B float64 on that operator's plan, card
   against CPU at 6^3 <= 1e-8, the six probes' build and solve times
   (``HomogenizationResult.timings``) and iterations printed; (c)
   ``solve(operator="routed", precond="twolevel", tol=1e-10)`` on a
   perturbed ``grid_tet(16)`` P2 with a 1000:1 sphere, clamped: float64
   relative residual <= 1e-10, fewer inner iterations than Jacobi on the
   same problem, u against the CPU's float64 EBE two-level solve <= 1e-8;
   the transfers (prolong, kernel A, bit for bit; restrict, kernel B),
   A on the routed operator's ids, B float32 on its element-major plan
   and B float64 on the EBE plan held against their plain versions; then
   ``homogenize(precond="twolevel")`` on the void cell at ``grid_tet(16)``
   (float64: kernel A on float64 rows, B in float64) against
   ``precond="block"``, ``Ch`` within 1e-8; the same preconditioner built
   again on the cell's periodic simulator, its host Galerkin product and
   SuperLU times printed apart, its transfers and B float64 on the EBE
   plan held; (d) ``ComplianceTopOpt(64, 32, 32)`` (float32, 393,216
   tets), 5 iterations of ``run``: compliance finite and falling, MG-PCG
   iterations < 200, filtered volume within 0.02 of volfrac; the last
   iteration again by its steps (filter, MG build, solve, gradient, OC
   update), each timed, its state solve's true relative residual read in
   float64 <= solve_tol + 20x the float32 floor (the residual of the
   float64 solution rounded to float32), u within 1e-4 of the float64 u;
   the card's float64 history at (4, 2, 2) against the CPU's <= 1e-8;
13. triangle meshes, 2D elasticity and 2D homogenization, each path
   counted (counts zeroed just before, read just after, its kernels
   required): (a) the 2D cantilever of BASELINE config 1 over [0, 4] x
   [0, 1], P1, clamped at x = 0 and loaded in -y at the tip through
   ``parse_bc(..., dim=2)``, by the default call ``solve(tol=1e-10)`` (the
   routed dense operator: E at (2, 1), A and B rows at 2 values a node;
   every apply in rows), float64 relative residual <= 1e-10; the uniaxial
   bar of the reference's ``tests/test_elasticity.py:50-70`` on the same
   mesh at tol 1e-12, every element's stress (t, 0, 0) and strain
   (t/E, -nu t/E, 0) to 1e-7; the card's u against the CPU's at
   grid_tri(32, 8) (1e-8); (b) the P2 cantilever through
   ``solve(operator="routed")`` dense (E at (2, 2)), ``MESHFEM_FACTORED=1``
   (C) and ``MESHFEM_FACTORED_TQ=1`` (D), every apply in node rows, each to
   1e-10, each factored apply against the dense one (5e-6 of max|y|) and u
   against the dense u (1e-8); the sizes are cut (``CANT_P1_N``,
   ``CANT_P2_N``: float32 CG inside float64 refinement stalls above 1e-10
   on the larger meshes); (c) ``homogenize`` on grid_tri(256, 256) P2 with
   a void disc of radius 0.3, precond 'block' and 'jacobi' (one 3-column
   routed block CG, A and B at 6 values a node, inside float64
   refinement): Ch symmetric, positive definite, under the Voigt bound,
   |C00 - C11| <= 1e-7 C00, every column's float64 residual <= 1e-9, the
   two Ch within 1e-8, card against CPU at grid_tri(8, 8) (1e-8); (d)
   ``homogenize_voxels`` on a 512^2 pixel cross through the 2D torus
   multigrid (float64, tol 1e-9): fewer than 60 block iterations, Ch SPD
   with |d0 - d1| <= 1e-7 d0, every column's residual <= 1e-8,
   ``apply_channels`` against the float64 EBE ``apply_K`` (1e-12), card
   against CPU at 8^2 (1e-8), its build, solve, ms per block iteration
   and peak memory printed; (f) the cuts' witness: the cantilever at the
   sizes above them (P1 at twice and four times ``CANT_P1_N``, P2 at two,
   four (factored) and eight times ``CANT_P2_N``), one routed solve each,
   its rounds and where its refinement stopped printed, not gated; (e) in
   phase 14, kernels A-E held against
   their plain versions at their 2D shapes on the uncut meshes
   (grid_tri(1024, 256) P1 and grid_tri(512, 128) P2) and the 13c cell:
   A rows at 2 and 6 values with an odd slot count (exact), A planes at 2
   and 6, B rows float32 and float64 at 2 and 6 values and B planes at 2
   and 6 (bit-identical across two runs, B rows bit for bit against B in
   planes, 1e-5 / 1e-12 of max|y| against plain), C and D at (2, 1) and
   (2, 2) (1e-5, D against C 5e-6; in rows too, bit for bit against
   planes, and in rows at the 13c cell's 3 columns), E at (2, 1) and
   (2, 2) (1e-5 of
   max|Ke|, one float32 ulp of the float64 Ke on the mesh and on seeded
   random inputs with an isotropic and an anisotropic [3, 3] material),
   each then timed as phase 14 times the others;
14. each kernel timed beside its bound, its plain version and one PyTorch
   call computing the same function (median of per-launch CUDA-event
   times, L2 flushed before each launch, the call queued before its first
   event fires), A and B in planes also at the 18
   planes of the factored block apply (the layout it ran in before node
   rows), A and B in rows at 3 and 18 values a node (B in f32 and f64), C
   and D in planes and in node rows at 1 column (bench mesh) and 6
   columns (cell), each rows line held against plain (1e-5) and against
   the kernel in planes column by column (bit for bit), with the byte
   bound 4 (K1 d + 1 + 2 n d m) bytes an element, F beside kernel A on
   the same count of
   routed values, printed as one ``{"kernels": [...]}`` line.  A bound
   counts what the FUNCTION needs from its inputs (each byte once; the
   fewest operations a known algorithm does), so D shares kernel C's and
   E's operations are those of the material-first contraction; the time
   the kernel's own algorithm needs at the peak rate is printed beside it
   as ``algorithm_ops_ms`` (D: the reassociated table form; E: the
   material-first contraction with H's symmetry, at the float64 rate it
   runs at), and the compiler's
   register, shared-memory and spill report (``-Xptxas -v``) of C, D and
   E as ``ptxas``; each line's ``bound_share`` is its bound over its
   time; C's lines also carry ``clean_l2_ms``, the same timer with the L2
   flushed by a read (the flush's ``zero_()`` leaves dirty lines that the
   timed launch writes back); C in node rows runs its persistent
   pipelined path (a warp's next tile in flight by one bulk asynchronous
   copy while it computes the current one from shared memory and the
   previous one drains out), C in planes its direct path, both with the
   tables compiled in;
   A and B also at the shell correction's shapes, and the structured conv
   alone with the same timer;
   each kernel line also carries ``launches_bc_paths``, its launches on
   each of phase 11's paths in the line's own mode (a kernel B line its
   dtype's, the widths of one dtype together; ``launches`` stays the
   count of the earlier main path it was read from, in the same mode),
   and ``launches_cell_paths`` likewise on phase 12's paths (kernel A in
   rows also split by dtype: its ``gather_rows/f64/18`` line times it on
   float64 rows at the two-level prolongation's shapes), and
   ``launches_2d_paths`` on phase 13's (the ``.../2d/...`` lines are
   phase 13e's);
15. scalar Poisson, the discrete operators, geodesics in heat, mesh and
   field I/O and the two CLIs, every scalar path counted (counts zeroed
   just before, read just after): every float64 EBE apply, diagonal and
   ``sparse.assembly.scatter_load`` must have launched kernel B in float64
   once (``segment_sum_rows``, one value a node) and nothing else may have
   launched (no float32 B, no planes, no plain version): (a) the
   convergence suite of ``experiments/laplace_convergence.py``,
   sin(pi x) sin(pi y) on ``grid_tri(n, n)``, P1 for n = 64 ... 1024
   (1,050,625 nodes) and P2 for n = 32 ... 512, ``PoissonProblem.solve``
   to tol 1e-13: every L2 error rate (through the port's consistent
   ``mass``) within 0.35 of 2 (P1) and 3 (P2), every solve at its tol
   before ``maxiter = 20000``; n, the error, the rate, the CG iterations,
   the CG and the true relative residuals, seconds and ms an iteration
   printed, and the solve closest to its limit; (b) the exact quadratic of
   ``test_p2_reproduces_quadratic`` on ``grid_tet(36)`` P2 (389,017
   nodes), its consistent source through ``load_from_source``: max error
   <= 1e-7 max|u|; (c) ``geodesic_distances`` from the corner of
   ``grid_tri(n, n)`` P1 at the reference CG's default maxiter (1000): at
   n = ``GEO_GATE_N`` (20) max |d - |x|| < 0.08, d monotone along the
   diagonal, both solves within maxiter and the card against the CPU
   (1e-10, the same counts); at ``GEO_CONV_N`` (176) both solves within
   maxiter; at 512, 16, 24, 32 and 192 the counts, residuals and errors
   printed (the reference's heat step loses its far field below the
   solve's tolerance past ~20 cells, so its accuracy gate cannot hold at
   the larger sizes); (d) ``PoissonProblem
   .solve``, ``neumann_load``, ``geodesic_distances``,
   ``boundary_laplacian`` and ``bilaplacian_apply`` on ``grid_tri(16,
   16)`` and ``grid_tet(4, 4, 4)``, P1 and P2, the card against the CPU
   (1e-10 of max, non-finite entries in the same places); (e) the bench
   mesh with phase 4's u (node vector) and von Mises (element scalar)
   written as binary and as ASCII MSH and read back by ``meshio`` and
   ``msh_fields``, equal bit for bit (float64 binary nodes, %.17g text),
   the host seconds of each write and read printed; (f) ``cli.poisson`` on
   a ``grid_tri(256, 256)`` .off written by the port's ``meshio`` with the
   .bc of ``tests/test_cli.py::test_poisson_cli``, and ``cli.simulate`` on
   13b's P2 cantilever written as .msh, both on the card: the outputs read
   back, the Poisson u equal to the package API's solve (1e-12 of max),
   in [0, 1], the Simulate u within 1e-8 of max|u| of the API's solve;
   (g) kernel B in float64 rows at 1 value on 15a's largest P1 plan
   (6,291,456 rows into 1,050,625 nodes): bit-identical across two runs,
   bit for bit against B in planes and the CPU's plain sum, 1e-12 of
   max|y| against the card's plain version, and its line
   ``segment_sum_rows/f64/1`` in the kernel report (time, byte bound,
   plain and ``index_add_`` times with phase 14's timer); one Laplacian
   apply on that operator timed by its stages (the gather, the batched
   ``bmm``, B; events, warm L2); every kernel line carries
   ``launches_poisson_paths``, its launches on each of these paths;
16. the unstructured multigrid (``precond="amg"``), deformed
   configurations and deformed cells, every path counted (counts zeroed
   just before, read just after, its kernels required), with TF32 checked
   off: (a) the clamped bench problem by ``sim.solve(operator="routed",
   precond="amg", tol=1e-10)`` (the operator and the hierarchy built inside
   the count: P2, P1, the aggregation levels and the dense coarsest),
   relative residual <= 1e-10 and u within 1e-6 of max|u| of phase 4's
   routed u; the build's stages, the rounds, the inner iterations, ms an
   inner iteration (host clock, the hierarchy cached) and one V-cycle
   (events) printed; (b) the V-cycle's symmetry at bench size on two
   random free vectors (|<y, M x> - <x, M y>| <= 1e-4 of the larger, <x,
   M x> > 0, the reference's criteria), its launches counted: kernels A and
   B once each per routed apply and once per transfer; (c) ``grid_tet(36)``
   with its interior vertices moved by up to 0.15 of a cell (it fails
   ``validate_kuhn_grid``) by AMG and by Jacobi to 1e-10, side by side, and
   the 1e4-contrast field of ``tests/test_amg.py`` on it by AMG (1e-10) and
   by Jacobi capped at ``JACOBI_CAP`` iterations an inner solve (where it
   stopped printed); (d) ``homogenize_deformed`` on phase 7's void cell:
   the identity against phase 7's ``Ch``, a rotation R that maps the cell
   onto itself (the cyclic permutation of the axes; 90 degrees in 2D)
   warped and in ``transform_version`` form against ``transform(Ch, R)``
   (1e-7 of max), a homogeneous ``grid_tet(8)`` cell under the shear [[1,
   0.2, 0], [0, 1, 0], [0, 0, 1]] against D (1e-8; its loads are rounding
   noise, so it is kept small), the void cell under it printed, and the
   energy form (``homogenized_tensor_at``, ``w Ke w``, exact for P2) at
   its sheared positions against its stress-form ``Ch`` (1e-8 of max);
   the same on 13c's triangle cell with a homogeneous ``grid_tri(16)``;
   (e) ``homogenized_tensor_shape_gradient``
   on the void cell against a central difference of the frozen-w energy
   form along a random direction (1e-5), twice equal to the bit and under
   ``torch.profiler`` with no library scatter (its corner gather is a
   ``GatherPlan``, kernel B in the backward); (f) ``cli.homogenize`` (with
   ``-o``) and ``cli.deformed_cells`` (``--jacobian``, and
   ``--parametrizedTransform`` with two jacobians on stdin) on the void
   cell written by ``io.meshio.save_msh``, their printed ``Ch`` against
   16d's and phase 7's to the printed digits; (g) kernel A on the P1 -> P2
   prolongation and the aggregation prolongation, kernel B on the P2 -> P1
   restriction, the aggregation restriction (6 values) and the float64
   Gershgorin row sums, each bit for bit against its plain version (B
   also against B in planes and the CPU's plain sum) and timed as phase
   14 times the others; kernel E on the sheared void cell's geometry
   (``node_positions``) within one float32 ulp of the float64 ``Ke``; every
   kernel line carries ``launches_amg_paths``;
17. vibrational modes, material optimization, the autograd pair and
   Newton, every path counted (counts zeroed just before, read just after;
   kernel B required, and kernel A where a gradient runs): (a)
   ``compute_vibrational_modes`` on the bench mesh with
   ``Material.isotropic(3, 200, 0.35)``, free (rigid modes deflated) and
   with the x = 0 face as ``fixed_mask``, ``MODES_ITERS`` LOBPCG iterations
   (the reference's 3D LOBPCG stalls above its tolerance, so the count is
   fixed): ms an iteration (host clock), the eigenvalues and the residual
   history printed, then the K and M applies at 6 and 18 columns by stage
   (the gather, the float64 ``bmm``, B at 18 / 54 values; events, warm
   L2) beside the ``Ke`` floor; (b) the card against the CPU on
   grid_tet(4, 3, 2) P2 at ``MODES_SMALL_ITERS`` iterations, the host-stage
   branch and the device loop (scalar ``EBEKernel`` operators): eigenvalues
   to 1e-9 relative, the M-projectors onto the blocks to 1e-7; and the
   reference test's grid_tri(5, 5) P1 modes on the card against scipy's
   shift-invert ``eigsh`` (rtol 1e-4); (c) ``optimize(...,
   precond="multigrid")`` on the bench mesh with per-element moduli,
   ``MO_STEPS`` Adam steps, each split into the multigrid build, the
   forward and adjoint solves (with their iterations) and the rest; the
   objective must fall; the backward alone counted (A = B + 2: each
   adjoint matvec and the replayed matvec one of each, and B's two
   adjoints); one step on grid_tet(2) P2 (unpreconditioned: the same
   differentiated code) under ``torch.profiler`` with no library scatter
   (``index_add_``, an accumulating ``index_put_``, ``scatter_add``); the
   gradient against central differences on grid_tet(6) P2 (< 1e-4) and
   against the CPU on grid_tet(4) P2 (1e-8); (d) the gradient of load . u
   through ``differentiable_displacement`` on ``ComplianceTopOpt(64, 32,
   32)`` in float64 against ``compliance_and_grad``'s dc (rtol 5e-5), the
   forward and backward timed; (e) ``newton_from_energy`` on the
   neo-Hookean energy of a clamped bar grid_tet(2n, n, n) P1 (n =
   ``NEWTON_N``) stretched 20%, to gradTol 1e-8, s an iteration and the CG
   iterations printed, and the card against the CPU at n = 3 (x to 1e-8,
   equal iteration counts); (f) ``cli.material_opt`` on a grid_tet(6) P1
   mesh and a .bc file with a ``target`` region, the fitted field read back
   against the API (1e-10); (g) kernel B in float64 rows at 18 and 54
   values on the modes' plan and kernel A in float64 rows on material
   optimization's gather, each against its plain version and timed; every
   kernel line carries ``launches_phase17_paths``;
18. multi-device (``meshfem_tpu_torch/parallel/``) on the clamped bench
   problem with 4 shards in one process (``LocalShards`` on the card), every
   path counted (counts zeroed just before, read just after): (a)
   ``DomainDecomposition.from_simulator(sim, 4)`` timed, ``Nl``, ``H``,
   ``K``, each shard's interior and boundary elements and the halo scalars
   an apply beside the full vector's 3 N printed; (b) ``dd_cg_solve``,
   float64, block Jacobi, to tol 1e-8 (host checks every 100 iterations):
   true relative residual through the EBE operator <= 1e-7, u within 5e-3
   of max|u| of phase 4's routed u, kernel B in float64 once for each
   shard's interior and once for its boundary elements an iteration;
   iterations, seconds, ms an iteration (host clock), one shard apply and
   one exchange (events, warm L2) printed; (c) S = 1, 2 and 4 at 30
   iterations within 1e-8 of max|u| of each other; (d) the routed shards
   (``dd.build_routed()``, float32) at 25 iterations within 2e-4 of max|u|
   of the float64 DD at the same count, every shard apply one launch of A
   in rows and one of B in rows, nothing in planes; (e) ``DDCoarse`` with
   ``agg_size=128`` (396 aggregates, 2,376 coarse unknowns, <= 3,000), its
   build by stage, at 60 iterations its res2 <= 1e-2 of block Jacobi's;
   (f) ``sharded_elasticity_solve_multichip`` on 2 domain x 2 column
   groups, six strain loads, 20 iterations, within 1e-9 of max|U| of a
   single-device Jacobi ``cg_block`` of the same count; (g)
   ``dryrun_multidevice(4)`` with both of its gates, then the same dry run
   in a one-rank NCCL group in this process (``FileStore``, 120 s
   timeout) equal bit for bit to one in-process shard; (h) kernels A and B
   on every shard plan held against their plain versions (A exactly, B in
   f32 to 1e-5 and in f64 to 1e-12 of max|y|, B also bit for bit against B
   in planes and the CPU's plain sum) and shard 0's timed
   (``.../shard`` lines); every kernel line carries
   ``launches_phase18_paths``;
19. the analyses, every path counted (counts zeroed just before, read
   just after): (a) ``open_linkage`` on a grid_tri(256) P2 cell with a
   tilted elliptical void (``slot_cell``; 13c's round void is softest in
   pure shear, whose first component is ~1e-15, so the eigenstrain's sign
   flip would be decided by roundoff), ``Material.isotropic(2, 1, 0.3)``,
   3 steps at speed 0.005, tol 1e-7, routed: each step's block residual
   through the float64 EBE operator, translations projected, <= tol in
   the whole-block norm, Eh symmetric (1e-6) and positive definite, the
   opening strain's first component >= 0.1 of its largest, the step's
   largest vertex move the speed to 1e-9, kernel E once a step, A and B
   in rows on every block apply; the grid_tri(8) cell on the card against
   the CPU (Eh and vertices to 1e-8); (b) ``optimize_linkage`` on the same
   cell, 2 steps of a quarter grid spacing: identified vertices' steps
   equal (1e-12); dEh by autograd at full width, the forward and each of
   the 9 reverse passes timed, twice equal to the bit, counted (A f64 2,
   B f64 18) and under ``torch.profiler`` with no library scatter; on the
   small cell dEh against the CPU (1e-9) and along a seeded direction
   against a central difference of the whole pipeline on the card (2e-4);
   (c) ``harmonic`` (two Jacobi CGs to 1e-11 within the reference's
   1,000 iterations, the boundary on the unit circle to 1e-8, every scale
   factor > 0) on the paraboloid cap grid_tri(408) P1 in 3D (cut: the
   largest grid, in steps of 8, that converges within the cap; 416 is
   logged beside it), ``scp`` (50 LOBPCG iterations, ms an iteration) on
   the grid_tri(512) cap, ``lscm`` (CG to 1e-11, conformal distortion 1
   to 1e-6) on the flat grid_tri(256) (cut: at 512 its unpreconditioned
   CG ends at the reference's 20,000 iterations, 4.4e-6), each counted
   as a scalar path (kernel B in float64 once for every apply, diagonal
   and area pairing, and nothing else), CG iterations and ms an
   iteration (host clock); the
   grid_tri(16) meshes on the card against the CPU (1e-8; scp at 12
   iterations, up to sign, eigenvalues 1e-10); (d) on a cube's six
   grid_tri(256) faces welded and projected onto the unit sphere
   (393,218 vertices, 786,432 triangles), on one corner plan built once
   (a call building its own timed beside): Gauss-Bonnet to 1e-9 relative,
   the sensitivity of the total deficit <= 1e-9 of a per-term gradient
   (that of a seeded +-1 weighting of the deficits), the gradient of the
   sum of squared deficits against central differences along unit
   directions over all coordinates (< 1e-5 on the grid_tri(32) sphere;
   at full width roundoff and truncation leave ~1e-4 at the best step, so
   < 1e-3 there) and,
   with the sensitivity, twice equal to the bit; (e) ``cli.mechanisms``
   ``open`` and ``optimize`` on the grid_tri(8) cell written by
   ``io.meshio.save_off``, on the card and on the CPU: the files exist and
   the minimum eigenvalues agree to 1e-8; (f) kernels A and B on the plans
   phase 19 made (B f64 at 1 value on ``harmonic``'s EBE plan and at 2
   on ``lscm``'s, A at 3 values and B at 1 on the curvature's corner plan and each
   the other way, A at 2 values on the endpoint plan of
   ``node_positions_from_vertices`` and B as its adjoint), each against
   its plain version and timed, and E on the 19a cell within one float32
   ulp of the float64 ``Ke``; every kernel line carries
   ``launches_phase19_paths``;
20. the host tools, every card path counted, each number printed beside
   the card's name and power limit: (a) the port's host core (built by
   ``g++`` beside ``nvcc`` in phase 2, its seconds printed; a failure to
   build or load fails the run) numbering ``FEMMesh(grid_tet(36))`` P2
   equal to the bit to ``MESHFEM_TORCH_NO_NATIVE=1`` (``elem_nodes``,
   ``node_positions``, the boundary and the half-face opposites), host
   seconds of each, and its Morton codes of the bench nodes equal to
   ``reorder._morton_codes``; (b) ``triangulate_pslg(quality=True)`` of
   the unit square with two square holes at min angle 25 and area 8e-6
   (>= 100,000 triangles; every angle >= 25 - 1e-6, every area positive
   and <= the target + 1e-12, the area sum exact to 1e-9), ``FEMMesh``
   P2, x = 0 clamped and x = 1 loaded, solved by the default 2D call
   (routed Jacobi CG in float32 inside float64 refinement) to an f64
   relative residual <= 1e-10; (c)
   ``FieldSampler`` built and ``locate`` of 20,000 seeded points in the
   domain timed, and of 10 in its holes (where a bucket holds no element
   and every element is tested); on 2,000 of them x^2 - y exact to 1e-12 and
   ``sample_nodal`` of the card's u against ``sample_matrix @ u`` (1e-12
   relative); ``cli.msh_processor`` (``--device cuda``) on the solution
   written by ``save_msh``: the max nodal |u|, the smoothed von Mises
   averaged on the elements (``outMSH``) and |u| sampled at a point,
   each against the same quantity computed on the card (1e-12); (d)
   ``python -m ...cli.mesh_convert --reflect x --clean --reorient
   --sortElements`` on the bench mesh equal to the bit to the in-process
   filters, ``python -m ...cli.tools triangulate`` on a .poly equal to
   ``triangulate_pslg``, and ``tools isotropic_validation`` (``--device
   cuda``) on a quadrant quality-meshed and reflected into a periodic cell
   (>= 50,000 triangles), its printed tensor against ``homogenize`` (1e-12
   of max); seconds of each; (e) kernels A and B (f32 rows at 2 values,
   B also f64) and E on the quality mesh's plans and geometry, each held
   against its plain version and timed; every kernel line carries
   ``launches_phase20_paths``;
21. last, ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

BENCH_N = 36                  # grid_tet(36, 36, 36), bench.py's size
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
# The material field's float64 relative residual gate, just above where
# its refinement stalls on the H100 (1.985e-10).  Phase 10's extended-
# precision witness holds the stall to float64: refined on with the same
# multigrid and long double residuals, the solution reaches 1.3e-13, and
# that solution rounded to float64 reads 1.2e-10 (long double) and 1.7e-10
# (the float64 EBE operator).
FIELD_RELRES_GATE = 3e-10
F32_FLOP_PER_S = 67e12        # H100 SXM float32, outside the tensor cores
F64_FLOP_PER_S = 34e12        # H100 SXM float64, outside the tensor cores


def log(*args):
    print(*args, flush=True)


class Timer:
    """Device time of one call: the median over ``reps`` launches, each
    between two CUDA events, with the 50 MB L2 flushed before each launch
    (the bounds count every byte once from device memory).  The card spins
    for ~1 ms after the flush, so the host has queued the call before the
    first event fires: the events time the device, not the host's Python
    and launch path (tens of microseconds on a busy host, as much as a
    small kernel).  The flush writes, so the L2 it leaves is dirty and the
    timed launch pays for writing it back as it evicts it; ``clean=True``
    flushes by reading instead, which times the kernel alone."""

    SPIN_CYCLES = 2_000_000

    def __init__(self, device):
        self.flush_buf = torch.empty(128 << 20, dtype=torch.int8,
                                     device=device)

    def __call__(self, fn, reps=15, warmup=2, clean=False):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            if clean:
                self.flush_buf.view(torch.int32).sum()
            else:
                self.flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        return times[len(times) // 2]


def median_apply_ms(apply, inputs):
    """Median over varied inputs of one apply's device time (warm L2, as
    inside CG)."""
    times = []
    for x in inputs:
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        apply(x)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    times.sort()
    return times[len(times) // 2]


def stage_ms(stages, inputs):
    """Device time of each stage of a hand-composed apply and of the whole
    sequence: an event between consecutive stages, warm L2 (as inside CG),
    the median over ``inputs`` after one warm-up sequence.  ``stages`` is a
    list of (name, function of the previous stage's result)."""
    per, whole = [[] for _ in stages], []
    for i, x in enumerate([inputs[0]] + list(inputs)):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(
            len(stages) + 1)]
        torch.cuda.synchronize()
        ev[0].record()
        for k, (_, fn) in enumerate(stages):
            x = fn(x)
            ev[k + 1].record()
        ev[-1].synchronize()
        if i == 0:
            continue
        for k in range(len(stages)):
            per[k].append(ev[k].elapsed_time(ev[k + 1]))
        whole.append(ev[0].elapsed_time(ev[-1]))
    med = lambda v: sorted(v)[len(v) // 2]
    return {name: med(v) for (name, _), v in zip(stages, per)}, med(whole), x


class ApplyCounter:
    """Counts the routed operator's applies (``apply_planes``,
    ``apply_block``, ``__call__``; one nested in another counts once) while
    active, by wrapping the class's methods."""

    NAMES = ("apply_planes", "apply_block", "__call__")

    def __init__(self):
        self.count = 0
        self._depth = 0

    def _wrap(self, fn):
        def counted(op, *args, **kw):
            self.count += self._depth == 0
            self._depth += 1
            try:
                return fn(op, *args, **kw)
            finally:
                self._depth -= 1
        return counted

    def __enter__(self):
        from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

        self._saved = {k: getattr(RoutedEBE, k) for k in self.NAMES}
        for k, fn in self._saved.items():
            setattr(RoutedEBE, k, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

        for k, fn in self._saved.items():
            setattr(RoutedEBE, k, fn)


def ulps_from(Ke32, K64):
    """max over entries of |Ke32 - K64| / (2^-23 |K64| + 2^-40 max|K64|):
    at most 1 when the float32 Ke32 is the float64 K64 rounded once, to
    within an ulp of each entry (the floor covers float64 rounding where
    an entry cancels to near zero; a float32 sum errs ~10^5 times more)."""
    floor = 2.0 ** -40 * float(K64.abs().max())
    worst = 0.0
    for a, b in zip(Ke32.reshape(-1).split(1 << 26),
                    K64.reshape(-1).split(1 << 26)):
        worst = max(worst, float(((a.double() - b).abs()
                                  / (2.0 ** -23 * b.abs() + floor)).max()))
    return worst


def check_rows_path(label, counts, applies, contraction=None):
    """A routed path: each apply launched kernel A in rows once and kernel
    B in rows, and no apply launched a kernel in planes (B in rows also
    carries the f64 residuals and the diagonal, so it counts more); on the
    factored backend each apply, a block apply too, also launched its
    ``contraction`` (kernel C or D) once, in rows."""
    log(f"{label}: {applies} routed applies; gather_rows "
        f"{counts['gather_rows']}, segment_sum_rows "
        f"{counts['segment_sum_rows']}, gather_planes "
        f"{counts['gather_planes']}, segment_sum_csr "
        f"{counts['segment_sum_csr']}" + (
            "" if contraction is None else
            f", {contraction} {counts[contraction]} (in rows "
            f"{counts[contraction + '/rows']})"))
    if not (applies > 0 and counts["gather_rows"] == applies
            and counts["segment_sum_rows"] >= applies
            and counts["gather_planes"] == 0
            and counts["segment_sum_csr"] == 0):
        raise RuntimeError(f"{label}: not every apply ran in node rows")
    if contraction is not None and not (
            counts[contraction] == applies
            and counts[contraction + "/rows"] == applies):
        raise RuntimeError(f"{label}: {contraction} did not run once an "
                           f"apply, in rows")


def clamped_problem(size, device):
    """bench.py:397-404: clamp x = 0, load the far face in -y.  ``size`` is
    n for grid_tet(n, n, n) or "bar" for bar_tet(6, 2, 2)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    if size == "bar":
        V, T = generators.bar_tet(6, 2, 2)
    else:
        V, T = generators.grid_tet(size, size, size)
    t0 = time.time()
    mesh = FEMMesh(V, T, degree=2)
    t_mesh = time.time() - t0
    t0 = time.time()
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                              device=device)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    t_sim = time.time() - t0
    X = mesh.node_positions
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
    sim.neumann_load = torch.as_tensor(load, device=sim.device)
    return sim, t_mesh, t_sim


def check_solution(sim, u, label, gate=1e-10):
    """u finite, of the right shape, float64 relative residual <= ``gate``
    through the EBE operator, and the energy balance u.Ku == b.u."""
    if tuple(u.shape) != (sim.num_dofs, sim.dim) or not bool(
            torch.isfinite(u).all()):
        raise RuntimeError(f"{label}: bad solution {tuple(u.shape)}")
    free = torch.as_tensor(~sim.dirichlet_mask, dtype=torch.float64,
                           device=sim.device)
    b = sim.neumann_load
    Ku = sim.apply_K(u)
    relres = float(torch.linalg.norm((b - Ku) * free)
                   / torch.linalg.norm(b * free))
    work = float(torch.vdot(b.reshape(-1), u.reshape(-1)))
    energy2 = float(torch.vdot(u.reshape(-1), Ku.reshape(-1)))
    balance = abs(energy2 - work) / abs(work)
    log(f"{label}: f64 relative residual {relres:.3e}, energy balance "
        f"|u.Ku - b.u|/|b.u| = {balance:.3e}, max |u| = "
        f"{float(u.abs().max()):.6e}")
    if not relres <= gate:
        raise RuntimeError(f"{label}: relative residual {relres:.3e} > "
                           f"{gate:.3e}")
    if not balance <= 1e-8:
        raise RuntimeError(f"{label}: energy balance {balance:.3e}")
    return relres


def counted(label, fn, required=()):
    """One counted run of ``fn``, the one form every phase measures a path
    in: launch counts zeroed just before, read just after (synchronised);
    each wrapper in ``required`` must have launched.  Returns (fn's result,
    host seconds, counts): each wrapper's launches by its name, kernel B's
    and A's float64 launches, a part of them, under ``<name>/f64``, and C's
    and D's launches in node rows, a part of them, under ``<name>/rows``."""
    from meshfem_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {w.__name__: w.launches for w in kernels.WRAPPERS}
    for part in ("f64", "rows"):
        counts.update({f"{w.__name__}/{part}": getattr(w, "launches_" + part)
                       for w in kernels.WRAPPERS
                       if hasattr(w, "launches_" + part)})
    for name in required:
        if counts[name] == 0:
            raise RuntimeError(f"{label}: {name} was not launched")
    return out, wall, counts


def drive_solve(sim, label, required):
    """One counted run of the user's entry points ``sim.routed_kernel`` (the
    operator is built anew, timed apart) and ``sim.solve``: counts are
    zeroed just before and read just after; each wrapper in ``required``
    must have launched."""
    def build_and_solve():
        t0 = time.time()
        sim.routed_kernel()
        torch.cuda.synchronize()
        t_build = time.time() - t0
        return sim.solve(operator="routed", tol=1e-10), t_build

    sim._routed = None
    with ApplyCounter() as applies:
        ((u, res), t_build), wall, counts = counted(label, build_and_solve,
                                                    required)
    wall -= t_build
    log(f"{label}: operator built in {t_build:.3f} s; "
        f"solve {wall:.3f} s, {res.rounds} refinement rounds, "
        f"{res.iters} inner CG iterations, relres {res.resnorm:.3e}, "
        f"launches {counts}")
    return u, res, wall, counts, applies.count


def void_cell(n):
    """grid_tet(n, n, n) on the unit cube with the tets whose centroid lies
    within 0.3 of the centre removed and the vertices renumbered: a
    periodic cell with a spherical void."""
    from meshfem_tpu_torch.mesh import generators

    V, T = generators.grid_tet(n, n, n)
    cent = V[T].mean(axis=1)
    T2 = T[((cent - 0.5) ** 2).sum(axis=1) > 0.3 ** 2]
    used = np.unique(T2)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[T2].astype(np.int32)


def block_residual(sim, w):
    """Float64 relative residual of the cell problems through the EBE
    operator, translations projected: (whole-block norm, per column)."""
    from meshfem_tpu_torch.analysis import homogenization as hom

    X = torch.zeros((sim.num_dofs, sim.dim, w.shape[0]), dtype=torch.float64,
                    device=sim.device)
    X[sim._dof_map_t] = w.movedim(0, -1)
    B = hom._project_translations(hom._cell_loads(sim))
    R = hom._project_translations(B - sim.apply_K(X))
    cols = (torch.linalg.norm(R.reshape(-1, R.shape[-1]), dim=0)
            / torch.linalg.norm(B.reshape(-1, B.shape[-1]), dim=0))
    return float(torch.linalg.norm(R) / torch.linalg.norm(B)), cols.tolist()


def drive_homogenize(mesh, material, label, env, required,
                     precond="block"):
    """One counted run of the user's entry point ``homogenize`` (with
    ``precond``) under the contraction switches ``env``: counts are zeroed
    just before and read just after; each wrapper in ``required`` must
    have launched.  The block CG is wrapped to record the inner iterations
    of every refinement round."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.solvers import cg as cg_mod

    for k in ("MESHFEM_FACTORED", "MESHFEM_FACTORED_TQ"):
        os.environ.pop(k, None)
    os.environ.update(env)
    rounds, cg_seconds = [], []
    inner = cg_mod.cg_block

    def recording(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.time()
        res = inner(*args, **kw)
        torch.cuda.synchronize()
        cg_seconds.append(time.time() - t0)
        rounds.append(int(res.iters))
        return res

    cg_mod.cg_block = recording
    try:
        with warnings.catch_warnings(record=True) as caught, \
                ApplyCounter() as applies:
            warnings.simplefilter("always")
            res, wall, counts = counted(
                label, lambda: hom.homogenize(mesh, material, tol=1e-10,
                                              precond=precond),
                required)
    finally:
        cg_mod.cg_block = inner
        for k in env:
            os.environ.pop(k, None)
    stagnated = [str(c.message) for c in caught
                 if "stagnated" in str(c.message)]
    iters = sum(rounds)
    cg_s = sum(cg_seconds)
    log(f"{label}: homogenize {wall:.3f} s ({cg_s:.3f} s in the block CG, "
        f"the rest set-up, f64 residuals and the tensor), {len(rounds)} "
        f"refinement rounds {rounds}, {iters} block CG iterations, "
        f"{cg_s / max(iters, 1) * 1e3:.4f} ms per block iteration (host "
        f"clock around the block CG), launches {counts}")
    for msg in stagnated:
        log(f"{label}: WARNING {msg}")
    return res, dict(seconds=wall, block_cg_seconds=cg_s,
                     block_iter_ms=cg_s / max(iters, 1) * 1e3,
                     rounds=len(rounds), round_iters=rounds,
                     inner_iters=iters, stagnated=bool(stagnated),
                     launches=counts, applies=applies.count)


def check_homogenized(sim, res, label, D, phi, gate):
    """Residual and tensor gates of one homogenization run."""
    Ch = res.Ch
    relres, cols = block_residual(sim, res.w)
    log(f"{label}: f64 block relative residual {relres:.3e} (columns "
        + ", ".join(f"{c:.2e}" for c in cols) + ")")
    if not relres <= gate:
        raise RuntimeError(f"{label}: block residual {relres:.3e} > {gate}")
    if tuple(Ch.shape) != tuple(D.shape) \
            or not bool(torch.isfinite(Ch).all()) \
            or not bool(torch.isfinite(res.w).all()):
        raise RuntimeError(f"{label}: Ch or w not finite")
    scale = float(Ch.abs().max())
    asym = float((Ch - Ch.t()).abs().max()) / scale
    Cs = 0.5 * (Ch + Ch.t())
    emin = float(torch.linalg.eigvalsh(Cs).min())
    voigt = float(torch.linalg.eigvalsh((1.0 - phi) * D - Cs).min())
    log(f"{label}: Ch[0,0] {float(Ch[0, 0]):.6f} (D[0,0] "
        f"{float(D[0, 0]):.6f}), asymmetry {asym:.2e} of max|Ch|, min "
        f"eigenvalue {emin:.4f}, min eig((1-phi) D - Ch) {voigt:.4f}")
    if not asym <= 1e-8:
        raise RuntimeError(f"{label}: Ch not symmetric: {asym:.3e}")
    if not emin > 0:
        raise RuntimeError(f"{label}: Ch not positive definite")
    if not float(Ch[0, 0]) < float(D[0, 0]):
        raise RuntimeError(f"{label}: the void did not soften the cell")
    if not voigt >= -1e-8 * scale:
        raise RuntimeError(f"{label}: Ch above the Voigt bound")
    return relres, cols


def small_cell_check(dev):
    """grid_tet(4,4,4) P2 with a soft inclusion (MaterialField): routed on
    the card against the float64 EBE block solve on the CPU."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import MaterialField

    V, T = generators.grid_tet(4, 4, 4)
    mesh = FEMMesh(V, T, degree=2)
    cent = V[T].mean(axis=1)
    young = np.where(((cent - 0.5) ** 2).sum(axis=1) < 0.09, 0.2, 2.0)
    mat = MaterialField.isotropic_field(3, young, np.full(len(young), 0.3))
    out = {}
    for name, device, op in (("card", dev, "routed"), ("cpu", "cpu", "ebe")):
        sim = hom.periodic_simulator(mesh, mat, device=device)
        w, _ = hom.solve_cell_problems(sim, tol=1e-12, operator=op)
        w = w - w.mean(dim=1, keepdim=True)
        out[name] = (w.cpu(), hom.homogenized_tensor_stress_form(sim, w).cpu())
    dw = float((out["card"][0] - out["cpu"][0]).abs().max()
               / out["cpu"][0].abs().max())
    dC = float((out["card"][1] - out["cpu"][1]).abs().max()
               / out["cpu"][1].abs().max())
    log(f"small periodic cell (grid_tet(4) P2, soft inclusion): card routed "
        f"vs CPU f64 EBE: w {dw:.3e}, Ch {dC:.3e} of max")
    if not (dw <= 1e-8 and dC <= 1e-8):
        raise RuntimeError("small periodic cell disagrees with the CPU path")
    return dw, dC


def structured_solve(sim, label, mg_name, required):
    """One counted run of the user's default call ``sim.solve(tol=1e-10)``
    (operator "auto"): counts zeroed just before, read just after.  The
    solve must have built ``mg_name`` in float32 and every wrapper in
    ``required`` must have launched.  The build time (host clock) and the
    rounds come from what the solve records (``sim._mg``,
    ``res.history``); the ms per MG-PCG iteration from one inner solve of
    the first round's right-hand side, timed alone after the run."""
    sim._mg = None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (u, res), wall, counts = counted(
            label, lambda: sim.solve(tol=1e-10), required)
    mg = sim._mg[1] if sim._mg is not None else None
    if type(mg).__name__ != mg_name or mg.free_ch.dtype != torch.float32:
        raise RuntimeError(f"{label}: the default call did not build a "
                           f"float32 {mg_name} (got {type(mg).__name__})")
    free = torch.as_tensor(~sim.dirichlet_mask, dtype=torch.float32,
                           device=sim.device)
    b32 = sim.neumann_load.float() * free
    torch.cuda.synchronize()
    t0 = time.time()
    _, inner = mg.solve(b32, tol=1e-4, maxiter=120)
    torch.cuda.synchronize()
    inner_s = time.time() - t0
    build_s = sim._mg[2]
    out = dict(build_s=build_s, solve_s=wall,
               solve_minus_build_s=wall - build_s,
               rounds=res.rounds, round_iters=[it for _, it in res.history],
               round_relres=[rel for rel, _ in res.history],
               mg_pcg_iters=res.iters, relres=res.resnorm,
               inner_solve_s=inner_s, inner_solve_iters=int(inner.iters),
               ms_per_mg_pcg_iter=inner_s / max(int(inner.iters), 1) * 1e3,
               launches=counts, levels=[list(lvl.n3) for lvl in mg.levels],
               coarse="dense inverse" if mg.coarse_inv is not None
               else "host LU", lam=list(mg.lam),
               stagnated=[str(c.message) for c in caught
                          if "stagnated" in str(c.message)])
    if mg_name == "StructuredMG":
        # every fine apply runs the shell correction, kernel A once
        out["fine_applies"] = counts["gather_rows"]
    log(f"{label}: {mg_name} built in {build_s:.3f} s (host clock; levels "
        f"{out['levels']}, coarsest {out['coarse']}); solve {wall:.3f} s "
        f"with the build, {res.rounds} refinement rounds, MG-PCG iterations "
        f"{out['round_iters']} = {res.iters} (the reference's float64 solve "
        f"on the CPU: 24), f64 relative residual before each round "
        + ", ".join(f"{r:.3e}" for r in out["round_relres"])
        + f", final {res.resnorm:.3e}; {out['ms_per_mg_pcg_iter']:.3f} ms per "
        f"MG-PCG iteration (one inner solve alone, {int(inner.iters)} "
        f"iterations in {inner_s:.3f} s, host clock); launches gather_rows "
        f"{counts['gather_rows']}, segment_sum_rows "
        f"{counts['segment_sum_rows']} (kernel B: "
        f"{counts['segment_sum_rows'] - counts['segment_sum_rows/f64']} "
        f"float32 shell sums, {counts['segment_sum_rows/f64']} float64 EBE "
        f"residual sums)")
    for msg in out["stagnated"]:
        log(f"{label}: WARNING {msg}")
    return u, res, mg, out


def extended_witness(sim, u, mg, rounds=3):
    """A second reading of a float64 solve's residual, in the host's
    extended precision (long double, a 64-bit significand: rounding in
    the residual itself stays ~2^-11 of float64's).  It reads (1) the
    solve's ``u``; (2) ``u`` refined ``rounds`` more times with the same
    float32 multigrid's inner solve (``mg.solve(r32, tol=1e-4,
    maxiter=120)``), each residual taken in extended precision, which
    separates a multigrid that stops correcting from a float64 residual
    that stops seeing; (3) that near-exact solution rounded to float64,
    read in extended precision and through the float64 EBE operator: the
    residual a float64 solution can show here."""
    ld = np.longdouble
    if not np.finfo(ld).eps <= 2.0 ** -60:
        raise RuntimeError("the host's long double is not extended "
                           "precision")
    Ke = sim.Ke.cpu().numpy()
    ed = sim.elem_dofs.cpu().numpy()
    free = ~sim.dirichlet_mask
    b = sim.neumann_load.cpu().numpy().astype(ld) * free
    bn = np.sqrt((b * b).sum())
    chunk = 16384

    def resid(x):
        y = np.zeros(x.shape, dtype=ld)
        for s in range(0, ed.shape[0], chunk):
            e = ed[s:s + chunk]
            fe = np.matmul(Ke[s:s + chunk].astype(ld),
                           x[e].reshape(len(e), -1, 1))
            np.add.at(y, e.reshape(-1), fe.reshape(-1, x.shape[1]))
        r = (b - y) * free
        return r, float(np.sqrt((r * r).sum()) / bn)

    t0 = time.time()
    x = u.cpu().numpy().astype(ld)
    r, rel = resid(x)
    history, iters = [rel], []
    for _ in range(rounds):
        dx, res = mg.solve(torch.as_tensor(r.astype(np.float64),
                                           dtype=torch.float32,
                                           device=sim.device),
                           tol=1e-4, maxiter=120)
        iters.append(int(res.iters))
        x = x + dx.cpu().numpy().astype(ld)
        r, rel = resid(x)
        history.append(rel)
    x64 = x.astype(np.float64)
    _, rel_rounded = resid(x64.astype(ld))
    xt = torch.as_tensor(x64, device=sim.device)
    free_t = torch.as_tensor(free, dtype=torch.float64, device=sim.device)
    rel_rounded_f64 = float(
        torch.linalg.norm((sim.neumann_load - sim.apply_K(xt)) * free_t)
        / torch.linalg.norm(sim.neumann_load * free_t))
    du = float((u - xt).abs().max() / xt.abs().max())
    return dict(relres_u=history[0], history=history, iters=iters,
                relres_rounded=rel_rounded,
                relres_rounded_f64=rel_rounded_f64, u_vs_refined=du,
                seconds=time.time() - t0)


def device_busy(fn):
    """Device kernels one call launches and their summed device time
    (``torch.profiler``), beside the call's host-clock time measured apart
    without the profiler (synchronised): the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    return dict(launches=len(kern), busy_ms=busy_ms, wall_ms=wall_ms,
                idle_share=1.0 - busy_ms / wall_ms if busy_ms else None)


def drive_structured(sim, u_routed, dev, gen):
    """The structured multigrid at full width: the default call on the bench
    problem, the material field, card against CPU, the TF32 switches, the
    shell correction's kernels against their plain versions, and the stage
    times."""
    import torch.nn.functional as F

    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.ops.structured import StructuredP2Elasticity
    from meshfem_tpu_torch.physics import (ElasticitySimulator,
                                           MaterialField)

    if torch.backends.cudnn.allow_tf32 or \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the V-cycle needs full float32 "
                           "products")
    log("TF32: cudnn.allow_tf32 False, cuda.matmul.allow_tf32 False")
    torch.cuda.reset_peak_memory_stats()

    # the default call on the bench problem
    u, res, mg, out = structured_solve(
        sim, "structured default solve", "StructuredMG",
        ("gather_rows", "segment_sum_rows"))
    out["relres_ebe"] = check_solution(sim, u, "structured default solve")
    du = float((u - u_routed).abs().max() / u_routed.abs().max())
    log(f"structured vs routed solution: {du:.3e} of max|u_routed|")
    if not du <= 1e-6:
        raise RuntimeError(f"structured and routed solutions differ: {du}")
    out["vs_routed"] = du
    out["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # the material field: a 1000:1 spherical inclusion on the same grid
    mesh = sim.mesh
    cent = mesh.V[mesh.F].mean(axis=1)
    young = np.where(((cent - 0.5) ** 2).sum(axis=1) < 0.08, 1000.0, 1.0)
    fsim = ElasticitySimulator(
        mesh, MaterialField.isotropic_field(3, young,
                                            np.full(len(young), 0.3)),
        device=dev)
    fsim.dirichlet_mask[:] = sim.dirichlet_mask
    fsim.neumann_load = sim.neumann_load
    uf, _, fmg, fout = structured_solve(fsim, "structured material field",
                                        "VarStructuredMG",
                                        ("segment_sum_rows",))
    # Its refinement stalls near 2e-10 through the float64 EBE operator.
    # The extended-precision witness reads the same residual without that
    # operator's rounding and refines on with the same multigrid: it must
    # converge (else the multigrid is at fault), and it shows what a
    # float64 solution can read here.  Both are printed before any gate.
    wit = extended_witness(fsim, uf, fmg)
    log(f"structured material field, extended-precision witness "
        f"({wit['seconds']:.1f} s on the host): relative residual of u "
        f"{wit['relres_u']:.3e}; refined on with VarStructuredMG "
        f"({wit['iters']} iterations) " + " -> ".join(
            f"{r:.3e}" for r in wit["history"])
        + f"; that solution rounded to float64 reads "
        f"{wit['relres_rounded']:.3e} (extended) and "
        f"{wit['relres_rounded_f64']:.3e} (float64 EBE operator); "
        f"max|u - u_refined| / max|u_refined| {wit['u_vs_refined']:.3e}")
    fout["witness"] = wit
    fout["relres_ebe"] = check_solution(fsim, uf, "structured material "
                                        "field", FIELD_RELRES_GATE)
    if not wit["history"][-1] <= 1e-12:
        raise RuntimeError(f"structured material field: VarStructuredMG's "
                           f"corrections stop at {wit['history'][-1]:.3e} "
                           f"with an extended-precision residual")
    if not wit["u_vs_refined"] <= 1e-10:
        raise RuntimeError(f"structured material field: u is "
                           f"{wit['u_vs_refined']:.3e} from the refined "
                           f"solution")
    fout["stiff_share"] = float((young > 1).mean())
    out["material_field"] = fout
    del fsim, uf

    # card against CPU on a small grid
    small = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        ssim, _, _ = clamped_problem(8, device)
        us, rs = ssim.solve(tol=1e-10)
        small[name] = (us.cpu(), rs, type(ssim._mg[1]).__name__)
    d_small = float((small["card"][0] - small["cpu"][0]).abs().max()
                    / small["cpu"][0].abs().max())
    log(f"small grid (grid_tet(8) P2, clamped): card {small['card'][2]} "
        f"float32 in refinement ({small['card'][1].rounds} rounds, "
        f"{small['card'][1].iters} iterations) vs CPU float64 "
        f"({small['cpu'][1].iters} iterations): {d_small:.3e} of max|u|")
    if not (small["card"][2] == small["cpu"][2] == "StructuredMG"
            and d_small <= 1e-7):
        raise RuntimeError("small grid: card and CPU structured solves "
                           "disagree")
    out["small_card_vs_cpu"] = d_small

    # the f32 conv apply against the f64 apply, and A and B at the shell's
    # shapes against their plain versions
    op = mg.fine
    N = op.num_slots
    xs = [torch.randn((N, 3), generator=gen, device=dev) * op.valid_mask()
          for _ in range(7)]
    op64 = StructuredP2Elasticity.build(mesh, sim.D, device="cpu")
    y32 = op.apply_channels(xs[0])
    y64 = op64.apply_channels(xs[0].cpu().double())
    rel_apply = float((y32.cpu().double() - y64).abs().max()
                      / y64.abs().max())
    log(f"structured apply: card float32 vs CPU float64 {rel_apply:.3e} of "
        f"max|y|")
    if not rel_apply <= 1e-5:
        raise RuntimeError(f"structured f32 apply disagrees: {rel_apply}")
    out["apply_f32_vs_f64"] = rel_apply
    del op64, y64
    ids, plan = op.fake_ids, op.fake_plan
    g = kernels.gather_rows(xs[0], ids)
    if not torch.equal(g, kernels.gather_rows_plain(xs[0], ids)):
        raise RuntimeError("gather_rows at the shell's shapes != plain")
    fe = (g.view(-1, 81) @ op.K_cube.t()).view(-1, 3)
    s = kernels.segment_sum_rows(fe, plan.perm, plan.offsets)
    s_ref = kernels.segment_sum_rows_plain(fe, plan.perm, plan.offsets)
    err_shell_b = float((s - s_ref).abs().max())
    if not err_shell_b <= 1e-5 * float(s_ref.abs().max()):
        raise RuntimeError(f"segment_sum_rows at the shell's shapes "
                           f"disagrees: {err_shell_b}")
    R, S = ids.shape[0], plan.num_segments
    nkept = int(plan.perm.shape[0])
    log(f"shell correction: {R // 27} fake cubes, {R} rows ({nkept} in the "
        f"box) -> {S} shell slots; A equal to plain, B {err_shell_b:.3e} "
        f"max abs err")

    # stage times (events, warm L2, median over the inputs)
    mx, my, mz = (c + 1 for c in op.n3)
    conv = lambda x: F.conv3d(x.view(1, mx, my, mz, 24).permute(0, 4, 1, 2,
                                                              3),
                              op.weight, padding=1)
    rc = [x.view(mg.free_ch.shape) * mg.free_ch for x in xs]
    # the stencil's nonzeros; assembly leaves ~1e-16-relative roundoff in
    # a few hundred further entries, which are counted apart
    nz_exact = int(np.count_nonzero(op.kernel))
    nz = int(np.count_nonzero(np.abs(op.kernel)
                              > 1e-12 * np.abs(op.kernel).max()))
    nz_blocks = int(np.count_nonzero(np.abs(op.kernel).reshape(
        27, 8, 3, 8, 3).sum(axis=(2, 4))))
    points = mx * my * mz
    stages = dict(
        conv_ms=median_apply_ms(conv, xs),
        shell_correction_ms=median_apply_ms(op._shell_correction, xs),
        shell_gather_ms=median_apply_ms(
            lambda x: kernels.gather_rows(x, ids), xs),
        shell_sum_ms=median_apply_ms(
            lambda x: kernels.segment_sum_rows(fe, plan.perm, plan.offsets),
            xs),
        apply_ms=median_apply_ms(op.apply_channels, xs),
        p1_apply_ms={str(lvl.n3[0]): median_apply_ms(
            lvl.apply, [torch.randn(lvl.free.shape, generator=gen,
                                    device=dev) for _ in range(7)])
            for lvl in mg.levels},
        v_cycle_ms=median_apply_ms(mg.precondition, rc))
    conv_bytes = 2 * points * 24 * 4 + op.weight.numel() * 4
    stages.update(
        conv_bound_bytes_ms=conv_bytes / HBM_BYTES_PER_S * 1e3,
        conv_bound_ops_ms=2 * nz * points / F32_FLOP_PER_S * 1e3,
        conv_dense_ops_ms=2 * op.weight.numel() * points / F32_FLOP_PER_S
        * 1e3,
        stencil_nonzeros=nz, stencil_nonzeros_exact=nz_exact,
        stencil_nonzero_blocks=nz_blocks,
        dense_macs_per_point=op.weight.numel(),
        conv_launches_default_solve=out["fine_applies"])
    stages["conv_bound_ms"] = max(stages["conv_bound_bytes_ms"],
                                  stages["conv_bound_ops_ms"])
    log(f"structured stages (ms, events, warm L2): conv "
        f"{stages['conv_ms']:.4f} (bound {stages['conv_bound_ms']:.4f}: "
        f"bytes {stages['conv_bound_bytes_ms']:.4f}, the stencil's {nz} "
        f"nonzero multiply-adds a point ({nz_blocks} of 1728 blocks) "
        f"{stages['conv_bound_ops_ms']:.4f}; the dense conv's "
        f"{op.weight.numel()} a point {stages['conv_dense_ops_ms']:.4f}), "
        f"shell correction {stages['shell_correction_ms']:.4f} (A "
        f"{stages['shell_gather_ms']:.4f}, B {stages['shell_sum_ms']:.4f}), "
        f"whole apply {stages['apply_ms']:.4f}, P1 apply "
        + ", ".join(f"{k}^3 {v:.4f}" for k, v in
                    stages["p1_apply_ms"].items())
        + f", V-cycle {stages['v_cycle_ms']:.4f}; "
        f"{out['ms_per_mg_pcg_iter']:.3f} ms per MG-PCG iteration (host)")
    out["stages"] = stages
    out["device_busy"] = {
        "v_cycle": device_busy(lambda: mg.precondition(rc[0])),
        "inner_solve": device_busy(lambda: mg.solve(
            sim.neumann_load.float(), tol=1e-4, maxiter=120))}
    for k, v in out["device_busy"].items():
        log(f"structured {k}: {v['launches']} device kernels, busy "
            f"{v['busy_ms']:.3f} ms of {v['wall_ms']:.3f} ms on the host "
            f"clock (idle share {v['idle_share']:.3f})"
            if v["busy_ms"] else f"structured {k}: device time not "
            f"measured (the profiler saw no device kernel)")
    out["shell"] = dict(rows=R, rows_in_box=nkept, segments=S,
                        sum_max_abs_err=err_shell_b)
    return out, (xs[0], ids, fe, plan, lambda: conv(xs[0]))


def bc_json(regions, no_rigid_motion=False):
    return json.dumps({"no_rigid_motion": no_rigid_motion,
                       "regions": regions})


FACE_X0 = {"box%": {"minCorner": [-0.001, -0.001, -0.001],
                    "maxCorner": [0.001, 1.001, 1.001]}}
FACE_X1 = {"box%": {"minCorner": [0.999, -0.001, -0.001],
                    "maxCorner": [1.001, 1.001, 1.001]}}
# the reference README's quick start regions: a clamp, and the force
# [0, 0, -10] on the far face
QUICKSTART_BC = bc_json([{"type": "dirichlet", "value": [0, 0, 0], **FACE_X0},
                         {"type": "force", "value": [0, 0, -10], **FACE_X1}])
# a free body in uniform tension: equal and opposite end forces
FREE_BODY_BC = bc_json([{"type": "force", "value": [-1, 0, 0], **FACE_X0},
                        {"type": "force", "value": [1, 0, 0], **FACE_X1}],
                       no_rigid_motion=True)


def bc_simulator(mesh, dev, text, label):
    """A simulator of ``mesh`` with ``parse_bc(text)`` applied, the host
    seconds of the boundary-condition matching printed."""
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           parse_bc)

    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, 0.3),
                              device=dev)
    t0 = time.time()
    sim.apply_boundary_conditions(parse_bc(text, dim=3))
    t_bc = time.time() - t0
    log(f"{label}: apply_boundary_conditions {t_bc:.3f} s on the host "
        f"({mesh.num_boundary_elements} boundary triangles), "
        f"{int(sim.dirichlet_mask.sum())} fixed dofs, total load "
        f"{sim.neumann_load.sum(dim=0).tolist()}")
    return sim, t_bc


def own_mode(counts, name):
    """The launches, in ``counts`` (as ``counted`` reads them), of the
    report line ``name``'s own mode: a kernel A or B line takes its
    dtype's (``.../f64`` lines the float64 launches, the others the float32
    ones; the widths of one dtype together), a kernel C or D line its
    layout's (``.../rows`` lines the launches in node rows, the others
    those in planes), any other line its wrapper's."""
    wrapper = name.split("/")[0]
    for part in ("f64", "rows"):
        if f"{wrapper}/{part}" in counts:
            sub = counts[f"{wrapper}/{part}"]
            return sub if f"/{part}" in name else counts[wrapper] - sub
    return counts[wrapper]


def check_rows_on_plan(plan, dtype, label, gen, P=3):
    """Kernel B in rows on a path's own ``plan`` and shapes: random
    contribution rows ``[R, P]`` in ``dtype`` on the card must sum bit for
    bit as B in planes sums them, and as the plain version sums them on
    the CPU (in the kernel's order); the plain version on the card (float
    atomics) must agree to 1e-5 (float32) or 1e-12 (float64) of max|y|.
    Returns the max abs error against the card's plain version."""
    from meshfem_tpu_torch import kernels

    src = torch.randn((plan.num_rows, P), generator=gen, device=gen.device,
                      dtype=dtype)
    y = kernels.segment_sum_rows(src, plan.perm, plan.offsets)
    yp = kernels.segment_sum_csr(src.t().contiguous(), plan.perm,
                                 plan.offsets)
    y_cpu = kernels.segment_sum_rows_plain(src.cpu(), plan.perm.cpu(),
                                           plan.offsets.cpu())
    ref = kernels.segment_sum_rows_plain(src, plan.perm, plan.offsets)
    err = float((y - ref).abs().max())
    gate = (1e-5 if dtype == torch.float32 else 1e-12) \
        * float(ref.abs().max())
    if not (torch.equal(y.t(), yp) and torch.equal(y.cpu(), y_cpu)):
        raise RuntimeError(f"{label}: segment_sum_rows {dtype} on the path's "
                           f"plan != segment_sum_csr / the CPU plain sum bit "
                           f"for bit")
    if not err <= gate:
        raise RuntimeError(f"{label}: segment_sum_rows {dtype} disagrees "
                           f"with plain: {err:.3e}")
    return err


def drive_bc(mesh, dev):
    """Phases 11a-d: the boundary-condition front end, the rigid-motion
    projection and warm starts at full width, and the README quick start.
    Returns (summary, launch counts per path)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           parse_bc)
    from meshfem_tpu_torch.solvers import cg as cg_mod
    from meshfem_tpu_torch.utils.linalg import orthonormalize

    out, paths = {}, {}
    # -- 11a. the quick start at bench size: the default call ------------
    sim, t_bc = bc_simulator(mesh, dev, QUICKSTART_BC, "quick start (bench)")
    (u, res), wall, paths["quickstart_bench"] = counted(
        "quick start (bench)", lambda: sim.solve(tol=1e-10),
        ("gather_rows", "segment_sum_rows"))
    if sim._mg is None or type(sim._mg[1]).__name__ != "StructuredMG":
        raise RuntimeError("quick start (bench): the default call did not "
                           "take the structured multigrid")
    relres = check_solution(sim, u, "quick start (bench)")
    reaction = sim.report_region_surface_forces(u)
    err_r = float(np.abs(reaction[0] - [0.0, 0.0, 10.0]).max() / 10.0)
    log(f"quick start (bench): structured, {wall:.3f} s (MG build "
        f"{sim._mg[2]:.3f} s), {res.rounds} rounds, {res.iters} MG-PCG "
        f"iterations, relres {res.resnorm:.3e}; clamp reaction "
        f"{reaction[0].tolist()} ({err_r:.3e} from (0, 0, 10), relative); "
        f"launches {paths['quickstart_bench']}")
    if not (reaction.shape == (1, 3) and err_r <= 1e-8):
        raise RuntimeError(f"quick start (bench): reaction {reaction} is "
                           f"not (0, 0, 10)")
    out["quickstart_bench"] = dict(
        bc_s=t_bc, solve_s=wall, mg_build_s=sim._mg[2], rounds=res.rounds,
        mg_pcg_iters=res.iters, relres=relres,
        reaction=reaction[0].tolist(), reaction_rel_err=err_r)

    # -- 11c. warm starts on the same problem, routed --------------------
    def warm():
        r0 = sim.solve(operator="routed", tol=1e-10, x0=u)
        r1 = sim.solve(operator="routed", tol=1e-10, x0=0.5 * u)
        return r0, r1

    ((u0, r0), (uh, rh)), wall_w, paths["warm_start"] = counted(
        "warm start", warm, ("gather_rows", "segment_sum_rows",
                             "element_stiffness"))
    (uc, rc), wall_c, _ = counted(
        "cold routed", lambda: sim.solve(operator="routed", tol=1e-10), ())
    du_h = float((uh - u).abs().max() / u.abs().max())
    log(f"warm start (routed): from u {r0.rounds} rounds, {r0.iters} inner "
        f"iterations, relres {r0.resnorm:.3e}; from u/2 {rh.rounds} rounds, "
        f"{rh.iters} inner iterations, relres {rh.resnorm:.3e}, "
        f"{du_h:.3e} of max|u| from the structured u; cold {rc.rounds} "
        f"rounds, {rc.iters} inner iterations ({wall_c:.3f} s); the two "
        f"warm solves {wall_w:.3f} s with the routed build; launches "
        f"{paths['warm_start']}")
    if not (r0.rounds == 0 and rh.resnorm <= 1e-10 and rc.resnorm <= 1e-10
            and du_h <= 1e-6):
        raise RuntimeError("warm start: x0 = u did not return at once, or "
                           "a routed solve missed 1e-10")
    try:
        sim.solve(operator="structured", tol=1e-10, x0=u)
        raise RuntimeError("warm start: operator='structured' took x0")
    except ValueError:
        pass
    out["warm_start"] = dict(
        rounds_from_u=r0.rounds, rounds_from_half=rh.rounds,
        inner_iters_from_half=rh.iters, cold_rounds=rc.rounds,
        cold_inner_iters=rc.iters, cold_solve_s=wall_c,
        warm_pair_s=wall_w, relres_from_half=rh.resnorm)
    del sim, u, u0, uh, uc

    # -- 11b. a free body in tension: routed dense, then factored --------
    X = torch.as_tensor(mesh.node_positions, device=dev)
    exact = torch.stack([X[:, 0] / 200, -0.3 * X[:, 1] / 200,
                         -0.3 * X[:, 2] / 200], dim=1)
    for name, env, required in (
            ("dense", {}, ("gather_rows", "segment_sum_rows",
                           "element_stiffness")),
            ("factored", {"MESHFEM_FACTORED": "1"},
             ("gather_rows", "segment_sum_rows", "qp_contract"))):
        label = f"free body ({name})"
        fsim, t_bc = bc_simulator(mesh, dev, FREE_BODY_BC, label)
        if not fsim.no_rigid_motion:
            raise RuntimeError(f"{label}: no_rigid_motion not set")
        t0 = time.time()
        Z = fsim._rigid_basis()
        torch.cuda.synchronize()
        t_z = time.time() - t0
        def build_and_solve():
            t0 = time.time()
            fsim.routed_kernel()
            torch.cuda.synchronize()
            t_build = time.time() - t0
            return fsim.solve(tol=1e-10), t_build

        os.environ.update(env)
        try:
            with ApplyCounter() as applies:
                ((uf, rf), t_build), wall, paths["free_body_" + name] = \
                    counted(label, build_and_solve, required)
        finally:
            for k in env:
                os.environ.pop(k, None)
        if name == "factored":
            check_rows_path(label, paths["free_body_" + name], applies.count,
                            "qp_contract")
        if fsim._routed is None or (fsim._routed.KeP is None) != bool(env):
            raise RuntimeError(f"{label}: the solve did not take the routed "
                               f"{name} operator")
        project = cg_mod.nullspace_projector(Z)
        b = fsim.neumann_load
        relres = float(torch.linalg.norm(project(b - fsim.apply_K(uf)))
                       / torch.linalg.norm(project(b)))
        Q = orthonormalize(Z)
        rigid = float(torch.linalg.norm(Q.t() @ uf.reshape(-1))
                      / torch.linalg.norm(uf))
        s_err = float((fsim.average_stress_field(uf) - torch.tensor(
            [1.0, 0, 0, 0, 0, 0], dtype=uf.dtype, device=dev)).abs().max())
        pe = project(exact)
        u_err = float((project(uf) - pe).abs().max() / pe.abs().max())
        iter_ms = (wall - t_build) / max(rf.iters, 1) * 1e3
        log(f"{label}: {wall:.3f} s with the routed build ({t_build:.3f} "
            f"s), {rf.rounds} rounds, {rf.iters} inner iterations, "
            f"{iter_ms:.4f} ms an iteration (host clock, the solve without "
            f"the build), projected f64 relative "
            f"residual {relres:.3e} (refinement's {rf.resnorm:.3e}); stress "
            f"max|s - (1,0,0,0,0,0)| {s_err:.3e}; u against the analytic "
            f"field, rigid modes removed, {u_err:.3e}; |Q^T u|/|u| "
            f"{rigid:.3e}; rigid modes built in {t_z:.3f} s on the host; "
            f"launches {paths['free_body_' + name]}")
        if not relres <= 1e-10:
            raise RuntimeError(f"{label}: projected residual {relres:.3e}")
        if not (s_err <= 1e-6 and u_err <= 1e-6):
            raise RuntimeError(f"{label}: not the uniform tension "
                               f"({s_err:.3e}, {u_err:.3e})")
        out["free_body_" + name] = dict(
            bc_s=t_bc, rigid_modes_s=t_z, solve_s=wall, build_s=t_build,
            iter_ms=iter_ms, rounds=rf.rounds, inner_iters=rf.iters,
            relres=relres, stress_err=s_err, u_err=u_err, rigid_share=rigid)
        if name == "dense":
            # the inner CG's float32 rigid-mode projection, built as the
            # routed solve builds it, beside the routed apply it follows
            rk = fsim._routed
            N = fsim.num_dofs
            Zp = rk.permute_in(Z.reshape(N, 3, -1)).permute(1, 0, 2) \
                .reshape(3 * N, -1)
            proj32 = cg_mod.nullspace_projector(Zp, dtype=torch.float32)
            vs = [torch.randn((3, N), device=dev) for _ in range(7)]
            k = Zp.shape[1]
            # Q read twice (Q^T v, then v - Q c), v twice, the result once
            proj_bytes = (2 * 3 * N * k + 3 * 3 * N) * 4
            out["rigid_projection"] = dict(
                ms=median_apply_ms(proj32, vs),
                bound_ms=proj_bytes / HBM_BYTES_PER_S * 1e3,
                apply_ms=median_apply_ms(rk.apply_planes, vs))
            log(f"{label}: the float32 rigid projection (planes [3, {N}], "
                f"basis [{3 * N}, {k}]) "
                f"{out['rigid_projection']['ms']:.4f} ms (events, warm L2; "
                f"bound {out['rigid_projection']['bound_ms']:.4f} ms by "
                f"bytes), the dense routed apply "
                f"{out['rigid_projection']['apply_ms']:.4f} ms")
            del rk, Zp, proj32, vs
        del fsim, uf, Z, Q, project
    del X, exact

    # -- 11d. the README quick start, literally, on the card -------------
    V, T = generators.bar_tet(12, 3, 3, length=4.0)
    qs = {}
    for where in ("card", "cpu"):
        qmesh = FEMMesh(V, T, degree=2)
        qsim = ElasticitySimulator(qmesh, Material.isotropic(3, 200.0, 0.35),
                                   device=dev if where == "card" else "cpu")
        qsim.fix_nodes(qmesh.nodes_in_box((0, 0, 0), (0, 1, 1)))
        qsim.apply_boundary_conditions(parse_bc(
            '{"regions": [{"type": "force", "value": [0, 0, -10], "box%": '
            '{"minCorner": [0.999, -0.001, -0.001], "maxCorner": '
            '[1.001, 1.001, 1.001]}}]}', dim=3))
        if where == "card":
            (uq, rq), wall, paths["readme_quickstart"] = counted(
                "README quick start", lambda: qsim.solve(tol=1e-10),
                ("segment_sum_rows",))
            if qsim._kernel32 is None or rq.rounds < 1:
                raise RuntimeError("README quick start: the card did not "
                                   "take the refined EBE branch")
            # B on this branch's own plans: the float32 inner CG's and the
            # float64 residual's (a wrong float32 B would only slow the
            # refinement, so the u gate below cannot catch it)
            gen = torch.Generator(device=dev).manual_seed(6)
            b_err = {str(t).split(".")[1]: check_rows_on_plan(
                k.plan, t, "README quick start", gen) for k, t in (
                    (qsim._kernel32, torch.float32),
                    (qsim._kernel, torch.float64))}
        else:
            uq, rq = qsim.solve(tol=1e-10)
        qs[where] = (uq.cpu(), rq)
    dq = float((qs["card"][0] - qs["cpu"][0]).abs().max()
               / qs["cpu"][0].abs().max())
    log(f"README quick start (bar_tet(12,3,3) P2, 648 tets): card "
        f"_solve_ebe_refined {qs['card'][1].rounds} rounds, "
        f"{qs['card'][1].iters} inner iterations, relres "
        f"{qs['card'][1].resnorm:.3e}, {wall:.3f} s; CPU float64 CG "
        f"{qs['cpu'][1].iters} iterations; u card vs CPU {dq:.3e} of max|u|; "
        f"B rows on its plans ([{qsim._kernel.plan.num_rows}, 3]) equal bit "
        f"for bit to B in planes and to the CPU's plain sum, max abs err "
        f"against the card's plain {b_err}; launches "
        f"{paths['readme_quickstart']}")
    if not (dq <= 1e-8 and qs["card"][1].resnorm <= 1e-10):
        raise RuntimeError(f"README quick start: card and CPU differ ({dq})")
    out["readme_quickstart"] = dict(
        rounds=qs["card"][1].rounds, inner_iters=qs["card"][1].iters,
        solve_s=wall, cpu_iters=qs["cpu"][1].iters, card_vs_cpu=dq,
        segment_sum_rows_max_abs_err=b_err)
    return out, paths


# ---------------------------------------------------------------------------
# Phase 12: voxel homogenization, the orthotropic cell, the two-level
# preconditioner and SIMP topology optimization
# ---------------------------------------------------------------------------

VOXEL_N = 36                  # the cross lattice at grid_tet(36)'s width
ORTHO_N = 36                  # the orthotropic 1/8 cell, grid_tet(36)
TWOLEVEL_N = 16               # host SuperLU of the P1 coarse space bounds it
TOPOPT_SHAPE = (64, 32, 32)   # 65,536 cells, 393,216 tets
TOPOPT_ITERS = 5
SMALL_N = 6                   # card against CPU


def cross_lattice(n):
    """The cross lattice of ``examples/homogenize_voxels.py`` at n^3."""
    lo, hi = n // 2 - max(n // 8, 1), n // 2 + max(n // 8, 1)
    occ = np.zeros((n, n, n), bool)
    occ[lo:hi, :, lo:hi] = True
    occ[:, lo:hi, lo:hi] = True
    occ[lo:hi, lo:hi, :] = True
    return occ


def sphere_field(V, T, centre, r2, contrast=1000.0):
    """A ``MaterialField`` with a ``contrast``:1 stiff sphere."""
    from meshfem_tpu_torch.physics import MaterialField

    cent = V[T].mean(axis=1)
    young = np.where(((cent - centre) ** 2).sum(axis=1) < r2, contrast, 1.0)
    return MaterialField.isotropic_field(3, young, np.full(len(young), 0.3))


def timed(fn):
    """(fn(), host seconds), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def rel_err(a, b):
    return float((a.cpu() - b.cpu()).abs().max() / b.cpu().abs().max())


def check_tensor(Ch, label, fl=6):
    """Ch finite, symmetric to 1e-8 of max|Ch|, positive definite; returns
    (asymmetry, smallest eigenvalue)."""
    Ch = Ch.detach().cpu()
    if tuple(Ch.shape) != (fl, fl) or not bool(torch.isfinite(Ch).all()):
        raise RuntimeError(f"{label}: Ch not a finite {fl} x {fl} tensor")
    asym = float((Ch - Ch.t()).abs().max() / Ch.abs().max())
    emin = float(torch.linalg.eigvalsh(0.5 * (Ch + Ch.t())).min())
    if not asym <= 1e-8:
        raise RuntimeError(f"{label}: Ch not symmetric: {asym:.3e}")
    if not emin > 0:
        raise RuntimeError(f"{label}: Ch not positive definite ({emin})")
    return asym, emin


def drive_voxels(dev):
    """12a: ``homogenize_voxels`` on the cross lattice at VOXEL_N; then the
    same cell by its parts (the periodic simulator, ``PeriodicVarMG.build``
    and ``solve_cell_problems_grid(sim, mg=mg)``), timed apart."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.ops import structured_periodic as sp
    from meshfem_tpu_torch.physics import MaterialField

    n = VOXEL_N
    occ = cross_lattice(n)
    torch.cuda.reset_peak_memory_stats()
    res, wall, counts = counted(
        "voxels", lambda: hom.homogenize_voxels(occ, device=dev),
        ("segment_sum_rows",))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    iters = max(res.cg_iters)

    # the same cell by its parts: the build and the block CG apart
    V, T = generators.grid_tet(n, n, n)
    E_field = np.repeat(np.where(occ.reshape(-1), 1.0, 1e-6), 6)
    sim = hom.periodic_simulator(
        FEMMesh(V, T, degree=2), MaterialField.isotropic_field(
            3, E_field, np.full(len(E_field), 0.3)), device=dev)
    mg, build_s = timed(lambda: sp.PeriodicVarMG.build(
        sim.mesh, sim.D, sim.dof_map, dtype=sim.Ke.dtype, device=dev))
    (_, iters2), solve_s = timed(lambda: sp.solve_cell_problems_grid(
        sim, mg=mg, tol=1e-9, maxiter=100000))
    out = dict(n=n, volume_fraction=float(occ.mean()), seconds=wall,
               block_iters=iters, mg_build_s=build_s, solve_s=solve_s,
               parts_block_iters=iters2[0],
               ms_per_block_iter=solve_s / max(iters2[0], 1) * 1e3,
               levels=[list(lvl.n3) for lvl in mg.levels],
               coarse="dense pinv" if mg.coarse_inv is not None
               else "host SuperLU", lam=list(mg.lam),
               peak_device_gib=peak, launches=counts)
    log(f"12a voxels (cross lattice {n}^3, volume fraction "
        f"{out['volume_fraction']:.4f}, {6 * n ** 3} tets, {8 * n ** 3} "
        f"periodic nodes, {24 * n ** 3} unknowns x 6 columns, float64): "
        f"homogenize_voxels {wall:.3f} s, {iters} block CG iterations, peak "
        f"device memory {peak:.2f} GiB; launches {counts}; by its parts: "
        f"PeriodicVarMG build {build_s:.3f} s (levels {out['levels']}, "
        f"coarsest {out['coarse']}), solve_cell_problems_grid "
        f"{solve_s:.3f} s, {iters2[0]} iterations, "
        f"{out['ms_per_block_iter']:.3f} ms per block iteration (host "
        f"clock)")

    # the gates: iterations, the tensor, cubic symmetry
    Ch = res.Ch.cpu()
    asym, emin = check_tensor(Ch, "12a voxels")
    d = torch.diagonal(Ch)[:3]
    spread = float((d - d.mean()).abs().max() / d.mean())
    out.update(Ch=Ch.tolist(), asymmetry=asym, min_eig=emin,
               cubic_spread=spread)
    log(f"12a voxels: Ch diag {torch.diagonal(Ch).tolist()}, asymmetry "
        f"{asym:.2e}, min eigenvalue {emin:.4e}, normal moduli spread "
        f"{spread:.2e}")
    if not iters < 60:
        raise RuntimeError(f"12a voxels: {iters} block CG iterations")
    if not spread <= 1e-6:
        raise RuntimeError(f"12a voxels: not cubic ({spread:.3e})")

    # every column's residual through the f64 EBE operator of the
    # periodic simulator, B on that operator's plan (the loads' path), and
    # the torus operator against it
    relres, cols = block_residual(sim, res.w)
    gen = torch.Generator(device=dev).manual_seed(12)
    b_err = check_rows_on_plan(sim._kernel.plan, torch.float64, "12a voxels",
                               gen)
    u = torch.randn((sim.num_dofs, 3), generator=gen, device=dev,
                    dtype=torch.float64)
    y_ebe = sim.apply_K(u)
    op_err = float((mg.fine(u) - y_ebe).abs().max() / y_ebe.abs().max())
    out.update(relres=relres, column_relres=cols, torus_vs_ebe=op_err,
               segment_sum_rows_f64_max_abs_err=b_err)
    log(f"12a voxels: f64 relative residual per column through the EBE "
        f"operator " + ", ".join(f"{c:.2e}" for c in cols)
        + f" (block {relres:.2e}); B f64 rows on the periodic simulator's "
        f"plan ([{sim._kernel.plan.num_rows}, 3]) equal bit for bit to B in "
        f"planes and to the CPU's plain sum, max abs err against the card's "
        f"plain {b_err:.3e}; torus apply vs f64 EBE apply on a seeded field "
        f"{op_err:.3e} of max|y|")
    if not max(cols) <= 1e-8:
        raise RuntimeError(f"12a voxels: a column's residual is "
                           f"{max(cols):.3e}")
    if not op_err <= 1e-12:
        raise RuntimeError(f"12a voxels: torus operator vs EBE {op_err}")
    del sim, mg, u, y_ebe

    # card against CPU on a small lattice
    small = {w: hom.homogenize_voxels(cross_lattice(SMALL_N), device=d)
             for w, d in (("card", dev), ("cpu", "cpu"))}
    dC = rel_err(small["card"].Ch, small["cpu"].Ch)
    out["small_card_vs_cpu"] = dC
    log(f"12a voxels at {SMALL_N}^3: card {small['card'].cg_iters[0]} / CPU "
        f"{small['cpu'].cg_iters[0]} iterations, Ch card vs CPU {dC:.3e} of "
        f"max")
    if not dC <= 1e-8:
        raise RuntimeError(f"12a voxels: card and CPU differ ({dC})")
    return out, counts


def drive_ortho(dev):
    """12b: ``homogenize_orthotropic(precond="multigrid")`` on the 1/8 cell
    with the reference test's 1000:1 sphere at ORTHO_N; each probe's
    residual through the f64 EBE operator with that probe's pins."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator

    def cell(n):
        V, T = generators.grid_tet(n, n, n, hi=(0.5, 0.5, 0.5))
        return FEMMesh(V, T, degree=2), sphere_field(V, T, 0.25, 0.02)

    def run(n, device):
        return hom.homogenize_orthotropic(*cell(n), tol=1e-10,
                                          precond="multigrid", device=device)

    res, wall, counts = counted("ortho", lambda: run(ORTHO_N, dev),
                                ("segment_sum_rows",))
    t = res.timings
    Ch = res.Ch.cpu()
    asym, emin = check_tensor(Ch, "12b ortho")
    off = torch.ones(6, 6, dtype=torch.bool)
    off[:3, :3] = False
    off[range(6), range(6)] = False
    nonzero_off = int((Ch[off] != 0).sum())
    w_max = float(res.w.abs().max())
    out = dict(n=ORTHO_N, seconds=wall, probe_build_s=t["probe_build_s"],
               probe_solve_s=t["probe_solve_s"], probe_iters=res.cg_iters,
               Ch=Ch.tolist(), asymmetry=asym, min_eig=emin, max_w=w_max,
               launches=counts)
    log(f"12b ortho (grid_tet({ORTHO_N}) on [0, 0.5]^3, 1000:1 sphere, "
        f"float64 VarStructuredMG per probe): {wall:.3f} s; probes (build / "
        f"solve / iterations, host clock) " + ", ".join(
            f"{b:.3f} s / {s:.3f} s / {i}" for b, s, i in zip(
                t["probe_build_s"], t["probe_solve_s"], res.cg_iters))
        + f"; Ch diag {torch.diagonal(Ch).tolist()}, min eigenvalue "
        f"{emin:.4e}, {nonzero_off} non-orthotropic entries nonzero (zero "
        f"by construction of the reflection-sign reconstruction), max|w| "
        f"{w_max:.3e}; launches {counts}")
    if nonzero_off or not w_max > 0 or len(res.cg_iters) != 6:
        raise RuntimeError("12b ortho: not an orthotropic tensor from six "
                           "nonzero probes")

    # each probe's f64 relative residual through the EBE operator, with
    # that probe's symmetry-plane pins; B on that operator's plan
    mesh, mat = cell(ORTHO_N)
    sim = ElasticitySimulator(mesh, mat, device=dev)
    stretch, shear = hom._ortho_fixed_masks(mesh)
    cols = []
    for i, m in enumerate([stretch] * 3 + list(shear)):
        free = torch.as_tensor(~m, dtype=torch.float64, device=dev)
        b = sim.constant_strain_load(
            -hom.canonical_strain(3, i, torch.float64)) * free
        r = (b - sim.apply_K(res.w[i])) * free
        cols.append(float(torch.linalg.norm(r) / torch.linalg.norm(b)))
    gen = torch.Generator(device=dev).manual_seed(13)
    b_err = check_rows_on_plan(sim._kernel.plan, torch.float64, "12b ortho",
                               gen)
    out.update(probe_relres=cols, segment_sum_rows_f64_max_abs_err=b_err)
    log(f"12b ortho: f64 relative residual per probe through the EBE "
        f"operator " + ", ".join(f"{c:.2e}" for c in cols)
        + f"; B f64 rows on its plan equal bit for bit to B in planes and to "
        f"the CPU's plain sum, max abs err against the card's plain "
        f"{b_err:.3e}")
    if not max(cols) <= 1e-9:
        raise RuntimeError(f"12b ortho: a probe's residual is {max(cols)}")
    del sim, res

    dC = rel_err(run(SMALL_N, dev).Ch, run(SMALL_N, "cpu").Ch)
    out["small_card_vs_cpu"] = dC
    log(f"12b ortho at {SMALL_N}^3: Ch card vs CPU {dC:.3e} of max")
    if not dC <= 1e-8:
        raise RuntimeError(f"12b ortho: card and CPU differ ({dC})")
    return out, counts


def twolevel_problem(device):
    """grid_tet(TWOLEVEL_N) P2 with its interior vertices moved (not a Kuhn
    grid), the 1000:1 sphere, clamped as ``clamped_problem``."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import ElasticitySimulator

    n = TWOLEVEL_N
    V, T = generators.grid_tet(n, n, n)
    V = V.copy()
    interior = ((V > 1e-9) & (V < 1 - 1e-9)).all(axis=1)
    rng = np.random.default_rng(12)
    V[interior] += (0.15 / n) * rng.uniform(-1, 1, (interior.sum(), 3))
    mesh = FEMMesh(V, T, degree=2)
    sim = ElasticitySimulator(mesh, sphere_field(V, T, 0.5, 0.08),
                              device=device)
    X = mesh.node_positions
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
    sim.neumann_load = torch.as_tensor(load, device=sim.device)
    return sim


def check_transfers(tl, dev, label):
    """The two-level transfers on the card against their plain versions:
    prolong (kernel A, float32 and float64) bit for bit; restrict (kernel
    B) bit for bit against the CPU's plain sum (the same order) and to
    1e-5 / 1e-12 of max against the card's plain one (float atomics)."""
    from meshfem_tpu_torch import kernels

    gen = torch.Generator(device=dev).manual_seed(7)
    ND = tl.ids_ab.shape[0] // 2
    errs = {}
    for dt, gate in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        xc = torch.randn((tl.n_coarse, 3, 6), generator=gen, device=dev,
                         dtype=dt)
        rows = kernels.gather_rows_plain(xc.reshape(tl.n_coarse, 18),
                                         tl.ids_ab)
        ref = (0.5 * (rows[:ND] + rows[ND:])).reshape(ND, 3, 6)
        if not torch.equal(tl.prolong(xc), ref):
            raise RuntimeError(f"{label}: prolong ({dt}) != plain")
        r = torch.randn((ND, 3, 6), generator=gen, device=dev, dtype=dt)
        y = tl.restrict(r)
        half = (0.5 * r).reshape(ND, 18)
        y_cpu = kernels.segment_sum_rows_plain(
            half.cpu(), tl.plan.perm.cpu(), tl.plan.offsets.cpu())
        y_plain = kernels.segment_sum_rows_plain(half, tl.plan.perm,
                                                 tl.plan.offsets)
        err = float((y.reshape(-1, 18) - y_plain).abs().max())
        if not torch.equal(y.reshape(-1, 18).cpu(), y_cpu):
            raise RuntimeError(f"{label}: restrict ({dt}) != the CPU's "
                               f"plain sum bit for bit")
        if not err <= gate * float(y_plain.abs().max()):
            raise RuntimeError(f"{label}: restrict ({dt}) disagrees {err}")
        errs[str(dt).split(".")[1]] = err
    return errs


def drive_twolevel(dev):
    """12c: the routed two-level solve at TWOLEVEL_N beside Jacobi and the
    CPU, and ``homogenize(precond="twolevel")`` on the void cell; every
    plan those paths launch A or B on is held against the plain version."""
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics import Material
    from meshfem_tpu_torch.solvers.twolevel import TwoLevel

    out, paths = {}, {}
    sim = twolevel_problem(dev)
    (u, res), wall, paths["twolevel_routed"] = counted(
        "12c two-level routed",
        lambda: sim.solve(operator="routed", precond="twolevel", tol=1e-10),
        ("gather_rows", "segment_sum_rows"))
    tl = next(iter(sim._twolevel.values()))
    relres = check_solution(sim, u, "12c two-level routed")
    (_, res_j), wall_j, _ = counted(
        "12c jacobi routed",
        lambda: sim.solve(operator="routed", precond="jacobi", tol=1e-10))
    t = tl.timings
    out["routed"] = dict(
        tets=sim.mesh.num_elements, dofs=3 * sim.num_dofs, solve_s=wall,
        rounds=res.rounds, inner_iters=res.iters, relres=relres,
        galerkin_s=t["galerkin_s"], splu_s=t["splu_s"],
        build_s=t["total_s"], coarse_dofs=t["coarse_dofs"],
        coarse_nnz=t["coarse_nnz"], jacobi_solve_s=wall_j,
        jacobi_inner_iters=res_j.iters, launches=paths["twolevel_routed"])
    log(f"12c two-level routed (grid_tet({TWOLEVEL_N}) P2 perturbed, "
        f"{sim.mesh.num_elements} tets, {3 * sim.num_dofs} dofs, 1000:1 "
        f"sphere): {wall:.3f} s with the build; host Galerkin P^T A P "
        f"{t['galerkin_s']:.3f} s, SuperLU {t['splu_s']:.3f} s "
        f"({t['coarse_dofs']} coarse dofs, {t['coarse_nnz']} nonzeros); "
        f"{res.rounds} rounds, {res.iters} inner iterations; Jacobi "
        f"{res_j.rounds} rounds, {res_j.iters} inner iterations in "
        f"{wall_j:.3f} s; launches {paths['twolevel_routed']}")
    if not res.iters < res_j.iters:
        raise RuntimeError("12c: the two-level solve took no fewer inner "
                           "iterations than Jacobi")
    # A and B on this path's own plans: the transfers, the routed
    # operator's gather ids and element-major plan (float32), the EBE
    # residual's plan (float64); a wrong float32 kernel would only slow
    # the refinement, so the u gates cannot catch it
    rk = sim.routed_kernel()
    gen = torch.Generator(device=dev).manual_seed(14)
    src = torch.randn((3, sim.num_dofs), generator=gen, device=dev)
    if not torch.equal(kernels.gather_rows(src, rk.ids_em, planes_in=True),
                       kernels.gather_rows_plain(src, rk.ids_em, True)):
        raise RuntimeError("12c routed: gather_rows on the operator's ids "
                           "!= plain")
    checks = dict(
        transfers=check_transfers(tl, dev, "12c routed"),
        routed_f32=check_rows_on_plan(rk.plan_em, torch.float32,
                                      "12c routed", gen),
        ebe_f64=check_rows_on_plan(sim._kernel.plan, torch.float64,
                                   "12c routed", gen))
    del rk, src
    cpu = twolevel_problem("cpu")
    u_cpu, res_cpu = cpu.solve(operator="ebe", precond="twolevel", tol=1e-12)
    du = rel_err(u, u_cpu)
    out["routed"].update(card_vs_cpu=du, cpu_iters=res_cpu.iters,
                         max_abs_err=checks)
    log(f"12c two-level routed: A on the operator's ids and the "
        f"prolongation equal to plain; B max abs err against the card's "
        f"plain (bit for bit against the CPU's) {checks}; u card vs CPU "
        f"float64 EBE two-level ({res_cpu.iters} iterations) {du:.3e} of "
        f"max|u|")
    if not du <= 1e-8:
        raise RuntimeError(f"12c: card and CPU differ ({du})")
    del sim, cpu

    # homogenize(precond="twolevel") on the void cell against "block"
    V, T = void_cell(TWOLEVEL_N)
    mesh = FEMMesh(V, T, degree=2)
    mat = Material.isotropic(3, 200.0, 0.3)
    res_t, wall_t, paths["twolevel_homogenize"] = counted(
        "12c two-level homogenize",
        lambda: hom.homogenize(mesh, mat, tol=1e-11, precond="twolevel",
                               device=dev),
        ("gather_rows", "segment_sum_rows"))
    res_b, wall_b, _ = counted(
        "12c block homogenize",
        lambda: hom.homogenize(mesh, mat, tol=1e-11, precond="block",
                               device=dev))
    check_tensor(res_t.Ch, "12c two-level homogenize")
    dC = rel_err(res_t.Ch, res_b.Ch)
    c = paths["twolevel_homogenize"]
    # the same preconditioner built again on the same periodic simulator:
    # its host times, and A and B on its plans and the EBE plan
    hsim = hom.periodic_simulator(mesh, mat, device=dev)
    tl_c = TwoLevel.from_simulator(hsim)
    t = tl_c.timings
    cell_checks = dict(
        transfers=check_transfers(tl_c, dev, "12c cell"),
        ebe_f64=check_rows_on_plan(hsim._kernel.plan, torch.float64,
                                   "12c cell", gen))
    out["homogenize"] = dict(
        tets=mesh.num_elements, seconds=wall_t, block_iters=res_t.cg_iters[0],
        galerkin_s=t["galerkin_s"], splu_s=t["splu_s"],
        coarse_dofs=t["coarse_dofs"], block_precond_s=wall_b,
        block_precond_iters=res_b.cg_iters[0], Ch_vs_block=dC, launches=c,
        max_abs_err=cell_checks)
    log(f"12c two-level homogenize (void cell grid_tet({TWOLEVEL_N}), "
        f"{mesh.num_elements} tets, float64 EBE block CG): {wall_t:.3f} s, "
        f"{res_t.cg_iters[0]} block iterations; precond='block' (routed, "
        f"float32 in refinement) {wall_b:.3f} s, {res_b.cg_iters[0]} inner "
        f"iterations; Ch two-level vs block {dC:.3e} of max; kernel A "
        f"float64 launches {c['gather_rows/f64']}, kernel B float64 "
        f"{c['segment_sum_rows/f64']}; the preconditioner built again: host "
        f"Galerkin {t['galerkin_s']:.3f} s, SuperLU {t['splu_s']:.3f} s "
        f"({t['coarse_dofs']} coarse dofs), prolongation equal to plain, B "
        f"max abs err {cell_checks}")
    if not dC <= 1e-8:
        raise RuntimeError(f"12c: two-level and block tensors differ ({dC})")
    if not (c["gather_rows/f64"] > 0 and c["segment_sum_rows/f64"] > 0):
        raise RuntimeError("12c: the float64 two-level transfers did not "
                           "run on kernels A and B")
    # kernel A on float64 rows at the prolongation's shapes, for the table
    out["prolong_f64_inputs"] = tl_c
    return out, paths


def drive_topopt(dev):
    """12d: ``ComplianceTopOpt.run`` at TOPOPT_SHAPE in float32,
    TOPOPT_ITERS iterations; one more iteration from the last one's input
    by its public steps, each timed, whose state solve is held against a
    float64 solve of the same system; the card against the CPU at
    (4, 2, 2) in float64."""
    from meshfem_tpu_torch.analysis.topopt import ComplianceTopOpt
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.ops.structured_mg import VarStructuredMG

    top = ComplianceTopOpt(*TOPOPT_SHAPE, device=dev)
    rhos = [torch.full((top.nx, top.ny, top.nz), top.volfrac,
                       dtype=top.dtype, device=dev)]
    (rho_end, hist), wall, counts = counted(
        "12d topopt", lambda: top.run(
            iters=TOPOPT_ITERS, callback=lambda it, rho, h: rhos.append(rho)))
    cs = [h["compliance"] for h in hist]
    inner = [h["inner_iters"] for h in hist]
    vols = [h["volume"] for h in hist]
    if not (all(np.isfinite(cs)) and cs[-1] < cs[0]):
        raise RuntimeError("12d: the compliance did not decrease")
    if not max(inner) < 200:
        raise RuntimeError(f"12d: {max(inner)} MG-PCG iterations")
    if not abs(vols[-1] - top.volfrac) <= 0.02:
        raise RuntimeError(f"12d: filtered volume {vols[-1]}")

    # the last iteration again, step by step (compliance_and_grad's and
    # run's steps), each synchronised and timed
    rho_in = rhos[-2]
    split = {}
    rho_f, split["filter"] = timed(lambda: top.filtered(rho_in))
    mg, split["mg_build"] = timed(lambda: top._mg_for(rho_f))
    (u, res), split["solve"] = timed(lambda: mg.solve(
        top.load, tol=top.solve_tol, maxiter=300))

    def gradient():
        dE = top.penal * rho_f ** (top.penal - 1.0) * (top.E0 - top.E_min)
        return top.filter_adjoint(-(dE * top.cell_energies(u)))

    dc, split["gradient"] = timed(gradient)
    rho_new, split["oc_update"] = timed(lambda: top.oc_update(rho_in, dc))
    d_rho = float((rho_new - rho_end).abs().max())
    del mg, dc

    # that state solve's true residual, read in float64 through the
    # structured operator of the same design; float32 cannot hold u to
    # better than the residual of the float64 solution rounded to float32
    E_elem = torch.repeat_interleave(top.modulus(rho_f.double()).reshape(-1),
                                     top.tets_per_cell)
    mg64 = VarStructuredMG.build(
        top.mesh, et.isotropic(3, E_elem, torch.full_like(E_elem, top.nu)),
        fixed_mask=torch.as_tensor(top.fixed), dtype=torch.float64,
        device=dev)
    u64, res64 = mg64.solve(top.load.double(), tol=1e-10, maxiter=300)
    free = torch.as_tensor(~top.fixed, dtype=torch.float64, device=dev)
    b = top.load.double() * free

    def relres(v):
        r = (b - mg64.fine(v.double())) * free
        return float(torch.linalg.norm(r) / torch.linalg.norm(b))

    rr, rr_floor, rr64 = relres(u), relres(u64.float()), relres(u64)
    du = rel_err(u.double(), u64)
    del mg64, u64, u
    per_it = wall / TOPOPT_ITERS
    out = dict(shape=list(TOPOPT_SHAPE), tets=top.mesh.num_elements,
               dofs=3 * top.mesh.num_nodes, seconds=wall,
               s_per_iteration=per_it, split_last_iteration=split,
               compliance=cs, inner_iters=inner, volume=vols,
               last_solve=dict(iters=int(res.iters), relres=rr,
                               f32_floor=rr_floor, f64_relres=rr64,
                               f64_iters=int(res64.iters), u_vs_f64=du),
               rho_step_vs_run=d_rho, launches=counts)
    log(f"12d topopt ({TOPOPT_SHAPE}, {top.mesh.num_elements} tets, "
        f"{3 * top.mesh.num_nodes} unknowns, float32, {TOPOPT_ITERS} "
        f"iterations): {wall:.3f} s, {per_it:.3f} s an iteration; compliance "
        f"{cs}; MG-PCG iterations {inner}; filtered volume {vols}; launches "
        f"{counts}")
    log(f"12d topopt, the last iteration again by its steps: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items())
        + f" s (sum {sum(split.values()):.3f}); its density vs the run's "
        f"{d_rho:.2e} max abs; its state solve {int(res.iters)} iterations, "
        f"true relative residual {rr:.3e} in float64 (solve_tol "
        f"{top.solve_tol:.0e}; the float64 solution rounded to float32 "
        f"{rr_floor:.3e}; the float64 solve {rr64:.3e} in "
        f"{int(res64.iters)} iterations), u vs the float64 u {du:.3e} of "
        f"max")
    if not (rr <= top.solve_tol + 20 * rr_floor and rr64 <= 1e-9
            and du <= 1e-4):
        raise RuntimeError(f"12d: the state solve is off: residual {rr}, "
                           f"float32 floor {rr_floor}, u {du}")
    hists = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        small = ComplianceTopOpt(4, 2, 2, dtype=torch.float64,
                                 solve_tol=1e-11, device=device)
        hists[where] = [h["compliance"] for h in small.run(
            iters=TOPOPT_ITERS)[1]]
    dc = max(abs(a - b) / abs(b) for a, b in zip(hists["card"],
                                                  hists["cpu"]))
    out["small_card_vs_cpu"] = dc
    log(f"12d topopt at (4, 2, 2) float64: compliance history card vs CPU "
        f"{dc:.3e} (relative, worst iteration)")
    if not dc <= 1e-8:
        raise RuntimeError(f"12d: card and CPU histories differ ({dc})")
    return out, counts


def drive_cells(dev):
    """Phase 12a-d; returns (summary, launch counts per path)."""
    out, paths = {}, {}
    t0 = time.time()
    out["voxels"], paths["voxels"] = drive_voxels(dev)
    out["ortho"], paths["ortho"] = drive_ortho(dev)
    out["twolevel"], tl_paths = drive_twolevel(dev)
    paths.update(tl_paths)
    out["topopt"], paths["topopt"] = drive_topopt(dev)
    out["phase_s"] = time.time() - t0
    log(f"phase 12 (12a-d): {out['phase_s']:.1f} s")
    return out, paths


# ---------------------------------------------------------------------------
# Phase 13: triangle meshes, 2D elasticity and 2D homogenization
# ---------------------------------------------------------------------------

# The 2D cantilever of BASELINE config 1 over [0, 4] x [0, 1].  Its solves
# run at cut sizes: at grid_tri(1024, 256) P1 and grid_tri(512, 128) P2
# (526,850 dofs each) float32 CG inside float64 refinement stalls above
# 1e-10 (the inner CG's residual plateaus past its 2,048-iteration stall
# window, and the dense float32 Ke's rounding, ~eps32 times the condition
# number, slows the rounds); halved until every backend passes (PERF.md).
CANT_P1_N = 256               # grid_tri(256, 64) P1: 33,410 dofs
CANT_P2_N = 64                # grid_tri(64, 16) P2: 8,514 dofs
FULL_P1_N = 1024              # the kernels' timing shapes: the uncut meshes
FULL_P2_N = 512
TRI_CELL_N = 256              # grid_tri(256, 256) P2 with a void disc
PIXEL_N = 512                 # the pixel cross, 512^2 pixels
SMALL_2D_N = 32               # card against CPU: grid_tri(32, 8)
SMALL_CELL_2D_N = 8           # and the 8^2 cells
E_2D, NU_2D, BAR_T = 200.0, 0.3, 1.0

EDGE_X0 = {"box%": {"minCorner": [-0.001, -0.001],
                    "maxCorner": [0.001, 1.001]}}
EDGE_X1 = {"box%": {"minCorner": [0.999, -0.001],
                    "maxCorner": [1.001, 1.001]}}
EDGE_Y0 = {"box%": {"minCorner": [-0.001, -0.001],
                    "maxCorner": [1.001, 0.001]}}
# x = 0 clamped, the tip loaded in -y
CANTILEVER_2D_BC = bc_json([{"type": "dirichlet", "value": [0, 0],
                             **EDGE_X0},
                            {"type": "force", "value": [0, -1], **EDGE_X1}])
# the uniaxial bar of the reference's tests/test_elasticity.py:50-70:
# rollers on x = 0 and y = 0, a uniform traction on the far edge
UNIAXIAL_BC = bc_json([{"type": "dirichletx", "value": [0, 0], **EDGE_X0},
                       {"type": "dirichlety", "value": [0, 0], **EDGE_Y0},
                       {"type": "traction", "value": [BAR_T, 0],
                        **EDGE_X1}])
ROWS_2D = ("gather_rows", "segment_sum_rows", "element_stiffness")


def cantilever_2d(n, deg, device, text=CANTILEVER_2D_BC):
    """grid_tri(n, n / 4) over [0, 4] x [0, 1], isotropic (plane stress),
    the regions of ``text`` applied through ``parse_bc(..., dim=2)``."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           parse_bc)

    V, F = generators.grid_tri(n, n // 4, hi=(4.0, 1.0))
    sim = ElasticitySimulator(FEMMesh(V, F, degree=deg),
                              Material.isotropic(2, E_2D, NU_2D),
                              device=device)
    sim.apply_boundary_conditions(parse_bc(text, dim=2))
    return sim


def counted_solve(sim, label, required, **kw):
    """``sim.solve(**kw)`` counted, the routed operator built anew inside
    the count; returns (u, result, seconds, counts, routed applies)."""
    sim._routed = None
    with ApplyCounter() as applies:
        (u, res), wall, counts = counted(label, lambda: sim.solve(**kw),
                                         required)
    log(f"{label}: solve {wall:.3f} s, {res.rounds} refinement rounds, "
        f"{res.iters} inner CG iterations ({wall / max(res.iters, 1) * 1e3:.4f}"
        f" ms each on the host clock), relres {res.resnorm:.3e}, round "
        f"history {[(f'{r:.1e}', i) for r, i in res.history]}, launches "
        f"{counts}")
    return u, res, wall, counts, applies.count


def drive_cantilever_2d(dev):
    """13a: the P1 cantilever by the default call (routed dense: E at
    (2, 1), A and B rows at 2 values), the uniaxial bar's closed form on the
    same mesh, and the card against the CPU at grid_tri(32, 8)."""
    out, paths = {}, {}
    sim, t_set = timed(lambda: cantilever_2d(CANT_P1_N, 1, dev))
    N = sim.num_dofs
    label = f"13a P1 cantilever grid_tri({CANT_P1_N}, {CANT_P1_N // 4})"
    log(f"{label}: {sim.mesh.num_elements} triangles, {N} nodes, {2 * N} "
        f"dofs; mesh, simulator and parse_bc {t_set:.3f} s")
    u, res, wall, counts, applies = counted_solve(sim, label, ROWS_2D,
                                                  tol=1e-10)
    check_rows_path(label, counts, applies)
    relres = check_solution(sim, u, label)
    paths["cantilever_p1"] = counts
    out["cantilever_p1"] = dict(
        triangles=sim.mesh.num_elements, dofs=2 * N, rounds=res.rounds,
        inner_iters=res.iters, relres=relres, solve_s=wall,
        ms_per_inner_iter=wall / max(res.iters, 1) * 1e3,
        tip_deflection=float(u[:, 1].min()), applies=applies)
    rk = sim.routed_kernel()
    x = torch.randn((2, N), generator=torch.Generator(device=dev)
                    .manual_seed(13), device=dev)
    out["cantilever_p1"]["apply_ms"] = median_apply_ms(
        rk.apply_planes, [x * (1 + i) for i in range(9)])
    del sim, rk

    bar = cantilever_2d(CANT_P1_N, 1, dev, UNIAXIAL_BC)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ub, resb, wallb, countsb, _ = counted_solve(
            bar, "13a uniaxial bar", ROWS_2D, tol=1e-12)
    for c in caught:
        log(f"13a uniaxial bar: WARNING {c.message}")
    stress = bar.average_stress_field(ub)
    strain = bar.average_strain_field(ub)
    s_exact = torch.tensor([BAR_T, 0.0, 0.0], dtype=torch.float64,
                           device=dev)
    e_exact = torch.tensor([BAR_T / E_2D, -NU_2D * BAR_T / E_2D, 0.0],
                           dtype=torch.float64, device=dev)
    s_err = float((stress - s_exact).abs().max()) / BAR_T
    e_err = float((strain - e_exact).abs().max()) / (BAR_T / E_2D)
    paths["uniaxial_bar"] = countsb
    out["uniaxial_bar"] = dict(rounds=resb.rounds, inner_iters=resb.iters,
                               relres=resb.resnorm, solve_s=wallb,
                               stress_err=s_err, strain_err=e_err)
    log(f"13a uniaxial bar (traction {BAR_T} on x = 4, rollers): every "
        f"element's stress against (t, 0, 0) {s_err:.3e} of t, strain "
        f"against (t/E, -nu t/E, 0) {e_err:.3e} of t/E (plane stress)")
    if not (s_err <= 1e-7 and e_err <= 1e-7):
        raise RuntimeError("13a uniaxial bar: the closed form does not hold")
    del bar

    card = cantilever_2d(SMALL_2D_N, 1, dev)
    uc, _ = card.solve(operator="routed", tol=1e-10)
    cpu = cantilever_2d(SMALL_2D_N, 1, "cpu")
    ux, _ = cpu.solve(tol=1e-12)
    du = rel_err(uc, ux)
    out["small_card_vs_cpu"] = du
    log(f"13a grid_tri({SMALL_2D_N}, {SMALL_2D_N // 4}) P1: card routed vs "
        f"CPU f64 EBE u {du:.3e} of max")
    if not du <= 1e-8:
        raise RuntimeError(f"13a: card and CPU differ ({du})")
    return out, paths


def drive_p2_backends(dev):
    """13b: the P2 cantilever through the three contraction backends of
    ``solve(operator="routed")``: dense (E at (2, 2)), ``MESHFEM_FACTORED``
    (C) and ``MESHFEM_FACTORED_TQ`` (D), each apply in node rows (A, the
    contraction, B; no kernel in planes)."""
    out, paths, ops = {}, {}, {}
    sim = cantilever_2d(CANT_P2_N, 2, dev)
    N = sim.num_dofs
    variants = (
        ("p2_dense", {}, ROWS_2D),
        ("p2_factored", {"MESHFEM_FACTORED": "1"},
         ("gather_rows", "segment_sum_rows", "qp_contract")),
        ("p2_factored_tq", {"MESHFEM_FACTORED": "1",
                            "MESHFEM_FACTORED_TQ": "1"},
         ("gather_rows", "segment_sum_rows", "factored_contract")))
    us = {}
    for name, env, required in variants:
        for k in ("MESHFEM_FACTORED", "MESHFEM_FACTORED_TQ"):
            os.environ.pop(k, None)
        os.environ.update(env)
        label = (f"13b P2 cantilever grid_tri({CANT_P2_N}, {CANT_P2_N // 4})"
                 f" {name}")
        try:
            u, res, wall, counts, applies = counted_solve(
                sim, label, required, operator="routed", tol=1e-10)
        finally:
            for k in env:
                os.environ.pop(k, None)
        check_rows_path(label, counts, applies, required[2]
                        if name != "p2_dense" else None)
        relres = check_solution(sim, u, label)
        ops[name], us[name], paths[name] = sim._routed, u, counts
        out[name] = dict(rounds=res.rounds, inner_iters=res.iters,
                         relres=relres, solve_s=wall)
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((2, N), generator=gen, device=dev)
    yd = ops["p2_dense"].apply_planes(x)
    for name in ("p2_factored", "p2_factored_tq"):
        d_apply = float((ops[name].apply_planes(x) - yd).abs().max()
                        / yd.abs().max())
        d_u = rel_err(us[name], us["p2_dense"])
        out[name].update(vs_dense_apply=d_apply, vs_dense_u=d_u)
        log(f"13b {name}: apply vs dense {d_apply:.3e} of max|y|, u vs "
            f"dense {d_u:.3e} of max|u|")
        if not (d_apply <= 5e-6 and d_u <= 1e-8):
            raise RuntimeError(f"13b {name} disagrees with the dense "
                               f"backend")
    out["triangles"], out["dofs"] = sim.mesh.num_elements, 2 * N
    return out, paths


def tri_void_cell(n):
    """grid_tri(n, n) on the unit square with the triangles whose centroid
    lies within 0.3 of the centre removed, vertices renumbered."""
    from meshfem_tpu_torch.mesh import generators

    V, F = generators.grid_tri(n, n)
    cent = V[F].mean(axis=1)
    F2 = F[((cent - 0.5) ** 2).sum(axis=1) > 0.3 ** 2]
    used = np.unique(F2)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[F2].astype(np.int32)


def drive_tri_cell(dev):
    """13c: ``homogenize`` on the triangle void cell, precond 'block' and
    'jacobi': one 3-column routed block CG (A and B at 6 values a node)
    inside float64 refinement."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics import Material

    out, paths, Chs = {}, {}, {}
    mesh = FEMMesh(*tri_void_cell(TRI_CELL_N), degree=2)
    mat = Material.isotropic(2, E_2D, NU_2D)
    D = mat.D.to(dev)
    hsim = hom.periodic_simulator(mesh, mat, device=dev)
    phi = 1.0 - float(hsim.geom.volume.sum())
    for precond in ("block", "jacobi"):
        label = f"13c triangle cell grid_tri({TRI_CELL_N}) P2 ({precond})"
        res, info = drive_homogenize(mesh, mat, label, {}, ROWS_2D,
                                     precond=precond)
        check_rows_path(label, info["launches"], info["applies"])
        relres, cols = check_homogenized(hsim, res, label, D, phi, 1e-9)
        Ch = res.Ch
        sq = abs(float(Ch[0, 0] - Ch[1, 1])) / float(Ch[0, 0])
        log(f"{label}: Ch {Ch.cpu().tolist()}; |C00 - C11| {sq:.3e} of C00")
        if not max(cols) <= 1e-9:
            raise RuntimeError(f"{label}: a column's residual is "
                               f"{max(cols):.3e}")
        if not sq <= 1e-7:
            raise RuntimeError(f"{label}: not square symmetric ({sq:.3e})")
        info.update(relres=relres, column_relres=cols, square_spread=sq)
        Chs[precond], paths[f"tri_cell_{precond}"] = Ch, info.pop("launches")
        out[precond] = info
    dC = rel_err(Chs["jacobi"], Chs["block"])
    log(f"13c: Ch (jacobi) vs Ch (block) {dC:.3e} of max|Ch|")
    if not dC <= 1e-8:
        raise RuntimeError(f"13c: the two preconditioners' Ch differ ({dC})")
    small = FEMMesh(*tri_void_cell(SMALL_CELL_2D_N), degree=2)
    Cs = {}
    for name, device, op in (("card", dev, "routed"), ("cpu", "cpu", "ebe")):
        s = hom.periodic_simulator(small, mat, device=device)
        w, _ = hom.solve_cell_problems(s, tol=1e-12, operator=op)
        Cs[name] = hom.homogenized_tensor_stress_form(
            s, w - w.mean(dim=1, keepdim=True))
    dS = rel_err(Cs["card"], Cs["cpu"])
    log(f"13c at grid_tri({SMALL_CELL_2D_N}): card routed vs CPU f64 EBE Ch "
        f"{dS:.3e} of max")
    if not dS <= 1e-8:
        raise RuntimeError(f"13c: card and CPU differ ({dS})")
    out.update(triangles=mesh.num_elements, dofs=2 * hsim.num_dofs,
               void_share=phi, Ch=Chs["block"].cpu().tolist(),
               jacobi_vs_block=dC, small_card_vs_cpu=dS)
    return out, paths, hsim


def pixel_cross(n):
    """Two struts of width n/4 crossing: the reference test's pixel cell
    (tests/test_structured_periodic.py:164-175) at n^2."""
    occ = np.zeros((n, n), bool)
    occ[3 * n // 8:5 * n // 8, :] = True
    occ[:, 3 * n // 8:5 * n // 8] = True
    return occ


def drive_pixels(dev):
    """13d: ``homogenize_voxels`` on the pixel cross through the 2D torus
    multigrid (float64, void 1e-6, tol 1e-9); then the same cell by its
    parts, timed apart."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.ops import structured_periodic2d as sp2
    from meshfem_tpu_torch.physics import MaterialField

    n = PIXEL_N
    occ = pixel_cross(n)
    torch.cuda.reset_peak_memory_stats()
    res, wall, counts = counted(
        "13d pixels", lambda: hom.homogenize_voxels(occ, device=dev),
        ("segment_sum_rows",))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    iters = max(res.cg_iters)
    V, F = generators.grid_tri(n, n, diagonal="right")
    E_field = np.repeat(np.where(occ.reshape(-1), 1.0, 1e-6), 2)
    sim, sim_s = timed(lambda: hom.periodic_simulator(
        FEMMesh(V, F, degree=2), MaterialField.isotropic_field(
            2, E_field, np.full(len(E_field), 0.3)), device=dev))
    mg, build_s = timed(lambda: sp2.PeriodicVarMG2D.build(
        sim.mesh, sim.D, sim.dof_map, dtype=sim.Ke.dtype, device=dev))
    (_, iters2), solve_s = timed(lambda: sp2.solve_cell_problems_grid2d(
        sim, mg=mg, tol=1e-9, maxiter=100000))
    out = dict(n=n, volume_fraction=float(occ.mean()), seconds=wall,
               block_iters=iters, simulator_s=sim_s, mg_build_s=build_s,
               solve_s=solve_s, parts_block_iters=iters2[0],
               ms_per_block_iter=solve_s / max(iters2[0], 1) * 1e3,
               levels=[list(lvl.n2) for lvl in mg.levels],
               coarse="dense pinv" if mg.coarse_inv is not None
               else "host SuperLU", peak_device_gib=peak)
    log(f"13d pixels (cross {n}^2, volume fraction "
        f"{out['volume_fraction']:.4f}, {2 * n * n} triangles, "
        f"{8 * n * n} unknowns x 3 columns, float64): homogenize_voxels "
        f"{wall:.3f} s, {iters} block CG iterations, peak device memory "
        f"{peak:.2f} GiB; launches {counts}; by its parts: periodic "
        f"simulator {sim_s:.3f} s, PeriodicVarMG2D build {build_s:.3f} s "
        f"(levels {out['levels']}, coarsest {out['coarse']}), "
        f"solve_cell_problems_grid2d {solve_s:.3f} s, {iters2[0]} "
        f"iterations, {out['ms_per_block_iter']:.3f} ms per block iteration "
        f"(host clock)")
    Ch = res.Ch.cpu()
    asym, emin = check_tensor(Ch, "13d pixels", fl=3)
    d = torch.diagonal(Ch)
    spread = float((d[0] - d[1]).abs() / d[0])
    out.update(Ch=Ch.tolist(), asymmetry=asym, min_eig=emin,
               square_spread=spread)
    log(f"13d pixels: Ch {Ch.tolist()}, asymmetry {asym:.2e}, min "
        f"eigenvalue {emin:.4e}, |d0 - d1| {spread:.2e} of d0")
    if not iters < 60:
        raise RuntimeError(f"13d pixels: {iters} block CG iterations")
    if not spread <= 1e-7:
        raise RuntimeError(f"13d pixels: not square symmetric ({spread})")
    relres, cols = block_residual(sim, res.w)
    gen = torch.Generator(device=dev).manual_seed(15)
    u = torch.randn((sim.num_dofs, 2), generator=gen, device=dev,
                    dtype=torch.float64)
    y_ebe = sim.apply_K(u)
    op_err = float((mg.fine(u) - y_ebe).abs().max() / y_ebe.abs().max())
    out.update(relres=relres, column_relres=cols, torus_vs_ebe=op_err)
    log(f"13d pixels: f64 relative residual per column through the EBE "
        f"operator " + ", ".join(f"{c:.2e}" for c in cols)
        + f"; torus apply_channels vs f64 EBE apply_K on a seeded field "
        f"{op_err:.3e} of max|y|")
    if not max(cols) <= 1e-8:
        raise RuntimeError(f"13d pixels: a column's residual is "
                           f"{max(cols):.3e}")
    if not op_err <= 1e-12:
        raise RuntimeError(f"13d pixels: torus operator vs EBE {op_err}")
    del sim, mg, u, y_ebe
    small = {w: hom.homogenize_voxels(pixel_cross(SMALL_CELL_2D_N),
                                      device=d)
             for w, d in (("card", dev), ("cpu", "cpu"))}
    dC = rel_err(small["card"].Ch, small["cpu"].Ch)
    out["small_card_vs_cpu"] = dC
    log(f"13d pixels at {SMALL_CELL_2D_N}^2: card "
        f"{small['card'].cg_iters[0]} / CPU {small['cpu'].cg_iters[0]} "
        f"iterations, Ch card vs CPU {dC:.3e} of max")
    if not dC <= 1e-8:
        raise RuntimeError(f"13d pixels: card and CPU differ ({dC})")
    return out, counts


# the sizes the 13a / 13b cuts stop short of, each solved once through
# ``solve(operator="routed", tol=1e-10)`` and reported, not gated: the
# witness of the cut (deg, n, contraction switches)
CUT_WITNESS = ((1, 2 * CANT_P1_N, {}), (1, 4 * CANT_P1_N, {}),
               (2, 2 * CANT_P2_N, {}),
               (2, 4 * CANT_P2_N, {"MESHFEM_FACTORED": "1"}),
               (2, 8 * CANT_P2_N, {}))


def drive_cut_witness(dev):
    """13f: the cantilever at the sizes above the cuts, one routed solve
    each: the refinement's rounds, inner iterations and the float64
    residual where it stopped (a RuntimeWarning when above 1e-10)."""
    out = []
    for deg, n, env in CUT_WITNESS:
        for k in ("MESHFEM_FACTORED", "MESHFEM_FACTORED_TQ"):
            os.environ.pop(k, None)
        os.environ.update(env)
        try:
            sim = cantilever_2d(n, deg, dev)
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                (u, res), wall = timed(lambda: sim.solve(operator="routed",
                                                         tol=1e-10))
        finally:
            for k in env:
                os.environ.pop(k, None)
        rec = dict(deg=deg, n=n, dofs=2 * sim.num_dofs,
                   backend="factored" if env else "dense",
                   rounds=res.rounds, inner_iters=res.iters,
                   relres=res.resnorm, solve_s=wall,
                   history=[list(h) for h in res.history])
        out.append(rec)
        log(f"13f cut witness: grid_tri({n}, {n // 4}) P{deg} "
            f"{rec['backend']} ({rec['dofs']} dofs): {res.rounds} rounds, "
            f"{res.iters} inner iterations, stopped at relres "
            f"{res.resnorm:.3e} ({'reached' if res.resnorm <= 1e-10 else 'above'}"
            f" 1e-10), {wall:.2f} s; rounds "
            f"{[(f'{r:.1e}', i) for r, i in res.history]}")
        del sim, u
    return out


def drive_2d(dev):
    """Phase 13a-d and 13f; returns (summary, launch counts per path, the
    13c cell's periodic simulator for 13e)."""
    out, paths = {}, {}
    t0 = time.time()
    out["cantilever"], p = drive_cantilever_2d(dev)
    paths.update(p)
    out["p2_backends"], p = drive_p2_backends(dev)
    paths.update(p)
    out["tri_cell"], p, hsim = drive_tri_cell(dev)
    paths.update(p)
    out["pixels"], paths["pixels"] = drive_pixels(dev)
    out["cut_witness"] = drive_cut_witness(dev)
    out["phase_s"] = time.time() - t0
    log(f"phase 13 (13a-d, f): {out['phase_s']:.1f} s")
    return out, paths, hsim


def kernels_2d(dev, entry, paths, hsim, ptxas=None):
    """13e: kernels A-E held against their plain versions at their 2D
    shapes (the uncut P1 and P2 cantilever meshes, whose operators the
    cut paths share in form, and the 13c cell's operator at 6 values a
    node), then timed with ``entry``; ``ptxas``: source -> its compiler
    report lines, kept in C's lines."""
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.ops import element_matrices as em
    from meshfem_tpu_torch.sparse.contract import qp_tables
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    gen = torch.Generator(device=dev).manual_seed(16)
    out = {}
    src_dir = "meshfem_tpu_torch/csrc/"
    A_TPU, B_TPU = ("meshfem_tpu/sparse/route.py:139",
                    "meshfem_tpu/sparse/route.py:162")
    d, K1 = 2, 3
    launches = lambda path, name: own_mode(paths[path], name) \
        if path in paths else 0
    for deg, n in ((1, FULL_P1_N), (2, FULL_P2_N)):
        sim = cantilever_2d(n, deg, dev)
        E, N, nn = sim.mesh.num_elements, sim.num_dofs, \
            sim.mesh.nodes_per_elem
        tag = f"2d/{deg}"
        shape = f"grid_tri({n}, {n // 4}) P{deg}: {E} triangles, {N} nodes"
        # E: against plain, the f64 Ke (one ulp) and on random inputs
        gl32 = sim.geom.grad_lambda.float().contiguous()
        vol32 = sim.geom.volume.float().contiguous()
        D_host = sim.D.cpu()
        Ke32 = kernels.element_stiffness(gl32, vol32, D_host, deg)
        e_ref = kernels.element_stiffness_plain(gl32, vol32, D_host, deg)
        ke_max = float(e_ref.abs().max())
        err_e = float((Ke32 - e_ref).abs().max())
        err_e64 = float((Ke32 - sim.Ke.float()).abs().max())
        ulps = ulps_from(Ke32, sim.Ke)
        del Ke32, e_ref
        gl_r = torch.randn((E, K1, d), generator=gen, device=dev)
        vol_r = torch.rand((E,), generator=gen, device=dev) + 0.5
        A_r = np.random.default_rng(6).standard_normal((3, 3))
        D_aniso = torch.as_tensor(50.0 * (A_r @ A_r.T + 3.0 * np.eye(3)))
        rand = {}
        for kind, Dm in (("isotropic", D_host), ("anisotropic", D_aniso)):
            e_out = kernels.element_stiffness(gl_r, vol_r, Dm, deg)
            e_pl = kernels.element_stiffness_plain(gl_r, vol_r, Dm, deg)
            k64 = em.element_elasticity_fused(gl_r.double(), vol_r.double(),
                                              Dm, deg)
            rand[kind] = dict(
                rel_err=float((e_out - e_pl).abs().max() / e_pl.abs().max()),
                ulps=ulps_from(e_out, k64))
            del e_out, e_pl, k64
        log(f"13e E element_stiffness ({tag}, {shape}): max abs err "
            f"{err_e:.3e} against plain (max|Ke| {ke_max:.3e}), {err_e64:.3e} "
            f"against the f64 Ke, {ulps:.3f} ulp of each entry from it; "
            f"random inputs {rand}")
        if not (err_e <= 1e-5 * ke_max and err_e64 <= 1e-5 * ke_max
                and ulps <= 1.0 and all(r["rel_err"] <= 1e-5
                                        and r["ulps"] <= 1.0
                                        for r in rand.values())):
            raise RuntimeError(f"13e element_stiffness ({tag}) disagrees")
        M32 = torch.as_tensor(em.fused_matrix_for(sim.D, 2, deg),
                              dtype=torch.float32, device=dev)
        nd = nn * d
        entry(f"element_stiffness/{tag}", src_dir + "element_stiffness.cu",
              "meshfem_tpu/kernels/element_stiffness.py:42",
              launches("cantilever_p1" if deg == 1 else "p2_dense",
                       "element_stiffness"), err_e,
              lambda: kernels.element_stiffness(gl32, vol32, D_host, deg),
              lambda: kernels.element_stiffness_plain(gl32, vol32, D_host,
                                                      deg),
              lambda: em.element_elasticity_fused_apply(gl32, vol32, M32,
                                                        nn),
              (K1 * d + 1 + nd * nd) * E * 4 + 9 * 8,
              (2 * ((K1 * d) ** 2 * d * d + nd * nd * K1 * K1) + nd * nd) * E,
              algorithm_flops=(2 * (K1 * (K1 + 1) // 2 * (d * d + d ** 4)
                                    + nd * nd * K1 * K1) + nd * nd) * E,
              algorithm_flop_rate=F64_FLOP_PER_S, max_abs_Ke=ke_max,
              max_abs_err_vs_f64=err_e64, max_ulps_vs_f64=ulps,
              random_inputs=rand,
              launches_path="13a P1 cantilever" if deg == 1
              else "13b P2 dense",
              library_call="ops.element_matrices."
                           "element_elasticity_fused_apply",
              shape=f"{shape}; grad_lambda [{E}, 3, 2], vol [{E}] f32, "
                    f"D [3, 3]")

        # C and D on the factored operator's inputs
        rk = sim.routed_kernel()
        lam, mu = et.lame_parameters(sim.D)
        rkf = RoutedEBE.build(None, sim.mesh.elem_nodes, N, d,
                              coords=sim.mesh.node_positions,
                              factor=(sim.geom.grad_lambda, sim.geom.volume,
                                      lam, mu, deg), device=dev)
        ue = torch.randn((d, nn, E), generator=gen, device=dev)
        c_out = kernels.qp_contract(rkf.g, rkf.vol, ue, lam, mu)
        c_ref = kernels.qp_contract_plain(rkf.g, rkf.vol, ue, lam, mu)
        d_out = kernels.factored_contract(rkf.g, rkf.vol, ue, lam, mu)
        d_ref = kernels.factored_contract_plain(rkf.g, rkf.vol, ue, lam, mu)
        rel_c = float((c_out - c_ref).abs().max() / c_ref.abs().max())
        rel_d = float((d_out - d_ref).abs().max() / d_ref.abs().max())
        rel_dc = float((d_out - c_out).abs().max() / c_out.abs().max())
        del c_ref, d_ref
        # in rows, as 13b's factored applies run them: against plain and,
        # bit for bit, against the kernel in planes
        ue_rows = ue.permute(2, 1, 0).reshape(E * nn, d).contiguous()
        err_rows = {}
        for name, out_planes in (("qp_contract", c_out),
                                 ("factored_contract", d_out)):
            out_rows = getattr(kernels, name)(rkf.g, rkf.vol, ue_rows, lam,
                                              mu, rows=True)
            ref = getattr(kernels, name + "_plain")(rkf.g, rkf.vol, ue_rows,
                                                    lam, mu, rows=True)
            err_rows[name] = float((out_rows - ref).abs().max())
            if not (err_rows[name] <= 1e-5 * float(ref.abs().max())
                    and torch.equal(out_rows.view(E, nn, d).permute(2, 1, 0),
                                    out_planes)):
                raise RuntimeError(f"13e {name} ({tag}) in rows disagrees "
                                   f"with plain or with planes")
            del out_rows, ref
        del d_out
        log(f"13e C qp_contract ({tag}) {rel_c:.3e} of max|y| against "
            f"plain; D factored_contract {rel_d:.3e}, D vs C {rel_dc:.3e}; "
            f"both in rows equal to plain (max abs err {err_rows}) and bit "
            f"for bit to planes")
        if not (rel_c <= 1e-5 and rel_d <= 1e-5 and rel_dc <= 5e-6):
            raise RuntimeError(f"13e C or D ({tag}) disagrees")
        Q = qp_tables(d, deg)[0].shape[0]
        qp_flops = Q * (2 * nn * K1 * d + 2 * d * d * nn + d + 1
                        + 4 * d * d + 2 * d + 2 * nn * d * d)
        ue_dense = ue.permute(2, 1, 0).reshape(E, nd, 1)
        KeP = rk.KeP
        c_bytes = (K1 * d + 1 + 2 * d * nn) * E * 4
        entry(f"qp_contract/rows/2d/{deg}", src_dir + "qp_contract.cu",
              "meshfem_tpu/sparse/contract.py:232",
              launches("p2_factored", "qp_contract/rows") if deg == 2 else 0,
              err_rows["qp_contract"],
              lambda: kernels.qp_contract(rkf.g, rkf.vol, ue_rows, lam, mu,
                                          rows=True),
              lambda: kernels.qp_contract_plain(rkf.g, rkf.vol, ue_rows, lam,
                                                mu, rows=True),
              lambda: torch.bmm(KeP, ue_dense), c_bytes, qp_flops * E,
              max_rel_err=rel_c,
              ptxas=(ptxas or {}).get("qp_contract.cu", []),
              timed=dict(planes_ms=lambda: kernels.qp_contract(
                  rkf.g, rkf.vol, ue, lam, mu)),
              timed_clean=dict(clean_l2_ms=lambda: kernels.qp_contract(
                  rkf.g, rkf.vol, ue_rows, lam, mu, rows=True)),
              mode=f"element-major rows [E*{nn}, 2], as 13b's applies run "
                   f"it (planes_ms: the kernel in planes [2, {nn}, E])",
              launches_path="13b P2 factored" if deg == 2
              else "none (13a runs the dense backend)",
              library_call="torch.bmm with the dense f32 Ke",
              shape=f"{shape}; g [6, {E}], vol [{E}], rows [{E * nn}, 2] f32")
        NG, NPAIR = K1 * (K1 + 1) // 2, nn * (nn + 1) // 2
        fma_d = (K1 * nn * d + (K1 * nn) ** 2 + d * nn * K1 + NG * d
                 + NPAIR * NG + d * nn * nn + d * nn)
        entry(f"factored_contract/rows/2d/{deg}",
              src_dir + "factored_contract.cu",
              "meshfem_tpu/sparse/contract.py:91",
              launches("p2_factored_tq", "factored_contract/rows")
              if deg == 2 else 0, err_rows["factored_contract"],
              lambda: kernels.factored_contract(rkf.g, rkf.vol, ue_rows, lam,
                                                mu, rows=True),
              lambda: kernels.factored_contract_plain(rkf.g, rkf.vol, ue_rows,
                                                      lam, mu, rows=True),
              lambda: torch.bmm(KeP, ue_dense), c_bytes, qp_flops * E,
              algorithm_flops=2 * fma_d * E, max_rel_err=rel_d,
              vs_kernel_c=rel_dc,
              timed=dict(planes_ms=lambda: kernels.factored_contract(
                  rkf.g, rkf.vol, ue, lam, mu)),
              mode=f"element-major rows [E*{nn}, 2], as 13b's applies run "
                   f"it (planes_ms: the kernel in planes [2, {nn}, E])",
              launches_path="13b P2 factored TQ" if deg == 2
              else "none (13a runs the dense backend)",
              library_call="torch.bmm with the dense f32 Ke",
              shape=f"{shape}; g [6, {E}], vol [{E}], rows [{E * nn}, 2] f32")
        del c_out, ue, ue_rows, ue_dense

        if deg == 1:
            # A and B in node rows at 2 values a node: 13a's dense applies
            ids_em, S = rk.ids_em, rk.ids_em.shape[0]
            src2 = torch.randn((2, N), generator=gen, device=dev)
            rows2 = src2.t().contiguous()
            for S_ in (S, S - 1):            # odd S: the scalar path
                ids_ = ids_em[:S_].contiguous()
                ref = kernels.gather_rows_plain(rows2, ids_)
                if not (torch.equal(kernels.gather_rows(rows2, ids_), ref)
                        and torch.equal(kernels.gather_rows(
                            src2, ids_, planes_in=True), ref)):
                    raise RuntimeError(f"13e gather_rows (2 values, S = "
                                       f"{S_}) != plain")
            ids_long = ids_em.long()
            entry("gather_rows/2d/2", src_dir + "gather_planes.cu", A_TPU,
                  launches("cantilever_p1", "gather_rows"), 0.0,
                  lambda: kernels.gather_rows(src2, ids_em, planes_in=True),
                  lambda: kernels.gather_rows_plain(src2, ids_em, True),
                  lambda: torch.index_select(rows2, 0, ids_long),
                  S * 4 + 2 * N * 4 + 2 * S * 4, 0,
                  odd_S_checked=S - 1,
                  mode="rows out [S, 2] from planes [2, N], as apply_planes "
                       "runs it",
                  launches_path="13a P1 cantilever",
                  library_call="torch.index_select",
                  shape=f"{shape}; src [2, {N}] f32, ids_em [{S}] int32")
            perm_em, offs = rk.plan_em.perm, rk.plan_em.offsets
            fr = torch.randn((S, 2), generator=gen, device=dev)
            out["rows_f32_2"] = check_b_rows(fr, rk, offs, "13e B rows f32 "
                                             "(2 values)")
            acc = torch.zeros((N, 2), device=dev)
            entry("segment_sum_rows/2d/2", src_dir + "segment_sum_csr.cu",
                  B_TPU, launches("cantilever_p1", "segment_sum_rows/2d/2"),
                  out["rows_f32_2"],
                  lambda: kernels.segment_sum_rows(fr, perm_em, offs,
                                                   planes_out=True),
                  lambda: kernels.segment_sum_rows_plain(fr, perm_em, offs,
                                                         True),
                  lambda: acc.index_add_(0, ids_long, fr),
                  2 * S * 4 + S * 4 + (N + 1) * 4 + 2 * N * 4, 2 * S,
                  mode="rows [S, 2] -> planes [2, N], as apply_planes runs "
                       "it",
                  launches_path="13a P1 cantilever, float32 launches",
                  library_call="Tensor.index_add_ (float atomics)",
                  shape=f"{shape}; src [{S}, 2] f32 -> [2, {N}]")
            plan64 = sim._kernel.plan
            R = plan64.num_rows
            dr = torch.randn((R, 2), generator=gen, device=dev,
                             dtype=torch.float64)
            out["rows_f64_2"] = check_rows_on_plan(
                plan64, torch.float64, "13e B rows f64 (2 values)", gen, P=2)
            dst64 = sim._kernel.elem_dofs.reshape(-1)
            acc64 = torch.zeros((N, 2), device=dev, dtype=torch.float64)
            entry("segment_sum_rows/f64/2d/2", src_dir + "segment_sum_csr.cu",
                  B_TPU + " (f64: the XLA scatter of "
                  "meshfem_tpu/sparse/scatter.py)",
                  launches("cantilever_p1", "segment_sum_rows/f64/2d/2"),
                  out["rows_f64_2"], lambda: plan64.sum_rows(dr),
                  lambda: kernels.segment_sum_rows_plain(dr, plan64.perm,
                                                         plan64.offsets),
                  lambda: acc64.index_add_(0, dst64, dr),
                  2 * R * 8 + R * 4 + (N + 1) * 4 + 2 * N * 8, 2 * R,
                  flop_rate=F64_FLOP_PER_S,
                  mode="f64 rows [R, 2] -> rows [N, 2]: the EBE residual",
                  launches_path="13a P1 cantilever, float64 launches",
                  library_call="Tensor.index_add_ (float atomics)",
                  shape=f"{shape}; src [{R}, 2] f64 -> [{N}, 2]")
        else:
            # A and B in planes at 2 planes, the layout of 13b's factored
            # applies before they ran in node rows: held, on no path
            ids, S = rkf.ids, rkf.ids.shape[0]
            src2 = torch.randn((2, N), generator=gen, device=dev)
            if not torch.equal(kernels.gather_planes(src2, ids),
                               kernels.gather_planes_plain(src2, ids)):
                raise RuntimeError("13e gather_planes (2 planes) != plain")
            ids_long = ids.long()
            entry("gather_planes/2d/2", src_dir + "gather_planes.cu", A_TPU,
                  launches("p2_factored", "gather_planes"), 0.0,
                  lambda: kernels.gather_planes(src2, ids),
                  lambda: kernels.gather_planes_plain(src2, ids),
                  lambda: torch.index_select(src2, 1, ids_long),
                  S * 4 + 2 * N * 4 + 2 * S * 4, 0,
                  launches_path="13b P2 factored and factored TQ (none: "
                                "their applies run in node rows)",
                  launches_2d_factored_tq=launches("p2_factored_tq",
                                                   "gather_planes"),
                  library_call="torch.index_select",
                  shape=f"{shape}; src [2, {N}] f32, ids [{S}] int32")
            perm, offs = rkf.plan.perm, rkf.plan.offsets
            fp = torch.randn((2, S), generator=gen, device=dev)
            out["planes_f32_2"] = check_b_planes(fp, perm, offs,
                                                 "13e B planes (2)")
            acc = torch.zeros((2, N), device=dev)
            entry("segment_sum_csr/2d/2", src_dir + "segment_sum_csr.cu",
                  B_TPU, launches("p2_factored", "segment_sum_csr/2d/2"),
                  out["planes_f32_2"],
                  lambda: kernels.segment_sum_csr(fp, perm, offs),
                  lambda: kernels.segment_sum_csr_plain(fp, perm, offs),
                  lambda: acc.index_add_(1, ids_long, fp),
                  2 * S * 4 + S * 4 + (N + 1) * 4 + 2 * N * 4, 2 * S,
                  launches_path="13b P2 factored and factored TQ (none: "
                                "their applies run in node rows)",
                  launches_2d_factored_tq=launches(
                      "p2_factored_tq", "segment_sum_csr/2d/2"),
                  library_call="Tensor.index_add_ (float atomics)",
                  shape=f"{shape}; src [2, {S}] f32 -> [2, {N}]")
        del sim, rk, rkf

    # 6 values a node: the 13c cell's block apply (3 columns x 2)
    hrk = hsim.routed_kernel(block_rhs=3)
    Nh = hsim.num_dofs
    ids_em, S = hrk.ids_em, hrk.ids_em.shape[0]
    U6 = torch.randn((Nh, 6), generator=gen, device=dev)
    for S_ in (S, S - 1):
        ids_ = ids_em[:S_].contiguous()
        if not torch.equal(kernels.gather_rows(U6, ids_),
                           kernels.gather_rows_plain(U6, ids_)):
            raise RuntimeError(f"13e gather_rows (6 values, S = {S_}) != "
                               f"plain")
    shape = f"13c cell: {hsim.mesh.num_elements} triangles, {Nh} nodes"
    ids_long = ids_em.long()
    entry("gather_rows/2d/6", src_dir + "gather_planes.cu", A_TPU,
          launches("tri_cell_block", "gather_rows"), 0.0,
          lambda: kernels.gather_rows(U6, ids_em),
          lambda: kernels.gather_rows_plain(U6, ids_em),
          lambda: torch.index_select(U6, 0, ids_long),
          S * 4 + 6 * Nh * 4 + 6 * S * 4, 0, odd_S_checked=S - 1,
          mode="rows [N, 6] -> [S, 6], as apply_block runs it",
          launches_path="13c triangle cell (block)",
          launches_2d_jacobi=launches("tri_cell_jacobi", "gather_rows"),
          library_call="torch.index_select",
          shape=f"{shape}; U [{Nh}, 6] f32, ids_em [{S}] int32")
    perm_em, offs = hrk.plan_em.perm, hrk.plan_em.offsets
    f6 = torch.randn((S, 6), generator=gen, device=dev)
    out["rows_f32_6"] = check_b_rows(f6, hrk, offs, "13e B rows f32 (6)")
    acc = torch.zeros((Nh, 6), device=dev)
    entry("segment_sum_rows/2d/6", src_dir + "segment_sum_csr.cu", B_TPU,
          launches("tri_cell_block", "segment_sum_rows/2d/6"),
          out["rows_f32_6"],
          lambda: kernels.segment_sum_rows(f6, perm_em, offs),
          lambda: kernels.segment_sum_rows_plain(f6, perm_em, offs),
          lambda: acc.index_add_(0, ids_long, f6),
          6 * S * 4 + S * 4 + (Nh + 1) * 4 + 6 * Nh * 4, 6 * S,
          mode="rows [S, 6] -> rows [N, 6], as apply_block runs it",
          launches_path="13c triangle cell (block), float32 launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"{shape}; src [{S}, 6] f32 -> [{Nh}, 6]")
    plan64 = hsim._kernel.plan
    R = plan64.num_rows
    d6 = torch.randn((R, 6), generator=gen, device=dev, dtype=torch.float64)
    out["rows_f64_6"] = check_rows_on_plan(plan64, torch.float64,
                                           "13e B rows f64 (6)", gen, P=6)
    dst64 = hsim._kernel.elem_dofs.reshape(-1)
    acc64 = torch.zeros((Nh, 6), device=dev, dtype=torch.float64)
    entry("segment_sum_rows/f64/2d/6", src_dir + "segment_sum_csr.cu",
          B_TPU + " (f64: the XLA scatter of meshfem_tpu/sparse/scatter.py)",
          launches("tri_cell_block", "segment_sum_rows/f64/2d/6"),
          out["rows_f64_6"], lambda: plan64.sum_rows(d6),
          lambda: kernels.segment_sum_rows_plain(d6, plan64.perm,
                                                 plan64.offsets),
          lambda: acc64.index_add_(0, dst64, d6),
          6 * R * 8 + R * 4 + (Nh + 1) * 4 + 6 * Nh * 8, 6 * R,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [R, 6] -> rows [N, 6]: the block residual",
          launches_path="13c triangle cell (block), float64 launches",
          launches_2d_pixels=launches("pixels", "segment_sum_rows/f64"),
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"{shape}; src [{R}, 6] f64 -> [{Nh}, 6]")
    # A and B in planes at 6 planes, the factored block apply's layout
    # before node rows (on no path), and C and D in rows at its 3 columns
    for k in ("MESHFEM_FACTORED", "MESHFEM_FACTORED_TQ"):
        os.environ.pop(k, None)
    os.environ["MESHFEM_FACTORED"] = "1"
    try:
        hsim._routed = None
        hrf = hsim.routed_kernel(block_rhs=3)
    finally:
        os.environ.pop("MESHFEM_FACTORED", None)
        hsim._routed = None
    lam_h, mu_h = hrf.lam, hrf.mu
    nn_h, Eh = hrf.nodes_per_elem, hrf.num_elements
    rows6 = torch.randn((Eh * nn_h, 6), generator=gen, device=dev)
    for name in ("qp_contract", "factored_contract"):
        fn = getattr(kernels, name)
        f6 = fn(hrf.g, hrf.vol, rows6, lam_h, mu_h, rows=True)
        ref = getattr(kernels, name + "_plain")(hrf.g, hrf.vol, rows6, lam_h,
                                                mu_h, rows=True)
        rel = float((f6 - ref).abs().max() / ref.abs().max())
        u4, f4 = rows6.view(Eh, nn_h, 2, 3), f6.view(Eh, nn_h, 2, 3)
        same = all(torch.equal(
            fn(hrf.g, hrf.vol, u4[..., j].permute(2, 1, 0).contiguous(),
               lam_h, mu_h), f4[..., j].permute(2, 1, 0)) for j in range(3))
        out[name + "_rows_3"] = rel
        log(f"13e {name} in rows at the 13c cell's 3 columns ([{Eh * nn_h}, "
            f"6]): {rel:.3e} of max|y| against plain; "
            f"{'bit for bit' if same else 'NOT EQUAL'} against planes column "
            f"by column")
        if not (rel <= 1e-5 and same):
            raise RuntimeError(f"13e {name} in rows (3 columns) disagrees")
        del f6, ref, u4, f4
    del rows6
    ids, Sf = hrf.ids, hrf.ids.shape[0]
    src6 = torch.randn((6, Nh), generator=gen, device=dev)
    if not torch.equal(kernels.gather_planes(src6, ids),
                       kernels.gather_planes_plain(src6, ids)):
        raise RuntimeError("13e gather_planes (6 planes) != plain")
    ids_long = ids.long()
    entry("gather_planes/2d/6", src_dir + "gather_planes.cu", A_TPU,
          0, 0.0, lambda: kernels.gather_planes(src6, ids),
          lambda: kernels.gather_planes_plain(src6, ids),
          lambda: torch.index_select(src6, 1, ids_long),
          Sf * 4 + 6 * Nh * 4 + 6 * Sf * 4, 0,
          launches_path="none (13c runs the dense backend; the factored "
                        "block apply's 6 planes)",
          library_call="torch.index_select",
          shape=f"{shape}; src [6, {Nh}] f32, ids [{Sf}] int32")
    fp6 = torch.randn((6, Sf), generator=gen, device=dev)
    out["planes_f32_6"] = check_b_planes(fp6, hrf.plan.perm, hrf.plan.offsets,
                                         "13e B planes (6)")
    acc6 = torch.zeros((6, Nh), device=dev)
    entry("segment_sum_csr/2d/6", src_dir + "segment_sum_csr.cu", B_TPU, 0,
          out["planes_f32_6"],
          lambda: kernels.segment_sum_csr(fp6, hrf.plan.perm,
                                          hrf.plan.offsets),
          lambda: kernels.segment_sum_csr_plain(fp6, hrf.plan.perm,
                                                hrf.plan.offsets),
          lambda: acc6.index_add_(1, ids_long, fp6),
          6 * Sf * 4 + Sf * 4 + (Nh + 1) * 4 + 6 * Nh * 4, 6 * Sf,
          launches_path="none (13c runs the dense backend; the factored "
                        "block apply's 6 planes)",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"{shape}; src [6, {Sf}] f32 -> [6, {Nh}]")
    return out


# ---------------------------------------------------------------------------
# Phase 15: scalar Poisson, the discrete operators, geodesics in heat, mesh
# and field I/O and the Poisson and Simulate CLIs
# ---------------------------------------------------------------------------

# The convergence suite of experiments/laplace_convergence.py on
# grid_tri(n, n): P1 up to 1024 and P2 up to 512 (1,050,625 nodes each).
POISSON_P1_SIZES = (64, 128, 256, 512, 1024)
POISSON_P2_SIZES = (32, 64, 128, 256, 512)
POISSON_TOL, POISSON_MAXITER = 1e-13, 20000
# Geodesics in heat run at the reference CG's default maxiter (1000).  Its
# heat step (t = h^2) decays by a constant factor a cell, so past ~20 cells
# the far field lies below the solve's 1e-11 tolerance and the distances
# lose accuracy: the reference's own geodesic_distances on the CPU misses
# its 0.08 gate from grid_tri(24) on, and the port gives the same numbers.
# So the accuracy gates run at GEO_GATE_N; at GEO_CONV_N, the largest
# probed n whose divergence solve still reaches tol within 1000 iterations
# on the CPU (at 192 it stops at 1000), both solves must converge; at
# GEO_BIG_N and the sizes of GEO_SWEEP only the numbers are printed.
GEO_GATE_N, GEO_CONV_N, GEO_BIG_N = 20, 176, 512
GEO_SWEEP = (16, 24, 32, 192)
CLI_POISSON_N = 256
# the Poisson CLI's regions in tests/test_cli.py::test_poisson_cli
POISSON_CLI_BC = json.dumps({"regions": [
    {"type": "dirichlet", "value": ["sin(pi * x)", 0, 0],
     "box%": {"minCorner": [-0.001, 0.999], "maxCorner": [1.001, 1.001]}},
    {"type": "dirichlet", "value": [0, 0, 0],
     "box%": {"minCorner": [-0.001, -0.001], "maxCorner": [1.001, 0.001]}}]})


class ScalarApplyCounter:
    """Counts, while active, what must launch kernel B once in float64 on
    the scalar paths: every f64 EBE apply and diagonal (``EBEKernel``) and
    every ``sparse.assembly.scatter_load``; and the calls of B's plain
    versions, which must be none on the card."""

    def __init__(self):
        self.count = {"apply": 0, "diagonal": 0, "scatter_load": 0,
                      "plain": 0}

    def _wrap(self, owner, name, key):
        fn = getattr(owner, name)

        def counted(*args, **kw):
            self.count[key] += 1
            return fn(*args, **kw)
        self._saved.append((owner, name, fn))
        setattr(owner, name, counted)

    def __enter__(self):
        from meshfem_tpu_torch.kernels import segment_sum
        from meshfem_tpu_torch.sparse import assembly
        from meshfem_tpu_torch.sparse.ebe import EBEKernel

        self._saved = []
        self._wrap(EBEKernel, "__call__", "apply")
        self._wrap(EBEKernel, "diagonal", "diagonal")
        self._wrap(assembly, "scatter_load", "scatter_load")
        for name in ("segment_sum_rows_plain", "segment_sum_csr_plain"):
            self._wrap(segment_sum, name, "plain")
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def total(self):
        return self.count["apply"] + self.count["diagonal"] \
            + self.count["scatter_load"]


def counted_scalar(label, fn, extra_sums=lambda: 0):
    """One counted run of a scalar path: every f64 apply, diagonal and
    ``scatter_load``, and the ``extra_sums()`` other f64 sums the path
    makes through a ``ScatterPlan`` (read after the run), must have
    launched kernel B in float64 once, and nothing else may have launched
    (no float32 B, no planes, no plain version)."""
    with ScalarApplyCounter() as sc:
        out, wall, counts = counted(label, fn, ("segment_sum_rows",))
    n = sc.total() + extra_sums()
    others = {k: v for k, v in counts.items()
              if v and not k.startswith("segment_sum_rows")}
    log(f"{label}: {sc.count}, other sums {n - sc.total()}, "
        f"segment_sum_rows {counts['segment_sum_rows']} (f64 "
        f"{counts['segment_sum_rows/f64']})")
    if not (n > 0 and counts["segment_sum_rows"] == n
            and counts["segment_sum_rows/f64"] == n
            and sc.count["plain"] == 0 and not others):
        raise RuntimeError(f"{label}: not every scalar apply and load sum "
                           f"launched kernel B in float64 once "
                           f"({sc.count}, {counts})")
    return out, wall, counts


def sin_sin(X):
    return np.sin(np.pi * X[:, 0]) * np.sin(np.pi * X[:, 1])


def poisson_free_relres(prob, u, b, fixed):
    """The true float64 relative residual |P (b - L u)| / |P b| on the free
    nodes."""
    free = (~fixed).to(b.dtype)
    return float(torch.linalg.norm((b - prob.L(u)) * free)
                 / torch.linalg.norm(b * free))


def drive_convergence(dev):
    """15a: sin(pi x) sin(pi y) on grid_tri(n, n), P1 and P2, tol 1e-13;
    the L2 error through the consistent mass, its rate, the CG counts.
    Returns (rows, the launch counts of all the solves, the largest P1
    problem)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import PoissonProblem

    rows, keep, total = [], None, {}
    for deg, sizes, order in ((1, POISSON_P1_SIZES, 2.0),
                              (2, POISSON_P2_SIZES, 3.0)):
        prev = None
        for n in sizes:
            t0 = time.time()
            V, F = generators.grid_tri(n, n)
            mesh = FEMMesh(V, F, degree=deg)
            t_mesh = time.time() - t0
            X = mesh.node_positions
            exact = sin_sin(X)
            f = 2 * np.pi ** 2 * exact          # the reference's source
            t0 = time.time()
            prob = PoissonProblem(mesh, device=dev)
            torch.cuda.synchronize()
            t_prob = time.time() - t0
            (u, res), wall, counts = counted_scalar(
                f"15a P{deg} n={n}", lambda: prob.solve(
                    mesh.bdry_nodes, 0.0, source=f, tol=POISSON_TOL,
                    maxiter=POISSON_MAXITER))
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            d = u - torch.as_tensor(exact, device=dev)
            err = float(torch.sqrt(torch.vdot(d, prob.M(d))))
            rate = float(np.log2(prev / err)) if prev else None
            prev = err
            fixed = torch.zeros(mesh.num_nodes, dtype=torch.bool, device=dev)
            fixed[torch.as_tensor(mesh.bdry_nodes, device=dev)] = True
            b = prob.load_from_source(f)
            bfree = float(torch.linalg.norm(b * (~fixed)))
            row = dict(deg=deg, n=n, nodes=mesh.num_nodes,
                       elements=mesh.num_elements, l2_error=err, rate=rate,
                       iters=res.iters, cg_relres=res.resnorm / bfree,
                       true_relres=poisson_free_relres(prob, u, b, fixed),
                       solve_s=wall, ms_per_iter=wall / max(res.iters, 1)
                       * 1e3, mesh_s=t_mesh, problem_s=t_prob)
            rows.append(row)
            log(f"15a P{deg} n={n}: {mesh.num_nodes} nodes, L2 error "
                f"{err:.6e}, rate {rate if rate is None else round(rate, 4)},"
                f" {res.iters} CG iterations, CG relres "
                f"{row['cg_relres']:.3e}, true relres "
                f"{row['true_relres']:.3e}, solve {wall:.3f} s "
                f"({row['ms_per_iter']:.4f} ms an iteration), mesh "
                f"{t_mesh:.2f} s, problem {t_prob:.2f} s")
            if not (res.iters < POISSON_MAXITER
                    and row["cg_relres"] <= POISSON_TOL):
                raise RuntimeError(f"15a P{deg} n={n}: the solve stopped at "
                                   f"{res.iters} iterations, relres "
                                   f"{row['cg_relres']:.3e}")
            if rate is not None and not abs(rate - order) <= 0.35:
                raise RuntimeError(f"15a P{deg} n={n}: rate {rate:.3f}, "
                                   f"expected {order} +- 0.35")
            if deg == 1 and n == sizes[-1]:
                keep = prob
            del prob, u, d, b
    worst = max(rows, key=lambda r: r["iters"])
    log(f"15a: the solve closest to maxiter = {POISSON_MAXITER}: "
        f"P{worst['deg']} n={worst['n']}, {worst['iters']} iterations")
    return rows, total, keep


def drive_quadratic_3d(dev):
    """15b: the exact quadratic of test_p2_reproduces_quadratic on
    grid_tet(36) P2, the consistent source through load_from_source."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import PoissonProblem

    V, T = generators.grid_tet(BENCH_N, BENCH_N, BENCH_N)
    mesh = FEMMesh(V, T, degree=2)
    X = mesh.node_positions
    coef = np.array([1.0, -2.0, 1.5])
    exact = (X ** 2) @ coef
    f = np.full(mesh.num_nodes, -2.0 * coef.sum())
    prob = PoissonProblem(mesh, device=dev)
    bn = mesh.bdry_nodes
    (u, res), wall, counts = counted_scalar(
        "15b", lambda: prob.solve(bn, exact[bn], source=f, tol=POISSON_TOL,
                                  maxiter=POISSON_MAXITER))
    err = float((u - torch.as_tensor(exact, device=dev)).abs().max())
    umax = float(u.abs().max())
    out = dict(nodes=mesh.num_nodes, iters=res.iters, solve_s=wall,
               ms_per_iter=wall / max(res.iters, 1) * 1e3, max_err=err,
               gate=1e-7 * umax)
    log(f"15b grid_tet({BENCH_N}) P2 quadratic: {mesh.num_nodes} nodes, "
        f"{res.iters} CG iterations in {wall:.3f} s, max error {err:.3e} "
        f"(gate {1e-7 * umax:.3e})")
    if not err <= 1e-7 * umax:
        raise RuntimeError(f"15b: max error {err:.3e} > 1e-7 max|u|")
    return out, counts


class SolveRecorder:
    """Records (iterations, residual) of each ``solve_dirichlet`` that
    ``analysis.geodesics`` runs, while active."""

    def __enter__(self):
        from meshfem_tpu_torch.analysis import geodesics

        self.mod, self.log = geodesics.cg_mod, []
        self._fn = self.mod.solve_dirichlet

        def rec(*args, **kw):
            res = self._fn(*args, **kw)
            self.log.append((res.iters, res.resnorm))
            return res
        self.mod.solve_dirichlet = rec
        return self

    def __exit__(self, *exc):
        self.mod.solve_dirichlet = self._fn


def geodesics_at(n, device, gate, count=True):
    """geodesic_distances from the corner node of grid_tri(n, n) P1:
    (distances, its numbers, the launch counts when ``count``)."""
    from meshfem_tpu_torch.analysis import geodesics
    from meshfem_tpu_torch.mesh import FEMMesh, generators

    V, F = generators.grid_tri(n, n)
    mesh = FEMMesh(V, F, degree=1)
    src = mesh.nodes_in_box((0, 0), (0, 0))
    with SolveRecorder() as rec:
        if count:
            d, wall, counts = counted_scalar(
                f"15c n={n}",
                lambda: geodesics.geodesic_distances(mesh, src,
                                                     device=device))
        else:
            t0 = time.time()
            d, counts = geodesics.geodesic_distances(mesh, src,
                                                     device=device), None
            wall = time.time() - t0
    dh = d.cpu().numpy()
    err = float(np.abs(dh - np.linalg.norm(mesh.node_positions,
                                           axis=1)).max())
    diag = [mesh.nodes_in_box((x, x), (x, x))[0] for x in
            (0.25, 0.5, 0.75, 1.0)]
    monotone = bool(np.all(np.diff(dh[diag]) > 0))
    out = dict(n=n, nodes=mesh.num_nodes, solves=rec.log, seconds=wall,
               max_err=err, monotone=monotone)
    if count:
        log(f"15c geodesics grid_tri({n}): (iterations, residual) "
            f"{rec.log}, {wall:.3f} s, max |d - |x|| {err:.4f}, monotone "
            f"along the diagonal {monotone}")
    if gate == "accuracy" and not (err < 0.08 and monotone):
        raise RuntimeError(f"15c n={n}: max error {err:.4f}, monotone "
                           f"{monotone}")
    if gate in ("accuracy", "converge") and not all(
            it < 1000 for it, _ in rec.log):
        raise RuntimeError(f"15c n={n}: a solve ran out of maxiter "
                           f"({rec.log})")
    return d, out, counts


def drive_geodesics(dev):
    """15c: geodesics in heat at GEO_GATE_N (gated on accuracy, against
    the CPU too), GEO_CONV_N (both solves converge), GEO_BIG_N and the
    sizes of GEO_SWEEP (printed)."""
    out, paths = {}, {}
    for n in GEO_SWEEP:
        out[n] = geodesics_at(n, dev, None, count=False)[1]
        log(f"15c geodesics grid_tri({n}) (printed, no gate): "
            f"(iterations, residual) {out[n]['solves']}, max |d - |x|| "
            f"{out[n]['max_err']:.4f}, monotone {out[n]['monotone']}")
    for n, gate in ((GEO_GATE_N, "accuracy"), (GEO_CONV_N, "converge"),
                    (GEO_BIG_N, None)):
        d, out[n], paths[f"15c_geodesics_{n}"] = geodesics_at(n, dev, gate)
        if n == GEO_GATE_N:
            d_cpu, cpu, _ = geodesics_at(n, torch.device("cpu"), None,
                                         count=False)
            err = rel_err(d.cpu(), d_cpu)
            out[n]["vs_cpu"] = err
            if not (err <= 1e-10 and [i for i, _ in cpu["solves"]]
                    == [i for i, _ in out[n]["solves"]]):
                raise RuntimeError(f"15c n={n}: card against CPU {err:.3e}, "
                                   f"iterations {out[n]['solves']} / "
                                   f"{cpu['solves']}")
            log(f"15c n={n}: card against CPU {err:.3e}, the same counts")
    return out, paths


def drive_poisson_vs_cpu(dev):
    """15d: PoissonProblem.solve, neumann_load, geodesic_distances,
    boundary_laplacian and bilaplacian_apply on grid_tri(16, 16) and
    grid_tet(4, 4, 4), P1 and P2, card against CPU (1e-10 of max)."""
    from meshfem_tpu_torch.analysis import geodesics
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.ops import extra_operators, operators
    from meshfem_tpu_torch.physics import PoissonProblem

    cpu = torch.device("cpu")
    worst = {}
    for name, (V, F) in (("tri", generators.grid_tri(16, 16)),
                         ("tet", generators.grid_tet(4, 4, 4))):
        for deg in (1, 2):
            mesh = FEMMesh(V, F, degree=deg)
            X = mesh.node_positions
            bn = mesh.bdry_nodes
            exact = (X ** 2) @ np.array([1.0, -2.0, 1.5])[:mesh.dim]
            flux = np.linspace(-1.0, 1.0, mesh.num_boundary_elements)
            u0 = np.random.default_rng(deg).normal(size=mesh.num_nodes)
            src = mesh.nodes_in_box(X.min(0), X.min(0))
            res = {}
            for where, device in (("card", dev), ("cpu", cpu)):
                prob = PoissonProblem(mesh, device=device)
                u = torch.as_tensor(u0, device=device)
                res[where] = dict(
                    solve=prob.solve(bn, exact[bn], source=lambda x: 1.0,
                                     tol=1e-13)[0],
                    neumann_load=prob.neumann_load(flux),
                    geodesics=geodesics.geodesic_distances(mesh, src,
                                                           device=device),
                    boundary_laplacian=extra_operators.boundary_laplacian(
                        mesh, device=device)(u),
                    bilaplacian=operators.bilaplacian_apply(
                        mesh, device=device)(u))
            for key, a in res["card"].items():
                b = res["cpu"][key]
                fin = torch.isfinite(b)
                # the P2 triangle's lumped mass has zero vertex weights
                if not torch.equal(torch.isfinite(a).cpu(), fin):
                    raise RuntimeError(f"15d {name} P{deg} {key}: finite "
                                       f"entries differ")
                e = rel_err(a.cpu()[fin], b[fin])
                worst[f"{name}{deg}/{key}"] = e
                if not e <= 1e-10:
                    raise RuntimeError(f"15d {name} P{deg} {key}: card "
                                       f"against CPU {e:.3e}")
    log(f"15d card against CPU: worst {max(worst.values()):.3e} "
        f"({max(worst, key=worst.get)})")
    return worst


def drive_io(sim, u, tmp):
    """15e: the bench mesh grid_tet(36) P2 with phase 4's u (node vector)
    and von Mises (element scalar), written as binary and as ASCII MSH and
    read back by meshio and msh_fields; host seconds of each."""
    from meshfem_tpu_torch.io import meshio, msh_fields

    mesh = sim.mesh
    uh = u.cpu().numpy()
    vm = sim.von_mises_field(u).cpu().numpy()
    fields = [{"name": "u", "data": uh, "where": "node", "kind": "vector"},
              {"name": "von_mises", "data": vm, "where": "element",
               "kind": "scalar"}]
    out = {}
    for kind, binary in (("binary", True), ("ascii", False)):
        path = os.path.join(tmp, f"bench_{kind}.msh")
        t0 = time.time()
        meshio.save_msh(path, mesh.node_positions, mesh.elem_nodes,
                        binary=binary, fields=fields)
        t_write = time.time() - t0
        t0 = time.time()
        V, F = meshio.load(path)
        t_load = time.time() - t0
        t0 = time.time()
        got = msh_fields.read_fields(path)
        t_fields = time.time() - t0
        # the nodes go out in binary float64 or as %.17g text, the fields
        # as %.17g text: both read back to the same float64 bits
        same = (np.array_equal(V, mesh.node_positions)
                and np.array_equal(F, mesh.elem_nodes)
                and np.array_equal(msh_fields.vector_field(got, "u"), uh)
                and np.array_equal(msh_fields.scalar_field(got, "von_mises"),
                                   vm))
        out[kind] = dict(bytes=os.path.getsize(path), write_s=t_write,
                         load_s=t_load, read_fields_s=t_fields,
                         bit_for_bit=same)
        log(f"15e {kind} MSH: {os.path.getsize(path) / 2**20:.1f} MiB, "
            f"write {t_write:.2f} s, meshio.load {t_load:.2f} s, "
            f"msh_fields.read_fields {t_fields:.2f} s; equal bit for bit "
            f"{same}")
        os.remove(path)
        if not same:
            raise RuntimeError(f"15e: the {kind} MSH did not read back bit "
                               f"for bit")
    return out


def drive_clis(dev, tmp):
    """15f: cli.poisson on a grid_tri(256, 256) .off, cli.simulate on the
    13b P2 cantilever as .msh, on the card; outputs read back, the
    Simulate u against the package API's solve (1e-8 of max|u|)."""
    from meshfem_tpu_torch.cli import poisson as poisson_cli
    from meshfem_tpu_torch.cli import simulate as simulate_cli
    from meshfem_tpu_torch.io import meshio, msh_fields
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import PoissonProblem, load_bc
    from meshfem_tpu_torch.physics.boundary_conditions import \
        match_boundary_nodes
    from meshfem_tpu_torch.utils.expressions import evaluate

    out, paths = {}, {}
    V, F = generators.grid_tri(CLI_POISSON_N, CLI_POISSON_N)
    off, bc, msh = (os.path.join(tmp, f) for f in ("sq.off", "p.bc",
                                                   "u.msh"))
    meshio.save_off(off, V, F)
    with open(bc, "w") as fh:
        fh.write(POISSON_CLI_BC)
    _, wall, paths["15f_poisson_cli"] = counted_scalar(
        "15f cli.poisson", lambda: poisson_cli.main([off, "-b", bc, "-o",
                                                     msh]))
    got = msh_fields.read_fields(msh)
    u_cli = msh_fields.scalar_field(got, "u")
    # the same solve through the package API
    mesh = FEMMesh(V, F, degree=1)
    nodes, vals = [], []
    for region in load_bc(bc, dim=2).regions:
        ns = match_boundary_nodes(mesh, region)
        nodes.append(ns)
        vals.append(evaluate(region.value[0], mesh.node_positions[ns]))
    u_api, _ = PoissonProblem(mesh, device=dev).solve(
        np.concatenate(nodes), np.concatenate(vals), tol=1e-12)
    err = float(np.abs(u_cli - u_api.cpu().numpy()).max())
    out["poisson"] = dict(seconds=wall, nodes=mesh.num_nodes,
                          vs_api=err, u_min=float(u_cli.min()),
                          u_max=float(u_cli.max()))
    log(f"15f cli.poisson grid_tri({CLI_POISSON_N}): {wall:.2f} s, u in "
        f"[{u_cli.min():.6g}, {u_cli.max():.6g}], against the API {err:.3e}")
    if not (err <= 1e-12 * np.abs(u_cli).max() and u_cli.max() <= 1 + 1e-9
            and u_cli.min() >= -1e-6 and "grad_u" in got):
        raise RuntimeError("15f cli.poisson: bad output")

    sim = cantilever_2d(CANT_P2_N, 2, dev)
    V2, F2 = sim.mesh.V, sim.mesh.F
    bar, mat, bc2, out_msh = (os.path.join(tmp, f) for f in (
        "bar.msh", "mat.material", "bar.bc", "bar_out.msh"))
    meshio.save_msh(bar, V2, F2)
    with open(mat, "w") as fh:
        json.dump({"type": "isotropic_material", "dim": 2, "young": E_2D,
                   "poisson": NU_2D}, fh)
    with open(bc2, "w") as fh:
        fh.write(CANTILEVER_2D_BC)
    _, wall, paths["15f_simulate_cli"] = counted(
        "15f cli.simulate", lambda: simulate_cli.main(
            [bar, "-m", mat, "-b", bc2, "-o", out_msh, "--degree", "2"]))
    got = msh_fields.read_fields(out_msh)
    u_cli = msh_fields.vector_field(got, "u", 2)
    with warnings.catch_warnings(record=True) as stalled:
        warnings.simplefilter("always", RuntimeWarning)
        u_api, res = sim.solve(tol=1e-11)
    u_api = u_api.cpu().numpy()
    err = float(np.abs(u_cli - u_api).max())
    umax = float(np.abs(u_api).max())
    out["simulate"] = dict(seconds=wall, dofs=2 * sim.num_dofs, vs_api=err,
                           max_u=umax, api_iters=res.iters,
                           api_rounds=res.rounds, api_relres=res.resnorm,
                           api_warnings=[str(w.message) for w in stalled])
    log(f"15f cli.simulate grid_tri({CANT_P2_N}, {CANT_P2_N // 4}) P2: "
        f"{wall:.2f} s, fields {sorted(got)}, u against the API {err:.3e} "
        f"(max|u| {umax:.4e}); the API solve at the CLI's tol 1e-11: "
        f"{res.rounds} rounds, {res.iters} inner iterations, relres "
        f"{res.resnorm:.3e}, warnings {out['simulate']['api_warnings']}")
    if not (err <= 1e-8 * umax and {"u", "load", "strain", "stress",
                                     "von_mises"} <= set(got)):
        raise RuntimeError("15f cli.simulate: bad output")
    return out, paths


def drive_poisson(dev, sim, u):
    """Phase 15a-f; returns (summary, launch counts per path, the largest
    P1 problem for 15g)."""
    import tempfile

    out, paths = {}, {}
    t0 = time.time()
    out["convergence"], paths["15a_convergence"], big = \
        drive_convergence(dev)
    out["convergence_s"] = time.time() - t0
    out["quadratic_3d"], paths["15b_quadratic_3d"] = drive_quadratic_3d(dev)
    t = time.time()
    out["geodesics"], p = drive_geodesics(dev)
    out["geodesics_s"] = time.time() - t
    paths.update(p)
    out["vs_cpu"] = drive_poisson_vs_cpu(dev)
    with tempfile.TemporaryDirectory() as tmp:
        out["io"] = drive_io(sim, u, tmp)
        out["clis"], p = drive_clis(dev, tmp)
    paths.update(p)
    out["phase_s"] = time.time() - t0
    log(f"phase 15 (15a-f): {out['phase_s']:.1f} s")
    return out, paths, big


def kernels_poisson(dev, entry, big, paths, gen):
    """15g: kernel B on the scalar path, the plan of 15a's largest P1
    operator (one value a node, float64): held against its plain version
    and bit-identical across two runs, timed with ``entry``; then one full
    Laplacian apply by its stages.  Returns the stage times."""
    from meshfem_tpu_torch import kernels

    plan_p = big.L._kernel.plan
    Rp, Np = plan_p.num_rows, plan_p.num_segments
    src_p = torch.randn((Rp, 1), generator=gen, device=dev,
                        dtype=torch.float64)
    y1 = kernels.segment_sum_rows(src_p, plan_p.perm, plan_p.offsets)
    y2 = kernels.segment_sum_rows(src_p, plan_p.perm, plan_p.offsets)
    if not torch.equal(y1, y2):
        raise RuntimeError("15g: segment_sum_rows f64 (1 value) not "
                           "bit-identical across two runs")
    err_p = check_rows_on_plan(plan_p, torch.float64,
                               "15g B rows f64 (1 value)", gen, P=1)
    log(f"15g B rows f64 at 1 value ({Rp} rows into {Np} nodes): "
        f"bit-identical across two runs, max abs err against plain "
        f"{err_p:.3e}")
    del y1, y2
    dst_p = big.L._kernel.elem_dofs.reshape(-1)
    acc_p = torch.zeros((Np, 1), device=dev, dtype=torch.float64)
    conv = paths["15a_convergence"]
    entry("segment_sum_rows/f64/1",
          "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:207 (_reduce_kernel, 1 plane; f64: "
          "the XLA segment_sum of meshfem_tpu/sparse/assembly.py and "
          "sparse/ebe.py)", conv["segment_sum_rows/f64"], err_p,
          lambda: plan_p.sum_rows(src_p),
          lambda: kernels.segment_sum_rows_plain(src_p, plan_p.perm,
                                                 plan_p.offsets),
          lambda: acc_p.index_add_(0, dst_p, src_p),
          Rp * 8 + Rp * 4 + (Np + 1) * 4 + Np * 8, Rp,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [R, 1] -> [N, 1]: every scalar apply, diagonal "
               "and scatter_load",
          launches_path="15a convergence suite (all sizes, P1 and P2)",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"grid_tri({POISSON_P1_SIZES[-1]}) P1 Laplacian plan: src "
                f"[{Rp}, 1] f64 -> [{Np}, 1]")
    # one full Laplacian apply by its stages (events, warm L2)
    kern = big.L._kernel
    Ep = kern.Ke.shape[0]
    lap_inputs = [torch.randn(Np, generator=gen, device=dev,
                              dtype=torch.float64) for _ in range(7)]
    st, whole, y = stage_ms(
        [("gather", lambda v: v[kern.elem_dofs].reshape(Ep, 3, 1)),
         ("bmm", lambda ue: torch.bmm(kern.Ke, ue)),
         ("B", lambda fe: kern.plan(fe.reshape(Rp, 1)))], lap_inputs)
    if not torch.equal(y.reshape(-1), big.L(lap_inputs[-1])):
        raise RuntimeError("15g: the staged Laplacian apply differs from "
                           "the operator's")
    stages = dict(
        st, whole_ms=whole, apply_ms=median_apply_ms(big.L, lap_inputs),
        gather_bound_ms=(Ep * 3 * 8 + Ep * 3 * 8 + Np * 8)
        / HBM_BYTES_PER_S * 1e3,
        bmm_bound_ms=(Ep * 9 * 8 + 2 * Ep * 3 * 8) / HBM_BYTES_PER_S * 1e3)
    log(f"15g Laplacian apply by stages (grid_tri({POISSON_P1_SIZES[-1]}) "
        f"P1, events, warm L2): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in stages.items()))
    return stages


# ---------------------------------------------------------------------------
# Phase 16: the unstructured multigrid, deformed configurations and cells
# ---------------------------------------------------------------------------

AMG_N = 36                    # the bench mesh, perturbed for 16c
AMG_CONTRAST = 1e4            # tests/test_amg.py:17-34's field
JACOBI_CAP = 500              # maxiter of each Jacobi inner solve at 1e4
DEFORM_SHEAR = ((1.0, 0.2, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
# rotations that map the discrete cells onto themselves, so that the
# transform_version form (the base material rotated; isotropic, so unchanged)
# must give transform(Ch, R) too: the cyclic permutation of the axes (120
# degrees about (1, 1, 1)) keeps the Kuhn grid's diagonal; 90 degrees keeps
# grid_tri's alternating diagonals on an even grid
ROT_3D = ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
ROT_2D = ((0.0, -1.0), (1.0, 0.0))
AMG_PATH = ("gather_rows", "segment_sum_rows", "element_stiffness")
# the homogeneous sheared cells: w = 0 solves their cell problems, whose
# loads are rounding noise that CG must resolve in every mode, so they are
# kept small (the EBE path: kernel B in float64)
HOMOGENEOUS_3D_N = 8
HOMOGENEOUS_2D_N = 16


def perturbed_clamped(n, device, contrast=None):
    """grid_tet(n) P2 with its interior vertices moved by up to 0.15 of a
    cell (seeded; it fails ``validate_kuhn_grid``), clamped and loaded as
    ``clamped_problem``; with ``contrast`` the field of
    ``tests/test_amg.py:17-34`` (E = 200 above z = 0.5, 200 / contrast
    below)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           MaterialField)

    V, T = generators.grid_tet(n, n, n)
    V = V.copy()
    interior = ((V > 1e-9) & (V < 1 - 1e-9)).all(axis=1)
    rng = np.random.default_rng(16)
    V[interior] += (0.15 / n) * rng.uniform(-1, 1, (interior.sum(), 3))
    mesh = FEMMesh(V, T, degree=2)
    if contrast is None:
        mat = Material.isotropic(3, 200.0, 0.3)
    else:
        E_el = np.where(V[T].mean(axis=1)[:, 2] > 0.5, 200.0,
                        200.0 / contrast)
        mat = MaterialField.isotropic_field(3, E_el, np.full(len(E_el), 0.3))
    sim = ElasticitySimulator(mesh, mat, device=device)
    X = mesh.node_positions
    sim.fix_nodes(np.flatnonzero(X[:, 0] < 1e-9))
    load = np.zeros((mesh.num_nodes, 3))
    load[X[:, 0] > X[:, 0].max() - 1e-9, 1] = -1.0
    sim.neumann_load = torch.as_tensor(load, device=sim.device)
    return sim


def amg_solve(sim, label, required=AMG_PATH, **kw):
    """One counted ``sim.solve(operator="routed", precond="amg")`` with the
    operator and the hierarchy built anew (inside the count); returns (u,
    CGResult, seconds, counts, the hierarchy)."""
    sim._routed, sim._amg = None, None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        (u, res), wall, counts = counted(label, lambda: sim.solve(
            operator="routed", precond="amg", **kw), required)
    mg = sim._amg[1]
    log(f"{label}: {wall:.3f} s with the build, {res.rounds} rounds "
        f"{[h[1] for h in res.history]}, {res.iters} inner MG-PCG "
        f"iterations, relres {res.resnorm:.3e}; hierarchy "
        f"{amg_levels(mg)} unknowns; build " + ", ".join(
            f"{k} {v:.3f}" for k, v in mg.timings.items())
        + f"; launches {counts}")
    return u, res, wall, counts, mg


def amg_levels(mg):
    """Unknowns per level: P2, P1, each aggregation level (the last one the
    dense coarsest)."""
    return [3 * mg.Nf, 3 * mg.NC] + [6 * lv.n_agg for lv in mg.levels]


def vcycle_symmetry(mg, gen, label):
    """16b: two random free vectors x, y (internal order): |<y, M x> - <x,
    M y>| <= 1e-4 max(|<y, M x>|, |<x, M y>|) and <x, M x> > 0 (the
    reference's criteria, ``tests/test_amg.py:37-53``); the first V-cycle
    counted: every routed apply launched A and B once in rows and every
    transfer (P2 <-> P1 and each aggregation level) one more A or B, so A
    and B each launch (applies + 1 + levels) times."""
    Nf = mg.Nf
    x = torch.randn((Nf, 3), generator=gen, device=gen.device) * mg.free_f
    y = torch.randn((Nf, 3), generator=gen, device=gen.device) * mg.free_f
    with ApplyCounter() as applies:
        Mx, _, counts = counted(label, lambda: mg.precondition(x),
                                ("gather_rows", "segment_sum_rows"))
    My = mg.precondition(y)
    a = float(torch.vdot(y.reshape(-1), Mx.reshape(-1)))
    b = float(torch.vdot(x.reshape(-1), My.reshape(-1)))
    xMx = float(torch.vdot(x.reshape(-1), Mx.reshape(-1)))
    asym = abs(a - b) / max(abs(a), abs(b))
    expect = applies.count + 1 + len(mg.levels)
    log(f"{label}: <y, Mx> {a:.9e}, <x, My> {b:.9e}, asymmetry {asym:.3e}, "
        f"<x, Mx> {xMx:.6e}; {applies.count} routed applies, gather_rows "
        f"{counts['gather_rows']}, segment_sum_rows "
        f"{counts['segment_sum_rows']} (expected {expect} each)")
    if not (asym <= 1e-4 and xMx > 0):
        raise RuntimeError(f"{label}: the V-cycle is not symmetric positive")
    if not (counts["gather_rows"] == expect
            and counts["segment_sum_rows"] == expect
            and counts["segment_sum_rows/f64"] == 0
            and counts["gather_planes"] == counts["segment_sum_csr"] == 0):
        raise RuntimeError(f"{label}: a transfer or apply did not run on "
                           f"kernels A and B in rows")
    return dict(asymmetry=asym, xMx=xMx, routed_applies=applies.count), \
        counts


def drive_amg(dev, sim, u_routed, gen):
    """16a-c; returns (summary, launch counts per path, the bench
    hierarchy)."""
    from meshfem_tpu_torch.ops.structured import validate_kuhn_grid

    out, paths = {}, {}
    t_phase = time.time()
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("16: TF32 is on; the V-cycle needs full float32")
    # 16a: the clamped bench problem through AMG
    u, res, wall, paths["16a_amg"], mg = amg_solve(sim, "16a AMG (bench)",
                                                   tol=1e-10)
    relres = check_solution(sim, u, "16a AMG (bench)")
    du = float((u - u_routed).abs().max() / u_routed.abs().max())
    log(f"16a: u against phase 4's routed u {du:.3e} of max|u|")
    if not du <= 1e-6:
        raise RuntimeError(f"16a: AMG and routed solutions differ ({du})")
    torch.cuda.synchronize()
    t0 = time.time()
    _, res2 = sim.solve(operator="routed", precond="amg", tol=1e-10)
    torch.cuda.synchronize()
    solve_s = time.time() - t0
    vin = [torch.randn((mg.Nf, 3), generator=gen, device=dev) * mg.free_f
           for _ in range(5)]
    vcycle_ms = median_apply_ms(mg.precondition, vin)
    out["bench"] = dict(
        levels=amg_levels(mg), build=mg.timings, first_solve_s=wall,
        solve_s=solve_s, rounds=res2.rounds, inner_iters=res2.iters,
        round_iters=[h[1] for h in res2.history], relres=relres,
        inner_iter_ms=solve_s / max(res2.iters, 1) * 1e3,
        vcycle_ms=vcycle_ms, vs_routed=du)
    log(f"16a: solve with the hierarchy cached {solve_s:.3f} s, "
        f"{res2.rounds} rounds, {res2.iters} inner iterations, "
        f"{out['bench']['inner_iter_ms']:.3f} ms an inner iteration (host "
        f"clock); one V-cycle {vcycle_ms:.4f} ms (events, median of "
        f"{len(vin)})")
    # 16b: the V-cycle's symmetry at bench size
    out["symmetry"], paths["16b_vcycle"] = vcycle_symmetry(
        mg, gen, "16b V-cycle (bench)")
    # 16c: the unstructured case, AMG beside Jacobi
    psim = perturbed_clamped(AMG_N, dev)
    try:
        validate_kuhn_grid(psim.mesh)
        raise RuntimeError("16c: the perturbed mesh passed the Kuhn-grid "
                           "validation")
    except ValueError:
        pass
    up, res_a, wall_a, paths["16c_amg"], mg_p = amg_solve(
        psim, "16c AMG (perturbed)", tol=1e-10)
    check_solution(psim, up, "16c AMG (perturbed)")
    psim._routed = None
    (uj, res_j), wall_j, paths["16c_jacobi"] = counted(
        "16c Jacobi (perturbed)", lambda: psim.solve(
            operator="routed", precond="jacobi", tol=1e-10), AMG_PATH)
    check_solution(psim, uj, "16c Jacobi (perturbed)")
    dj = float((up - uj).abs().max() / uj.abs().max())
    log(f"16c perturbed grid_tet({AMG_N}): AMG {wall_a:.3f} s (build "
        f"{mg_p.timings['total_s']:.3f}), {res_a.iters} inner iterations; "
        f"Jacobi {wall_j:.3f} s, {res_j.iters}; u AMG vs Jacobi {dj:.3e} "
        f"of max")
    if not dj <= 1e-6:
        raise RuntimeError(f"16c: AMG and Jacobi solutions differ ({dj})")
    out["perturbed"] = dict(
        amg=dict(s=wall_a, build_s=mg_p.timings["total_s"],
                 rounds=res_a.rounds, inner_iters=res_a.iters,
                 levels=amg_levels(mg_p)),
        jacobi=dict(s=wall_j, rounds=res_j.rounds, inner_iters=res_j.iters),
        amg_vs_jacobi=dj)
    del mg_p
    csim = perturbed_clamped(AMG_N, dev, contrast=AMG_CONTRAST)
    uc, res_c, wall_c, paths["16c_contrast_amg"], mg_c = amg_solve(
        csim, f"16c AMG (perturbed, {AMG_CONTRAST:g} contrast)", tol=1e-10,
        required=("gather_rows", "segment_sum_rows"))
    relres_c = check_solution(csim, uc, "16c AMG (contrast)")
    csim._routed = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        (ucj, res_cj), wall_cj, paths["16c_contrast_jacobi"] = counted(
            "16c Jacobi (contrast)", lambda: csim.solve(
                operator="routed", precond="jacobi", tol=1e-10,
                maxiter=JACOBI_CAP), ("gather_rows", "segment_sum_rows"))
    log(f"16c {AMG_CONTRAST:g} contrast: AMG {wall_c:.3f} s, {res_c.rounds} "
        f"rounds, {res_c.iters} inner iterations, relres {relres_c:.3e}; "
        f"Jacobi capped at {JACOBI_CAP} an inner solve stopped after "
        f"{res_cj.rounds} rounds, {res_cj.iters} iterations, {wall_cj:.3f} "
        f"s, at relres {res_cj.resnorm:.3e}")
    out["contrast"] = dict(
        amg=dict(s=wall_c, rounds=res_c.rounds, inner_iters=res_c.iters,
                 relres=relres_c, levels=amg_levels(mg_c)),
        jacobi_capped=dict(maxiter=JACOBI_CAP, s=wall_cj,
                           rounds=res_cj.rounds, inner_iters=res_cj.iters,
                           relres=res_cj.resnorm))
    del psim, csim, mg_c, uc, ucj
    out["phase_s"] = time.time() - t_phase
    log(f"16a-c: {out['phase_s']:.1f} s")
    return out, paths, mg


def deformed_gates(label, mesh, mat, Ch_plain, rot, shear, homogeneous,
                   dev, paths, gate=1e-7, sheared_cell=True):
    """16d on one cell: ``homogenize_deformed`` under the identity (against
    ``Ch_plain``), a rotation ``rot`` warped and in ``transform_version``
    form (against ``transform(Ch_plain, rot)``), each to ``gate`` of
    max|Ch|; the ``homogeneous`` cell (no void) under ``shear`` gives D
    (1e-8); with ``sheared_cell`` the cell under ``shear`` printed.  Each
    run counted."""
    from meshfem_tpu_torch.analysis.deformed_cells import homogenize_deformed
    from meshfem_tpu_torch.fem import elasticity_tensor as et

    out, res = {}, {}
    dim = mesh.dim
    Rt = torch.as_tensor(np.asarray(rot))
    Sm = np.asarray(shear)[:dim, :dim]
    expect_R = et.transform(Ch_plain.cpu(), Rt)
    runs = (("identity", mesh, np.eye(dim), False, Ch_plain.cpu()),
            ("rotation", mesh, Rt.numpy(), False, expect_R),
            ("rotation_transform_version", mesh, Rt.numpy(), True, expect_R),
            ("homogeneous_shear", homogeneous, Sm, False, mat.D),
            ("shear", mesh, Sm, False, None))[:5 if sheared_cell else 4]
    for name, m, J, tv, expect in runs:
        required = ("segment_sum_rows",) if m is homogeneous else AMG_PATH
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            r, wall, paths[f"16d_{label}_{name}"] = counted(
                f"16d {label} {name}", lambda: homogenize_deformed(
                    m, mat, J, transform_version=tv, tol=1e-10), required)
        err = None if expect is None else rel_err(r.Ch, expect)
        log(f"16d {label} {name}: {wall:.3f} s, block CG iterations "
            f"{r.cg_iters[0]}, Ch {np.round(r.Ch.cpu().numpy(), 6).tolist()}"
            + ("" if err is None else f"; {err:.3e} of max|Ch| from the "
               f"expected tensor"))
        g = 1e-8 if name == "homogeneous_shear" else gate
        if err is not None and not err <= g:
            raise RuntimeError(f"16d {label} {name}: {err:.3e} > {g:g}")
        out[name] = dict(s=wall, iters=r.cg_iters[0], err=err,
                         Ch=r.Ch.cpu().tolist())
        res[name] = r
    return out, res


def drive_deformed(dev, cell, hsim, Ch_cell, Ch_tri):
    """16d-f; returns (summary, launch counts per path, the sheared cell's
    simulator for 16g)."""
    import contextlib
    import io
    import tempfile

    from meshfem_tpu_torch.analysis import deformed_cells as dc
    from meshfem_tpu_torch.cli import deformed_cells as cli_dc
    from meshfem_tpu_torch.cli import homogenize as cli_h
    from meshfem_tpu_torch.io import meshio
    from meshfem_tpu_torch.mesh import FEMMesh, generators, periodic
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    out, paths = {}, {}
    t_phase = time.time()
    mat = Material.isotropic(3, 200.0, 0.3)
    n = HOMOGENEOUS_3D_N
    full = FEMMesh(*generators.grid_tet(n, n, n), degree=2)
    out["cell_3d"], res3 = deformed_gates(
        "void cell", cell, mat, Ch_cell, ROT_3D, DEFORM_SHEAR, full, dev,
        paths)
    del full
    # the energy form (w Ke w, exact for P2) at the sheared positions with
    # the sheared cell's w is its stress-form Ch (det = 1, so |Y| is the
    # bounding box's); the reference's centroid-strain form misses by ~2e-2
    Xs = cell.node_positions @ np.asarray(DEFORM_SHEAR).T
    Eh_s = dc.homogenized_tensor_at(hsim, res3["shear"].w, node_positions=Xs)
    err_eh = rel_err(Eh_s, res3["shear"].Ch)
    log(f"16d void cell shear: the energy form at the sheared positions "
        f"against the stress-form Ch {err_eh:.3e} of max|Ch| "
        f"({cell.num_elements} P2 tets)")
    if not err_eh <= 1e-8:
        raise RuntimeError(f"16d: the energy form misses the stress form on "
                           f"the sheared P2 cell ({err_eh:.3e})")
    out["energy_form_vs_stress_form"] = err_eh
    tri = FEMMesh(*tri_void_cell(TRI_CELL_N), degree=2)
    n = HOMOGENEOUS_2D_N
    full2 = FEMMesh(*generators.grid_tri(n, n), degree=2)
    out["cell_2d"], _ = deformed_gates(
        "triangle cell", tri, Material.isotropic(2, E_2D, NU_2D),
        torch.as_tensor(Ch_tri, dtype=torch.float64), ROT_2D, DEFORM_SHEAR,
        full2, dev, paths, sheared_cell=False)
    del tri, full2

    # 16e: the shape gradient at full width, against a central difference
    w = res3["identity"].w
    Wg = torch.randn((6, 6), generator=torch.Generator().manual_seed(16),
                     dtype=torch.float64)
    Wg = (Wg + Wg.t()).numpy()
    torch.cuda.synchronize()
    t0 = time.time()
    g = dc.homogenized_tensor_shape_gradient(hsim, w, Wg)
    torch.cuda.synchronize()
    t_grad = time.time() - t0
    X0 = torch.as_tensor(cell.node_positions, device=dev)
    v = torch.randn(X0.shape, generator=torch.Generator(device=dev)
                    .manual_seed(16), device=dev, dtype=torch.float64)
    Wt = torch.as_tensor(Wg, device=dev)
    J = lambda X: float((Wt * dc._energy_form_tensor(cell, hsim.D, w, X))
                        .sum())
    eps = 1e-6
    fd = (J(X0 + eps * v) - J(X0 - eps * v)) / (2 * eps)
    gv = float((g * v).sum())
    fd_err = abs(fd - gv) / abs(fd)
    log(f"16e shape gradient ({cell.num_nodes} nodes): {t_grad:.3f} s; "
        f"along a random direction {gv:.9e}, central difference (eps "
        f"{eps:g}) {fd:.9e}, {fd_err:.3e} relative")
    if not fd_err <= 1e-5:
        raise RuntimeError(f"16e: the shape gradient misses its central "
                           f"difference ({fd_err:.3e})")
    # the corner gather is a GatherPlan: its backward is kernel B, so two
    # gradients agree to the bit and no library scatter runs
    g2 = dc.homogenized_tensor_shape_gradient(hsim, w, Wg)
    bitwise = bool(torch.equal(g, g2))
    ops, kern = profile_kernels(
        lambda: dc.homogenized_tensor_shape_gradient(hsim, w, Wg))
    bad = sorted({n for n in ops + kern
                  if any(s in n for s in LIBRARY_SCATTERS)})
    log(f"16e shape gradient twice equal to the bit: {bitwise}; under "
        f"torch.profiler {len(ops)} operator events, {len(kern)} device "
        f"kernels, library scatters {bad}")
    if not bitwise or bad or not kern:
        raise RuntimeError(f"16e: the shape gradient is not repeatable or "
                           f"ran a library scatter: {bad}")
    del g2
    out["shape_gradient"] = dict(s=t_grad, along_v=gv, central_difference=fd,
                                 rel_err=fd_err, bitwise=bitwise,
                                 profile=dict(ops=len(ops), kernels=len(kern),
                                              scatters=bad))

    # 16f: the Homogenize and DeformedCells CLIs on the card
    with tempfile.TemporaryDirectory() as tmp:
        meshio.save_msh(f"{tmp}/cell.msh", cell.V, cell.F)
        with open(f"{tmp}/base.material", "w") as f:
            json.dump({"type": "isotropic_material", "dim": 3,
                       "young": 200.0, "poisson": 0.3}, f)
        args = [f"{tmp}/cell.msh", "-m", f"{tmp}/base.material",
                "--tol", "1e-10", "--device", str(dev)]

        def run_cli(main, argv, stdin=None):
            buf = io.StringIO()
            saved = sys.stdin
            if stdin is not None:
                sys.stdin = io.StringIO(stdin)
            try:
                with contextlib.redirect_stdout(buf):
                    main(argv)
            finally:
                sys.stdin = saved
            return buf.getvalue()

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            text_h, t_h, paths["16f_cli_homogenize"] = counted(
                "16f cli.homogenize", lambda: run_cli(
                    cli_h.main, args + ["-o", f"{tmp}/w.msh"]), AMG_PATH)
            S = np.asarray(DEFORM_SHEAR)
            text_j, t_j, paths["16f_cli_deformed_jacobian"] = counted(
                "16f cli.deformed_cells --jacobian", lambda: run_cli(
                    cli_dc.main, args + ["--jacobian"]
                    + [repr(float(x)) for x in S.ravel()]), AMG_PATH)
            stdin = "\n".join(" ".join(repr(float(x)) for x in np.ravel(J))
                              for J in (np.eye(3), ROT_3D)) + "\n"
            text_p, t_p, paths["16f_cli_deformed_parametrized"] = counted(
                "16f cli.deformed_cells --parametrizedTransform",
                lambda: run_cli(cli_dc.main,
                                args + ["--parametrizedTransform"], stdin),
                AMG_PATH)
        out_w = os.path.getsize(f"{tmp}/w.msh")
    rows = [[float(x) for x in line.split()]
            for line in text_h.splitlines()[1:7]]
    ch_lines = [[float(x) for x in line.split()[1:]]
                for line in (text_j + text_p).splitlines()
                if line.startswith("Ch:")]
    iu = np.triu_indices(6)
    errs = dict(
        homogenize=rel_err(torch.as_tensor(rows), Ch_cell),
        jacobian_shear=rel_err(torch.as_tensor(ch_lines[0]),
                               res3["shear"].Ch.cpu()[iu]),
        parametrized_identity=rel_err(torch.as_tensor(ch_lines[1]),
                                      res3["identity"].Ch.cpu()[iu]),
        parametrized_rotation=rel_err(torch.as_tensor(ch_lines[2]),
                                      res3["rotation"].Ch.cpu()[iu]))
    log(f"16f CLIs: homogenize {t_h:.3f} s (-o wrote {out_w} bytes), "
        f"deformed_cells --jacobian {t_j:.3f} s, --parametrizedTransform "
        f"(2 jacobians) {t_p:.3f} s; printed Ch against 16d / phase 7: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    # the printed digits: 6 significant for homogenize, 8 for the rest
    if not (errs["homogenize"] <= 1e-5 and max(
            v for k, v in errs.items() if k != "homogenize") <= 1e-7):
        raise RuntimeError(f"16f: a CLI's printed Ch differs: {errs}")
    out["clis"] = dict(homogenize_s=t_h, jacobian_s=t_j,
                       parametrized_s=t_p, msh_bytes=out_w, errs=errs)

    # the sheared void cell's simulator (node_positions), for 16g
    dof_map, _, _ = periodic.match_periodic_nodes(cell.node_positions,
                                                  cell.bbox())
    dsim = ElasticitySimulator(cell, mat, device=dev, dof_map=dof_map,
                               node_positions=cell.node_positions
                               @ np.asarray(DEFORM_SHEAR).T)
    out["phase_s"] = time.time() - t_phase
    log(f"16d-f: {out['phase_s']:.1f} s")
    return out, paths, dsim


def kernels_amg(dev, entry, sim, mg, paths, dsim, gen):
    """16g: kernels A and B on the AMG plans (the P2 <-> P1 transfers, the
    aggregation restriction and prolongation, the float64 row sums) held
    bit for bit against their plain versions (B also against B in planes
    and the CPU's plain sum), and E on the deformed cell's geometry to one
    float32 ulp of the float64 Ke; each timed with ``entry``."""
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.ops import element_matrices as em

    out = {}
    main = paths["16a_amg"]
    Nf, NC = mg.Nf, mg.NC
    # A: the P1 -> P2 prolongation (2 Nf endpoint ids, 3 values a row)
    src_c = torch.randn((NC, 3), generator=gen, device=dev)
    ab = mg.ids_ab
    if not torch.equal(kernels.gather_rows(src_c, ab),
                       kernels.gather_rows_plain(src_c, ab)):
        raise RuntimeError("16g: gather_rows on the prolongation != plain")
    ab_long = ab.long()
    entry("gather_rows/amg_prolong", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139 (here the P1 -> P2 prolongation, "
          "plan_copy at meshfem_tpu/solvers/amg.py:303)",
          own_mode(main, "gather_rows"), 0.0,
          lambda: kernels.gather_rows(src_c, ab),
          lambda: kernels.gather_rows_plain(src_c, ab),
          lambda: torch.index_select(src_c, 0, ab_long),
          2 * Nf * 4 + NC * 3 * 4 + 2 * Nf * 3 * 4, 0,
          mode="rows [NC, 3] -> [2 Nf, 3], as UnstructuredMG._prolong_f "
               "runs it", launches_path="16a AMG solve, float32 launches",
          library_call="torch.index_select",
          shape=f"src [{NC}, 3] f32, ids_ab [{2 * Nf}] int32")
    # B: the P2 -> P1 restriction (2 Nf halves into NC rows)
    pr = mg.plan_r
    err_r = check_rows_on_plan(pr, torch.float32, "16g B restriction", gen)
    half = torch.randn((Nf, 3), generator=gen, device=dev)
    acc_c = torch.zeros((NC, 3), device=dev)
    seg_r = torch.cat([ab_long[:Nf], ab_long[Nf:]])
    half2 = torch.cat([half, half])
    entry("segment_sum_rows/amg_restrict",
          "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (here the P2 -> P1 restriction, "
          "plan_reduce at meshfem_tpu/solvers/amg.py:304)",
          own_mode(main, "segment_sum_rows"), err_r,
          lambda: pr.sum_rows(half),
          lambda: kernels.segment_sum_rows_plain(half, pr.perm, pr.offsets),
          lambda: acc_c.index_add_(0, seg_r, half2),
          Nf * 3 * 4 + 2 * Nf * 4 + (NC + 1) * 4 + NC * 3 * 4, 2 * Nf * 3,
          mode="rows [Nf, 3] read twice (2 Nf halves) -> [NC, 3], as "
               "UnstructuredMG._restrict_f runs it",
          launches_path="16a AMG solve, float32 launches",
          library_call="Tensor.index_add_ (float atomics, not "
                       "deterministic)",
          shape=f"src [{Nf}, 3] f32, perm [{2 * Nf}] -> [{NC}, 3]")
    # the aggregation level: B restriction and A prolongation, 6 values
    lv = mg.levels[0]
    n_units, n_agg = lv.agg_of.shape[0], lv.n_agg
    err_a6 = check_rows_on_plan(lv.plan, torch.float32,
                                "16g B aggregation restriction", gen, P=6)
    con = torch.randn((n_units, 6), generator=gen, device=dev)
    acc_a = torch.zeros((n_agg, 6), device=dev)
    agg_long = lv.agg_of.long()
    entry("segment_sum_rows/agg/6", "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (here AggLevel.restrict, "
          "jax.ops.segment_sum at meshfem_tpu/solvers/amg.py:83)",
          own_mode(main, "segment_sum_rows"), err_a6,
          lambda: lv.plan.sum_rows(con),
          lambda: kernels.segment_sum_rows_plain(con, lv.plan.perm,
                                                 lv.plan.offsets),
          lambda: acc_a.index_add_(0, agg_long, con),
          n_units * 6 * 4 + n_units * 4 + (n_agg + 1) * 4 + n_agg * 6 * 4,
          n_units * 6,
          mode="rows [units, 6] -> [aggregates, 6], as AggLevel.restrict "
               "runs it", launches_path="16a AMG solve, float32 launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{n_units}, 6] f32 -> [{n_agg}, 6]")
    src_a = torch.randn((n_agg, 6), generator=gen, device=dev)
    if not torch.equal(kernels.gather_rows(src_a, lv.agg_of),
                       kernels.gather_rows_plain(src_a, lv.agg_of)):
        raise RuntimeError("16g: gather_rows on the aggregate ids != plain")
    entry("gather_rows/agg/6", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139 (here AggLevel.prolong, an XLA "
          "gather at meshfem_tpu/solvers/amg.py:89)",
          own_mode(main, "gather_rows"), 0.0,
          lambda: kernels.gather_rows(src_a, lv.agg_of),
          lambda: kernels.gather_rows_plain(src_a, lv.agg_of),
          lambda: torch.index_select(src_a, 0, agg_long),
          n_units * 4 + n_agg * 6 * 4 + n_units * 6 * 4, 0,
          mode="rows [aggregates, 6] -> [units, 6], as AggLevel.prolong "
               "runs it", launches_path="16a AMG solve, float32 launches",
          library_call="torch.index_select",
          shape=f"src [{n_agg}, 6] f32, agg_of [{n_units}] int32")
    # B float64: the P2 Gershgorin row sums on the EBE plan
    plan64 = sim._kernel.plan
    err_64 = check_rows_on_plan(plan64, torch.float64,
                                "16g B f64 row sums", gen)
    Keabs = sim.Ke.abs().sum(dim=2).reshape(-1, 3).contiguous()
    R64, N64 = plan64.num_rows, plan64.num_segments
    dst = sim._kernel.elem_dofs.reshape(-1)
    acc64 = torch.zeros((N64, 3), device=dev, dtype=torch.float64)
    entry("segment_sum_rows/f64/rowsums",
          "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (f64; here the P2 Gershgorin row "
          "sums, jax.ops.segment_sum at meshfem_tpu/solvers/amg.py:378)",
          own_mode(main, "segment_sum_rows/f64"), err_64,
          lambda: plan64.sum_rows(Keabs),
          lambda: kernels.segment_sum_rows_plain(Keabs, plan64.perm,
                                                 plan64.offsets),
          lambda: acc64.index_add_(0, dst, Keabs),
          3 * R64 * 8 + R64 * 4 + (N64 + 1) * 4 + 3 * N64 * 8, 3 * R64,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [E n, 3] |Ke| row sums -> [N, 3]",
          launches_path="16a AMG solve, float64 launches (the row sums and "
                        "the EBE residuals)",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{R64}, 3] f64 -> [{N64}, 3]")
    del Keabs
    # E on the sheared void cell (node_positions): one float32 ulp of the
    # float64 Ke of its own (float32) inputs, and near the simulator's
    # float64 Ke, whose gradients float32 cannot hold exactly once sheared
    g32 = dsim.geom.grad_lambda.float().contiguous()
    v32 = dsim.geom.volume.float().contiguous()
    D_host = dsim.D.cpu()
    Ke32 = kernels.element_stiffness(g32, v32, D_host, 2)
    e_ref = kernels.element_stiffness_plain(g32, v32, D_host, 2)
    scale = float(dsim.Ke.abs().max())
    err_e = float((Ke32 - e_ref).abs().max())
    err_sim = float((Ke32.double() - dsim.Ke).abs().max())
    del e_ref
    ulps = ulps_from(Ke32, em.element_elasticity_fused(
        g32.double(), v32.double(), dsim.D, 2))
    del Ke32
    log(f"16g E on the sheared void cell ({dsim.mesh.num_elements} tets, "
        f"node_positions): max abs err {err_e:.3e} against plain, "
        f"{err_sim:.3e} against the simulator's f64 Ke (max|Ke| "
        f"{scale:.3e}); {ulps:.3f} ulp of each entry from the f64 Ke of "
        f"the same float32 inputs")
    if not (err_e <= 1e-5 * scale and err_sim <= 1e-5 * scale
            and ulps <= 1.0):
        raise RuntimeError("16g: element_stiffness on the deformed cell "
                           "disagrees")
    Ed = g32.shape[0]
    deformed_runs = [c for p, c in paths.items()
                     if p.startswith("16d_void cell")]
    M32 = torch.as_tensor(em.fused_matrix_for(dsim.D, 3, 2),
                          dtype=torch.float32, device=dev)
    entry("element_stiffness/deformed",
          "meshfem_tpu_torch/csrc/element_stiffness.cu",
          "meshfem_tpu/kernels/element_stiffness.py:42",
          sum(c["element_stiffness"] for c in deformed_runs), err_e,
          lambda: kernels.element_stiffness(g32, v32, D_host, 2),
          lambda: kernels.element_stiffness_plain(g32, v32, D_host, 2),
          lambda: em.element_elasticity_fused_apply(g32, v32, M32, 10),
          (12 + 1 + 900) * Ed * 4 + 36 * 8,
          (2 * (144 * 9 + 900 * 16) + 900) * Ed,
          algorithm_flops=(2 * (10 * (9 + 81) + 900 * 16) + 900) * Ed,
          algorithm_flop_rate=F64_FLOP_PER_S,
          mode="f32 Ke [E, 30, 30] at the sheared positions, as "
               "ElasticitySimulator(node_positions=...)._routed_Ke runs it",
          max_ulps_vs_f64=ulps, max_abs_err_vs_simulator_f64=err_sim,
          launches_path="16d void-cell runs (one a dense operator build)",
          library_call="ops.element_matrices.element_elasticity_fused_apply "
                       "(einsum + torch.matmul, TF32 off)",
          shape=f"grad_lambda [{Ed}, 4, 3] f32, vol [{Ed}] f32")
    out.update(restrict_err=err_r, agg_err=err_a6, rowsum_err=err_64,
               deformed_E_err=err_e, deformed_E_vs_simulator=err_sim,
               deformed_E_ulps=ulps)
    return out


# ---------------------------------------------------------------------------
# Phase 17: vibrational modes, the implicit-function solve, material
# optimization, differentiable_displacement, nonlinear energies and Newton
# ---------------------------------------------------------------------------

MODES_NU = 0.35               # examples/vibrational_modes.py's material
MODES_ITERS = 20              # LOBPCG iterations at bench size (a fixed count:
#                               the reference's 3D LOBPCG stalls above 1e-7)
MODES_SMALL_ITERS = 15        # 17b, card against CPU
MO_STEPS = 3                  # 17c Adam steps at bench size
MO_FD_N = 6                   # 17c finite-difference gate's grid_tet(n) P2
MO_CPU_N = 4                  # 17c card against CPU
MO_PROFILE_N = 2              # 17c the profiled step's grid_tet(n) P2
TOPOPT17_SHAPE = (64, 32, 32)  # 17d, 12d's grid
NEWTON_N = 16                 # 17e: the bar grid_tet(2n, n, n) P1
NEWTON_CPU_N = 3              # 17e card against CPU
CLI_MO_N = 6                  # 17f: grid_tet(n) P1 for cli.material_opt
PHASE17_PATH = ("gather_rows", "segment_sum_rows")


def m_projector_gap(X, Y, M):
    """max |P_X - P_Y| of the M-orthogonal projectors onto the spans of the
    host blocks X and Y ([n, k]), M a host (scipy) matrix."""
    def P(Z):
        MZ = M @ Z
        return Z @ np.linalg.solve(Z.T @ MZ, MZ.T)

    return float(np.abs(P(X) - P(Y)).max())


def modes_bench(dev, gen):
    """17a: ``compute_vibrational_modes`` on the bench mesh (with the
    clamp's x = 0 face as ``fixed_mask``, then the free body), counted;
    then the K and M applies timed by stage at 6 and 18 columns."""
    from meshfem_tpu_torch.analysis import modes
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.ops import operators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material

    out, paths = {}, {}
    V, T = generators.grid_tet(BENCH_N, BENCH_N, BENCH_N)
    mesh = FEMMesh(V, T, degree=2)
    t0 = time.time()
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 200.0, MODES_NU),
                              device=dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.time() - t0
    X = mesh.node_positions
    fixed = np.zeros((sim.num_dofs, 3), bool)
    fixed[X[:, 0] < 1e-9] = True
    for label, mask in (("clamped", fixed), ("free", None)):
        hist = []
        (lam, Xm), wall, paths[f"17a_modes_{label}"] = counted(
            f"17a modes ({label})", lambda: modes.compute_vibrational_modes(
                sim, n_modes=6, maxiter=MODES_ITERS, fixed_mask=mask,
                history=hist), required=("segment_sum_rows",))
        if not (Xm.shape == (mesh.num_nodes, 3, 6)
                and bool(torch.isfinite(Xm).all())
                and np.all(np.isfinite(lam)) and np.all(lam > 0)
                and np.all(np.diff(lam) >= 0)):
            raise RuntimeError(f"17a modes ({label}): bad output")
        c = paths[f"17a_modes_{label}"]
        out[label] = dict(seconds=wall, iterations=len(hist),
                          ms_per_iteration=wall / len(hist) * 1e3,
                          eigenvalues=lam.tolist(),
                          residual_history=[h.tolist() for h in hist],
                          launches_b_f64=c["segment_sum_rows/f64"])
        log(f"17a modes ({label}) grid_tet({BENCH_N}) P2, "
            f"{3 * sim.num_dofs} dofs: {wall:.3f} s, {len(hist)} LOBPCG "
            f"iterations, {wall / len(hist) * 1e3:.2f} ms an iteration "
            f"(host clock); eigenvalues {lam.tolist()}; relative residuals "
            f"first {hist[0].tolist()} last {hist[-1].tolist()}; B f64 "
            f"launches {c['segment_sum_rows/f64']}")
    # the K and M applies by stage (events, warm L2)
    Mv = operators.mass_elasticity(mesh, device=dev)
    stages = {}
    for name, kern in (("K", sim._kernel), ("M", Mv._kernel)):
        E, nd, _ = kern.Ke.shape
        R = kern.plan.num_rows
        for m in (6, 18):
            ins = [torch.randn((sim.num_dofs, 3, m), generator=gen,
                               device=dev, dtype=torch.float64)
                   for _ in range(5)]
            st, whole, y = stage_ms(
                [("gather", lambda u: u[kern.elem_dofs].reshape(E, nd, m)),
                 ("bmm", lambda ue: torch.bmm(kern.Ke, ue)),
                 ("B", lambda fe: kern.plan(fe.reshape(R, 3 * m)))], ins)
            if not torch.equal(y.reshape(ins[-1].shape), kern(ins[-1])):
                raise RuntimeError("17a: the staged apply differs from the "
                                   "operator's")
            ue_bytes = E * nd * m * 8
            stages[f"{name}_{m}"] = dict(
                st, whole_ms=whole, apply_ms=median_apply_ms(kern, ins),
                gather_bound_ms=(sim.num_dofs * 3 * m * 8
                                 + kern.elem_dofs.numel() * 8 + ue_bytes)
                / HBM_BYTES_PER_S * 1e3,
                ke_floor_ms=kern.Ke.numel() * 8 / HBM_BYTES_PER_S * 1e3,
                bmm_bound_ms=(kern.Ke.numel() * 8 + 2 * ue_bytes)
                / HBM_BYTES_PER_S * 1e3,
                b_bound_ms=(ue_bytes + R * 4 + (sim.num_dofs + 1) * 4
                            + sim.num_dofs * 3 * m * 8)
                / HBM_BYTES_PER_S * 1e3)
            log(f"17a {name} apply at {m} columns ({3 * m} values a node "
                f"in B): " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                       stages[f"{name}_{m}"].items()))
            del ins, y
    out["stages"] = stages
    return out, paths, sim, Mv


def modes_vs_cpu(dev):
    """17b: the port on the card against the port on the CPU at a fixed
    iteration count, the host-stage branch (``compute_vibrational_modes``)
    and the device loop (scalar ``EBEKernel`` operators); then the
    reference's own 2D check on the card against scipy's shift-invert
    ``eigsh`` (rtol 1e-4)."""
    import scipy.sparse.linalg as spla

    from meshfem_tpu_torch.analysis import modes
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.ops import operators
    from meshfem_tpu_torch.physics import ElasticitySimulator, Material
    from meshfem_tpu_torch.solvers import eigen

    cpu = torch.device("cpu")
    out, paths = {}, {}
    V, T = generators.grid_tet(4, 3, 2, hi=(1.0, 0.8, 0.6))
    mesh = FEMMesh(V, T, degree=2)
    mat = Material.isotropic(3, 200.0, MODES_NU)
    res = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        sim = ElasticitySimulator(mesh, mat, device=d)
        run = lambda: modes.compute_vibrational_modes(
            sim, n_modes=6, maxiter=MODES_SMALL_ITERS)
        if where == "card":
            res[where], _, paths["17b_modes_small"] = counted(
                "17b modes (card)", run, required=("segment_sum_rows",))
        else:
            res[where] = run()
    M = operators.mass_elasticity(mesh, device=cpu).to_scipy()
    lam_gap = float(np.abs(res["card"][0] - res["cpu"][0]).max()
                    / np.abs(res["cpu"][0]).max())
    proj_gap = m_projector_gap(res["card"][1].cpu().numpy().reshape(-1, 6),
                               res["cpu"][1].numpy().reshape(-1, 6), M)
    out["host_loop"] = dict(eig_rel=lam_gap, projector_gap=proj_gap,
                            eigenvalues=res["card"][0].tolist())
    # the device loop: registered operators (the scalar Laplacian and mass)
    X0 = np.random.default_rng(17).standard_normal((mesh.num_nodes, 3))
    dl = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        K = operators.laplacian(mesh, device=d)._kernel
        Mk = operators.mass(mesh, device=d)._kernel
        if not eigen._ops_are_pytrees(K, Mk):
            raise RuntimeError("17b: EBEKernel operators did not take the "
                               "device loop")
        run = lambda: eigen.lobpcg_generalized(
            K, Mk, torch.as_tensor(X0, device=d), tol=1e-7,
            maxiter=MODES_SMALL_ITERS, deflate=np.ones((mesh.num_nodes, 1)))
        if where == "card":
            dl[where], _, paths["17b_device_loop"] = counted(
                "17b device loop (card)", run,
                required=("segment_sum_rows",))
        else:
            dl[where] = run()
    Ms = operators.mass(mesh, device=cpu).to_scipy()
    dl_lam = float(np.abs(dl["card"][0] - dl["cpu"][0]).max()
                   / np.abs(dl["cpu"][0]).max())
    dl_proj = m_projector_gap(dl["card"][1].cpu().numpy(),
                              dl["cpu"][1].numpy(), Ms)
    out["device_loop"] = dict(eig_rel=dl_lam, projector_gap=dl_proj,
                              eigenvalues=dl["card"][0].tolist())
    log(f"17b card against CPU, grid_tet(4, 3, 2) P2, {MODES_SMALL_ITERS} "
        f"iterations: host loop eigenvalues {lam_gap:.3e} relative, "
        f"projectors {proj_gap:.3e}; device loop eigenvalues {dl_lam:.3e}, "
        f"projectors {dl_proj:.3e}")
    if not (lam_gap <= 1e-9 and proj_gap <= 1e-7 and dl_lam <= 1e-9
            and dl_proj <= 1e-7):
        raise RuntimeError("17b: modes on the card differ from the CPU")
    # the reference test's 2D check on the card against scipy
    V2, F2 = generators.grid_tri(5, 5)
    m2 = FEMMesh(V2, F2, degree=1)
    sim2 = ElasticitySimulator(m2, Material.isotropic(2, 5.0, 0.3),
                               device=dev)
    (lam2, _), wall2, paths["17b_modes_2d"] = counted(
        "17b modes 2D", lambda: modes.compute_vibrational_modes(
            sim2, n_modes=4, tol=1e-7, maxiter=400),
        required=("segment_sum_rows",))
    w_ref = np.sort(spla.eigsh(
        sim2.to_scipy(), k=7,
        M=operators.mass_elasticity(m2, device=cpu).to_scipy(),
        sigma=-1e-6, which="LM", return_eigenvectors=False))[3:]
    rel2 = float(np.abs(lam2[:3] - w_ref[:3]).max() / np.abs(w_ref[:3]).max())
    out["scipy_2d"] = dict(eigenvalues=lam2.tolist(), scipy=w_ref.tolist(),
                           rel=rel2, seconds=wall2)
    log(f"17b grid_tri(5, 5) P1 on the card: {lam2.tolist()} against "
        f"scipy's eigsh {w_ref[:3].tolist()}: {rel2:.3e} relative, "
        f"{wall2:.2f} s")
    if not rel2 <= 1e-4:
        raise RuntimeError("17b: 2D modes disagree with scipy")
    return out, paths


def mo_problem(n, device, targets=None, E_true=3.0):
    """grid_tet(n) P2 with the x = 0 face fixed and a unit load on x = 1
    (-y, spread over the face), targets on x = 1: the displacement of the
    uniform E_true (as ``tests/test_solvers_autodiff.py:190-219`` makes
    them, here solved with the multigrid V-cycle) unless given."""
    from meshfem_tpu_torch.analysis import material_optimization as mo
    from meshfem_tpu_torch.mesh import FEMMesh, generators

    mesh = FEMMesh(*generators.grid_tet(n, n, n), degree=2)
    X = mesh.node_positions
    right = np.flatnonzero(X[:, 0] > 1 - 1e-9)
    fixed = np.zeros((mesh.num_nodes, 3), bool)
    fixed[X[:, 0] < 1e-9] = True
    load = np.zeros((mesh.num_nodes, 3))
    load[right, 1] = -1.0 / len(right)
    mk = lambda tv: mo.MaterialOptimizationProblem(
        mesh, 0.3, fixed, np.zeros_like(load),
        torch.as_tensor(load, device=device), right, tv, bounds=(0.5, 8.0),
        device=device)
    if targets is None:
        prob = mk(np.zeros((len(right), 3)))
        E = torch.full((mesh.num_elements,), E_true, dtype=torch.float64,
                       device=device)
        with torch.no_grad():
            u = prob.displacement(E, M_inv=mg_vcycle(prob, E))
        targets = u[torch.as_tensor(right, device=device)].cpu().numpy()
    return mk(targets)


def mg_vcycle(prob, young):
    """The variable-material V-cycle of ``optimize(precond="multigrid")``
    for the field ``young``, as a preconditioner of nodal residuals."""
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.ops.structured_mg import VarStructuredMG

    D = et.isotropic(3, young, torch.full_like(young, prob.poisson))
    mg = VarStructuredMG.build(prob.mesh, D,
                               fixed_mask=torch.as_tensor(prob.fixed_mask),
                               device=prob.device)
    return lambda r: mg.fine.from_channels(
        mg.precondition(mg.fine.to_channels(r)))


class SolveLog:
    """Times every ``cg`` call (and its iterations) and every
    ``VarStructuredMG.build`` (its start on the host clock, and its
    seconds) while active, by wrapping the two names where the port looks
    them up."""

    def __enter__(self):
        from meshfem_tpu_torch.ops import structured_mg
        from meshfem_tpu_torch.solvers import cg as cg_mod

        self.cg, self.builds = [], []
        self._cg, self._build = cg_mod.cg, structured_mg.VarStructuredMG.build

        def cg(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            res = self._cg(*a, **k)
            torch.cuda.synchronize()
            self.cg.append((time.time() - t0, res.iters))
            return res

        def build(*a, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            mg = self._build(*a, **k)
            torch.cuda.synchronize()
            self.builds.append((t0, time.time() - t0))
            return mg

        cg_mod.cg = cg
        structured_mg.VarStructuredMG.build = build
        return self

    def __exit__(self, *exc):
        from meshfem_tpu_torch.ops import structured_mg
        from meshfem_tpu_torch.solvers import cg as cg_mod

        cg_mod.cg = self._cg
        structured_mg.VarStructuredMG.build = self._build


def profile_kernels(fn):
    """(operator names, device kernel names) of one call of ``fn`` under
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    kern = [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return ops, kern


# library scatters that sum in no fixed order: index_add_ (its CUDA
# kernels indexFuncSmallIndex / indexFuncLargeIndex) and index_put_ with
# accumulate=True (its sort-based indexing_backward_kernel), scatter_add
LIBRARY_SCATTERS = ("index_add", "indexFunc", "indexing_backward",
                    "scatter_add", "put_with_sort")


def drive_material_opt(dev):
    """17c: ``optimize(..., precond="multigrid")`` at bench size, its steps
    split by stage; the backward's launches; a profiler trace of one step
    free of library scatters; the gradient against central differences
    (grid_tet(6)) and against the CPU (grid_tet(4))."""
    from meshfem_tpu_torch.analysis import material_optimization as mo
    from meshfem_tpu_torch.utils.fd_validation import fd_gradient_check

    out, paths = {}, {}
    t0 = time.time()
    prob = mo_problem(BENCH_N, dev)
    torch.cuda.synchronize()
    out["setup_s"] = time.time() - t0
    E = prob.mesh.num_elements
    y0 = torch.full((E,), 2.0, dtype=torch.float64, device=dev)
    with SolveLog() as sl:
        (young, hist), wall, paths["17c_optimize"] = counted(
            "17c optimize", lambda: mo.optimize(
                prob, y0, steps=MO_STEPS, learning_rate=0.2,
                precond="multigrid"), required=PHASE17_PATH)
    t_end = time.time()
    # a step starts with its multigrid build: its seconds run from that
    # build's start to the next one's (the last to the call's end)
    starts = [t for t, _ in sl.builds] + [t_end]
    steps = []
    for k in range(MO_STEPS):
        (tf, itf), (ta, ita) = sl.cg[2 * k], sl.cg[2 * k + 1]
        tb = sl.builds[k][1]
        ts = starts[k + 1] - starts[k]
        steps.append(dict(step_s=ts, mg_build_s=tb, forward_s=tf,
                          forward_iters=itf, adjoint_s=ta, adjoint_iters=ita,
                          gradient_and_rest_s=ts - tb - tf - ta))
    step_s = wall / MO_STEPS
    out.update(seconds=wall, s_per_step=step_s, history=hist, steps=steps,
               young_range=[float(young.min()), float(young.max())])
    log(f"17c optimize grid_tet({BENCH_N}) P2 ({E} tets, per-element "
        f"moduli), precond=multigrid, {MO_STEPS} Adam steps: {wall:.2f} s, "
        f"{step_s:.3f} s a step; objective {hist}; steps {steps}")
    if not (hist[-1] < hist[0] and all(np.isfinite(hist))
            and bool(torch.isfinite(young).all())):
        raise RuntimeError("17c: the objective did not fall")
    # the backward alone, counted: B's adjoint is kernel A
    M_inv = mg_vcycle(prob, young)
    th = young.detach().clone().requires_grad_(True)
    with SolveLog() as sl:
        val = prob.objective(th, M_inv=M_inv)
        (g,), wall_b, paths["17c_backward"] = counted(
            "17c backward", lambda: torch.autograd.grad(val, th),
            required=PHASE17_PATH)
    c = paths["17c_backward"]
    n_adj = sl.cg[-1][1]
    out["backward"] = dict(seconds=wall_b, adjoint_iters=n_adj,
                           gather_rows=c["gather_rows"],
                           segment_sum_rows=c["segment_sum_rows"])
    log(f"17c backward alone: {wall_b:.3f} s, adjoint CG {n_adj} "
        f"iterations; launches A {c['gather_rows']}, B "
        f"{c['segment_sum_rows']} (each adjoint matvec one of each, the "
        f"replayed matvec one of each, and B's two adjoints: A = B + 2)")
    if not (c["gather_rows"] == c["segment_sum_rows"] + 2
            and c["segment_sum_rows"] == n_adj + 1):
        raise RuntimeError("17c: the backward's launches are not the A/B "
                           "pair's")
    # the gradient against central differences, then against the CPU
    p6 = mo_problem(MO_FD_N, dev)
    y6 = 2.0 + torch.rand(p6.mesh.num_elements, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(6)).to(dev)
    fd_err = fd_gradient_check(p6.objective, y6, eps=1e-5, n_dirs=3)
    p4 = mo_problem(MO_CPU_N, dev)
    p4c = mo_problem(MO_CPU_N, "cpu", targets=p4.target_values)
    y4 = 2.0 + torch.rand(p4.mesh.num_elements, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(4))
    g_card = p4.gradient(y4.to(dev)).cpu()
    g_cpu = p4c.gradient(y4)
    cpu_rel = float((g_card - g_cpu).abs().max() / g_cpu.abs().max())
    out.update(fd_err=fd_err, vs_cpu=cpu_rel)
    # one optimization step under the profiler (grid_tet(2), the
    # unpreconditioned solve: the same differentiated code as at full
    # width, in ~80,000 events where a multigrid step at full width makes
    # ~600,000): no library scatter
    p2 = mo_problem(MO_PROFILE_N, dev)
    y2 = torch.full((p2.mesh.num_elements,), 2.0, dtype=torch.float64,
                    device=dev)
    ops, kern = profile_kernels(lambda: mo.optimize(p2, y2, steps=1,
                                                    learning_rate=0.2))
    bad = sorted({n for n in ops + kern
                  if any(s in n for s in LIBRARY_SCATTERS)})
    out["profile"] = dict(ops=len(ops), kernels=len(kern), scatters=bad)
    log(f"17c one step under torch.profiler (grid_tet({MO_PROFILE_N}) P2): "
        f"{len(ops)} operator events, {len(kern)} device kernels; library "
        f"scatters {bad}")
    if bad or not kern:
        raise RuntimeError(f"17c: a library scatter ran: {bad}")
    log(f"17c gradient: against central differences (grid_tet({MO_FD_N}) "
        f"P2) {fd_err:.3e}; card against CPU (grid_tet({MO_CPU_N}) P2) "
        f"{cpu_rel:.3e} relative")
    if not (fd_err < 1e-4 and cpu_rel <= 1e-8):
        raise RuntimeError("17c: the gradient disagrees")
    return out, paths, prob


def drive_diff_displacement(dev):
    """17d: the gradient of load . u(rho) through
    ``differentiable_displacement`` against ``compliance_and_grad``'s dc
    (rtol 5e-5, ``tests/test_topopt.py:60-75``), float64 at 12d's grid."""
    from meshfem_tpu_torch.analysis import topopt

    out = {}
    top = topopt.ComplianceTopOpt(*TOPOPT17_SHAPE, dtype=torch.float64,
                                  solve_tol=1e-10, device=dev)
    rho = (0.5 + 0.05 * torch.randn(TOPOPT17_SHAPE, dtype=torch.float64,
                                    generator=torch.Generator()
                                    .manual_seed(17))).clamp(0.3, 0.8)
    rho = rho.to(dev).requires_grad_(True)
    u_of_rho = topopt.differentiable_displacement(top)

    def forward():
        return torch.vdot(top.load.reshape(-1), u_of_rho(rho).reshape(-1))

    J, wall_f, paths = counted("17d forward", forward)
    (g,), wall_b, pb = counted("17d backward",
                               lambda: torch.autograd.grad(J, rho))
    _, dc, _ = top.compliance_and_grad(rho.detach())
    scale = float(dc.abs().max())
    err = float(((g - dc).abs() - 5e-5 * dc.abs()).max())
    out.update(forward_s=wall_f, backward_s=wall_b,
               max_excess=err, dc_max=scale,
               rel=float((g - dc).abs().max()) / scale)
    log(f"17d differentiable_displacement {TOPOPT17_SHAPE} (float64): "
        f"forward {wall_f:.3f} s, backward {wall_b:.3f} s; gradient against "
        f"dc {out['rel']:.3e} of max|dc| ({scale:.3e})")
    if not err <= 1e-10 * scale:
        raise RuntimeError("17d: the gradient differs from dc")
    return out, {"17d_forward": paths, "17d_backward": pb}


def newton_bar(n, device):
    """The neo-Hookean total energy of grid_tet(2n, n, n) P1 on [0, 2] x
    [0, 1]^2, clamped at x = 0 and stretched 20% (x = 2 moved to 2.4, its
    other components free), from the uniform stretch; returns (energy,
    x0, projector)."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import energies
    from meshfem_tpu_torch.solvers import cg as cg_mod

    mesh = FEMMesh(*generators.grid_tet(2 * n, n, n, hi=(2.0, 1.0, 1.0)),
                   degree=1)
    X = mesh.node_positions
    fixed = np.zeros((mesh.num_nodes, 3), bool)
    fixed[X[:, 0] < 1e-9] = True
    fixed[X[:, 0] > 2 - 1e-9, 0] = True
    x0 = X.copy()
    x0[:, 0] *= 1.2
    E = energies.total_energy(mesh, "neo_hookean", 2.0, 1.0, device=device)
    return (E, torch.as_tensor(x0, device=device),
            cg_mod.mask_projector(torch.as_tensor(~fixed, device=device)))


def drive_newton(dev):
    """17e: ``newton_from_energy`` on the stretched bar, counted, and the
    card against the CPU at a small size (x to 1e-8, equal counts)."""
    from meshfem_tpu_torch.solvers import newton

    out = {}
    E, x0, proj = newton_bar(NEWTON_N, dev)
    (x, rep), wall, paths = counted(
        "17e Newton", lambda: newton.newton_from_energy(
            E, x0, project=proj, gradTol=1e-8, maxiter=30),
        required=PHASE17_PATH)
    dofs = x0.numel()
    out.update(seconds=wall, dofs=dofs, iterations=rep.iterations,
               converged=rep.converged, cg_iters=rep.cg_iters,
               grad_norm=rep.grad_norm, energy=rep.energy,
               s_per_iteration=wall / max(rep.iterations, 1))
    log(f"17e Newton, neo-Hookean bar grid_tet({2 * NEWTON_N}, {NEWTON_N}, "
        f"{NEWTON_N}) P1 ({dofs} dofs): {wall:.2f} s, {rep.iterations} "
        f"iterations ({out['s_per_iteration']:.3f} s each), CG iterations "
        f"{rep.cg_iters}, |g| {rep.grad_norm}")
    if not (rep.converged and bool(torch.isfinite(x).all())
            and rep.energy[-1] < rep.energy[0]):
        raise RuntimeError("17e: Newton did not converge")
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        Es, xs0, ps = newton_bar(NEWTON_CPU_N, d)
        res[where] = newton.newton_from_energy(Es, xs0, project=ps,
                                               gradTol=1e-8, maxiter=30)
    (xc, rc), (xh, rh) = res["card"], res["cpu"]
    rel = float((xc.cpu() - xh).abs().max() / xh.abs().max())
    out["vs_cpu"] = dict(rel=rel, iterations=[rc.iterations, rh.iterations],
                         cg_iters=[rc.cg_iters, rh.cg_iters])
    log(f"17e card against CPU (n = {NEWTON_CPU_N}): x {rel:.3e} relative, "
        f"iterations {rc.iterations} / {rh.iterations}, CG {rc.cg_iters} / "
        f"{rh.cg_iters}")
    if not (rel <= 1e-8 and rc.iterations == rh.iterations):
        raise RuntimeError("17e: Newton on the card differs from the CPU")
    return out, {"17e_newton": paths}


def drive_material_cli(dev, tmp):
    """17f: ``cli.material_opt`` on a grid_tet(6) P1 mesh and a .bc file with
    a ``target`` region written here; the fitted field read back from its
    MSH against the API's ``optimize`` on the same problem (1e-10)."""
    from meshfem_tpu_torch.analysis import material_optimization as mo
    from meshfem_tpu_torch.cli import material_opt
    from meshfem_tpu_torch.io import meshio, msh_fields
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           load_bc)
    from meshfem_tpu_torch.physics.boundary_conditions import (
        expression_env, match_boundary_nodes)

    V, F = generators.grid_tet(CLI_MO_N, CLI_MO_N, CLI_MO_N)
    msh, bc, fit = (os.path.join(tmp, f) for f in ("mo.msh", "mo.bc",
                                                   "fit.msh"))
    meshio.save_msh(msh, V, F)
    with open(bc, "w") as fh:
        fh.write(bc_json([{"type": "dirichlet", "value": [0, 0, 0],
                           **FACE_X0},
                          {"type": "force", "value": [0.1, 0, 0], **FACE_X1},
                          {"type": "target", "value": [0.02, 0, 0],
                           **FACE_X1}]))
    args = [msh, "-b", bc, "--steps", "3", "--lr", "0.2", "-o", fit,
            "--device", str(dev)]
    _, wall, paths = counted("17f cli.material_opt",
                             lambda: material_opt.main(args),
                             required=PHASE17_PATH)
    young_cli = np.asarray(msh_fields.read_fields(fit)["young"]["data"])
    Vm, Fm = meshio.load(msh)
    mesh = FEMMesh(Vm, Fm, degree=1)
    b = load_bc(bc, dim=3)
    sim = ElasticitySimulator(mesh, Material.isotropic(3, 1.0, 0.3),
                              device=dev)
    sim.apply_boundary_conditions(b)
    reg = [r for r in b.regions if r.type == "target"][0]
    nodes = match_boundary_nodes(mesh, reg)
    vals = reg.eval_value(mesh.node_positions[nodes], expression_env(mesh))
    prob = mo.MaterialOptimizationProblem(
        mesh, 0.3, sim.dirichlet_mask, sim.dirichlet_values,
        sim.neumann_load, nodes, vals[:, :3], device=dev)
    y, hist = mo.optimize(prob, torch.ones(mesh.num_elements,
                                           dtype=torch.float64, device=dev),
                          steps=3, learning_rate=0.2)
    y = y.cpu().numpy()
    err = float(np.abs(young_cli.reshape(-1) - y).max() / np.abs(y).max())
    log(f"17f cli.material_opt grid_tet({CLI_MO_N}) P1: {wall:.2f} s, "
        f"young in [{young_cli.min():.6g}, {young_cli.max():.6g}], against "
        f"the API {err:.3e}")
    if not (young_cli.size == mesh.num_elements and err <= 1e-10
            and hist[-1] < hist[0]):
        raise RuntimeError("17f cli.material_opt: bad output")
    return dict(seconds=wall, vs_api=err, history=hist), \
        {"17f_material_opt_cli": paths}


def drive_phase17(dev, gen):
    """Phase 17a-f; returns (summary, launch counts per path, the objects
    17g times kernels on)."""
    import tempfile

    out, paths, parts = {}, {}, {}
    t0 = time.time()

    def part(key, fn, *args):
        t = time.time()
        res = fn(*args)
        parts[key] = time.time() - t
        paths.update(res[1])
        return res

    out["modes"], _, msim, Mv = part("17a", modes_bench, dev, gen)
    out["modes_vs_cpu"], _ = part("17b", modes_vs_cpu, dev)
    out["material_opt"], _, prob = part("17c", drive_material_opt, dev)
    out["diff_displacement"], _ = part("17d", drive_diff_displacement, dev)
    out["newton"], _ = part("17e", drive_newton, dev)
    with tempfile.TemporaryDirectory() as tmp:
        out["material_cli"], _ = part("17f", drive_material_cli, dev, tmp)
    out["parts_s"] = parts
    out["phase_s"] = time.time() - t0
    log(f"phase 17 (17a-f): {out['phase_s']:.1f} s, by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return out, paths, (msim, Mv, prob)


def kernels_phase17(dev, entry, objs, paths, gen):
    """17g: kernel B in float64 rows at 18 and 54 values on the modes'
    plan (LOBPCG's K and M applies at 6 and 18 columns) and kernel A in
    float64 rows as B's adjoint on material optimization's gather, each
    held against its plain version (B also bit for bit against B in planes
    and the CPU's plain sum) and timed with ``entry``."""
    from meshfem_tpu_torch import kernels

    msim, Mv, prob = objs
    out = {}
    plan = msim._kernel.plan
    R, N = plan.num_rows, plan.num_segments
    dst = msim._kernel.elem_dofs.reshape(-1)
    modes_runs = [c for p, c in paths.items() if p.startswith("17a_modes")]
    for P in (18, 54):
        err = check_rows_on_plan(plan, torch.float64,
                                 f"17g B f64 rows ({P} values)", gen, P=P)
        src = torch.randn((R, P), generator=gen, device=dev,
                          dtype=torch.float64)
        acc = torch.zeros((N, P), device=dev, dtype=torch.float64)
        entry(f"segment_sum_rows/f64/{P}/modes",
              "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
              "meshfem_tpu/sparse/route.py:162 (f64: the XLA scatter of "
              "meshfem_tpu/sparse/ebe.py, LOBPCG's K and M applies)",
              sum(c["segment_sum_rows/f64"] for c in modes_runs), err,
              lambda: plan.sum_rows(src),
              lambda: kernels.segment_sum_rows_plain(src, plan.perm,
                                                     plan.offsets),
              lambda: acc.index_add_(0, dst, src),
              P * R * 8 + R * 4 + (N + 1) * 4 + P * N * 8, P * R,
              flop_rate=F64_FLOP_PER_S,
              mode=f"f64 rows [R, {P}] -> [N, {P}]: the EBE apply of a "
                   f"[N, 3, {P // 3}] block, as compute_vibrational_modes "
                   f"runs it",
              launches_path="17a modes (free and clamped), float64 launches "
                            "at 18 and 54 values together",
              library_call="Tensor.index_add_ (float atomics)",
              shape=f"grid_tet({BENCH_N}) P2 plan: src [{R}, {P}] f64 -> "
                    f"[{N}, {P}]")
        del src, acc
    # A: B's adjoint on the material-optimization gather (f64, 3 values)
    g = prob.gather
    ids = g.ids
    src = torch.randn((g.num_sources, 3), generator=gen, device=dev,
                      dtype=torch.float64)
    if not (torch.equal(kernels.gather_rows(src, ids),
                        kernels.gather_rows_plain(src, ids))
            and torch.equal(kernels.gather_rows(src, ids).cpu(),
                            kernels.gather_rows_plain(src.cpu(),
                                                      ids.cpu()))):
        raise RuntimeError("17g: gather_rows f64 != plain")
    ids_long = ids.long()
    S = ids.shape[0]
    bw = paths["17c_backward"]
    entry("gather_rows/f64/adjoint", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139 (f64: the transpose of the XLA "
          "scatter that jax.grad takes through meshfem_tpu/analysis/"
          "material_optimization.py:75-78)",
          bw["gather_rows/f64"], 0.0,
          lambda: kernels.gather_rows(src, ids),
          lambda: kernels.gather_rows_plain(src, ids),
          lambda: torch.index_select(src, 0, ids_long),
          S * 4 + g.num_sources * 3 * 8 + S * 3 * 8, 0,
          mode="f64 rows [N, 3] -> [E n, 3] (as float32 pairs): B's "
               "adjoint in material optimization's backward, and its "
               "matvec's gather",
          launches_path="17c backward alone, float64 launches (the adjoint "
                        "CG's matvecs and B's two adjoints)",
          library_call="torch.index_select",
          shape=f"grid_tet({BENCH_N}) P2 elem_nodes: src [{g.num_sources}, "
                f"3] f64, ids [{S}] int32")
    out["checked"] = ["segment_sum_rows/f64/18/modes",
                      "segment_sum_rows/f64/54/modes",
                      "gather_rows/f64/adjoint"]
    return out


# -- phase 18: multi-device ------------------------------------------------
DD_SHARDS = 4                 # LocalShards on the one card
DD_CHUNK = 100                # host tol checks every 100 iterations
DD_MAXITER = 20000
DD_INVARIANCE_ITERS = 30
DD_ROUTED_ITERS = 25
DD_COARSE_ITERS = 60
DD_AGG_SIZE = 128             # 50,653 P1 vertices -> 396 aggregates
DD_MULTICHIP_ITERS = 20
DD_BACKEND = "nccl"           # the one-rank group of 18g


def dd_shard_applies(dd, iters):
    """Kernel B launches a float64 DD solve of ``iters`` iterations makes:
    one for each shard's interior and one for its boundary elements an
    iteration."""
    return iters * int((dd.n_int > 0).sum() + (dd.n_bnd > 0).sum())


def dd_timings(dd, comm, gen):
    """Events (warm L2, as inside CG): shard 0's apply (interior, the
    halo-extended boundary) and one exchange of every shard's send slots."""
    S, Nl, K = dd.n_shards, dd.Nl, dd.K
    op0 = dd.shard_ops(0)
    xs = [torch.randn((S, Nl, 3, 1), generator=gen, device=gen.device,
                      dtype=torch.float64) for _ in range(5)]
    sends = [torch.stack([x[s][dd.shard_ops(s).send] for s in range(S)])
             .reshape(S, S, K, 3, 1) for x in xs]
    recv = comm.exchange(sends[0]).wait()

    def shard_apply(x):
        x_loc = torch.cat([x[0], recv[0][op0.take]])
        return op0.interior(x[0]) + op0.boundary(x_loc)[:Nl]

    return dict(shard_apply_ms=median_apply_ms(shard_apply, xs),
                exchange_ms=median_apply_ms(
                    lambda s: comm.exchange(s).wait(), sends),
                exchange_values=S * S * K * 3)


def drive_multidevice(dev, sim, u_routed, gen):
    """Phase 18a-g on the clamped bench problem; returns (summary, launch
    counts per path, the objects 18h checks and times kernels on)."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist

    from meshfem_tpu_torch.parallel import (
        DDCoarse, DomainDecomposition, LocalShards, RankShards, dd_cg_solve,
        dryrun_multidevice, sharded_elasticity_solve_multichip)
    from meshfem_tpu_torch.solvers import cg as cg_mod

    t_phase = time.time()
    out, paths = {}, {}
    S = DD_SHARDS
    free = torch.as_tensor(~sim.dirichlet_mask, dtype=torch.float64,
                           device=dev)
    b = sim.neumann_load * free
    N3 = 3 * sim.num_dofs

    def relres(u):
        return float(torch.linalg.norm((b - sim.apply_K(u)) * free)
                     / torch.linalg.norm(b))

    # (a) the build
    torch.cuda.synchronize()
    t0 = time.time()
    dd = DomainDecomposition.from_simulator(sim, S)
    torch.cuda.synchronize()
    vol = dd.comms_volume_per_spmv()
    out["build"] = dict(seconds=time.time() - t0, Nl=dd.Nl, H=dd.H, K=dd.K,
                        n_int=dd.n_int.tolist(), n_bnd=dd.n_bnd.tolist(),
                        halo_scalars=vol, full_vector=N3,
                        halo_share=vol / N3)
    log(f"18a DomainDecomposition.from_simulator(sim, {S}): "
        f"{out['build']['seconds']:.2f} s; Nl {dd.Nl}, H {dd.H}, K {dd.K}; "
        f"interior elements {dd.n_int.tolist()}, boundary "
        f"{dd.n_bnd.tolist()}; halo scalars an apply {vol} of the full "
        f"vector's {N3} ({vol / N3:.4f})")
    comm = LocalShards(S, dev)

    # (b) the float64 DD solve, block Jacobi, to 1e-8
    st = {}
    (u_dd, r2), wall, counts = counted(
        "18b DD solve", lambda: dd_cg_solve(
            dd, b, comm, free_mask=free, iters=DD_MAXITER, tol=1e-8,
            chunk=DD_CHUNK, precond="block", stats=st),
        ("segment_sum_rows",))
    paths["18b_dd_f64"] = counts
    iters = st["iters"]
    want = dd_shard_applies(dd, iters)
    if not (counts["segment_sum_rows/f64"] == want
            and counts["gather_planes"] == counts["segment_sum_csr"] == 0):
        raise RuntimeError(f"18b: kernel B f64 launched "
                           f"{counts['segment_sum_rows/f64']} times, every "
                           f"shard apply needs one of each of its {want}")
    rr = relres(u_dd)
    du = float((u_dd - u_routed).abs().max() / u_routed.abs().max())
    out["dd_solve"] = dict(iters=iters, chunks=st["chunks"], seconds=wall,
                           ms_per_iter=wall / iters * 1e3, relres=rr,
                           res2=float(r2), vs_routed=du,
                           **dd_timings(dd, comm, gen))
    log(f"18b DD solve (block Jacobi, {S} shards, tol 1e-8): {iters} "
        f"iterations in {wall:.3f} s, {wall / iters * 1e3:.3f} ms an "
        f"iteration (host clock); true f64 relative residual {rr:.3e}; "
        f"{du:.3e} of max|u| from phase 4's routed u; one shard apply "
        f"{out['dd_solve']['shard_apply_ms']:.4f} ms, one exchange "
        f"{out['dd_solve']['exchange_ms']:.4f} ms (events); B f64 launches "
        f"{counts['segment_sum_rows/f64']} = {want}")
    if not rr <= 1e-7:
        raise RuntimeError(f"18b: true relative residual {rr:.3e} > 1e-7")
    if not du <= 5e-3:
        raise RuntimeError(f"18b: {du:.3e} of max|u| from the routed u")

    # (c) partition invariance at a fixed count
    us = {}
    for Sx in (1, 2, S):
        ddx = dd if Sx == S else DomainDecomposition.from_simulator(sim, Sx)
        (us[Sx], _), _, paths[f"18c_S{Sx}"] = counted(
            f"18c S={Sx}", lambda: dd_cg_solve(
                ddx, b, LocalShards(Sx, dev), free_mask=free,
                iters=DD_INVARIANCE_ITERS), ("segment_sum_rows",))
        del ddx
    scale = float(us[1].abs().max())
    inv = max(float((us[a] - us[c]).abs().max()) / scale
              for a in us for c in us)
    out["invariance"] = dict(iters=DD_INVARIANCE_ITERS, max_rel_diff=inv)
    log(f"18c partition invariance, S = 1, 2, {S} at "
        f"{DD_INVARIANCE_ITERS} iterations: {inv:.3e} of max|u|")
    if not inv <= 1e-8:
        raise RuntimeError(f"18c: shards disagree by {inv:.3e}")
    del us

    # (d) the routed shards
    torch.cuda.synchronize()
    t0 = time.time()
    rsp = dd.build_routed()
    torch.cuda.synchronize()
    t_rb = time.time() - t0
    with ApplyCounter() as applies:
        (u_r, _), wall_r, counts = counted(
            "18d routed shards", lambda: dd_cg_solve(
                dd, b, comm, free_mask=free, iters=DD_ROUTED_ITERS,
                routed_spmv=rsp), ("gather_rows", "segment_sum_rows"))
    paths["18d_routed"] = counts
    check_rows_path("18d routed shards", counts, applies.count)
    if not (applies.count == S * DD_ROUTED_ITERS
            and counts["segment_sum_rows"] == applies.count
            and counts["segment_sum_rows/f64"] == 0):
        raise RuntimeError("18d: not one A and one B an apply, or an apply "
                           "missing")
    u_e, _ = dd_cg_solve(dd, b, comm, free_mask=free, iters=DD_ROUTED_ITERS)
    dr = float((u_r - u_e).abs().max() / u_e.abs().max())
    out["routed"] = dict(build_s=t_rb, iters=DD_ROUTED_ITERS, seconds=wall_r,
                         ms_per_iter=wall_r / DD_ROUTED_ITERS * 1e3,
                         applies=applies.count, vs_f64=dr)
    log(f"18d routed shards: built in {t_rb:.2f} s; {DD_ROUTED_ITERS} "
        f"iterations in {wall_r:.3f} s, {applies.count} shard applies "
        f"(A rows {counts['gather_rows']}, B rows "
        f"{counts['segment_sum_rows']}); {dr:.3e} of max|u| from the f64 DD "
        f"at the same count")
    if not dr <= 2e-4:
        raise RuntimeError(f"18d: routed shards {dr:.3e} from the f64 DD")

    # (e) the coarse level
    cst = {}
    co = DDCoarse.from_simulator(sim, dd, agg_size=DD_AGG_SIZE, stats=cst)
    n_coarse = co.n_agg * co.nm
    _, r2_plain = dd_cg_solve(dd, b, comm, free_mask=free,
                              iters=DD_COARSE_ITERS, precond="block")
    (_, r2_co), wall_co, paths["18e_coarse"] = counted(
        "18e DDCoarse", lambda: dd_cg_solve(
            dd, b, comm, free_mask=free, iters=DD_COARSE_ITERS,
            precond="block", coarse=co), ("segment_sum_rows",))
    ratio = float(r2_co) / float(r2_plain)
    out["coarse"] = dict(agg_size=DD_AGG_SIZE, n_agg=co.n_agg,
                         coarse_unknowns=n_coarse, build_s=cst,
                         iters=DD_COARSE_ITERS, res2_ratio=ratio,
                         seconds=wall_co)
    log(f"18e DDCoarse(agg_size={DD_AGG_SIZE}): {co.n_agg} aggregates, "
        f"{n_coarse} coarse unknowns; build " + ", ".join(
            f"{k} {v:.3f} s" for k, v in cst.items())
        + f"; at {DD_COARSE_ITERS} iterations res2 {float(r2_co):.3e} "
        f"against block Jacobi's {float(r2_plain):.3e} ({ratio:.3e})")
    if not n_coarse <= 3000:
        raise RuntimeError(f"18e: {n_coarse} coarse unknowns")
    if not ratio <= 1e-2:
        raise RuntimeError(f"18e: the coarse level reduced res2 only to "
                           f"{ratio:.3e} of block Jacobi's")
    del co

    # (f) the element-sharded multichip solve, 2 x 2
    cols = []
    for i in range(6):
        e = torch.zeros(6, dtype=torch.float64)
        e[i] = 1e-3
        cols.append(sim.constant_strain_load(e))
    B = torch.stack(cols, dim=-1) * free[..., None]
    (U, _), wall_f, paths["18f_multichip"] = counted(
        "18f multichip", lambda: sharded_elasticity_solve_multichip(
            sim, B, LocalShards(2, dev, col_groups=2), free_mask=free,
            iters=DD_MULTICHIP_ITERS), ("segment_sum_rows",))
    diag = sim.K_diagonal()
    safe = torch.where(diag > 0, diag, torch.ones_like(diag))[..., None]
    ref = cg_mod.cg_block(sim.apply_K, B, M_inv=lambda r: r / safe,
                          project=lambda v: v * free[..., None], tol=0.0,
                          maxiter=DD_MULTICHIP_ITERS)
    dm = float((U - ref.x).abs().max() / ref.x.abs().max())
    out["multichip"] = dict(iters=DD_MULTICHIP_ITERS, seconds=wall_f,
                            vs_single=dm, single_iters=ref.iters)
    log(f"18f sharded_elasticity_solve_multichip, 2 domain x 2 column "
        f"groups, 6 strain loads, {DD_MULTICHIP_ITERS} iterations: "
        f"{wall_f:.3f} s; {dm:.3e} of max|U| from a single-device Jacobi "
        f"block CG of {ref.iters} iterations")
    if not (ref.iters == DD_MULTICHIP_ITERS and dm <= 1e-9):
        raise RuntimeError(f"18f: {dm:.3e} from the single-device solve")
    del B, U, ref

    # (g) the dry run, and one rank of a process group
    dry, wall_g, paths["18g_dryrun"] = counted(
        "18g dryrun", lambda: dryrun_multidevice(S, device=dev),
        ("segment_sum_rows",))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            DD_BACKEND, store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1, timeout=timedelta(seconds=120))
        try:
            ranked, _, paths["18g_rank"] = counted(
                f"18g one {DD_BACKEND} rank",
                lambda: dryrun_multidevice(1, comm=RankShards()),
                ("segment_sum_rows",))
        finally:
            dist.destroy_process_group()
    local1 = dryrun_multidevice(1, comm=LocalShards(1, dev))
    same = (torch.equal(ranked["u"], local1["u"])
            and torch.equal(ranked["res2"], local1["res2"]))
    out["dryrun"] = dict(seconds=wall_g, relres=dry["relres"].tolist(),
                         err=dry["err"], rank_equals_local=same,
                         backend=DD_BACKEND)
    log(f"18g dryrun_multidevice({S}): {wall_g:.2f} s, true relative "
        f"residuals {dry['relres'].tolist()}, invariance {dry['err']:.3e}; "
        f"one {DD_BACKEND} rank "
        f"{'equal bit for bit to' if same else 'DIFFERENT from'} one "
        f"in-process shard")
    if not same:
        raise RuntimeError(f"18g: the {DD_BACKEND} rank differs from one "
                           f"in-process shard")
    out["phase_s"] = time.time() - t_phase
    log(f"phase 18: {out['phase_s']:.1f} s")
    return out, paths, (dd, rsp)


def kernels_multidevice(dev, entry, objs, paths, gen):
    """18h: kernels A and B on every shard plan of 18a-d held against their
    plain versions (A exactly, B f32 1e-5 and f64 1e-12 of max|y|, B also
    bit for bit against B in planes and the CPU's plain sum), shard 0's
    timed with ``entry``."""
    from meshfem_tpu_torch import kernels

    dd, rsp = objs
    errs = {}
    for s, op in rsp.ops.items():
        x = torch.randn((rsp.NlH, 3), generator=gen, device=dev)
        if not torch.equal(kernels.gather_rows(x, op.ids_em),
                           kernels.gather_rows_plain(x, op.ids_em)):
            raise RuntimeError(f"18h: gather_rows != plain on shard {s}")
        errs[(s, "f32")] = check_rows_on_plan(op.plan_em, torch.float32,
                                              f"18h shard {s} routed", gen)
        ops = dd.shard_ops(s)
        for which, ebe in (("interior", ops.interior),
                           ("boundary", ops.boundary)):
            if ebe is not None:
                errs[(s, which)] = check_rows_on_plan(
                    ebe.plan, torch.float64, f"18h shard {s} {which}", gen)
    log("18h A and B on the shard plans: A equal to plain, B within gates; "
        + ", ".join(f"{k}: {v:.3e}" for k, v in errs.items()))
    op = rsp.ops[0]
    NlH, ids = rsp.NlH, op.ids_em
    R = ids.shape[0]
    x = torch.randn((NlH, 3), generator=gen, device=dev)
    ids_long = ids.long()
    entry("gather_rows/shard", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139 (the routed gather inside each "
          "shard, meshfem_tpu/parallel/routed_dd.py:133-137)",
          paths["18d_routed"]["gather_rows"], 0.0,
          lambda: kernels.gather_rows(x, ids),
          lambda: kernels.gather_rows_plain(x, ids),
          lambda: torch.index_select(x, 0, ids_long),
          R * 4 + NlH * 3 * 4 + R * 3 * 4, 0,
          mode="rows [Nl + H, 3] -> [E_s n, 3], shard 0 of 4",
          launches_path="18d routed shards (4 shards x 25 iterations)",
          library_call="torch.index_select",
          shape=f"x [{NlH}, 3] f32, ids_em [{R}] int32")
    plan = op.plan_em
    fe = torch.randn((R, 3), generator=gen, device=dev)
    acc = torch.zeros((NlH, 3), device=dev)
    dst = plan.ids.long()
    entry("segment_sum_rows/shard",
          "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (the shard's SumPlan rung and "
          "its final XLA scatter-add, meshfem_tpu/parallel/routed_dd.py:"
          "142-149)",
          own_mode(paths["18d_routed"], "segment_sum_rows/shard"),
          errs[(0, "f32")],
          lambda: kernels.segment_sum_rows(fe, plan.perm, plan.offsets),
          lambda: kernels.segment_sum_rows_plain(fe, plan.perm,
                                                 plan.offsets),
          lambda: acc.index_add_(0, dst, fe),
          3 * R * 4 + R * 4 + (NlH + 1) * 4 + 3 * NlH * 4, 3 * R,
          mode="f32 rows [E_s n, 3] -> [Nl + H, 3], shard 0 of 4",
          launches_path="18d routed shards, float32 launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{R}, 3] f32 -> [{NlH}, 3]")
    plan64 = dd.shard_ops(0).interior.plan
    R64, N64 = plan64.num_rows, plan64.num_segments
    src64 = torch.randn((R64, 3), generator=gen, device=dev,
                        dtype=torch.float64)
    acc64 = torch.zeros((N64, 3), device=dev, dtype=torch.float64)
    dst64 = plan64.ids.long()
    entry("segment_sum_rows/f64/shard",
          "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (f64: the shard's XLA "
          "segment_sum, meshfem_tpu/parallel/domain.py:361-375)",
          own_mode(paths["18b_dd_f64"], "segment_sum_rows/f64/shard"),
          errs[(0, "interior")],
          lambda: plan64.sum_rows(src64),
          lambda: kernels.segment_sum_rows_plain(src64, plan64.perm,
                                                 plan64.offsets),
          lambda: acc64.index_add_(0, dst64, src64),
          3 * R64 * 8 + R64 * 4 + (N64 + 1) * 4 + 3 * N64 * 8, 3 * R64,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [E_s n, 3] -> [Nl, 3]: shard 0's interior EBE "
               "apply",
          launches_path="18b DD solve, float64 launches (interior and "
                        "boundary of every shard)",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{R64}, 3] f64 -> [{N64}, 3]")
    return {"checked": ["gather_rows/shard", "segment_sum_rows/shard",
                        "segment_sum_rows/f64/shard"],
            "max_abs_err": {f"{s}/{k}": v for (s, k), v in errs.items()}}


# ---------------------------------------------------------------------------
# Phase 19: the analyses on the card -- linkage mechanisms and their
# autograd shape derivative, surface parametrization, discrete curvature,
# the Mechanisms CLI
# ---------------------------------------------------------------------------

LINK_N = 256                  # 19a-b: grid_tri(256) P2, a tilted void
LINK_VOID = (0.2, 0.42, 0.35)  # the void's semi-axes and tilt (radians)
LINK_STEPS = 3
LINK_OPT_STEPS = 2
LINK_SPEED = 0.005
LINK_TOL = 1e-7               # the reference drivers' default tol
LINK_SMALL_N = 8              # card against CPU, and the CLI's cell
PARAM_N = 512                 # 19c: scp on grid_tri(512) P1, 263,169 nodes
HARMONIC_N = 408              # harmonic's cap: its Jacobi CGs take 994
#                               iterations here, 1,242 at 512, past cg's
#                               default 1,000, as at HARMONIC_N + 8 (logged)
LSCM_N = 256                  # lscm's flat grid: the unpreconditioned CG
#                               ends at its 20,000 iterations at 4.4e-6 on
#                               grid_tri(512); ~3x the iterations a doubling
PARAM_SMALL_N = 16            # card against CPU
SCP_ITERS = 50
SCP_SMALL_ITERS = 12
SPHERE_N = 256                # 19d: six grid_tri(256) faces, 393,218 vertices
SPHERE_FD_N = 32              # 19d's finite-difference gate at 1e-5
PHASE19_PATH = ("gather_rows", "segment_sum_rows")


def slot_cell(n):
    """grid_tri(n, n) on the unit square without the triangles whose
    centroid lies in the ellipse ``LINK_VOID`` about the centre (semi-axes
    a, b, turned by the tilt), vertices renumbered.  The tilt makes the
    softest eigenstrain simple with a first component far from zero, so
    the eigenstrain's sign flip is decided alike on the card and the CPU
    (13c's round void is softest in pure shear, first component ~1e-15)."""
    from meshfem_tpu_torch.mesh import generators

    a, b, tilt = LINK_VOID
    V, F = generators.grid_tri(n, n)
    c = V[F].mean(axis=1) - 0.5
    x = np.cos(tilt) * c[:, 0] + np.sin(tilt) * c[:, 1]
    y = -np.sin(tilt) * c[:, 0] + np.cos(tilt) * c[:, 1]
    F2 = F[(x / a) ** 2 + (y / b) ** 2 > 1]
    used = np.unique(F2)
    remap = -np.ones(len(V), dtype=np.int64)
    remap[used] = np.arange(len(used))
    return V[used], remap[F2]


class CellSolveLog:
    """Records (simulator, w, iterations) of every ``solve_cell_problems``
    call while active (the mechanisms look it up as
    ``homogenization.solve_cell_problems``)."""

    def __enter__(self):
        from meshfem_tpu_torch.analysis import homogenization as hom

        self.runs, self._inner = [], hom.solve_cell_problems

        def rec(sim, *a, **k):
            w, iters = self._inner(sim, *a, **k)
            self.runs.append((sim, w, iters))
            return w, iters

        hom.solve_cell_problems = rec
        return self

    def __exit__(self, *exc):
        from meshfem_tpu_torch.analysis import homogenization as hom

        hom.solve_cell_problems = self._inner


class CGLog:
    """Times every ``cg`` call while active: host seconds, iterations and
    the relative residual it stopped at (|r| over the projected right-hand
    side)."""

    def __enter__(self):
        from meshfem_tpu_torch.solvers import cg as cg_mod

        self.runs, self._cg = [], cg_mod.cg

        def cg(A, b, x0=None, **k):
            torch.cuda.synchronize()
            t0 = time.time()
            res = self._cg(A, b, x0, **k)
            torch.cuda.synchronize()
            bn = float(torch.linalg.norm((k.get("project")
                                          or (lambda v: v))(b)))
            self.runs.append(dict(s=time.time() - t0, iters=int(res.iters),
                                  relres=res.resnorm / max(bn, 1e-300),
                                  maxiter=k.get("maxiter", 1000)))
            return res

        cg_mod.cg = cg
        return self

    def __exit__(self, *exc):
        from meshfem_tpu_torch.solvers import cg as cg_mod

        cg_mod.cg = self._cg


def identified_steps_equal(mesh, step_field):
    """max over periodically identified vertex groups of the spread of
    their steps."""
    from meshfem_tpu_torch.mesh import periodic

    dof_map, _, _ = periodic.match_periodic_nodes(mesh.node_positions,
                                                  mesh.bbox(), 1e-7)
    vdofs = dof_map[mesh.vertex_nodes]
    order = np.argsort(vdofs, kind="stable")
    s, d = step_field[order], vdofs[order]
    first = np.r_[0, np.flatnonzero(np.diff(d)) + 1]
    lead = np.repeat(s[first], np.diff(np.r_[first, len(d)]), axis=0)
    return float(np.abs(s - lead).max())


def drive_linkage(dev):
    """19a: ``open_linkage`` on the full-width slot cell, counted; each
    step's block residual through the float64 EBE operator, Eh symmetric
    and positive definite, the opening strain's sign, the step's size,
    kernel E once a step and A and B in rows on every block apply; the
    small cell on the card against the CPU."""
    from meshfem_tpu_torch.analysis import mechanisms as mech
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics import Material

    out, paths = {}, {}
    mat = Material.isotropic(2, 1.0, 0.3)
    t0 = time.time()
    cell = FEMMesh(*slot_cell(LINK_N), degree=2)
    out.update(mesh_s=time.time() - t0, triangles=cell.num_elements,
               nodes=cell.num_nodes)
    with CellSolveLog() as cells, ApplyCounter() as applies:
        res, wall, c = counted(
            "19a open_linkage", lambda: mech.open_linkage(
                cell, mat, num_steps=LINK_STEPS, opening_speed=LINK_SPEED,
                tol=LINK_TOL, device=dev),
            required=PHASE19_PATH + ("element_stiffness",))
    paths["19a_open_linkage"] = c
    check_rows_path("19a open_linkage", c, applies.count)
    if c["element_stiffness"] != LINK_STEPS:
        raise RuntimeError(f"19a: kernel E ran {c['element_stiffness']} "
                           f"times in {LINK_STEPS} steps")
    steps = []
    for (sim, w, iters), st in zip(cells.runs, res.steps):
        relres, _ = block_residual(sim, w)
        Eh = torch.as_tensor(st.Eh)
        scale = float(Eh.abs().max())
        o = np.asarray(st.opening_strain)
        steps.append(dict(
            relres=relres, inner_iters=iters[0], Eh=st.Eh.tolist(),
            asym=float((Eh - Eh.t()).abs().max()) / scale,
            min_eig=float(torch.linalg.eigvalsh(0.5 * (Eh + Eh.t())).min()),
            min_eigenvalue=st.min_eigenvalue, opening=o.tolist(),
            step_max=float(np.linalg.norm(st.step_field, axis=1).max())))
    out.update(seconds=wall, s_per_step=wall / LINK_STEPS, steps=steps,
               block_applies=applies.count,
               max_rel_edge_change=res.max_rel_edge_change)
    log(f"19a open_linkage slot cell grid_tri({LINK_N}) P2 "
        f"({cell.num_elements} triangles, {cell.num_nodes} nodes, mesh "
        f"{out['mesh_s']:.2f} s): {LINK_STEPS} steps in {wall:.3f} s "
        f"({wall / LINK_STEPS:.3f} s a step), {applies.count} block "
        f"applies, launches {c}; steps {steps}")
    for k, s in enumerate(steps):
        o = np.asarray(s["opening"])
        if not (s["relres"] <= LINK_TOL and s["asym"] <= 1e-6
                and s["min_eig"] > 0 and o[0] >= 0.1 * np.abs(o).max()
                and abs(s["step_max"] - LINK_SPEED) <= 1e-9):
            raise RuntimeError(f"19a: step {k} fails its gates: {s}")
    sim0, w0, _ = cells.runs[0]
    del cells, res
    small = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        m = FEMMesh(*slot_cell(LINK_SMALL_N), degree=2)
        small[where] = mech.open_linkage(m, mat, num_steps=LINK_STEPS,
                                         opening_speed=LINK_SPEED,
                                         tol=LINK_TOL, device=d)
    vs_cpu = max([rel_err(torch.as_tensor(a.Eh), torch.as_tensor(b.Eh))
                  for a, b in zip(small["card"].steps, small["cpu"].steps)]
                 + [rel_err(torch.as_tensor(small["card"].vertices),
                            torch.as_tensor(small["cpu"].vertices))])
    out["vs_cpu"] = vs_cpu
    log(f"19a card against CPU (slot cell grid_tri({LINK_SMALL_N}) P2, "
        f"{LINK_STEPS} steps): Eh and vertices {vs_cpu:.3e} relative")
    if not vs_cpu <= 1e-8:
        raise RuntimeError("19a: open_linkage on the card differs from the "
                           "CPU")
    return out, paths, (cell, mat, sim0, w0)


def drive_linkage_opt(dev, cell, mat, w0):
    """19b: ``optimize_linkage`` on the full-width cell, counted; dEh by
    autograd at full width (the forward and each reverse pass timed apart,
    twice equal to the bit, counted, and once under ``torch.profiler`` with
    no library scatter); identified vertices' steps equal; on the small
    cell dEh against the CPU and a directional derivative against a
    central difference of the whole pipeline on the card."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.analysis import mechanisms as mech
    from meshfem_tpu_torch.mesh import FEMMesh

    out, paths = {}, {}
    step = 0.25 / LINK_N                   # a quarter of a grid spacing
    res, wall, paths["19b_optimize_linkage"] = counted(
        "19b optimize_linkage", lambda: mech.optimize_linkage(
            cell, mat, num_steps=LINK_OPT_STEPS, step_size=step,
            tol=LINK_TOL, device=dev),
        required=PHASE19_PATH + ("element_stiffness",))
    spread = max(identified_steps_equal(cell, s.step_field)
                 for s in res.steps)
    out.update(seconds=wall, s_per_step=wall / LINK_OPT_STEPS,
               identified_spread=spread,
               min_eigenvalues=[s.min_eigenvalue for s in res.steps])
    log(f"19b optimize_linkage ({LINK_OPT_STEPS} steps of {step:g}): "
        f"{wall:.3f} s, min eigenvalues {out['min_eigenvalues']}, "
        f"identified vertices' steps spread {spread:.3e}, launches "
        f"{paths['19b_optimize_linkage']}")
    if not spread <= 1e-12:
        raise RuntimeError("19b: identified vertices took different steps")

    # dEh at full width: the forward and the fl^2 reverse passes apart
    D = mat.D
    vol = cell.bbox().volume()
    with torch.enable_grad():
        torch.cuda.synchronize()
        t0 = time.time()
        Xv = torch.tensor(cell.V, dtype=torch.float64, device=dev,
                          requires_grad=True)
        Eh = mech.energy_form_Eh(cell, D, w0, Xv, vol)
        torch.cuda.synchronize()
        t_fwd = time.time() - t0
        passes = []
        fl = Eh.shape[0]
        for k in range(fl * fl):
            t0 = time.time()
            torch.autograd.grad(Eh[k // fl, k % fl], Xv,
                                retain_graph=k < fl * fl - 1)
            torch.cuda.synchronize()
            passes.append(time.time() - t0)
        del Eh, Xv
    dEh1, wall1, c = counted(
        "19b dEh", lambda: mech.eh_vertex_differential(
            cell, D, w0, base_cell_volume=vol, device=dev),
        required=PHASE19_PATH)
    paths["19b_dEh"] = c
    dEh2 = mech.eh_vertex_differential(cell, D, w0, base_cell_volume=vol,
                                       device=dev)
    bitwise = bool(torch.equal(dEh1, dEh2))
    ops, kern = profile_kernels(lambda: mech.eh_vertex_differential(
        cell, D, w0, base_cell_volume=vol, device=dev))
    bad = sorted({n for n in ops + kern
                  if any(s in n for s in LIBRARY_SCATTERS)})
    out["dEh"] = dict(seconds=wall1, forward_s=t_fwd, reverse_pass_s=passes,
                      reverse_s=sum(passes), bitwise=bitwise,
                      gather_rows_f64=c["gather_rows/f64"],
                      segment_sum_rows_f64=c["segment_sum_rows/f64"],
                      profile=dict(ops=len(ops), kernels=len(kern),
                                   scatters=bad))
    log(f"19b dEh [{cell.num_vertices}, 2, 3, 3] at full width: "
        f"{wall1:.3f} s; the forward {t_fwd:.3f} s, {fl * fl} reverse "
        f"passes {sum(passes):.3f} s ("
        + ", ".join(f"{p * 1e3:.1f}" for p in passes) + " ms); "
        f"twice equal to the bit: {bitwise}; launches A f64 "
        f"{c['gather_rows/f64']} (the endpoint and corner gathers), B f64 "
        f"{c['segment_sum_rows/f64']} (their adjoints, two a pass); under "
        f"torch.profiler {len(ops)} operator events, {len(kern)} device "
        f"kernels, library scatters {bad}")
    if not (bitwise and c["gather_rows/f64"] == 2
            and c["segment_sum_rows/f64"] == 2 * fl * fl):
        raise RuntimeError("19b: dEh not repeatable or not on the A/B pair")
    if bad or not kern:
        raise RuntimeError(f"19b: a library scatter ran: {bad}")
    del dEh1, dEh2

    # the small cell: dEh against the CPU, and a central difference of the
    # whole pipeline (re-meshed and re-solved at V +- h delta) on the card
    V, F = slot_cell(LINK_SMALL_N)
    small = FEMMesh(V, F, degree=2)
    dEh = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        sim = hom.periodic_simulator(small, mat, device=d)
        w, _ = hom.solve_cell_problems(sim, tol=1e-12)
        dEh[where] = mech.eh_vertex_differential(small, D, w).cpu()
    vs_cpu = rel_err(dEh["card"], dEh["cpu"])
    delta = np.random.default_rng(19).standard_normal(V.shape)
    delta[np.any((V < 1e-9) | (V > 1 - 1e-9), axis=1)] = 0.0
    directional = float(np.einsum("vc,vcij->ij", delta,
                                  dEh["card"].numpy())[0, 0])

    def full_Eh00(t):
        m = FEMMesh(V + t * delta, F, degree=2)
        s = hom.periodic_simulator(m, mat, device=dev)
        wt, _ = hom.solve_cell_problems(s, tol=1e-13)
        return float(hom.homogenized_tensor_stress_form(s, wt)[0, 0])

    h = 1e-5
    fd = (full_Eh00(h) - full_Eh00(-h)) / (2 * h)
    fd_err = abs(fd - directional) / abs(fd)
    out.update(vs_cpu=vs_cpu, fd=fd, directional=directional, fd_err=fd_err)
    log(f"19b small cell (grid_tri({LINK_SMALL_N}) P2): dEh card against "
        f"CPU {vs_cpu:.3e}; along a seeded direction {directional:.9e}, "
        f"central difference of the whole pipeline (h {h:g}) {fd:.9e}, "
        f"{fd_err:.3e} relative")
    if not (vs_cpu <= 1e-9 and fd_err <= 2e-4):
        raise RuntimeError("19b: dEh disagrees on the small cell")
    return out, paths


def paraboloid_cap(n, lifted=True):
    """grid_tri(n) P1 in 3D, on z = (x - 1/2)^2 + (y - 1/2)^2 or flat."""
    from meshfem_tpu_torch.mesh import FEMMesh, generators

    V, F = generators.grid_tri(n, n)
    z = ((V - 0.5) ** 2).sum(axis=1) if lifted else np.zeros(len(V))
    return FEMMesh(np.column_stack([V, z]), F, degree=1, embedding_dim=3)


class PairingCounter:
    """Counts, while active, the calls of every conformal operator H that
    ``parametrization._conformal_operator`` builds: each is one Laplacian
    apply and one boundary area pairing, a ``ScatterPlan`` sum that
    launches kernel B in float64 once."""

    def __enter__(self):
        from meshfem_tpu_torch.analysis import parametrization as par

        self.count, self._build = 0, par._conformal_operator

        def build(*args, **kw):
            H, L, edges = self._build(*args, **kw)

            def counted_H(z):
                self.count += 1
                return H(z)
            return counted_H, L, edges

        par._conformal_operator = build
        return self

    def __exit__(self, *exc):
        from meshfem_tpu_torch.analysis import parametrization as par

        par._conformal_operator = self._build


def drive_parametrization(dev):
    """19c: ``harmonic`` and ``scp`` on paraboloid caps, ``lscm`` on the
    flat grid, each counted as a scalar path (kernel B in float64 once for
    every apply, diagonal and area pairing), the CG iterations, residuals
    and ms an iteration (host clock); the small meshes on the card against
    the CPU."""
    from meshfem_tpu_torch.analysis import parametrization as par
    from meshfem_tpu_torch.ops import operators

    out, paths = {}, {}
    cap = paraboloid_cap(HARMONIC_N)
    with CGLog() as cl:
        uv, wall, paths["19c_harmonic"] = counted_scalar(
            "19c harmonic", lambda: par.harmonic(cap, device=dev))
    r = np.linalg.norm(uv.cpu().numpy()[cap.cell.boundary_vertices()],
                       axis=1)
    sf = par.scale_factor(cap, uv)
    out["harmonic"] = dict(seconds=wall, cg=cl.runs,
                           circle_err=float(np.abs(r - 1).max()),
                           min_scale_factor=float(sf.min()))
    log(f"19c harmonic on the paraboloid cap grid_tri({HARMONIC_N}) P1 "
        f"({cap.num_nodes} nodes, {cap.num_elements} triangles): "
        f"{wall:.3f} s; CG " + ", ".join(
            f"{c['iters']} iterations to {c['relres']:.2e} in "
            f"{c['s']:.3f} s ({c['s'] / max(c['iters'], 1) * 1e3:.4f} ms "
            f"an iteration)" for c in cl.runs)
        + f"; boundary off the circle {out['harmonic']['circle_err']:.2e}, "
        f"min scale factor {out['harmonic']['min_scale_factor']:.3e}")
    if not (len(cl.runs) == 2 and all(
            c["relres"] <= 1e-11 and c["iters"] < c["maxiter"]
            for c in cl.runs)
            and out["harmonic"]["circle_err"] <= 1e-8
            and bool((sf > 0).all())):
        raise RuntimeError("19c: harmonic fails its gates")
    L1 = operators.laplacian(cap, device=dev)
    del uv, sf
    # the next grid up, to show HARMONIC_N is the largest (in steps of 8)
    # that converges within the reference's cap
    with CGLog() as cl:
        par.harmonic(paraboloid_cap(HARMONIC_N + 8), device=dev)
    out["harmonic"]["next_grid"] = dict(n=HARMONIC_N + 8, cg=cl.runs)
    log(f"19c harmonic on the next grid up, grid_tri({HARMONIC_N + 8}): "
        + ", ".join(f"{c['iters']} iterations to {c['relres']:.2e}"
                    for c in cl.runs))

    flat = paraboloid_cap(LSCM_N, lifted=False)
    with CGLog() as cl, PairingCounter() as pc:
        uv, wall, paths["19c_lscm"] = counted_scalar(
            "19c lscm", lambda: par.lscm(flat, device=dev),
            extra_sums=lambda: pc.count)
    dist = par.conformal_distortion(flat, uv)
    out["lscm"] = dict(seconds=wall, cg=cl.runs,
                       distortion_err=float((dist - 1).abs().max()))
    c = cl.runs[0]
    log(f"19c lscm on the flat grid_tri({LSCM_N}) P1: {wall:.3f} s; CG "
        f"{c['iters']} iterations to {c['relres']:.2e} "
        f"({c['s'] / max(c['iters'], 1) * 1e3:.4f} ms an iteration); "
        f"conformal distortion off 1 by {out['lscm']['distortion_err']:.2e}")
    if not (c["relres"] <= 1e-11 and c["iters"] < c["maxiter"]
            and out["lscm"]["distortion_err"] <= 1e-6):
        raise RuntimeError("19c: lscm fails its gates")
    L2 = operators.laplacian(flat, device=dev)
    del uv, dist, flat

    cap = paraboloid_cap(PARAM_N)
    with PairingCounter() as pc:
        (z, lam), wall, paths["19c_scp"] = counted_scalar(
            "19c scp", lambda: par.scp(cap, tol=0.0, maxiter=SCP_ITERS,
                                       device=dev),
            extra_sums=lambda: pc.count)
    M = operators.mass(cap, device=dev)
    Mz = M(z.contiguous())
    translations = float(Mz.sum(dim=0).abs().max() / Mz.abs().sum())
    out["scp"] = dict(seconds=wall, ms_per_iteration=wall / SCP_ITERS * 1e3,
                      eigenvalues=[float(x) for x in lam],
                      translations=translations)
    log(f"19c scp on the cap, {SCP_ITERS} LOBPCG iterations: {wall:.3f} s "
        f"({out['scp']['ms_per_iteration']:.2f} ms an iteration), "
        f"eigenvalues {out['scp']['eigenvalues']}, M-weighted mean of the "
        f"map {translations:.2e}")
    if not (bool(torch.isfinite(z).all()) and np.all(np.isfinite(lam))
            and translations <= 1e-10):
        raise RuntimeError("19c: scp fails its gates")
    del z, M, Mz

    # the small meshes on the card against the CPU
    small = paraboloid_cap(PARAM_SMALL_N)
    small_flat = paraboloid_cap(PARAM_SMALL_N, lifted=False)
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        res[where] = (par.harmonic(small, device=d).cpu(),
                      par.lscm(small_flat, device=d).cpu(),
                      par.scp(small, tol=0.0, maxiter=SCP_SMALL_ITERS,
                              device=d))
    (hc, lc, (zc, lamc)), (hh, lh, (zh, lamh)) = res["card"], res["cpu"]
    sign = 1.0 if float((zc.cpu() * zh).sum()) >= 0 else -1.0
    errs = dict(harmonic=rel_err(hc, hh), lscm=rel_err(lc, lh),
                scp=rel_err(sign * zc.cpu(), zh),
                scp_eig=float(np.abs(lamc - lamh).max()
                              / np.abs(lamh).max()))
    out["vs_cpu"] = errs
    log(f"19c card against CPU (grid_tri({PARAM_SMALL_N})): {errs}")
    if not (max(errs["harmonic"], errs["lscm"], errs["scp"]) <= 1e-8
            and errs["scp_eig"] <= 1e-10):
        raise RuntimeError("19c: parametrization on the card differs from "
                           "the CPU")
    return out, paths, (L1, L2)


def cube_sphere(n):
    """A cube's six grid_tri(n) faces, welded and projected onto the unit
    sphere: (V [6 n^2 + 2, 3], F [12 n^2, 3]), wound outward."""
    from meshfem_tpu_torch.mesh import generators

    V2, F2 = generators.grid_tri(n, n)
    s = 2.0 * V2 - 1.0
    Vs, Fs = [], []
    for axis in range(3):
        u, v = (axis + 1) % 3, (axis + 2) % 3
        for sign in (-1.0, 1.0):
            P = np.empty((len(V2), 3))
            P[:, axis], P[:, u], P[:, v] = sign, s[:, 0], s[:, 1]
            Fs.append((F2 if sign > 0 else F2[:, ::-1])
                      + sum(len(x) for x in Vs))
            Vs.append(P)
    V, F = np.concatenate(Vs), np.concatenate(Fs)
    # grid coordinates are multiples of 2/n: weld on the exact integers
    _, first, inv = np.unique(np.rint(V * n / 2).astype(np.int64), axis=0,
                              return_index=True, return_inverse=True)
    V = V[first]
    return V / np.linalg.norm(V, axis=1, keepdims=True), \
        inv.reshape(-1)[F]


def drive_curvature(dev):
    """19d: the angle deficits of the cube sphere (Gauss-Bonnet), the
    sensitivity of their sum (zero on a closed surface), the gradient of
    the sum of squared deficits against central differences and twice
    equal to the bit, each counted, all on one corner plan built once
    (its build timed, and a call that builds its own beside one that is
    handed it).  Returns (summary, launch counts per path, the plan)."""
    from meshfem_tpu_torch.analysis import curvature as curv
    from meshfem_tpu_torch.utils.fd_validation import (fd_gradient_check,
                                                       grad_of)

    out, paths = {}, {}
    t0 = time.time()
    V, F = cube_sphere(SPHERE_N)
    Vt = torch.as_tensor(V, device=dev)
    out["mesh_s"] = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    cp = curv.corner_plan(F, len(V), dev)
    cp.adjoint
    torch.cuda.synchronize()
    out["plan_s"] = time.time() - t0
    d, wall, paths["19d_deficits"] = counted(
        "19d angle_deficits", lambda: curv.angle_deficits(Vt, F, plan=cp),
        required=PHASE19_PATH)
    _, wall_own, _ = counted(
        "19d angle_deficits (own plan)", lambda: curv.angle_deficits(Vt, F),
        required=PHASE19_PATH)
    total = float(d.sum())
    K = curv.gaussian_curvature(Vt, F, plan=cp)
    # the first backward of the process starts autograd's device thread:
    # the counted call is the second
    g2, wall_first, _ = counted(
        "19d sensitivity (first)",
        lambda: curv.gaussian_curvature_sensitivity(Vt, F, plan=cp))
    g, wall_g, paths["19d_sensitivity"] = counted(
        "19d sensitivity",
        lambda: curv.gaussian_curvature_sensitivity(Vt, F, plan=cp),
        required=PHASE19_PATH)
    r = torch.as_tensor(np.random.default_rng(19).choice([-1.0, 1.0],
                                                         len(V)), device=dev)
    scale = float(grad_of(
        lambda X: (r * curv.angle_deficits(X, F, plan=cp)).sum(),
        Vt).abs().max())
    sq = lambda X: (curv.angle_deficits(X, F, plan=cp) ** 2).sum()
    gs, wall_s, paths["19d_squares"] = counted(
        "19d grad sum d^2", lambda: grad_of(sq, Vt), required=PHASE19_PATH)
    bitwise = bool(torch.equal(gs, grad_of(sq, Vt))
                   and torch.equal(g, g2))
    # central differences along unit directions over all coordinates: at
    # full width neither step reaches 1e-5 (roundoff of a sum of 393,218
    # squares ~1.4e-10 / eps, truncation ~8e6 eps^2, from grid_tri(16) -
    # (128) on the CPU), so the 1e-5 gate is held on SPHERE_FD_N's sphere
    # and the full width's error, at its best step, to 1e-3
    fd_err = fd_gradient_check(sq, Vt, eps=2e-6, n_dirs=3)
    Vs, Fs = cube_sphere(SPHERE_FD_N)
    fd_small = fd_gradient_check(
        lambda X: (curv.angle_deficits(X, Fs) ** 2).sum(),
        torch.as_tensor(Vs, device=dev), eps=1e-6, n_dirs=3)
    out.update(vertices=len(V), triangles=len(F), deficits_s=wall,
               deficits_own_plan_s=wall_own,
               sensitivity_s=wall_g, sensitivity_first_s=wall_first,
               squares_grad_s=wall_s,
               gauss_bonnet_err=abs(total - 4 * np.pi) / (4 * np.pi),
               K_range=[float(K.min()), float(K.max())],
               sensitivity_max=float(g.abs().max()), per_term_scale=scale,
               fd_err=fd_err, fd_err_small=fd_small, bitwise=bitwise)
    log(f"19d curvature on the cube sphere ({len(V)} vertices, {len(F)} "
        f"triangles, built in {out['mesh_s']:.2f} s; its corner plan and "
        f"the adjoint {out['plan_s']:.3f} s): deficits {wall:.3f} s on the "
        f"plan, {wall_own:.3f} s building their own, sum {total:.15f} "
        f"(4 pi off by {out['gauss_bonnet_err']:.2e} relative), K in "
        f"{out['K_range']}; sensitivity {wall_g:.3f} s (the process's "
        f"first backward {wall_first:.3f} s), max "
        f"{out['sensitivity_max']:.3e} beside a per-term gradient's "
        f"{scale:.3e}; grad of sum d^2 {wall_s:.3f} s, against central "
        f"differences {fd_err:.3e} (eps 2e-6; on the grid_tri("
        f"{SPHERE_FD_N}) sphere {fd_small:.3e}, eps 1e-6); twice equal to "
        f"the bit: {bitwise}")
    if not (out["gauss_bonnet_err"] <= 1e-9
            and out["sensitivity_max"] <= 1e-9 * scale
            and fd_err <= 1e-3 and fd_small <= 1e-5 and bitwise):
        raise RuntimeError("19d: curvature fails its gates")
    return out, paths, cp


def drive_mechanisms_cli(dev, tmp):
    """19e: both subcommands of ``cli.mechanisms`` on the small slot cell
    written by ``io.meshio.save_off``, on the card (counted) and on the
    CPU, each in a directory of its own: the files exist and the minimum
    eigenvalues agree to 1e-8."""
    import contextlib
    import io

    from meshfem_tpu_torch.cli import mechanisms as cli
    from meshfem_tpu_torch.io import meshio

    paths = {}
    path = os.path.join(tmp, "cell.off")
    meshio.save_off(path, *slot_cell(LINK_SMALL_N))
    expect = ("link_minEigenvalue.txt", "link_openingStrain_ellipse.txt",
              "linkopen_it_0.msh", "linkopen_it_1.msh", "opened.msh",
              "vertical_linkage_it0.msh")
    eigs, secs = {}, {}
    for where, d in (("card", str(dev)), ("cpu", "cpu")):
        wd = os.path.join(tmp, where)
        os.makedirs(wd)
        cwd = os.getcwd()
        os.chdir(wd)
        try:
            runs = {}
            for sub, args, req in (
                    ("open", ["open", "link", path, "-n", "2", "-s",
                              "0.002", "--outputFreq", "1", "-d", "2"],
                     ("segment_sum_rows",)),
                    ("optimize", ["optimize", path, "-n", "1"],
                     PHASE19_PATH)):
                buf = io.StringIO()
                fn = lambda: cli.main(args + ["--device", d])
                with contextlib.redirect_stdout(buf):
                    if where == "card":
                        _, t, paths[f"19e_cli_{sub}"] = counted(
                            f"19e cli.mechanisms {sub}", fn, required=req)
                    else:
                        t0 = time.time()
                        fn()
                        t = time.time() - t0
                runs[sub] = (buf.getvalue(), t)
            missing = [f for f in expect if not os.path.exists(f)]
            with open("link_minEigenvalue.txt") as fh:
                opened = [float(x) for x in fh.read().split()]
        finally:
            os.chdir(cwd)
        if missing:
            raise RuntimeError(f"19e ({where}): missing files {missing}")
        optimized = [float(line.split()[3]) for line in
                     runs["optimize"][0].splitlines()
                     if line.startswith("Minimum Eh eigenvalue")]
        eigs[where] = opened + optimized
        secs[where] = {k: v[1] for k, v in runs.items()}
    err = float(np.abs(np.subtract(eigs["card"], eigs["cpu"])).max()
                / np.abs(eigs["cpu"]).max())
    log(f"19e cli.mechanisms open (2 steps) and optimize (1 step) on the "
        f"grid_tri({LINK_SMALL_N}) slot cell: seconds {secs}; minimum "
        f"eigenvalues {eigs['card']}, card against CPU {err:.3e}")
    if not (len(eigs["card"]) == 3 and err <= 1e-8):
        raise RuntimeError("19e: the CLI's eigenvalues differ")
    return dict(seconds=secs, eigenvalues=eigs["card"], vs_cpu=err), paths


def drive_phase19(dev, gen):
    """Phase 19a-e; returns (summary, launch counts per path, the objects
    19f checks and times kernels on)."""
    import tempfile

    out, paths, parts = {}, {}, {}
    t0 = time.time()

    def part(key, fn, *args):
        t = time.time()
        res = fn(*args)
        parts[key] = time.time() - t
        paths.update(res[1])
        return res

    out["open_linkage"], _, (cell, mat, sim0, w0) = part(
        "19a", drive_linkage, dev)
    out["optimize_linkage"], _ = part("19b", drive_linkage_opt, dev, cell,
                                      mat, w0)
    out["parametrization"], _, (L1, L2) = part("19c", drive_parametrization,
                                               dev)
    out["curvature"], _, cp = part("19d", drive_curvature, dev)
    with tempfile.TemporaryDirectory() as tmp:
        out["cli"], _ = part("19e", drive_mechanisms_cli, dev, tmp)
    out["parts_s"] = parts
    out["phase_s"] = time.time() - t0
    log(f"phase 19 (19a-e): {out['phase_s']:.1f} s, by part "
        + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return out, paths, (cell, sim0, L1, L2, cp)


def kernels_phase19(dev, entry, objs, paths, gen):
    """19f: kernels A, B and E on the plans phase 19 made, each held
    against its plain version (A exactly; B bit for bit against B in
    planes and the CPU's plain sum, 1e-12 of max|y| against the card's
    plain sum; E within one float32 ulp of the float64 ``Ke`` of its own
    inputs) and timed with ``entry``: B f64 at 1 value on the EBE plan of
    harmonic's Laplacian and at 2 on lscm's, A and B f64 on the 19d
    corner plan (A at 3 values, its adjoint B at 1, both ways), A on the
    endpoint plan of
    ``node_positions_from_vertices`` and B as its adjoint (2 values), E on
    the 19a cell's geometry."""
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.ops import element_matrices as em

    cell, sim0, L1, L2, cp = objs
    f64 = torch.float64
    out = {}
    src_dir = "meshfem_tpu_torch/csrc/"

    def f64_launches(prefix, name):
        return sum(c[f"{name}/f64"] for p, c in paths.items()
                   if p.startswith(prefix))

    def b_entry(tag, plan, P, launches, launches_path, replaces, mode):
        err = check_rows_on_plan(plan, f64, f"19f B f64 rows ({tag})", gen,
                                 P=P)
        R, N = plan.num_rows, plan.num_segments
        src = torch.randn((R, P), generator=gen, device=dev, dtype=f64)
        acc = torch.zeros((N, P), device=dev, dtype=f64)
        dst = plan.ids.long()
        entry(f"segment_sum_rows/f64/{P}/{tag}",
              src_dir + "segment_sum_csr.cu", replaces, launches, err,
              lambda: plan.sum_rows(src),
              lambda: kernels.segment_sum_rows_plain(src, plan.perm,
                                                     plan.offsets),
              lambda: acc.index_add_(0, dst, src),
              P * R * 8 + R * 4 + (N + 1) * 4 + P * N * 8, P * R,
              flop_rate=F64_FLOP_PER_S, mode=mode,
              launches_path=launches_path,
              library_call="Tensor.index_add_ (float atomics)",
              shape=f"src [{R}, {P}] f64 -> [{N}, {P}]")
        return err

    def a_entry(tag, plan, P, launches, launches_path, replaces, mode):
        ids = plan.ids
        src = torch.randn((plan.num_sources, P), generator=gen, device=dev,
                          dtype=f64)
        y = kernels.gather_rows(src, ids)
        if not (torch.equal(y, kernels.gather_rows_plain(src, ids))
                and torch.equal(y.cpu(), kernels.gather_rows_plain(
                    src.cpu(), ids.cpu()))):
            raise RuntimeError(f"19f: gather_rows f64 ({tag}) != plain")
        S = ids.shape[0]
        ids_long = ids.long()
        entry(f"gather_rows/f64/{P}/{tag}", src_dir + "gather_planes.cu",
              replaces, launches, 0.0,
              lambda: kernels.gather_rows(src, ids),
              lambda: kernels.gather_rows_plain(src, ids),
              lambda: torch.index_select(src, 0, ids_long),
              S * 4 + plan.num_sources * P * 8 + S * P * 8, 0, mode=mode,
              launches_path=launches_path, library_call="torch.index_select",
              shape=f"src [{plan.num_sources}, {P}] f64, ids [{S}] int32")

    # B on the 19c Laplacians' plans: harmonic's at 1 value, lscm's at 2
    for P, path, lap in ((1, "19c_harmonic", L1), (2, "19c_lscm", L2)):
        out[f"param_{P}"] = b_entry(
            "parametrization", lap._kernel.plan, P, f64_launches(path,
                                                     "segment_sum_rows"),
            f"{path}, float64 launches (every L and M apply, diagonal and "
            f"area pairing: the whole path's)",
            "meshfem_tpu/sparse/route.py:207 (f64: the XLA scatter of "
            "meshfem_tpu/sparse/ebe.py, the Laplacian's applies in "
            "meshfem_tpu/analysis/parametrization.py)",
            f"f64 rows [E n, {P}] -> [N, {P}]: the scalar EBE apply of "
            f"{'one column' if P == 1 else 'u and v together'}")
    # A and B on the 19d corner plan: V[F] (A, 3 values) and the vertex
    # sums (B, 1 value), each the other's adjoint in the gradient
    out["curv_b1"] = b_entry(
        "curvature", cp.adjoint, 1,
        f64_launches("19d", "segment_sum_rows"),
        "19d deficits, sensitivity and grad sum d^2, float64 launches "
        "(the vertex sums, and the corner gather's adjoint at 3 values)",
        "meshfem_tpu/sparse/route.py:207 (f64: the .at[F].add of "
        "meshfem_tpu/analysis/curvature.py:38,72)",
        "f64 rows [3 E, 1] -> [Nv, 1]: the angle sums into vertices")
    check_rows_on_plan(cp.adjoint, f64, "19f B f64 rows (curvature, 3 "
                       "values: the corner gather's adjoint)", gen, P=3)
    a_entry("curvature", cp, 3, f64_launches("19d", "gather_rows"),
            "19d deficits, sensitivity and grad sum d^2, float64 launches "
            "(the corner gathers, and the vertex sums' adjoint at 1 value)",
            "meshfem_tpu/sparse/route.py:139 (f64: the V[F] gather of "
            "meshfem_tpu/analysis/curvature.py:18, and the transpose of "
            ".at[F].add under jax.grad)",
            "f64 rows [Nv, 3] -> [3 E, 3]: the corner positions")
    src1 = torch.randn((cp.num_sources, 1), generator=gen, device=dev,
                       dtype=f64)
    if not torch.equal(kernels.gather_rows(src1, cp.ids),
                       kernels.gather_rows_plain(src1, cp.ids)):
        raise RuntimeError("19f: gather_rows f64 (curvature, 1 value) != "
                           "plain")
    # A on the endpoint plan of node_positions_from_vertices, B its adjoint
    ep = cell.endpoint_gather(dev)
    a_entry("linkage", ep, 2, f64_launches("19b", "gather_rows"),
            "19b optimize_linkage and dEh, float64 launches (the endpoint "
            "and corner gathers)",
            "meshfem_tpu/sparse/route.py:139 (f64: the Xv[ends] gather of "
            "meshfem_tpu/mesh/femmesh.py:247)",
            "f64 rows [Nv, 2] -> [2 N, 2]: P2 node positions from vertices")
    out["link_b2"] = b_entry(
        "linkage", ep.adjoint, 2, f64_launches("19b", "segment_sum_rows"),
        "19b optimize_linkage and dEh, float64 launches (the gathers' "
        "adjoints and the EBE residuals)",
        "meshfem_tpu/sparse/route.py:162 (f64: the transpose of the "
        "Xv[ends] gather under jax.jacrev)",
        "f64 rows [2 N, 2] -> [Nv, 2]: dEh's sum into vertices")
    # E on the 19a cell's geometry
    g32 = sim0.geom.grad_lambda.float().contiguous()
    v32 = sim0.geom.volume.float().contiguous()
    D_host = sim0.D.cpu()
    Ke32 = kernels.element_stiffness(g32, v32, D_host, 2)
    e_ref = kernels.element_stiffness_plain(g32, v32, D_host, 2)
    scale = float(e_ref.abs().max())
    err_e = float((Ke32 - e_ref).abs().max())
    ulps = ulps_from(Ke32, em.element_elasticity_fused(
        g32.double(), v32.double(), sim0.D, 2))
    del Ke32, e_ref
    log(f"19f E on the slot cell ({cell.num_elements} triangles): max abs "
        f"err {err_e:.3e} against plain (max|Ke| {scale:.3e}), {ulps:.3f} "
        f"ulp of each entry from the f64 Ke of the same float32 inputs")
    if not (err_e <= 1e-5 * scale and ulps <= 1.0):
        raise RuntimeError("19f: element_stiffness on the slot cell "
                           "disagrees")
    E, K1, d, nn = cell.num_elements, 3, 2, 6
    nd = nn * d
    M32 = torch.as_tensor(em.fused_matrix_for(sim0.D, 2, 2),
                          dtype=torch.float32, device=dev)
    entry("element_stiffness/linkage", src_dir + "element_stiffness.cu",
          "meshfem_tpu/kernels/element_stiffness.py:42",
          sum(c["element_stiffness"] for p, c in paths.items()
              if p.startswith(("19a", "19b"))), err_e,
          lambda: kernels.element_stiffness(g32, v32, D_host, 2),
          lambda: kernels.element_stiffness_plain(g32, v32, D_host, 2),
          lambda: em.element_elasticity_fused_apply(g32, v32, M32, nn),
          (K1 * d + 1 + nd * nd) * E * 4 + 9 * 8,
          (2 * ((K1 * d) ** 2 * d * d + nd * nd * K1 * K1) + nd * nd) * E,
          algorithm_flops=(2 * (K1 * (K1 + 1) // 2 * (d * d + d ** 4)
                                + nd * nd * K1 * K1) + nd * nd) * E,
          algorithm_flop_rate=F64_FLOP_PER_S, max_ulps_vs_f64=ulps,
          mode="f32 Ke [E, 12, 12] of a linkage step's cell, one per dense "
               "routed operator build",
          launches_path="19a open_linkage and 19b optimize_linkage (one a "
                        "step)",
          library_call="ops.element_matrices.element_elasticity_fused_apply",
          shape=f"slot cell grid_tri({LINK_N}) P2: grad_lambda [{E}, 3, 2], "
                f"vol [{E}] f32")
    out.update(E_err=err_e, E_ulps=ulps)
    out["checked"] = ["segment_sum_rows/f64/1/parametrization",
                      "segment_sum_rows/f64/2/parametrization",
                      "segment_sum_rows/f64/1/curvature",
                      "gather_rows/f64/3/curvature",
                      "gather_rows/f64/2/linkage",
                      "segment_sum_rows/f64/2/linkage",
                      "element_stiffness/linkage"]
    return out


# ---------------------------------------------------------------------------
# Phase 20: the host tools on the card: the port's host core, a quality
# mesh solved on the card, the field sampler, and the mesh tool CLIs
# ---------------------------------------------------------------------------

# the unit square with two square holes, meshed by Ruppert refinement at
# QUALITY_AREA (>= 100,000 triangles at 25 degrees)
QUALITY_HOLES = (((0.2, 0.2), (0.4, 0.4)), ((0.6, 0.55), (0.8, 0.75)))
QUALITY_ANGLE = 25.0
QUALITY_AREA = 8e-6
QUALITY_MIN_TRIANGLES = 100_000
SAMPLE_POINTS = 20_000            # located and timed
SAMPLE_CHECKED = 2_000            # of them, sampled and gated
HOLE_POINTS = 10                  # located in the holes, timed
SAMPLE_AT = (0.5, 0.5)            # msh_processor's sample: point
# 20d's isotropic_validation cell: the quadrant [0, 1/2]^2 without a
# quarter disc of radius CELL_VOID_R about (1/2, 1/2), quality-meshed at
# CELL_AREA and reflected in x and y (a periodic cell, >= 50,000 triangles)
CELL_VOID_R = 0.2
CELL_ARC = 64
CELL_AREA = 1.5e-5
CELL_MIN_TRIANGLES = 50_000
CONVERT_FLAGS = ("--reflect", "x", "--clean", "--reorient", "--sortElements")
CARD = ""                         # the card's name and power limit


def card_log(*args):
    """A phase-20 line, the card's name and power limit beside it."""
    log(*args, f"[{CARD}]")


def square_pslg():
    """(outline, holes) of 20b's domain, each counter-clockwise."""
    outline = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    holes = [np.asarray([[a, b], [c, b], [c, d], [a, d]])
             for (a, b), (c, d) in QUALITY_HOLES]
    return outline, holes


def quadrant_outline():
    """The quadrant without its quarter disc, counter-clockwise."""
    r = CELL_VOID_R
    phi = np.linspace(1.5 * np.pi, np.pi, CELL_ARC + 1)[1:-1]
    arc = 0.5 + r * np.stack([np.cos(phi), np.sin(phi)], axis=1)
    return np.vstack([[[0.0, 0.0], [0.5, 0.0], [0.5, 0.5 - r]], arc,
                      [[0.5 - r, 0.5], [0.0, 0.5]]])


def triangle_quality(V, F):
    """(min angle in degrees, areas) of a triangle mesh."""
    X = V[F]
    a, b = X[:, 1] - X[:, 0], X[:, 2] - X[:, 0]
    areas = 0.5 * (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0])
    angles = []
    for i in range(3):
        u = X[:, (i + 1) % 3] - X[:, i]
        v = X[:, (i + 2) % 3] - X[:, i]
        c = (u * v).sum(1) / np.sqrt((u * u).sum(1) * (v * v).sum(1))
        angles.append(np.degrees(np.arccos(np.clip(c, -1, 1))))
    return float(np.min(angles)), areas


def write_poly(path, loops):
    """A Triangle .poly of closed loops (1-based), no hole points."""
    pts = np.vstack(loops)
    lines = [f"{len(pts)} 2 0 0"]
    lines += [f"{i + 1} {x:.17g} {y:.17g}" for i, (x, y) in enumerate(pts)]
    segs, base = [], 0
    for loop in loops:
        n = len(loop)
        segs += [(base + i + 1, base + (i + 1) % n + 1) for i in range(n)]
        base += n
    lines.append(f"{len(segs)} 0")
    lines += [f"{k + 1} {a} {b}" for k, (a, b) in enumerate(segs)]
    lines.append("0")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def run_main(main, argv):
    """A CLI's ``main(argv)`` in this process; returns what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def run_module(module, argv):
    """``python -m module argv`` in a child process from the repository
    root; returns (stdout, seconds)."""
    t0 = time.time()
    res = subprocess.run([sys.executable, "-m", module, *argv],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if res.returncode != 0:
        raise RuntimeError(f"python -m {module} failed ({res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    return res.stdout, time.time() - t0


def printed_value(text, prefix):
    """The number after ``prefix: `` on the line that starts with it."""
    for line in text.splitlines():
        if line.startswith(prefix + ":"):
            return float(line.rsplit(" ", 1)[-1])
    raise RuntimeError(f"no line {prefix!r} in {text!r}")


def drive_hostcore(dev, core_s):
    """20a: the bench mesh's P2 numbering with the host core and without
    (``MESHFEM_TORCH_NO_NATIVE=1``), equal to the bit, host seconds each;
    the core's Morton codes of the bench nodes against
    ``reorder._morton_codes``."""
    from meshfem_tpu_torch import native
    from meshfem_tpu_torch.mesh import FEMMesh, generators
    from meshfem_tpu_torch.mesh.reorder import _morton_codes

    V, T = generators.grid_tet(BENCH_N, BENCH_N, BENCH_N)
    t0 = time.time()
    with_core = FEMMesh(V, T, degree=2)
    t_core = time.time() - t0
    os.environ["MESHFEM_TORCH_NO_NATIVE"] = "1"
    try:
        t0 = time.time()
        without = FEMMesh(V, T, degree=2)
        t_numpy = time.time() - t0
    finally:
        del os.environ["MESHFEM_TORCH_NO_NATIVE"]
    same = {name: bool(np.array_equal(getattr(with_core, name),
                                      getattr(without, name)))
            for name in ("elem_nodes", "node_positions", "bdry_elems",
                         "bdry_elem_nodes")}
    same["half_face_opposites"] = bool(np.array_equal(with_core.cell.O,
                                                      without.cell.O))
    card_log(f"20a host core: built in {core_s:.3f} s; FEMMesh(grid_tet("
             f"{BENCH_N})) P2 ({with_core.num_elements} tets, "
             f"{with_core.num_nodes} nodes) {t_core:.3f} s with the core, "
             f"{t_numpy:.3f} s with MESHFEM_TORCH_NO_NATIVE=1 (host "
             f"seconds); equal to the bit: {same}")
    if not all(same.values()) \
            or with_core.num_nodes != (2 * BENCH_N + 1) ** 3:
        raise RuntimeError(f"20a: the host core's mesh differs: {same}")
    X = with_core.node_positions
    d, nb = 3, 21
    lo, span = X.min(axis=0), np.maximum(X.max(axis=0) - X.min(axis=0),
                                         1e-300)
    q = np.minimum(((X - lo) / span * ((1 << nb) - 1)).astype(np.uint64),
                   (1 << nb) - 1)
    t0 = time.time()
    codes = native.morton_codes(q, nb)
    t_mc = time.time() - t0
    t0 = time.time()
    ref = _morton_codes(X)
    t_np = time.time() - t0
    ok = codes is not None and bool(np.array_equal(codes, ref))
    card_log(f"20a morton_codes of the {len(X)} bench nodes: core "
             f"{t_mc:.4f} s, numpy {t_np:.4f} s, equal: {ok}")
    if not ok:
        raise RuntimeError("20a: the core's Morton codes differ")
    return dict(core_build_s=core_s, femmesh_core_s=t_core,
                femmesh_numpy_s=t_numpy, equal=same, morton_core_s=t_mc,
                morton_numpy_s=t_np), with_core


def drive_quality_solve(dev):
    """20b: Ruppert quality mesh of the unit square with two square holes
    (the reference test's gates), ``FEMMesh`` P2, x = 0 clamped and x = 1
    loaded, solved by the default 2D call; the f64 relative residual."""
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg
    from meshfem_tpu_torch.physics import (ElasticitySimulator, Material,
                                           parse_bc)

    outline, holes = square_pslg()
    (V, F), t_tri = timed(lambda: triangulate_pslg(
        outline, holes=holes, target_area=QUALITY_AREA,
        min_angle=QUALITY_ANGLE, quality=True))
    amin, areas = triangle_quality(V, F)
    want = 1.0 - sum((c - a) * (d - b) for (a, b), (c, d) in QUALITY_HOLES)
    area_err = abs(float(areas.sum()) - want)
    card_log(f"20b triangulate_pslg(quality=True, min_angle "
             f"{QUALITY_ANGLE}, area {QUALITY_AREA:g}): {len(F)} triangles, "
             f"{len(V)} vertices in {t_tri:.3f} s (host); min angle "
             f"{amin:.4f} deg, areas in [{areas.min():.3e}, "
             f"{areas.max():.3e}], sum - exact {area_err:.3e}")
    if not (len(F) >= QUALITY_MIN_TRIANGLES
            and amin >= QUALITY_ANGLE - 1e-6 and areas.min() > 0
            and areas.max() <= QUALITY_AREA + 1e-12 and area_err < 1e-9):
        raise RuntimeError("20b: the quality mesh misses a gate")
    mesh, t_mesh = timed(lambda: FEMMesh(V, F, degree=2))
    sim, t_sim = timed(lambda: ElasticitySimulator(
        mesh, Material.isotropic(2, E_2D, NU_2D), device=dev))
    sim.apply_boundary_conditions(parse_bc(CANTILEVER_2D_BC, dim=2))
    label = f"20b quality mesh P2 ({mesh.num_elements} triangles)"
    u, res, wall, counts, applies = counted_solve(
        sim, f"{label}, the default call", ROWS_2D, tol=1e-10)
    relres = check_solution(sim, u, label)
    card_log(f"{label}: FEMMesh P2 {t_mesh:.3f} s ({mesh.num_nodes} nodes, "
             f"host), simulator {t_sim:.3f} s, the default call {wall:.3f} "
             f"s, {res.rounds} rounds, {res.iters} inner iterations, round "
             f"history {[(f'{r:.2e}', i) for r, i in res.history]}, f64 "
             f"relres {relres:.3e}; launches A {counts['gather_rows']}, B "
             f"{counts['segment_sum_rows']}, E {counts['element_stiffness']}")
    out = dict(triangles=len(F), vertices=len(V), nodes=mesh.num_nodes,
               min_angle=amin, max_area=float(areas.max()),
               area_err=area_err, triangulate_s=t_tri, femmesh_s=t_mesh,
               simulator_s=t_sim, solve_s=wall, rounds=res.rounds,
               inner_iters=res.iters, history=list(res.history),
               relres=relres, applies=applies)
    return out, {"20b": counts}, sim, u


def drive_sampler(dev, sim, u, tmp):
    """20c: ``FieldSampler`` on the 20b mesh (build, ``locate`` of
    SAMPLE_POINTS seeded points, the P2 field x^2 - y exact inside the
    domain, ``sample_nodal`` on the card against ``sample_matrix``), then
    ``cli.msh_processor`` on the solution written by ``save_msh``, each
    printed or written number against the same quantity computed here on
    the card."""
    from meshfem_tpu_torch.analysis.field_sampler import FieldSampler
    from meshfem_tpu_torch.cli import msh_processor
    from meshfem_tpu_torch.io import meshio, msh_fields
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.physics.elasticity import von_mises

    mesh = sim.mesh
    fs, t_build = timed(lambda: FieldSampler(mesh))
    # seeded points in the domain, and a few in its holes: a point whose
    # bucket holds no element is tested against every element (the
    # reference's fallback), ~1e3 times the cost of one in the domain
    rng = np.random.default_rng(20)
    cand = rng.random((2 * SAMPLE_POINTS, 2))
    in_hole = np.zeros(len(cand), dtype=bool)
    for (a, b), (c, d) in QUALITY_HOLES:
        in_hole |= ((cand[:, 0] > a - 1e-9) & (cand[:, 0] < c + 1e-9)
                    & (cand[:, 1] > b - 1e-9) & (cand[:, 1] < d + 1e-9))
    pts = cand[~in_hole][:SAMPLE_POINTS]
    _, t_loc = timed(lambda: fs.locate(pts))
    holes_pts = cand[in_hole][:HOLE_POINTS]
    _, t_hole = timed(lambda: fs.locate(holes_pts))
    # the gates sample the first SAMPLE_CHECKED points (each sample call
    # locates its points again, at the same Python-loop cost)
    sub = pts[:SAMPLE_CHECKED]
    X = torch.as_tensor(mesh.node_positions, device=dev)
    f = X[:, 0] ** 2 - X[:, 1]
    fv = fs.sample_nodal(f, sub)
    exact = torch.as_tensor(sub[:, 0] ** 2 - sub[:, 1], device=dev)
    err_f = float((fv - exact).abs().max())
    (us, t_sample) = timed(lambda: fs.sample_nodal(u, sub))
    S = fs.sample_matrix(sub)
    us_host = S @ u.cpu().numpy()
    err_u = float(np.abs(us.cpu().numpy() - us_host).max()
                  / np.abs(us_host).max())
    card_log(f"20c FieldSampler on {mesh.num_elements} P2 triangles: build "
             f"{t_build:.3f} s, locate of {len(pts)} points in the domain "
             f"{t_loc:.3f} s ({t_loc / len(pts) * 1e6:.1f} us a point), of "
             f"{len(holes_pts)} in its holes {t_hole:.3f} s "
             f"({t_hole / len(holes_pts) * 1e6:.1f} us a point), "
             f"sample_nodal(u) at {len(sub)} {t_sample:.3f} s (host "
             f"seconds); x^2 - y there max abs err {err_f:.3e}; "
             f"sample_nodal(u on the card) against sample_matrix @ u "
             f"{err_u:.3e} relative")
    if not (err_f <= 1e-12 and err_u <= 1e-12 and us.device == u.device):
        raise RuntimeError("20c: the field sampler misses a gate")

    # the solution on the P1 mesh of the vertices (msh_processor builds
    # its geometry from the file's elements), with the element stresses
    nv = mesh.num_vertices
    uv = u[:nv]
    stress = sim.average_stress_field(u)
    path = os.path.join(tmp, "solution.msh")
    out_path = os.path.join(tmp, "vm.msh")
    meshio.save_msh(path, mesh.V, mesh.F, fields=[
        {"name": "u", "data": uv.cpu().numpy(), "where": "node",
         "kind": "vector"},
        {"name": "stress", "data": stress.cpu().numpy(),
         "where": "element", "kind": "vector"}])
    x, y = SAMPLE_AT
    argv = [path, "-e", "u", "norm", "max", "print",
            "-e", "stress", "vonMises", "smoothedElementField",
            "elementAverage", f"outMSH:{out_path}",
            "-e", "u", f"sample:{x!r},{y!r}", "norm", "print",
            "--device", str(dev)]
    text, t_cli, paths = counted("20c msh_processor",
                                 lambda: run_main(msh_processor.main, argv))
    # the same quantities here on the card
    p1 = FEMMesh(mesh.V, mesh.F)
    Ft = torch.as_tensor(mesh.F, device=dev)
    vm = von_mises(stress, 2)
    vol = p1.geometry(dev).volume
    w = torch.zeros(nv, dtype=vol.dtype, device=dev)
    acc = torch.zeros(nv, dtype=vol.dtype, device=dev)
    for c in range(3):
        w.index_add_(0, Ft[:, c], vol)
        acc.index_add_(0, Ft[:, c], vm * vol)
    vm_elem = (acc / w)[Ft].mean(dim=1)
    unorm = float(torch.linalg.vector_norm(uv, dim=1).max())
    at = FieldSampler(p1).sample_nodal(uv, [[x, y]])[0]
    errs = dict(
        norm_max=abs(printed_value(text, "max(norm(u))") - unorm)
        / abs(unorm),
        sample_norm=abs(printed_value(text, "norm(sample(u))")
                        - float(torch.linalg.vector_norm(at)))
        / float(torch.linalg.vector_norm(at)))
    got = msh_fields.read_fields(out_path)
    got = got["elementAverage(smoothed(vonMises(stress)))"]["data"][:, 0]
    errs["vonMises_elementAverage"] = float(
        np.abs(got - vm_elem.cpu().numpy()).max()
        / float(vm_elem.abs().max()))
    card_log(f"20c msh_processor (norm max, vonMises smoothedElementField "
             f"elementAverage outMSH, sample:{x},{y} norm; --device "
             f"{dev}): {t_cli:.3f} s; against the card here: "
             + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if not max(errs.values()) <= 1e-12:
        raise RuntimeError(f"20c: msh_processor differs: {errs}")
    return dict(build_s=t_build, locate_s=t_loc, points=len(pts),
                locate_us_per_point=t_loc / len(pts) * 1e6,
                hole_points=len(holes_pts),
                hole_us_per_point=t_hole / len(holes_pts) * 1e6,
                sampled_points=len(sub), sample_nodal_s=t_sample,
                x2_minus_y_err=err_f, sample_vs_matrix=err_u,
                msh_processor_s=t_cli, msh_processor_errs=errs), \
        {"20c_msh_processor": paths}


def drive_tool_clis(dev, bench, tmp):
    """20d: ``mesh_convert`` on the bench mesh against the in-process
    filters (bit for bit), ``tools triangulate`` on a .poly, and ``tools
    isotropic_validation`` on a quality-meshed reflected cell, homogenized
    on the card, against ``homogenize`` here (1e-12)."""
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.cli import tools
    from meshfem_tpu_torch.fem import tensor_projection
    from meshfem_tpu_torch.io import meshio
    from meshfem_tpu_torch.mesh import FEMMesh, filters
    from meshfem_tpu_torch.mesh.triangulate import triangulate_pslg
    from meshfem_tpu_torch.physics import Material

    out, paths = {}, {}
    src, dst = os.path.join(tmp, "bench.msh"), os.path.join(tmp, "conv.msh")
    meshio.save_msh(src, bench.V, bench.F)
    text, t_conv = run_module("meshfem_tpu_torch.cli.mesh_convert",
                              [src, dst, *CONVERT_FLAGS])
    # the CLI's order: --clean and --reorient, then --reflect, then the sort
    V, F = meshio.load(src)
    V, F = filters.merge_duplicate_vertices(V, F, eps=1e-12)
    V, F = filters.remove_dangling_vertices(V, F)
    V, F = filters.reorient_negative_elements(V, F)
    V, F = filters.reflect(V, F, axes=[0])
    F = F[np.lexsort(tuple(F[:, c] for c in range(F.shape[1] - 1, -1, -1)))]
    Vc, Fc = meshio.load(dst)
    same = bool(np.array_equal(Vc, V) and np.array_equal(Fc, F))
    card_log(f"20d mesh_convert {' '.join(CONVERT_FLAGS)} on the bench mesh "
             f"({len(bench.F)} tets): {t_conv:.3f} s (python -m, host); "
             f"{len(Fc)} tets, {len(Vc)} vertices, equal to the in-process "
             f"filters to the bit: {same}")
    if not same or len(Fc) != 2 * len(bench.F):
        raise RuntimeError("20d: mesh_convert differs from the filters")
    out["mesh_convert"] = dict(s=t_conv, tets=len(Fc), vertices=len(Vc),
                               bitwise=same)

    outline, holes = square_pslg()
    poly, tri_out = os.path.join(tmp, "plate.poly"), os.path.join(tmp,
                                                                  "t.msh")
    write_poly(poly, [outline, *holes])
    text, t_tri = timed(lambda: run_main(tools.main, [
        "triangulate", poly, "--area", "1e-4", "-o", tri_out]))
    Vt, Ft = meshio.load(tri_out)
    Vr, Fr = triangulate_pslg(outline, holes=holes, target_area=1e-4)
    same_t = bool(np.array_equal(Vt[:, :2], Vr) and np.array_equal(Ft, Fr))
    card_log(f"20d tools triangulate: {t_tri:.3f} s (host), "
             f"{len(Ft)} triangles, equal to triangulate_pslg: {same_t}")
    if not same_t:
        raise RuntimeError("20d: tools triangulate differs")
    out["triangulate"] = dict(s=t_tri, triangles=len(Ft), bitwise=same_t)

    (Vq, Fq), t_q = timed(lambda: triangulate_pslg(
        quadrant_outline(), target_area=CELL_AREA, min_angle=QUALITY_ANGLE))
    Vq, Fq = filters.reflect(Vq, Fq)
    cell_path = os.path.join(tmp, "cell.msh")
    meshio.save_msh(cell_path, Vq, Fq)
    card_log(f"20d the isotropic_validation cell: a quadrant meshed in "
             f"{t_q:.3f} s and reflected in x and y: {len(Fq)} triangles")
    if len(Fq) < CELL_MIN_TRIANGLES:
        raise RuntimeError("20d: the cell is too small")
    argv = ["isotropic_validation", cell_path, "--young", str(E_2D),
            "--poisson", str(NU_2D), "--device", str(dev)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        text, t_iso, paths["20d_isotropic_validation"] = counted(
            "20d tools isotropic_validation",
            lambda: run_main(tools.main, argv), ROWS_2D)
        mat = Material.isotropic(2, E_2D, NU_2D)
        Vl, Fl = meshio.load(cell_path)
        r, t_hom, paths["20d_homogenize"] = counted(
            "20d homogenize", lambda: hom.homogenize(
                FEMMesh(Vl[:, :2], Fl, degree=2), mat, device=dev),
            ROWS_2D)
    body = text.split("homogenized tensor:")[1].split("relative")[0]
    printed = np.asarray([float(t) for t in
                          body.replace("[", " ").replace("]", " ").split()])
    Ch = r.Ch.cpu().numpy()
    err = float(np.abs(printed.reshape(3, 3) - Ch).max()
                / np.abs(Ch).max())
    dist = float(tensor_projection.isotropy_distance(r.Ch))
    d_err = abs(printed_value(text, "relative isotropy distance") - dist) \
        / dist
    card_log(f"20d tools isotropic_validation (P2, {len(Fq)} triangles, "
             f"--device {dev}): {t_iso:.3f} s, homogenize here {t_hom:.3f} "
             f"s; printed tensor against homogenize {err:.3e} of max|Ch|, "
             f"distance {dist:.6g} ({d_err:.1e} at its 6 printed digits); "
             f"block CG iterations {r.cg_iters}")
    if not (err <= 1e-12 and d_err <= 1e-5):
        raise RuntimeError("20d: isotropic_validation differs")
    out["isotropic_validation"] = dict(
        s=t_iso, homogenize_s=t_hom, triangles=len(Fq), err=err,
        distance=dist, Ch=Ch.tolist(), cg_iters=list(r.cg_iters),
        quadrant_s=t_q)
    return out, paths


def drive_phase20(dev, core_s):
    """Phase 20a-d; returns (summary, launch counts per path, the 20b
    simulator that 20e checks kernels on)."""
    import tempfile

    out, paths, parts = {}, {}, {}
    t0 = time.time()
    t = time.time()
    out["host_core"], bench = drive_hostcore(dev, core_s)
    parts["20a"] = time.time() - t
    t = time.time()
    out["quality_solve"], p, sim, u = drive_quality_solve(dev)
    paths.update(p)
    parts["20b"] = time.time() - t
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        out["sampler"], p = drive_sampler(dev, sim, u, tmp)
        paths.update(p)
        parts["20c"] = time.time() - t
        t = time.time()
        out["clis"], p = drive_tool_clis(dev, bench, tmp)
        paths.update(p)
        parts["20d"] = time.time() - t
    out["parts_s"] = parts
    out["phase_s"] = time.time() - t0
    card_log(f"phase 20 (20a-d): {out['phase_s']:.1f} s, by part "
             + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    return out, paths, sim


def kernels_phase20(dev, entry, sim, paths, gen):
    """20e: kernels A, B and E at the 20b quality mesh's shapes, each held
    against its plain version (A exactly; B in f32 rows bit for bit
    against B in planes and to 1e-5 of its plain version, in f64 to
    1e-12; E within one float32 ulp of the float64 ``Ke`` of its own
    inputs) and timed with ``entry``."""
    from meshfem_tpu_torch import kernels
    from meshfem_tpu_torch.ops import element_matrices as em

    src_dir = "meshfem_tpu_torch/csrc/"
    A_TPU, B_TPU = ("meshfem_tpu/sparse/route.py:139",
                    "meshfem_tpu/sparse/route.py:162")
    counts = paths["20b"]
    launches = lambda name: own_mode(counts, name)
    rk = sim.routed_kernel()
    E, N, nn, d, K1 = (sim.mesh.num_elements, sim.num_dofs,
                       sim.mesh.nodes_per_elem, 2, 3)
    shape = f"20b quality mesh P2: {E} triangles, {N} nodes"
    out = {}
    # A in node rows at 2 values a node, out of planes as the solve runs it
    ids_em, S = rk.ids_em, rk.ids_em.shape[0]
    src2 = torch.randn((2, N), generator=gen, device=dev)
    rows2 = src2.t().contiguous()
    for S_ in (S, S - 1):
        ids_ = ids_em[:S_].contiguous()
        ref = kernels.gather_rows_plain(rows2, ids_)
        if not (torch.equal(kernels.gather_rows(rows2, ids_), ref)
                and torch.equal(kernels.gather_rows(src2, ids_,
                                                    planes_in=True), ref)):
            raise RuntimeError(f"20e gather_rows (2 values, S = {S_}) != "
                               f"plain")
    ids_long = ids_em.long()
    entry("gather_rows/quality/2", src_dir + "gather_planes.cu", A_TPU,
          launches("gather_rows"), 0.0,
          lambda: kernels.gather_rows(src2, ids_em, planes_in=True),
          lambda: kernels.gather_rows_plain(src2, ids_em, True),
          lambda: torch.index_select(rows2, 0, ids_long),
          S * 4 + 2 * N * 4 + 2 * S * 4, 0, odd_S_checked=S - 1,
          mode="rows out [S, 2] from planes [2, N], as apply_planes runs it",
          launches_path="20b quality mesh, the default call",
          library_call="torch.index_select",
          shape=f"{shape}; src [2, {N}] f32, ids_em [{S}] int32")
    # B in node rows at 2 values a node, into planes
    perm_em, offs = rk.plan_em.perm, rk.plan_em.offsets
    fr = torch.randn((S, 2), generator=gen, device=dev)
    out["rows_f32_2"] = check_b_rows(fr, rk, offs, "20e B rows f32 (2 "
                                     "values)")
    acc = torch.zeros((N, 2), device=dev)
    entry("segment_sum_rows/quality/2", src_dir + "segment_sum_csr.cu",
          B_TPU, launches("segment_sum_rows/quality/2"), out["rows_f32_2"],
          lambda: kernels.segment_sum_rows(fr, perm_em, offs,
                                           planes_out=True),
          lambda: kernels.segment_sum_rows_plain(fr, perm_em, offs, True),
          lambda: acc.index_add_(0, ids_long, fr),
          2 * S * 4 + S * 4 + (N + 1) * 4 + 2 * N * 4, 2 * S,
          mode="rows [S, 2] -> planes [2, N], as apply_planes runs it",
          launches_path="20b quality mesh, the default call, float32 "
                        "launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"{shape}; src [{S}, 2] f32 -> [2, {N}]")
    # B in float64 on the EBE plan: the refinement's residuals
    plan64 = sim._kernel.plan
    R = plan64.num_rows
    dr = torch.randn((R, 2), generator=gen, device=dev, dtype=torch.float64)
    out["rows_f64_2"] = check_rows_on_plan(plan64, torch.float64,
                                           "20e B rows f64 (2 values)", gen,
                                           P=2)
    dst64 = sim._kernel.elem_dofs.reshape(-1)
    acc64 = torch.zeros((N, 2), device=dev, dtype=torch.float64)
    entry("segment_sum_rows/f64/quality/2", src_dir + "segment_sum_csr.cu",
          B_TPU + " (f64: the XLA scatter of meshfem_tpu/sparse/scatter.py)",
          launches("segment_sum_rows/f64/quality/2"), out["rows_f64_2"],
          lambda: plan64.sum_rows(dr),
          lambda: kernels.segment_sum_rows_plain(dr, plan64.perm,
                                                 plan64.offsets),
          lambda: acc64.index_add_(0, dst64, dr),
          2 * R * 8 + R * 4 + (N + 1) * 4 + 2 * N * 8, 2 * R,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [R, 2] -> rows [N, 2]: the EBE residual",
          launches_path="20b quality mesh, the default call, float64 "
                        "launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"{shape}; src [{R}, 2] f64 -> [{N}, 2]")
    # E on the quality mesh's geometry
    g32 = sim.geom.grad_lambda.float().contiguous()
    v32 = sim.geom.volume.float().contiguous()
    D_host = sim.D.cpu()
    Ke32 = kernels.element_stiffness(g32, v32, D_host, 2)
    e_ref = kernels.element_stiffness_plain(g32, v32, D_host, 2)
    scale = float(e_ref.abs().max())
    err_e = float((Ke32 - e_ref).abs().max())
    ulps = ulps_from(Ke32, em.element_elasticity_fused(
        g32.double(), v32.double(), sim.D, 2))
    del Ke32, e_ref
    card_log(f"20e E on the quality mesh ({E} triangles): max abs err "
             f"{err_e:.3e} against plain (max|Ke| {scale:.3e}), {ulps:.3f} "
             f"ulp of each entry from the f64 Ke of the same float32 "
             f"inputs")
    if not (err_e <= 1e-5 * scale and ulps <= 1.0):
        raise RuntimeError("20e: element_stiffness on the quality mesh "
                           "disagrees")
    nd = nn * d
    M32 = torch.as_tensor(em.fused_matrix_for(sim.D, 2, 2),
                          dtype=torch.float32, device=dev)
    entry("element_stiffness/quality", src_dir + "element_stiffness.cu",
          "meshfem_tpu/kernels/element_stiffness.py:42",
          launches("element_stiffness"), err_e,
          lambda: kernels.element_stiffness(g32, v32, D_host, 2),
          lambda: kernels.element_stiffness_plain(g32, v32, D_host, 2),
          lambda: em.element_elasticity_fused_apply(g32, v32, M32, nn),
          (K1 * d + 1 + nd * nd) * E * 4 + 9 * 8,
          (2 * ((K1 * d) ** 2 * d * d + nd * nd * K1 * K1) + nd * nd) * E,
          algorithm_flops=(2 * (K1 * (K1 + 1) // 2 * (d * d + d ** 4)
                                + nd * nd * K1 * K1) + nd * nd) * E,
          algorithm_flop_rate=F64_FLOP_PER_S, max_ulps_vs_f64=ulps,
          mode="f32 Ke [E, 12, 12] of the quality mesh, one per dense "
               "routed operator build",
          launches_path="20b quality mesh, the default call",
          library_call="ops.element_matrices.element_elasticity_fused_apply",
          shape=f"{shape}: grad_lambda [{E}, 3, 2], vol [{E}] f32")
    out.update(E_err=err_e, E_ulps=ulps)
    out["checked"] = ["gather_rows/quality/2", "segment_sum_rows/quality/2",
                      "segment_sum_rows/f64/quality/2",
                      "element_stiffness/quality"]
    return out


def check_b_rows(src, op, offsets, label):
    """Kernel B in rows on a routed operator's element-major plan: twice
    bit for bit, bit for bit against B in planes on the same contributions
    through the slot-major plan, and to 1e-5 of max|y| of its plain
    version.  Returns the max abs error against plain."""
    from meshfem_tpu_torch import kernels

    S, P = src.shape
    n, E = op.nodes_per_elem, op.num_elements
    perm_em = op.plan_em.perm
    y1 = kernels.segment_sum_rows(src, perm_em, offsets)
    y2 = kernels.segment_sum_rows(src, perm_em, offsets)
    yp = kernels.segment_sum_csr(src.reshape(E, n, P).permute(2, 1, 0)
                                 .reshape(P, S).contiguous(), op.plan.perm,
                                 op.plan.offsets)
    ref = kernels.segment_sum_rows_plain(src, perm_em, offsets)
    err = float((y1 - ref).abs().max())
    if not (torch.equal(y1, y2) and torch.equal(y1.t(), yp)):
        raise RuntimeError(f"{label}: not bit-identical run to run or "
                           f"against B in planes")
    if not err <= 1e-5 * float(ref.abs().max()):
        raise RuntimeError(f"{label}: disagrees with plain ({err:.3e})")
    log(f"{label}: bit-identical across two runs and against B in planes; "
        f"max abs err against plain {err:.3e}")
    return err


def check_b_planes(src, perm, offsets, label):
    """Kernel B in planes: twice bit for bit, and to 1e-5 of max|y| of its
    plain version.  Returns the max abs error against plain."""
    from meshfem_tpu_torch import kernels

    y1 = kernels.segment_sum_csr(src, perm, offsets)
    y2 = kernels.segment_sum_csr(src, perm, offsets)
    ref = kernels.segment_sum_csr_plain(src, perm, offsets)
    err = float((y1 - ref).abs().max())
    if not torch.equal(y1, y2):
        raise RuntimeError(f"{label}: not bit-identical run to run")
    if not err <= 1e-5 * float(ref.abs().max()):
        raise RuntimeError(f"{label}: disagrees with plain ({err:.3e})")
    log(f"{label}: bit-identical across two runs; max abs err against "
        f"plain {err:.3e}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from meshfem_tpu_torch import kernels, native
    from meshfem_tpu_torch.fem import elasticity_tensor as et
    from meshfem_tpu_torch.analysis import homogenization as hom
    from meshfem_tpu_torch.kernels import _build
    from meshfem_tpu_torch.mesh import FEMMesh
    from meshfem_tpu_torch.ops import element_matrices as em
    from meshfem_tpu_torch.physics import Material
    from meshfem_tpu_torch.sparse.contract import qp_tables
    from meshfem_tpu_torch.sparse.routed_ebe import RoutedEBE

    dev = torch.device("cuda")
    t_start = time.time()
    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 2. build, and the main path's problem -----------------------------
    # the host core (g++, mesh connectivity and Ruppert) builds beside nvcc
    global CARD
    CARD = smi
    core = {}

    def build_core():
        t = time.time()
        try:
            core["so"] = native.build()
        except Exception as exc:          # reported below, as a failure
            core["error"] = exc
        core["s"] = time.time() - t

    core_thread = threading.Thread(target=build_core)
    core_thread.start()
    t0 = time.time()
    so = _build.build()
    _build.load()
    log(f"kernels built in {time.time() - t0:.1f} s -> {so.name}")
    core_thread.join()
    if "error" in core or native.get_lib() is None:
        raise RuntimeError(f"the host core did not build or load: "
                           f"{core.get('error')}")
    log(f"host core built in {core['s']:.1f} s (beside nvcc) -> "
        f"{core['so'].name}")
    ptxas = {}                        # source -> its -Xptxas -v lines
    ptx_log = so.with_suffix(".log")
    if ptx_log.exists():
        source = None
        for line in ptx_log.read_text().splitlines():
            if line.startswith("== "):
                source = line.split()[1]
            elif any(k in line for k in ("entry function", "registers",
                                         "spill")):
                ptxas.setdefault(source, []).append(line.strip())
    for source, lines in ptxas.items():
        for line in lines:
            if source in ("qp_contract.cu", "factored_contract.cu",
                          "element_stiffness.cu") \
                    or "entry function" not in line:
                log(f"  ptxas {source}:", line)

    os.environ.pop("MESHFEM_FACTORED", None)
    n = BENCH_N
    sim, t_mesh, t_sim = clamped_problem(n, dev)
    E, N = sim.mesh.num_elements, sim.num_dofs
    log(f"grid_tet({n}) P2: {E} tets, {N} nodes, {3 * N} dofs; host mesh "
        f"+ P2 numbering {t_mesh:.2f} s, geometry + Ke + EBE plan "
        f"{t_sim:.2f} s")
    t0 = time.time()
    rk = sim.routed_kernel()
    torch.cuda.synchronize()
    log(f"dense routed operator (RCB order, first touch, CSR plan, f32 Ke) "
        f"built in {time.time() - t0:.2f} s")
    lam, mu = et.lame_parameters(sim.D)
    t0 = time.time()
    rkf = RoutedEBE.build(None, sim.mesh.elem_nodes, N, 3,
                          coords=sim.mesh.node_positions,
                          factor=(sim.geom.grad_lambda, sim.geom.volume,
                                  lam, mu, 2), device=dev)
    torch.cuda.synchronize()
    log(f"factored routed operator built in {time.time() - t0:.2f} s")

    # -- 3. each kernel against its plain version, main-path shapes --------
    gen = torch.Generator(device=dev).manual_seed(0)
    ids, S = rk.ids, rk.ids.shape[0]
    src3 = torch.randn((3, N), generator=gen, device=dev)
    for P in (3, 1):
        src = src3[:P].contiguous()
        out = kernels.gather_planes(src, ids)
        ref = kernels.gather_planes_plain(src, ids)
        if not torch.equal(out, ref):
            raise RuntimeError(f"gather_planes (planes {P}) != plain")
        if P == 3:
            err_a = float((out - ref).abs().max())
    log(f"A gather_planes: planes 3 and 1 equal to the plain version "
        f"(ids [{S}] int32, src [3, {N}])")
    ids_em = rk.ids_em
    for P in (3, 18):
        rows_src = torch.randn((N, P), generator=gen, device=dev)
        for src, planes_in in ((rows_src, False),
                               (rows_src.t().contiguous(), True)):
            out = kernels.gather_rows(src, ids_em, planes_in=planes_in)
            ref = kernels.gather_rows_plain(src, ids_em, planes_in)
            if not torch.equal(out, ref):
                raise RuntimeError(f"gather_rows ({P} values, planes_in "
                                   f"{planes_in}) != plain")
    err_a_rows = float((out - ref).abs().max())
    del rows_src, src, out, ref
    log(f"A gather_rows: 3 and 18 values a node, from node rows and from "
        f"planes, equal to the plain version (ids_em [{S}] int32)")

    perm, offs = rk.plan.perm, rk.plan.offsets
    fsrc = torch.randn((3, S), generator=gen, device=dev)
    b1 = kernels.segment_sum_csr(fsrc, perm, offs)
    b2 = kernels.segment_sum_csr(fsrc, perm, offs)
    bref = kernels.segment_sum_csr_plain(fsrc, perm, offs)
    err_b = float((b1 - bref).abs().max())
    if not torch.equal(b1, b2):
        raise RuntimeError("segment_sum_csr f32 is not bit-identical run "
                           "to run")
    if not err_b <= 1e-5 * float(bref.abs().max()):
        raise RuntimeError(f"segment_sum_csr f32 disagrees: {err_b}")
    plan64 = sim._kernel.plan
    dsrc = torch.randn((3, plan64.num_rows), generator=gen, device=dev,
                       dtype=torch.float64)
    d1 = kernels.segment_sum_csr(dsrc, plan64.perm, plan64.offsets)
    d2 = kernels.segment_sum_csr(dsrc, plan64.perm, plan64.offsets)
    dref = kernels.segment_sum_csr_plain(dsrc, plan64.perm, plan64.offsets)
    err_b64 = float((d1 - dref).abs().max())
    if not torch.equal(d1, d2):
        raise RuntimeError("segment_sum_csr f64 is not bit-identical run "
                           "to run")
    if not err_b64 <= 1e-12 * float(dref.abs().max()):
        raise RuntimeError(f"segment_sum_csr f64 disagrees: {err_b64}")
    log(f"B segment_sum_csr: f32 max abs err {err_b:.3e} (max|y| "
        f"{float(bref.abs().max()):.3e}), f64 {err_b64:.3e}; bit-identical "
        f"across two runs in both")

    # B in rows: the operator's element-major plan against its slot-major
    # one (f32), the EBE plan in rows against the same plan in planes (f64)
    perm_em = rk.plan_em.perm
    err_rows = {}
    for P in (3, 18):
        fp = fsrc if P == 3 else torch.randn((P, S), generator=gen,
                                             device=dev)
        fr = fp.reshape(P, 10, E).permute(2, 1, 0).reshape(S, P)
        yp = kernels.segment_sum_csr(fp, perm, offs)
        yr = kernels.segment_sum_rows(fr, perm_em, offs, planes_out=True)
        yr_rows = kernels.segment_sum_rows(fr, perm_em, offs)
        if not (torch.equal(yr, yp) and torch.equal(yr_rows.t(), yp)):
            raise RuntimeError(f"segment_sum_rows f32 ({P} values) != "
                               f"segment_sum_csr bit for bit")
        ref = kernels.segment_sum_rows_plain(fr, perm_em, offs)
        err_rows[("f32", P)] = float((yr_rows - ref).abs().max())
        if not err_rows[("f32", P)] <= 1e-5 * float(ref.abs().max()):
            raise RuntimeError(f"segment_sum_rows f32 ({P} values) "
                               f"disagrees: {err_rows[('f32', P)]}")
        dp = dsrc if P == 3 else torch.randn(
            (P, plan64.num_rows), generator=gen, device=dev,
            dtype=torch.float64)
        dr = dp.t().contiguous()
        yp = kernels.segment_sum_csr(dp, plan64.perm, plan64.offsets)
        yr_rows = kernels.segment_sum_rows(dr, plan64.perm, plan64.offsets)
        if not torch.equal(yr_rows.t(), yp):
            raise RuntimeError(f"segment_sum_rows f64 ({P} values) != "
                               f"segment_sum_csr bit for bit")
        ref = kernels.segment_sum_rows_plain(dr, plan64.perm, plan64.offsets)
        err_rows[("f64", P)] = float((yr_rows - ref).abs().max())
        if not err_rows[("f64", P)] <= 1e-12 * float(ref.abs().max()):
            raise RuntimeError(f"segment_sum_rows f64 ({P} values) "
                               f"disagrees: {err_rows[('f64', P)]}")
    del fp, fr, yp, yr, yr_rows, ref, dp, dr
    log("B segment_sum_rows: equal bit for bit to segment_sum_csr on the "
        "same contributions (f32 through the operator's element-major and "
        "slot-major plans, f64 through the EBE plan, 3 and 18 values a "
        "node); max abs err against plain " + ", ".join(
            f"{t} {P}: {e:.3e}" for (t, P), e in err_rows.items()))

    ue = torch.randn((3, 10, E), generator=gen, device=dev)
    c_out = kernels.qp_contract(rkf.g, rkf.vol, ue, lam, mu)
    c_ref = kernels.qp_contract_plain(rkf.g, rkf.vol, ue, lam, mu)
    err_c = float((c_out - c_ref).abs().max())
    rel_c = err_c / float(c_ref.abs().max())
    if not rel_c <= 1e-5:
        raise RuntimeError(f"qp_contract disagrees with plain: {rel_c}")
    log(f"C qp_contract: max abs err {err_c:.3e}, {rel_c:.3e} of max|y|")

    d_out = kernels.factored_contract(rkf.g, rkf.vol, ue, lam, mu)
    d_ref = kernels.factored_contract_plain(rkf.g, rkf.vol, ue, lam, mu)
    torch.cuda.synchronize()
    err_d = float((d_out - d_ref).abs().max())
    rel_d = err_d / float(d_ref.abs().max())
    rel_dc = float((d_out - c_out).abs().max() / c_out.abs().max())
    log(f"D factored_contract: max abs err {err_d:.3e}, {rel_d:.3e} of "
        f"max|y| against plain; {rel_dc:.3e} against kernel C")
    if not rel_d <= 1e-5:
        raise RuntimeError(f"factored_contract disagrees with plain: {rel_d}")
    if not rel_dc <= 5e-6:
        raise RuntimeError(f"factored_contract disagrees with C: {rel_dc}")
    del d_ref, c_ref
    # C and D in element-major node rows, as the factored applies run them
    ue_rows = ue.permute(2, 1, 0).reshape(E * 10, 3).contiguous()
    err_rows_cd = {}
    for name, out_planes in (("qp_contract", c_out),
                             ("factored_contract", d_out)):
        fn = getattr(kernels, name)
        out_rows = fn(rkf.g, rkf.vol, ue_rows, lam, mu, rows=True)
        ref = getattr(kernels, name + "_plain")(rkf.g, rkf.vol, ue_rows, lam,
                                                mu, rows=True)
        err_rows_cd[name] = float((out_rows - ref).abs().max())
        rel = err_rows_cd[name] / float(ref.abs().max())
        same = torch.equal(out_rows.view(E, 10, 3).permute(2, 1, 0),
                           out_planes)
        log(f"{name} in rows [{E * 10}, 3]: {rel:.3e} of max|y| against "
            f"plain; {'equal bit for bit to' if same else 'NOT EQUAL to'} "
            f"the kernel in planes")
        if not (rel <= 1e-5 and same):
            raise RuntimeError(f"{name} in rows disagrees with plain or with "
                               f"planes")
    del out_rows, ref, d_out

    gl32 = sim.geom.grad_lambda.float().contiguous()
    vol32 = sim.geom.volume.float().contiguous()
    D_host = sim.D.cpu()              # E's material, kept off the timed path
    Ke32 = kernels.element_stiffness(gl32, vol32, D_host, 2)
    torch.cuda.synchronize()
    e_ref = kernels.element_stiffness_plain(gl32, vol32, D_host, 2)
    Ke64_32 = sim.Ke.float()
    ke_max = float(e_ref.abs().max())
    err_e = float((Ke32 - e_ref).abs().max())
    err_e64 = float((Ke32 - Ke64_32).abs().max())
    err_plain64 = float((e_ref - Ke64_32).abs().max())
    ulps_e64 = ulps_from(Ke32, sim.Ke)
    ulps_plain64 = ulps_from(e_ref, sim.Ke)
    del e_ref, Ke64_32
    log(f"E element_stiffness: max abs err {err_e:.3e} against plain, "
        f"{err_e64:.3e} against the f64 Ke (the plain one-product form: "
        f"{err_plain64:.3e}), max|Ke| {ke_max:.3e}; {ulps_e64:.3f} ulp of "
        f"each entry from the f64 Ke (the plain form: {ulps_plain64:.1f})")
    if not (err_e <= 1e-5 * ke_max and err_e64 <= 1e-5 * ke_max):
        raise RuntimeError("element_stiffness disagrees with its plain "
                           "version or the f64 Ke")
    if not ulps_e64 <= 1.0:
        raise RuntimeError(f"element_stiffness is {ulps_e64} ulp from the "
                           f"f64 Ke: its sums are not float64")
    del Ke32
    gl_r = torch.randn((E, 4, 3), generator=gen, device=dev)
    vol_r = torch.rand((E,), generator=gen, device=dev) + 0.5
    A_r = np.random.default_rng(5).standard_normal((6, 6))
    D_aniso = torch.as_tensor(50.0 * (A_r @ A_r.T + 6.0 * np.eye(6)))
    err_e_rand, ulps_e_rand = {}, {}
    for kind, Dm in (("isotropic", D_host), ("anisotropic", D_aniso)):
        e_out = kernels.element_stiffness(gl_r, vol_r, Dm, 2)
        e_ref = kernels.element_stiffness_plain(gl_r, vol_r, Dm, 2)
        torch.cuda.synchronize()
        err, scale = (float((e_out - e_ref).abs().max()),
                      float(e_ref.abs().max()))
        del e_ref
        k64 = em.element_elasticity_fused(gl_r.double(), vol_r.double(),
                                          Dm, 2)
        ulps = ulps_from(e_out, k64)
        del e_out, k64
        err_e_rand[kind], ulps_e_rand[kind] = (err, scale), ulps
        log(f"E element_stiffness on seeded random gradients and volumes "
            f"[{E}], {kind} material: max abs err {err:.3e} against plain, "
            f"max|Ke| {scale:.3e} ({err / scale:.3e} of it); {ulps:.3f} ulp "
            f"of each entry from the f64 Ke of the same inputs")
        if not err <= 1e-5 * scale:
            raise RuntimeError(f"element_stiffness disagrees with its plain "
                               f"version on random inputs ({kind})")
        if not ulps <= 1.0:
            raise RuntimeError(f"element_stiffness is {ulps} ulp from the "
                               f"f64 Ke on random inputs ({kind})")
    del gl_r, vol_r
    err_e_rand_aniso = err_e_rand["anisotropic"]
    err_e_rand, ke_max_rand = err_e_rand["isotropic"]

    # -- 4. the main path: dense routed solve at full width ----------------
    u, res, wall, counts_dense, applies_dense = drive_solve(
        sim, "dense routed solve",
        ("gather_rows", "segment_sum_rows", "element_stiffness"))
    check_rows_path("dense routed solve", counts_dense, applies_dense)
    check_solution(sim, u, "dense routed solve")
    inputs = [torch.randn((3, N), generator=gen, device=dev)
              for _ in range(9)]
    dense_apply_ms = median_apply_ms(rk.apply_planes, inputs)
    u64 = inputs[0].t().double().contiguous()
    ebe64_ms = median_apply_ms(sim.apply_K,
                               [u64 * (1 + i) for i in range(5)])
    log(f"dense routed apply {dense_apply_ms:.4f} ms (median of "
        f"{len(inputs)} inputs); {wall / max(res.iters, 1) * 1e3:.4f} ms "
        f"per inner CG iteration on the host clock; f64 EBE residual apply "
        f"{ebe64_ms:.4f} ms")
    summary = dict(tets=E, dofs=3 * N, rounds=res.rounds,
                   inner_iters=res.iters, relres=res.resnorm, solve_s=wall,
                   apply_ms=dense_apply_ms, ebe64_apply_ms=ebe64_ms)

    # -- 5. the factored backend (kernel C) --------------------------------
    yd = rk.apply_planes(inputs[0])
    yf = rkf.apply_planes(inputs[0])
    rel_fd = float((yf - yd).abs().max() / yd.abs().max())
    fact_apply_ms = median_apply_ms(rkf.apply_planes, inputs)
    log(f"factored vs dense apply: {rel_fd:.3e} of max|y|; factored apply "
        f"{fact_apply_ms:.4f} ms")
    if not rel_fd <= 5e-6:
        raise RuntimeError(f"factored apply disagrees with dense: {rel_fd}")
    os.environ["MESHFEM_FACTORED"] = "1"
    uf, resf, wallf, counts_fact, applies_fact = drive_solve(
        sim, "factored routed solve",
        ("gather_rows", "segment_sum_rows", "qp_contract"))
    os.environ.pop("MESHFEM_FACTORED", None)
    check_rows_path("factored routed solve", counts_fact, applies_fact,
                    "qp_contract")
    if sim.routed_kernel().KeP is not None:
        raise RuntimeError("isotropic material did not take the factored "
                           "backend")
    check_solution(sim, uf, "factored routed solve")
    du = float((uf - u).abs().max() / u.abs().max())
    log(f"factored vs dense solution: {du:.3e} of max|u|")
    if not du <= 1e-8:
        raise RuntimeError(f"factored and dense solutions differ: {du}")
    summary.update(factored_rounds=resf.rounds,
                   factored_inner_iters=resf.iters, factored_solve_s=wallf,
                   factored_apply_ms=fact_apply_ms,
                   factored_vs_dense_apply=rel_fd)

    small, _, _ = clamped_problem("bar", dev)
    us, _ = small.solve(operator="routed", tol=1e-10)
    small_cpu, _, _ = clamped_problem("bar", "cpu")
    uc, _ = small_cpu.solve(operator="ebe", tol=1e-10)
    vm_c = small_cpu.von_mises_field(uc)
    rel_small = float((us.cpu() - uc).abs().max() / uc.abs().max())
    vm_rel = float((small.von_mises_field(us).cpu() - vm_c).abs().max()
                   / vm_c.abs().max())
    log(f"small bar: card routed vs CPU f64 EBE solve: u {rel_small:.3e}, "
        f"von Mises {vm_rel:.3e} of max")
    if not (rel_small <= 1e-8 and vm_rel <= 1e-8):
        raise RuntimeError("small-input solve disagrees with the CPU path")

    # -- 6. the assembly path (kernel E) -----------------------------------
    def assemble_and_apply():
        Ke32 = kernels.element_stiffness(gl32, vol32, sim.D, 2)
        rk32 = RoutedEBE.build(Ke32, sim.mesh.elem_nodes, N, 3,
                               coords=sim.mesh.node_positions, device=dev)
        return Ke32, rk32, rk32.apply_planes(inputs[0])

    (Ke32, rk32, y32), wall_asm, counts_asm = counted(
        "assembly path", assemble_and_apply, ("element_stiffness",))
    rk64 = RoutedEBE.build(sim.Ke, sim.mesh.elem_nodes, N, 3,
                           coords=sim.mesh.node_positions, device=dev)
    y64 = rk64.apply_planes(inputs[0])
    del rk64
    rel_asm = float((y32 - y64).abs().max() / y64.abs().max())
    log(f"assembly path: f32 Ke from kernel E -> RoutedEBE.build -> apply in "
        f"{wall_asm:.3f} s; apply vs the operator built from the f64 Ke: "
        f"{rel_asm:.3e} of max|y|; launches {counts_asm}")
    if not rel_asm <= 5e-6:
        raise RuntimeError(f"assembly path disagrees: {rel_asm}")
    summary.update(assembly_path_s=wall_asm, assembly_vs_f64_apply=rel_asm)
    del Ke32, rk32, y32, y64, yd, yf, small, small_cpu
    sim._routed = None

    # -- 7. the homogenization path at full width --------------------------
    t0 = time.time()
    cell = FEMMesh(*void_cell(BENCH_N), degree=2)
    t_cell = time.time() - t0
    mat = Material.isotropic(3, 200.0, 0.3)
    D = mat.D.to(dev)
    t0 = time.time()
    hsim = hom.periodic_simulator(cell, mat)
    torch.cuda.synchronize()
    phi = 1.0 - float(hsim.geom.volume.sum())
    Eh, Nh = cell.num_elements, hsim.num_dofs
    log(f"periodic cell with a void: {Eh} tets, {cell.num_nodes} nodes, "
        f"{Nh} periodic nodes, {3 * Nh} dofs, void share {phi:.4f}; host "
        f"mesh {t_cell:.2f} s, reference simulator {time.time() - t0:.2f} s")
    homog = {}
    variants = (
        ("dense", {},
         ("gather_rows", "segment_sum_rows", "element_stiffness")),
        ("factored", {"MESHFEM_FACTORED": "1"},
         ("gather_rows", "segment_sum_rows", "qp_contract")),
        ("factored_tq", {"MESHFEM_FACTORED": "1", "MESHFEM_FACTORED_TQ": "1"},
         ("gather_rows", "segment_sum_rows", "factored_contract")))
    Chs = {}
    block_inputs = [torch.randn((Nh, 3, 6), generator=gen, device=dev)
                    for _ in range(7)]
    for name, env, required in variants:
        label = f"homogenization ({name})"
        hres, info = drive_homogenize(cell, mat, label, env, required)
        check_rows_path(label, info["launches"], info["applies"],
                        None if name == "dense" else required[2])
        gate = 1e-8 if info["stagnated"] else 1e-10
        info["relres"], info["column_relres"] = check_homogenized(
            hsim, hres, label, D, phi, gate)
        Chs[name] = hres.Ch
        del hres
        # the block apply alone, timed with events on varied inputs
        os.environ.update(env)
        hsim._routed = None
        hrk = hsim.routed_kernel(block_rhs=6)
        info["block_apply_ms"] = median_apply_ms(hrk.apply_block,
                                                 block_inputs)
        for k in env:
            os.environ.pop(k, None)
        log(f"{label}: block apply (6 columns, 18 planes) "
            f"{info['block_apply_ms']:.4f} ms (median of "
            f"{len(block_inputs)} inputs)")
        homog[name] = info
    ch_scale = float(Chs["dense"].abs().max())
    for name in ("factored", "factored_tq"):
        dch = float((Chs[name] - Chs["dense"]).abs().max()) / ch_scale
        log(f"Ch ({name}) vs Ch (dense): {dch:.3e} of max|Ch|")
        homog[name]["Ch_vs_dense"] = dch
        if not dch <= 1e-7:
            raise RuntimeError(f"Ch of the {name} run differs: {dch}")
    summary["homogenization"] = dict(
        tets=Eh, dofs=3 * Nh, void_share=phi,
        Ch=Chs["dense"].cpu().tolist(), runs=homog)
    dw_small, dC_small = small_cell_check(dev)
    summary.update(small_cell_w=dw_small, small_cell_Ch=dC_small)
    summary["peak_device_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # -- 8. the probe path: kernel F at experiments/probe_route.py's shapes -
    NV, NT, CHAIN = 7530, 2797, 4
    prng = np.random.default_rng(0)                  # the probe's inputs
    px = torch.as_tensor(prng.standard_normal((NT, 128)).astype(np.float32),
                         device=dev)
    pwin0 = torch.as_tensor(prng.integers(0, NT - CHAIN, NV)
                            .astype(np.int32), device=dev)
    pwidx = torch.as_tensor(prng.integers(0, CHAIN, (NV, 8, 128))
                            .astype(np.int32), device=dev)
    plidx = torch.as_tensor(prng.integers(0, 128, (NV, 8, 128))
                            .astype(np.int32), device=dev)
    f_out, _, counts_probe = counted(
        "route_window", lambda: kernels.route_window(px, pwin0, pwidx,
                                                     plidx, CHAIN))
    f_ref = kernels.route_window_plain(px, pwin0, pwidx, plidx, CHAIN)
    if counts_probe["route_window"] != 1 or not torch.equal(f_out, f_ref):
        raise RuntimeError("route_window disagrees with its plain version")
    err_f = float((f_out - f_ref).abs().max())
    del f_out, f_ref
    log(f"F route_window: NV {NV}, NT {NT}, CHAIN {CHAIN} "
        f"({NV * 1024} routed values) equal to the plain version; launches "
        f"{counts_probe['route_window']}")

    # -- 9. the stage table: node rows against the former planes layout -----
    hsim._routed = None
    hrk_d = hsim.routed_kernel(block_rhs=6)          # dense, as phase 7 ran
    stage_table = {}

    def compare_layouts(label, rows, planes, package, inputs, exact):
        """Time the node-rows stages (the package's layout), the former
        planes composition and the package's whole apply; the two layouts
        agree to 1e-6 of max|y|, and where ``exact`` bit for bit, the
        package's apply too."""
        out = {}
        for name, stages in (("rows", rows), ("planes", planes)):
            per, whole, y = stage_ms(stages, inputs)
            out[name] = dict(stages=per, stage_sum_ms=sum(per.values()),
                             sequence_ms=whole)
            out[name + "_y"] = y
        out["rows"]["apply_ms"] = median_apply_ms(package, inputs)
        out["rows"]["stage_share"] = (out["rows"]["stage_sum_ms"]
                                      / out["rows"]["apply_ms"])
        y_rows, y_planes = out.pop("rows_y"), out.pop("planes_y")
        out["rows_vs_planes"] = float((y_rows - y_planes).abs().max()
                                      / y_planes.abs().max())
        out["bitwise"] = bool(torch.equal(y_rows, y_planes))
        out["package_equals_stages"] = bool(torch.equal(package(inputs[-1]),
                                                        y_rows))
        for name in ("rows", "planes"):
            r = out[name]
            log(f"{label}, {name}: " + ", ".join(
                f"{k} {v:.4f}" for k, v in r["stages"].items())
                + f" ms; stages {r['stage_sum_ms']:.4f} ms, sequence "
                f"{r['sequence_ms']:.4f} ms")
        log(f"{label}: the package's apply (rows) {out['rows']['apply_ms']:.4f}"
            f" ms, its stages {out['rows']['stage_share']:.3f} of it; rows vs "
            f"planes {out['rows_vs_planes']:.3e} of max|y|"
            + (", bit for bit" if out["bitwise"] else ""))
        if not (out["rows_vs_planes"] <= 1e-6 and (not exact or (
                out["bitwise"] and out["package_equals_stages"]))):
            raise RuntimeError(f"{label}: the two layouts disagree")
        return out

    def layouts(label, op, inputs, m, planes_io):
        """The dense apply in node rows (the package's, and its three
        stages) beside the planes layout composed by hand."""
        d, n, E_, N_ = 3, 10, op.num_elements, op.num_dofs
        KeC = op.KeP.view(E_, n, d, n, d).permute(0, 2, 1, 4, 3) \
            .reshape(E_, n * d, n * d)               # component-major copy
        if planes_io:                                # [d, N] planes in/out
            rows = [("A rows", lambda x: kernels.gather_rows(
                        x, op.ids_em, planes_in=True)),
                    ("bmm", lambda ue: torch.bmm(op.KeP,
                                                 ue.view(E_, n * d, 1))),
                    ("B rows", lambda fe: op.plan_em.sum_rows(
                        fe.view(E_ * n, d), planes_out=True))]
            planes = [("A planes", lambda x: kernels.gather_planes(x,
                                                                  op.ids)),
                      ("copy to bmm operand", lambda ue: ue.reshape(
                          d * n, E_).t().contiguous().unsqueeze(-1)),
                      ("bmm", lambda x: torch.bmm(KeC, x)),
                      ("copy from bmm", lambda fe: fe.reshape(
                          E_, d * n).t().contiguous().reshape(d, n * E_)),
                      ("B planes", op.plan.sum_planes)]
            package = op.apply_planes
        else:                                        # U [N, d, m] in/out
            rows = [("A rows", lambda U: kernels.gather_rows(
                        U.view(N_, d * m), op.ids_em)),
                    ("bmm", lambda ue: torch.bmm(op.KeP,
                                                 ue.view(E_, n * d, m))),
                    ("B rows", lambda fe: op.plan_em.sum_rows(
                        fe.view(E_ * n, d * m)).view(N_, d, m))]
            planes = [("copy U to planes", lambda U: U.permute(1, 2, 0)
                       .reshape(d * m, N_).contiguous()),
                      ("A planes", lambda x: kernels.gather_planes(x,
                                                                  op.ids)),
                      ("copy to bmm operand", lambda ue: ue.reshape(
                          d, m, n, E_).permute(3, 0, 2, 1)
                       .reshape(E_, d * n, m)),
                      ("bmm", lambda x: torch.bmm(KeC, x)),
                      ("copy from bmm", lambda fe: fe.reshape(
                          E_, d, n, m).permute(1, 3, 2, 0)
                       .reshape(d * m, n * E_)),
                      ("B planes", op.plan.sum_planes),
                      # the planes apply returned this as a strided view (no copy)
                      ("view as [N, d, m]", lambda y: y.reshape(
                          d, m, N_).permute(2, 0, 1))]
            package = op.apply_block
        out = compare_layouts(label, rows, planes, package, inputs, False)
        del KeC
        return out

    def factored_layouts(label, op, inputs, m, planes_io):
        """The factored apply (kernel C) in node rows as the package runs
        it (A rows, ONE launch of C over all m columns, B rows) beside the
        planes composition it replaced (A planes, C per column on
        contiguous copies of the columns, B planes): the same
        contributions in the same order, so the same bits."""
        d, n, E_, N_ = 3, 10, op.num_elements, op.num_dofs
        C = lambda u, **kw: kernels.qp_contract(op.g, op.vol, u, op.lam,
                                                op.mu, **kw)
        if planes_io:                                # [d, N] planes in/out
            rows = [("A rows", lambda x: kernels.gather_rows(
                        x, op.ids_em, planes_in=True)),
                    ("C rows", lambda ue: C(ue, rows=True)),
                    ("B rows", lambda fe: op.plan_em.sum_rows(
                        fe, planes_out=True))]
            planes = [("A planes", lambda x: kernels.gather_planes(x,
                                                                  op.ids)),
                      ("C planes", lambda ue: C(ue.view(d, n, E_))),
                      ("B planes", lambda fe: op.plan.sum_planes(
                          fe.reshape(d, n * E_)))]
            package = op.apply_planes
        else:                                        # U [N, d, m] in/out
            rows = [("A rows", lambda U: kernels.gather_rows(
                        U.view(N_, d * m), op.ids_em)),
                    ("C rows", lambda ue: C(ue, rows=True)),
                    ("B rows", lambda fe: op.plan_em.sum_rows(fe)
                     .view(N_, d, m))]
            planes = [("copy U to planes", lambda U: U.permute(1, 2, 0)
                       .reshape(d * m, N_).contiguous()),
                      ("A planes", lambda x: kernels.gather_planes(x,
                                                                  op.ids)),
                      ("copy the columns", lambda ue: [
                          ue.view(d, m, n, E_)[:, j].contiguous()
                          for j in range(m)]),
                      (f"C planes x{m}", lambda cols: [C(u) for u in cols]),
                      ("stack", lambda fes: torch.stack(fes, dim=1)),
                      ("B planes", lambda fe: op.plan.sum_planes(
                          fe.view(d * m, n * E_))),
                      ("view as [N, d, m]", lambda y: y.reshape(
                          d, m, N_).permute(2, 0, 1))]
            package = op.apply_block
        return compare_layouts(label, rows, planes, package, inputs, True)

    stage_table["block_apply"] = layouts(
        "dense block apply (cell, 6 columns)", hrk_d, block_inputs, 6, False)
    stage_table["single_apply"] = layouts(
        "dense single apply (bench mesh)", rk, inputs, 1, True)
    hsim._routed = None
    os.environ["MESHFEM_FACTORED"] = "1"
    try:
        hrk_f = hsim.routed_kernel(block_rhs=6)      # factored, kernel C
    finally:
        os.environ.pop("MESHFEM_FACTORED", None)
        hsim._routed = None
    stage_table["factored_block_apply"] = factored_layouts(
        "factored block apply (cell, 6 columns)", hrk_f, block_inputs, 6,
        False)
    stage_table["factored_single_apply"] = factored_layouts(
        "factored single apply (bench mesh)", rkf, inputs, 1, True)
    del hrk_f
    summary["stage_table"] = stage_table

    # -- 10. the structured multigrid: the default call on Kuhn grids ------
    struct, shell_inputs = drive_structured(sim, u, dev, gen)
    summary["structured"] = struct

    # -- 11. boundary conditions, the rigid-motion projection, warm starts -
    t0 = time.time()
    bc_out, bc_paths = drive_bc(sim.mesh, dev)
    bc_out["phase_s"] = time.time() - t0
    log(f"boundary-condition phases (11a-d): {bc_out['phase_s']:.1f} s")
    summary["boundary_conditions"] = bc_out

    # -- 12. voxel homogenization, the orthotropic cell, two-level, SIMP ---
    cells, cell_paths = drive_cells(dev)
    tl_h = cells["twolevel"].pop("prolong_f64_inputs")
    summary["cells"] = cells

    # -- 13. triangle meshes, 2D elasticity and 2D homogenization ---------
    two_d, paths_2d, hsim_2d = drive_2d(dev)
    summary["two_d"] = two_d

    # -- 14. kernels timed beside bound, plain version and library call ----
    timer = Timer(dev)
    report = []

    def entry(name, source, replaces, launches, err, fn, plain, library,
              nbytes, flops, algorithm_flops=None, flop_rate=F32_FLOP_PER_S,
              algorithm_flop_rate=F32_FLOP_PER_S, timed=None,
              timed_clean=None, **extra):
        """``flops``: the fewest operations a known algorithm needs for the
        function on these inputs (the bound's), at ``flop_rate``;
        ``algorithm_flops``: what the kernel's own algorithm does, where
        that is more, at ``algorithm_flop_rate`` (the precision it runs
        in); ``library``: None where no one PyTorch call computes the
        function; ``timed``: more calls, by key, timed as ``fn`` is;
        ``timed_clean``: the same with the L2 flushed by a read."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / flop_rate * 1e3
        if algorithm_flops is not None:
            extra["algorithm_ops_ms"] = (algorithm_flops / algorithm_flop_rate
                                         * 1e3)
        d = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches, max_abs_err=err, ms=timer(fn),
                 plain_ms=timer(plain, reps=5), bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=None if library is None else timer(library))
        d["bound_share"] = d["bound_ms"] / d["ms"]
        d.update(extra)
        d.update({k: timer(f) for k, f in (timed or {}).items()})
        d.update({k: timer(f, clean=True)
                  for k, f in (timed_clean or {}).items()})
        report.append(d)
        lib_ms = "none" if library is None else f"{d['library_ms']:.4f} ms"
        log(f"{name}: {d['ms']:.4f} ms (bound {d['bound_ms']:.4f} ms by "
            f"{d['bound_by']}, {d['bound_share']:.0%} of it), plain "
            f"{d['plain_ms']:.4f} ms, library {lib_ms}, max abs err "
            f"{err:.3e}, launches {launches}")

    ids_long = ids.long()
    entry("gather_planes", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139", counts_fact["gather_planes"],
          err_a, lambda: kernels.gather_planes(src3, ids),
          lambda: kernels.gather_planes_plain(src3, ids),
          lambda: torch.index_select(src3, 1, ids_long),
          S * 4 + 3 * N * 4 + 3 * S * 4, 0,
          also_replaces="meshfem_tpu/sparse/route.py:187 (_copy_kernel, "
                        "1 plane)",
          planes1_ms=timer(lambda: kernels.gather_planes(src3[:1], ids)),
          planes1_plain_ms=timer(
              lambda: kernels.gather_planes_plain(src3[:1], ids), reps=5),
          planes1_bound_ms=(S * 4 + N * 4 + S * 4) / HBM_BYTES_PER_S * 1e3,
          planes1_library_ms=timer(
              lambda: torch.index_select(src3[:1], 1, ids_long)),
          launches_path="factored clamped solve",
          library_call="torch.index_select",
          shape=f"src [3, {N}] f32, ids [{S}] int32")

    acc32 = torch.zeros((3, N), device=dev)
    acc64 = torch.zeros((3, N), device=dev, dtype=torch.float64)
    dst64 = sim._kernel.elem_dofs.reshape(-1)
    entry("segment_sum_csr", "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162", counts_fact["segment_sum_csr"],
          err_b, lambda: kernels.segment_sum_csr(fsrc, perm, offs),
          lambda: kernels.segment_sum_csr_plain(fsrc, perm, offs),
          lambda: acc32.index_add_(1, ids_long, fsrc),
          3 * S * 4 + S * 4 + (N + 1) * 4 + 3 * N * 4, 3 * S,
          also_replaces="meshfem_tpu/sparse/route.py:207 (_reduce_kernel, "
                        "1 plane); the SumPlan ladder "
                        "(meshfem_tpu/sparse/routed_ebe.py:74-123)",
          launches_path="factored clamped solve",
          library_call="Tensor.index_add_ (float atomics, not "
                       "deterministic)",
          shape=f"src [3, {S}] f32 -> [3, {N}]",
          planes1_ms=timer(lambda: kernels.segment_sum_csr(fsrc[:1], perm,
                                                           offs)),
          planes1_plain_ms=timer(lambda: kernels.segment_sum_csr_plain(
              fsrc[:1], perm, offs), reps=5),
          planes1_bound_ms=(S * 4 + S * 4 + (N + 1) * 4 + N * 4)
          / HBM_BYTES_PER_S * 1e3,
          planes1_library_ms=timer(
              lambda: acc32[:1].index_add_(1, ids_long, fsrc[:1])),
          f64_ms=timer(lambda: kernels.segment_sum_csr(
              dsrc, plan64.perm, plan64.offsets)),
          f64_plain_ms=timer(lambda: kernels.segment_sum_csr_plain(
              dsrc, plan64.perm, plan64.offsets), reps=5),
          f64_bound_ms=(3 * S * 8 + S * 4 + (N + 1) * 4 + 3 * N * 8)
          / HBM_BYTES_PER_S * 1e3,
          f64_library_ms=timer(lambda: acc64.index_add_(1, dst64, dsrc)),
          f64_max_abs_err=err_b64)

    Q, nn, K1 = qp_tables(3, 2)[0].shape
    # the quadrature form, per element: the fewest operations known for
    # f = vol Ke u from (g, vol, u); kernels C and D both compute it
    qp_flops = Q * (2 * nn * 3 * K1 + 2 * 9 * nn + 3 + 1 + 9 * 4 + 3 * 2
                    + 2 * nn * 9)
    flops = E * qp_flops
    ue_dense = ue.permute(2, 1, 0).reshape(E, 30, 1)    # node-major a*3+c
    entry("qp_contract", "meshfem_tpu_torch/csrc/qp_contract.cu",
          "meshfem_tpu/sparse/contract.py:232",
          own_mode(counts_fact, "qp_contract"),
          err_c, lambda: kernels.qp_contract(rkf.g, rkf.vol, ue, lam, mu),
          lambda: kernels.qp_contract_plain(rkf.g, rkf.vol, ue, lam, mu),
          lambda: torch.bmm(rk.KeP, ue_dense),
          (12 + 1 + 30 + 30) * E * 4, flops, max_rel_err=rel_c,
          ptxas=ptxas.get("qp_contract.cu", []),
          timed_clean=dict(clean_l2_ms=lambda: kernels.qp_contract(
              rkf.g, rkf.vol, ue, lam, mu)),
          mode="planes [3, 10, E], the direct path",
          launches_path="factored clamped solve, launches in planes (none: "
                        "its applies run in node rows, qp_contract/rows)",
          library_call="torch.bmm with the dense f32 Ke",
          shape=f"g [12, {E}], vol [{E}], ue [3, 10, {E}] f32")

    # D at the homogenization cell's shapes (the path that runs it)
    hg, hvol = hrk.g, hrk.vol
    ue_h = torch.randn((3, 10, Eh), generator=gen, device=dev)
    dh = kernels.factored_contract(hg, hvol, ue_h, lam, mu)
    dh_ref = kernels.factored_contract_plain(hg, hvol, ue_h, lam, mu)
    err_dh = float((dh - dh_ref).abs().max())
    rel_dh = err_dh / float(dh_ref.abs().max())
    if not rel_dh <= 1e-5:
        raise RuntimeError(f"factored_contract disagrees with plain at the "
                           f"cell's shapes: {rel_dh}")
    del dh, dh_ref
    hKeP = hrk_d.KeP
    ue_h_dense = ue_h.permute(2, 1, 0).reshape(Eh, 30, 1)
    K1, nn = 4, 10
    NG, NPAIR = K1 * (K1 + 1) // 2, nn * (nn + 1) // 2
    # the kernel's reassociated table form, per element: d1, S d1, f from
    # g and A, the distinct G2, the distinct W, W u, the volume
    fma_d = (K1 * nn * 3 + (K1 * nn) ** 2 + 3 * nn * K1 + NG * 3
             + NPAIR * NG + 3 * nn * nn + 3 * nn)
    entry("factored_contract", "meshfem_tpu_torch/csrc/factored_contract.cu",
          "meshfem_tpu/sparse/contract.py:91",
          own_mode(homog["factored_tq"]["launches"], "factored_contract"),
          err_dh,
          lambda: kernels.factored_contract(hg, hvol, ue_h, lam, mu),
          lambda: kernels.factored_contract_plain(hg, hvol, ue_h, lam, mu),
          lambda: torch.bmm(hKeP, ue_h_dense),
          (12 + 1 + 30 + 30) * Eh * 4, qp_flops * Eh,
          algorithm_flops=2 * fma_d * Eh, max_rel_err=rel_dh,
          vs_kernel_c=rel_dc, max_rel_err_bench_mesh=rel_d,
          qp_contract_same_inputs_ms=timer(
              lambda: kernels.qp_contract(hg, hvol, ue_h, lam, mu)),
          ptxas=ptxas.get("factored_contract.cu", []),
          mode="planes [3, 10, E]",
          launches_path="factored TQ homogenize, launches in planes (none: "
                        "its block applies run in node rows)",
          library_call="torch.bmm with the dense f32 Ke",
          shape=f"g [12, {Eh}], vol [{Eh}], ue [3, 10, {Eh}] f32")

    # C and D in element-major node rows, as the factored applies run them:
    # one column on the bench mesh (the solves), six on the cell (the block
    # apply), each held against its plain version and, column by column,
    # against itself in planes (bit for bit)
    ue_rows6 = torch.randn((Eh * 10, 18), generator=gen, device=dev)
    for name, label, gv, urows, Ecount, m, launches, path, K in (
            ("qp_contract", "qp_contract/rows", (rkf.g, rkf.vol), ue_rows,
             E, 1, own_mode(counts_fact, "qp_contract/rows"),
             "factored clamped solve", rk.KeP),
            ("factored_contract", "factored_contract/rows", (rkf.g, rkf.vol),
             ue_rows, E, 1, 0, "none (no 3D single-vector path runs the TQ "
             "backend)", rk.KeP),
            ("qp_contract", "qp_contract/rows/6", (hg, hvol), ue_rows6, Eh,
             6, own_mode(homog["factored"]["launches"], "qp_contract/rows"),
             "factored homogenize (one launch a block apply)", hKeP),
            ("factored_contract", "factored_contract/rows/6", (hg, hvol),
             ue_rows6, Eh, 6, own_mode(homog["factored_tq"]["launches"],
                                       "factored_contract/rows"),
             "factored TQ homogenize (one launch a block apply)", hKeP)):
        fn = getattr(kernels, name)
        plain = getattr(kernels, name + "_plain")
        out_rows = fn(*gv, urows, lam, mu, rows=True)
        ref = plain(*gv, urows, lam, mu, rows=True)
        err = float((out_rows - ref).abs().max())
        rel = err / float(ref.abs().max())
        u4, f4 = urows.view(Ecount, 10, 3, m), out_rows.view(Ecount, 10, 3, m)
        same = all(torch.equal(
            fn(*gv, u4[..., j].permute(2, 1, 0).contiguous(), lam, mu),
            f4[..., j].permute(2, 1, 0)) for j in range(m))
        del ref, u4, f4, out_rows
        log(f"{label}: {rel:.3e} of max|y| against plain; "
            f"{'equal bit for bit to' if same else 'NOT EQUAL to'} the "
            f"kernel in planes column by column")
        if not (rel <= 1e-5 and same):
            raise RuntimeError(f"{label} disagrees with plain or with planes")
        extra = dict(ptxas=ptxas.get(name + ".cu", []))
        if name == "factored_contract":
            extra.update(algorithm_flops=2 * fma_d * Ecount * m)
        else:
            extra.update(timed_clean=dict(clean_l2_ms=lambda: fn(
                *gv, urows, lam, mu, rows=True)))
        entry(label, f"meshfem_tpu_torch/csrc/{name}.cu",
              "meshfem_tpu/sparse/contract.py:"
              + ("232" if name == "qp_contract" else "91"), launches, err,
              lambda: fn(*gv, urows, lam, mu, rows=True),
              lambda: plain(*gv, urows, lam, mu, rows=True),
              lambda: torch.bmm(K, urows.view(Ecount, 30, m)),
              (12 + 1 + 2 * 30 * m) * Ecount * 4, qp_flops * Ecount * m,
              max_rel_err=rel, equals_planes_bitwise=same, columns=m,
              mode=f"element-major rows [E*10, {3 * m}], "
                   + ("pipelined through shared memory by bulk "
                      "asynchronous copies" if name == "qp_contract"
                      else "staged in shared memory")
                   + ", as the factored applies run it",
              launches_path=path,
              library_call="torch.bmm with the dense f32 Ke "
                           f"([E, 30, 30] @ [E, 30, {m}])",
              shape=f"g [12, {Ecount}], vol [{Ecount}], rows "
                    f"[{Ecount * 10}, {3 * m}] f32", **extra)
    del ue_rows6
    ue_h_block = torch.randn((Eh, 30, 6), generator=gen, device=dev)
    U64 = block_inputs[0].double()
    summary["homogenization"].update(
        dense_block_bmm_ms=timer(lambda: torch.bmm(hKeP, ue_h_block)),
        dense_block_bmm_bound_ms=(hKeP.numel() + 2 * ue_h_block.numel()) * 4
        / HBM_BYTES_PER_S * 1e3,
        ebe64_block_apply_ms=median_apply_ms(
            hsim.apply_K, [U64 * (1 + i) for i in range(5)]))
    del hKeP, ue_h_dense, ue_h_block, U64

    M32 = torch.as_tensor(em.fused_matrix_for(sim.D, 3, 2),
                          dtype=torch.float32, device=dev)
    gg32 = torch.einsum("eka,elb->ekalb", gl32, gl32).reshape(E, 144) \
        * vol32[:, None]
    entry("element_stiffness", "meshfem_tpu_torch/csrc/element_stiffness.cu",
          "meshfem_tpu/kernels/element_stiffness.py:42",
          counts_dense["element_stiffness"], err_e,
          lambda: kernels.element_stiffness(gl32, vol32, D_host, 2),
          lambda: kernels.element_stiffness_plain(gl32, vol32, D_host, 2),
          lambda: em.element_elasticity_fused_apply(gl32, vol32, M32, 10),
          (12 + 1 + 900) * E * 4 + 36 * 8,
          # material first, table second: H[k,l,c,f] = g_ka g_lb C_cafb
          # (144 x 9 FMAs), Ke = vol T[k,l,i,j] H[k,l,c,f] (900 x 16 FMAs)
          (2 * (144 * 9 + 900 * 16) + 900) * E,
          # the kernel's, in float64: H's 10 distinct (k <= l) blocks (9
          # products g g, 9 x 9 FMAs each), 900 x 16 FMAs for Ke and 900
          # volume products
          algorithm_flops=(2 * (10 * (9 + 81) + 900 * 16) + 900) * E,
          algorithm_flop_rate=F64_FLOP_PER_S,
          max_abs_err_vs_f64=err_e64, max_abs_Ke=ke_max,
          max_abs_err_plain_vs_f64=err_plain64,
          max_ulps_vs_f64=ulps_e64, max_ulps_plain_vs_f64=ulps_plain64,
          max_ulps_vs_f64_random_inputs=ulps_e_rand,
          dense_solve_inner_iters=res.iters,
          max_rel_err_random_anisotropic=(err_e_rand_aniso[0]
                                          / err_e_rand_aniso[1]),
          ptxas=ptxas.get("element_stiffness.cu", []),
          max_abs_err_random_inputs=err_e_rand,
          max_abs_Ke_random_inputs=ke_max_rand,
          launches_assembly_path=counts_asm["element_stiffness"],
          launches_homogenization={k: v["launches"]["element_stiffness"]
                                   for k, v in homog.items()},
          matmul_only_ms=timer(lambda: torch.matmul(gg32, M32)),
          library_call="ops.element_matrices.element_elasticity_fused_apply "
                       "(einsum + torch.matmul, TF32 off)",
          shape=f"grad_lambda [{E}, 4, 3], vol [{E}] f32, D [6, 6] f64")
    del gg32
    log(f"E against the f64 Ke: kernel {err_e64:.3e}, the plain one-product "
        f"form {err_plain64:.3e} (max|Ke| {ke_max:.3e}); dense clamped "
        f"solve {res.iters} inner iterations")

    # A and B at the 18 planes of the block apply (the cell's operator)
    hids, Sh = hrk.ids, hrk.ids.shape[0]
    hids_long = hids.long()
    src18 = torch.randn((18, Nh), generator=gen, device=dev)
    g18 = kernels.gather_planes(src18, hids)
    if not torch.equal(g18, kernels.gather_planes_plain(src18, hids)):
        raise RuntimeError("gather_planes (planes 18) != plain")
    report[0].update(
        planes18_ms=timer(lambda: kernels.gather_planes(src18, hids)),
        planes18_plain_ms=timer(
            lambda: kernels.gather_planes_plain(src18, hids), reps=5),
        planes18_bound_ms=(Sh * 4 + 18 * Nh * 4 + 18 * Sh * 4)
        / HBM_BYTES_PER_S * 1e3,
        planes18_library_ms=timer(
            lambda: torch.index_select(src18, 1, hids_long)),
        planes18_shape=f"src [18, {Nh}] f32, ids [{Sh}] int32",
        launches_homogenization={k: v["launches"]["gather_planes"]
                                 for k, v in homog.items()})
    hperm, hoffs = hrk.plan.perm, hrk.plan.offsets
    s18 = kernels.segment_sum_csr(g18, hperm, hoffs)
    s18_ref = kernels.segment_sum_csr_plain(g18, hperm, hoffs)
    err_b18 = float((s18 - s18_ref).abs().max())
    if not err_b18 <= 1e-5 * float(s18_ref.abs().max()):
        raise RuntimeError(f"segment_sum_csr (planes 18) disagrees: "
                           f"{err_b18}")
    hplan64 = hsim._kernel.plan
    d18 = torch.randn((18, hplan64.num_rows), generator=gen, device=dev,
                      dtype=torch.float64)
    r18 = kernels.segment_sum_csr(d18, hplan64.perm, hplan64.offsets)
    r18_ref = kernels.segment_sum_csr_plain(d18, hplan64.perm,
                                            hplan64.offsets)
    err_b18_64 = float((r18 - r18_ref).abs().max())
    if not err_b18_64 <= 1e-12 * float(r18_ref.abs().max()):
        raise RuntimeError(f"segment_sum_csr f64 (planes 18) disagrees: "
                           f"{err_b18_64}")
    del s18, s18_ref, r18, r18_ref
    acc18 = torch.zeros((18, Nh), device=dev)
    acc18_64 = torch.zeros((18, Nh), device=dev, dtype=torch.float64)
    hdst64 = hsim._kernel.elem_dofs.reshape(-1)
    report[1].update(
        planes18_ms=timer(lambda: kernels.segment_sum_csr(g18, hperm,
                                                          hoffs)),
        planes18_plain_ms=timer(lambda: kernels.segment_sum_csr_plain(
            g18, hperm, hoffs), reps=5),
        planes18_bound_ms=(18 * Sh * 4 + Sh * 4 + (Nh + 1) * 4
                           + 18 * Nh * 4) / HBM_BYTES_PER_S * 1e3,
        planes18_library_ms=timer(
            lambda: acc18.index_add_(1, hids_long, g18)),
        planes18_max_abs_err=err_b18,
        planes18_f64_ms=timer(lambda: kernels.segment_sum_csr(
            d18, hplan64.perm, hplan64.offsets)),
        planes18_f64_plain_ms=timer(lambda: kernels.segment_sum_csr_plain(
            d18, hplan64.perm, hplan64.offsets), reps=5),
        planes18_f64_bound_ms=(18 * Sh * 8 + Sh * 4 + (Nh + 1) * 4
                               + 18 * Nh * 8) / HBM_BYTES_PER_S * 1e3,
        planes18_f64_library_ms=timer(
            lambda: acc18_64.index_add_(1, hdst64, d18)),
        planes18_f64_max_abs_err=err_b18_64,
        planes18_shape=f"src [18, {Sh}] -> [18, {Nh}]",
        launches_homogenization={k: v["launches"]["segment_sum_csr"]
                                 for k, v in homog.items()})
    for r in report[:2]:
        log(f"{r['name']} at 18 planes: {r['planes18_ms']:.4f} ms (bound "
            f"{r['planes18_bound_ms']:.4f} ms), plain "
            f"{r['planes18_plain_ms']:.4f} ms, library "
            f"{r['planes18_library_ms']:.4f} ms")
    report[2]["launches_homogenization"] = own_mode(
        homog["factored"]["launches"], "qp_contract")

    del g18, d18, acc18, acc18_64
    # A and B in node rows: the dense applies' layout
    ids_em_long = ids_em.long()
    u3rows = src3.t().contiguous()
    entry("gather_rows", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139", counts_dense["gather_rows"],
          err_a_rows,
          lambda: kernels.gather_rows(src3, ids_em, planes_in=True),
          lambda: kernels.gather_rows_plain(src3, ids_em, True),
          lambda: torch.index_select(src3.t(), 0, ids_em_long),
          S * 4 + 3 * N * 4 + 3 * S * 4, 0,
          also_replaces="meshfem_tpu/sparse/route.py:187 (_copy_kernel)",
          mode="rows out [S, 3] from planes [3, N], as apply_planes runs it",
          launches_path="dense clamped solve",
          rows_in_ms=timer(lambda: kernels.gather_rows(u3rows, ids_em)),
          rows_in_library_ms=timer(
              lambda: torch.index_select(u3rows, 0, ids_em_long)),
          library_call="torch.index_select (dim 0 of the [N, 3] view)",
          shape=f"src [3, {N}] f32, ids_em [{S}] int32")
    h_ids_em = hrk_d.ids_em
    h_ids_em_long = h_ids_em.long()
    U18 = block_inputs[0].reshape(Nh, 18)
    g18r = kernels.gather_rows(U18, h_ids_em)
    if not torch.equal(g18r, kernels.gather_rows_plain(U18, h_ids_em)):
        raise RuntimeError("gather_rows (18 values a node, cell) != plain")
    entry("gather_rows/18", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139",
          homog["dense"]["launches"]["gather_rows"], 0.0,
          lambda: kernels.gather_rows(U18, h_ids_em),
          lambda: kernels.gather_rows_plain(U18, h_ids_em),
          lambda: torch.index_select(U18, 0, h_ids_em_long),
          Sh * 4 + 18 * Nh * 4 + 18 * Sh * 4, 0,
          mode="rows [Nh, 18] -> [Sh, 18], as apply_block runs it",
          launches_path="dense homogenize", library_call="torch.index_select",
          shape=f"U [{Nh}, 18] f32, ids_em [{Sh}] int32")

    # A on float64 rows (moved as float32 pairs) at the two-level
    # prolongation's shapes: the void cell's 6 columns, phase 12c
    NCh, NDh = tl_h.n_coarse, tl_h.ids_ab.shape[0] // 2
    xc64 = torch.randn((NCh, 18), generator=gen, device=dev,
                       dtype=torch.float64)
    ab_long = tl_h.ids_ab.long()
    g64 = kernels.gather_rows(xc64, tl_h.ids_ab)
    if not torch.equal(g64, kernels.gather_rows_plain(xc64, tl_h.ids_ab)):
        raise RuntimeError("gather_rows (float64, two-level) != plain")
    entry("gather_rows/f64/18", "meshfem_tpu_torch/csrc/gather_planes.cu",
          "meshfem_tpu/sparse/route.py:139 (here the two-level "
          "prolongation, a jnp gather at meshfem_tpu/solvers/twolevel.py:170)",
          cell_paths["twolevel_homogenize"]["gather_rows/f64"], 0.0,
          lambda: kernels.gather_rows(xc64, tl_h.ids_ab),
          lambda: kernels.gather_rows_plain(xc64, tl_h.ids_ab),
          lambda: torch.index_select(xc64, 0, ab_long),
          2 * NDh * 4 + NCh * 18 * 8 + 2 * NDh * 18 * 8, 0,
          mode="f64 rows [NC, 18] -> [2 ND, 18], as TwoLevel.prolong runs "
               "it (the kernel moves [NC, 36] float32 pairs)",
          launches_path="two-level homogenize (12c), float64 launches",
          library_call="torch.index_select",
          shape=f"src [{NCh}, 18] f64, ids_ab [{2 * NDh}] int32")
    del g64

    perm_em, h_perm_em = rk.plan_em.perm, hrk_d.plan_em.perm
    rows3 = fsrc.reshape(3, 10, E).permute(2, 1, 0).reshape(S, 3)
    acc_r3 = torch.zeros((N, 3), device=dev)
    entry("segment_sum_rows", "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162",
          own_mode(counts_dense, "segment_sum_rows"), err_rows[("f32", 3)],
          lambda: kernels.segment_sum_rows(rows3, perm_em, offs,
                                           planes_out=True),
          lambda: kernels.segment_sum_rows_plain(rows3, perm_em, offs, True),
          lambda: acc_r3.index_add_(0, ids_em_long, rows3),
          3 * S * 4 + S * 4 + (N + 1) * 4 + 3 * N * 4, 3 * S,
          also_replaces="meshfem_tpu/sparse/route.py:207 (_reduce_kernel)",
          mode="rows [S, 3] -> planes [3, N], as apply_planes runs it",
          launches_path="dense clamped solve, float32 launches",
          library_call="Tensor.index_add_ (float atomics, not "
                       "deterministic)",
          shape=f"src [{S}, 3] f32 -> [3, {N}]")
    err_b18r = float((kernels.segment_sum_rows(g18r, h_perm_em, hoffs)
                      - kernels.segment_sum_rows_plain(g18r, h_perm_em,
                                                       hoffs)).abs().max())
    acc_r18 = torch.zeros((Nh, 18), device=dev)
    entry("segment_sum_rows/18", "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162",
          own_mode(homog["dense"]["launches"], "segment_sum_rows/18"),
          err_b18r,
          lambda: kernels.segment_sum_rows(g18r, h_perm_em, hoffs),
          lambda: kernels.segment_sum_rows_plain(g18r, h_perm_em, hoffs),
          lambda: acc_r18.index_add_(0, h_ids_em_long, g18r),
          18 * Sh * 4 + Sh * 4 + (Nh + 1) * 4 + 18 * Nh * 4, 18 * Sh,
          mode="rows [Sh, 18] -> rows [Nh, 18], as apply_block runs it",
          launches_path="dense homogenize, float32 launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{Sh}, 18] f32 -> [{Nh}, 18]")
    rows64 = dsrc.t().contiguous()
    R64 = plan64.num_rows
    acc_r64 = torch.zeros((N, 3), device=dev, dtype=torch.float64)
    entry("segment_sum_rows/f64", "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (f64: the XLA scatter of "
          "meshfem_tpu/sparse/scatter.py)",
          own_mode(counts_dense, "segment_sum_rows/f64"), err_rows[("f64", 3)],
          lambda: plan64.sum_rows(rows64),
          lambda: kernels.segment_sum_rows_plain(rows64, plan64.perm,
                                                 plan64.offsets),
          lambda: acc_r64.index_add_(0, dst64, rows64),
          3 * R64 * 8 + R64 * 4 + (N + 1) * 4 + 3 * N * 8, 3 * R64,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [R, 3] -> rows [N, 3]: the EBE residual apply",
          launches_path="dense clamped solve, float64 launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{R64}, 3] f64 -> [{N}, 3]")
    hR64 = hplan64.num_rows
    rows64_18 = torch.randn((hR64, 18), generator=gen, device=dev,
                            dtype=torch.float64)
    r18r = kernels.segment_sum_rows(rows64_18, hplan64.perm, hplan64.offsets)
    r18r_ref = kernels.segment_sum_rows_plain(rows64_18, hplan64.perm,
                                              hplan64.offsets)
    err_b18r64 = float((r18r - r18r_ref).abs().max())
    if not err_b18r64 <= 1e-12 * float(r18r_ref.abs().max()):
        raise RuntimeError(f"segment_sum_rows f64 (18 values a node, cell) "
                           f"disagrees: {err_b18r64}")
    del r18r, r18r_ref
    acc_r64_18 = torch.zeros((Nh, 18), device=dev, dtype=torch.float64)
    entry("segment_sum_rows/f64/18",
          "meshfem_tpu_torch/csrc/segment_sum_csr.cu",
          "meshfem_tpu/sparse/route.py:162 (f64: the XLA scatter of "
          "meshfem_tpu/sparse/scatter.py)",
          own_mode(homog["dense"]["launches"], "segment_sum_rows/f64/18"),
          err_b18r64,
          lambda: hplan64.sum_rows(rows64_18),
          lambda: kernels.segment_sum_rows_plain(rows64_18, hplan64.perm,
                                                 hplan64.offsets),
          lambda: acc_r64_18.index_add_(0, hdst64, rows64_18),
          18 * hR64 * 8 + hR64 * 4 + (Nh + 1) * 4 + 18 * Nh * 8, 18 * hR64,
          flop_rate=F64_FLOP_PER_S,
          mode="f64 rows [R, 18] -> rows [Nh, 18]: the block residual",
          launches_path="dense homogenize, float64 launches",
          library_call="Tensor.index_add_ (float atomics)",
          shape=f"src [{hR64}, 18] f64 -> [{Nh}, 18]")

    # F, and kernel A on the same count of routed values
    n_vals = NV * 1024
    ids_same = ids_em[:n_vals // 3].contiguous()
    entry("route_window", "meshfem_tpu_torch/csrc/route_window.cu",
          "experiments/probe_route.py:22", counts_probe["route_window"],
          err_f, lambda: kernels.route_window(px, pwin0, pwidx, plidx, CHAIN),
          lambda: kernels.route_window_plain(px, pwin0, pwidx, plidx, CHAIN),
          None, NT * 128 * 4 + NV * 4 + 3 * n_vals * 4, 0,
          launches_path="the probe phase (8)",
          kernel_a_same_values_ms=timer(lambda: kernels.gather_rows(
              src3, ids_same, planes_in=True)),
          library_call=None,
          shape=f"x [{NT}, 128], win0 [{NV}], widx/lidx/out [{NV}, 8, 128]")
    f = report[-1]
    f["routed_values"] = n_vals
    f["values_per_s"] = n_vals / (f["ms"] * 1e-3)
    f["kernel_a_values_per_s"] = n_vals / (f["kernel_a_same_values_ms"]
                                           * 1e-3)
    log(f"route_window: {f['values_per_s'] / 1e9:.1f} Gvalues/s; kernel A "
        f"(rows from planes, 3 values a slot) on the same {n_vals} values "
        f"{f['kernel_a_same_values_ms']:.4f} ms, "
        f"{f['kernel_a_values_per_s'] / 1e9:.1f} Gvalues/s")
    for r in report:
        if r["name"].startswith(("gather_rows", "segment_sum_rows")):
            log(f"{r['name']}: {r['ms'] / r['library_ms']:.3f} x its library "
                f"call, {r['ms'] / r['bound_ms']:.3f} x its bound")

    # A and B at the shell correction's shapes (the structured path)
    src_s, ids_s, fe_s, plan_s, conv_call = shell_inputs
    st = struct["stages"]
    st["conv_flushed_ms"] = timer(conv_call)
    log(f"structured conv alone (L2 flushed, host ahead): "
        f"{st['conv_flushed_ms']:.4f} ms, "
        f"{st['conv_flushed_ms'] / st['conv_bound_ms']:.1f} x its bound "
        f"{st['conv_bound_ms']:.4f}, "
        f"{st['conv_dense_ops_ms'] / st['conv_flushed_ms']:.3f} of the "
        f"FP32 rate on the dense conv's operations; "
        f"{st['conv_launches_default_solve']} launches in the default solve")
    R_s, S_s = ids_s.shape[0], plan_s.num_segments
    kept_s = plan_s.perm.shape[0]
    ids_s_long = ids_s.long().clamp(min=0)
    # the gather reads only the distinct in-box slots, each once
    slots_s = int(torch.unique(ids_s[ids_s >= 0]).numel())
    acc_s = torch.zeros((S_s, 3), device=dev)
    seg_s = torch.repeat_interleave(
        torch.arange(S_s, device=dev),
        (plan_s.offsets[1:] - plan_s.offsets[:-1]).long())
    fe_sorted = fe_s[plan_s.perm.long()]
    for r in report:
        if r["name"] == "gather_rows":
            r.update(
                launches_structured=struct["launches"]["gather_rows"],
                shell_ms=timer(lambda: kernels.gather_rows(src_s, ids_s)),
                shell_plain_ms=timer(lambda: kernels.gather_rows_plain(
                    src_s, ids_s), reps=5),
                shell_bound_ms=(R_s * 4 + slots_s * 3 * 4 + R_s * 3 * 4)
                / HBM_BYTES_PER_S * 1e3,
                shell_slots_read=slots_s,
                shell_library_ms=timer(
                    lambda: torch.index_select(src_s, 0, ids_s_long)),
                shell_shape=f"rows [{src_s.shape[0]}, 3] f32, fake-cube "
                            f"ids [{R_s}] int32 (-1 outside the box)")
        elif r["name"] == "segment_sum_rows":
            r.update(
                launches_structured=struct["launches"]["segment_sum_rows"],
                shell_ms=timer(lambda: kernels.segment_sum_rows(
                    fe_s, plan_s.perm, plan_s.offsets)),
                shell_plain_ms=timer(lambda: kernels.segment_sum_rows_plain(
                    fe_s, plan_s.perm, plan_s.offsets), reps=5),
                shell_bound_ms=(kept_s * 3 * 4 + kept_s * 4 + (S_s + 1) * 4
                                + S_s * 3 * 4) / HBM_BYTES_PER_S * 1e3,
                shell_library_ms=timer(
                    lambda: acc_s.index_add_(0, seg_s, fe_sorted)),
                shell_max_abs_err=struct["shell"]["sum_max_abs_err"],
                shell_shape=f"rows [{R_s}, 3] f32 ({kept_s} in the box) -> "
                            f"[{S_s}, 3] shell slots")
    for r in report:
        if "shell_ms" in r:
            log(f"{r['name']} at the shell correction's shapes: "
                f"{r['shell_ms']:.4f} ms (bound {r['shell_bound_ms']:.4f}), "
                f"plain {r['shell_plain_ms']:.4f}, library "
                f"{r['shell_library_ms']:.4f}; launches in the structured "
                f"default solve {r['launches_structured']}")

    # 13e: the kernels at their 2D shapes
    t0 = time.time()
    two_d["kernel_checks"] = kernels_2d(dev, entry, paths_2d, hsim_2d,
                                        ptxas)
    two_d["kernels_s"] = time.time() - t0
    del hsim_2d

    # -- 15. scalar Poisson, operators, geodesics, I/O and the CLIs --------
    poisson, poisson_paths, big = drive_poisson(dev, sim, u)
    poisson["laplacian_stages"] = kernels_poisson(dev, entry, big,
                                                  poisson_paths, gen)
    summary["poisson"] = poisson
    del big

    # -- 16. AMG, deformed configurations, deformed cells and their CLIs ---
    amg_out, amg_paths, mg = drive_amg(dev, sim, u, gen)
    amg_out["deformed"], p, dsim = drive_deformed(
        dev, cell, hsim, Chs["dense"], two_d["tri_cell"]["Ch"])
    amg_paths.update(p)
    t0 = time.time()
    amg_out["kernel_checks"] = kernels_amg(dev, entry, sim, mg, amg_paths,
                                           dsim, gen)
    amg_out["kernels_s"] = time.time() - t0
    summary["amg"] = amg_out
    del mg, dsim

    # -- 17. modes, material optimization, autograd, energies, Newton -----
    p17, paths17, objs17 = drive_phase17(dev, gen)
    t0 = time.time()
    p17["kernel_checks"] = kernels_phase17(dev, entry, objs17, paths17, gen)
    p17["kernels_s"] = time.time() - t0
    summary["phase17"] = p17
    del objs17

    # -- 18. multi-device: domain decomposition, routed shards, ranks -----
    p18, paths18, objs18 = drive_multidevice(dev, sim, u, gen)
    t0 = time.time()
    p18["kernel_checks"] = kernels_multidevice(dev, entry, objs18, paths18,
                                               gen)
    p18["kernels_s"] = time.time() - t0
    summary["phase18"] = p18
    del objs18

    # -- 19. the analyses: mechanisms, parametrization, curvature, CLI ----
    p19, paths19, objs19 = drive_phase19(dev, gen)
    t0 = time.time()
    p19["kernel_checks"] = kernels_phase19(dev, entry, objs19, paths19, gen)
    p19["kernels_s"] = time.time() - t0
    summary["phase19"] = p19
    del objs19

    # -- 20. the host tools: core, quality mesh, sampler, mesh CLIs -------
    p20, paths20, sim20 = drive_phase20(dev, core["s"])
    t0 = time.time()
    p20["kernel_checks"] = kernels_phase20(dev, entry, sim20, paths20, gen)
    p20["kernels_s"] = time.time() - t0
    summary["phase20"] = p20
    del sim20
    summary.update(
        dense_bmm_ms=timer(lambda: torch.bmm(rk.KeP, ue_dense)),
        dense_bmm_bound_ms=rk.KeP.numel() * 4 / HBM_BYTES_PER_S * 1e3,
        cg_iter_ms=wall / max(res.iters, 1) * 1e3,
        factored_cg_iter_ms=wallf / max(resf.iters, 1) * 1e3)
    for r in report:          # the launches of phase 11's paths
        r["launches_bc_paths"] = {p: own_mode(c, r["name"])
                                  for p, c in bc_paths.items()}
        r["launches_cell_paths"] = {p: own_mode(c, r["name"])
                                    for p, c in cell_paths.items()}
        r["launches_2d_paths"] = {p: own_mode(c, r["name"])
                                  for p, c in paths_2d.items()}
        r["launches_poisson_paths"] = {p: own_mode(c, r["name"])
                                       for p, c in poisson_paths.items()}
        r["launches_amg_paths"] = {p: own_mode(c, r["name"])
                                   for p, c in amg_paths.items()}
        r["launches_phase17_paths"] = {p: own_mode(c, r["name"])
                                       for p, c in paths17.items()}
        r["launches_phase18_paths"] = {p: own_mode(c, r["name"])
                                       for p, c in paths18.items()}
        r["launches_phase19_paths"] = {p: own_mode(c, r["name"])
                                       for p, c in paths19.items()}
        r["launches_phase20_paths"] = {p: own_mode(c, r["name"])
                                       for p, c in paths20.items()}
    summary["seconds"] = time.time() - t_start
    log("solve " + json.dumps(summary))
    log(json.dumps({"kernels": report}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
