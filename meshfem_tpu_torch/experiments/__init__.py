"""The validation suites of the port, one module each, counterparts of
the reference's ``experiments/*.py`` scripts:

    python -m meshfem_tpu_torch.experiments.laplace_convergence [--max 64]
    python -m meshfem_tpu_torch.experiments.elasticity_convergence [--max 32]
    python -m meshfem_tpu_torch.experiments.fit_validation [--n 12]
    python -m meshfem_tpu_torch.experiments.circular_sector_homog [--levels 4]
    python -m meshfem_tpu_torch.experiments.animate_cstrain [--out DIR]
    python -m meshfem_tpu_torch.experiments.conductivity_inverse [--mesh M]
    python -m meshfem_tpu_torch.experiments.extrusion_validation
    python -m meshfem_tpu_torch.experiments.stress_extrusion_validation

Each runs on the CUDA device unless given ``--device cpu``, prints the
reference script's lines and raises where the reference asserts.  Each
keeps its computation in functions that return numbers.

``conductivity_inverse`` and the two extrusion suites read meshes, boundary
conditions and a material from a collection outside this repository in
the reference; given no mesh, the port writes stand-ins of its own into
the working directory (each module's docstring says what they are).

The reference's TPU probes (``experiments/probe_*.py``,
``ab_session.py``, ``fill_probe.py``) are measurement harnesses of the
TPU, not validation suites, and have no counterpart here; their one
Pallas kernel, the lane-routing probe of ``probe_route.py``, is the
port's kernel F (``kernels.route_window``).
"""
