"""Runnable examples of the port, one module each, counterparts of the
reference's ``examples/*.py``:

    python -m meshfem_tpu_torch.examples.cantilever [nx ny nz]
    python -m meshfem_tpu_torch.examples.homogenize_voxels [n]
    python -m meshfem_tpu_torch.examples.topology_optimization [--nx ...]
    python -m meshfem_tpu_torch.examples.vibrational_modes [mesh] [n_modes]
    python -m meshfem_tpu_torch.examples.homogenize_microstructure [mesh]

Each runs on the CUDA device unless given ``--device cpu``.
"""
