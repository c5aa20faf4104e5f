"""Command-line front ends (``python -m meshfem_tpu_torch.cli.<name>``):
``poisson``, ``simulate``, ``homogenize`` and ``deformed_cells``.  Each
takes the reference CLI's arguments plus ``--device`` (the CUDA device by
default)."""
