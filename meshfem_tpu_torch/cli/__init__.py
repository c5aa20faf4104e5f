"""Command-line front ends (``python -m meshfem_tpu_torch.cli.<name>``):
``poisson``, ``simulate``, ``homogenize``, ``deformed_cells``,
``material_opt`` and ``mechanisms`` (its ``open`` and ``optimize``
subcommands).  Each takes the reference CLI's arguments plus ``--device``
(the CUDA device by default)."""
