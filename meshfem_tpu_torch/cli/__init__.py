"""Command-line front ends (``python -m meshfem_tpu_torch.cli.<name>``):
``poisson``, ``simulate``, ``homogenize``, ``deformed_cells``,
``material_opt`` and ``mechanisms`` (its ``open`` and ``optimize``
subcommands), each with the reference CLI's arguments plus ``--device``
(the CUDA device by default); and the mesh tools ``mesh_convert`` (host
only), ``msh_processor`` (``--device`` for its torch ops) and ``tools``
(``--device`` on ``extract_b`` and ``isotropic_validation``)."""
