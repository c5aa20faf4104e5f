"""``vis.py`` of ``meshfem_tpu_torch`` against ``meshfem_tpu`` on the CPU.

``write_html_viewer`` writes the reference's file byte for byte for a 2D
P2 mesh with a nodal field and an animated mode, and for a tet mesh with
a per-triangle field and a deformation (tensors given to the port, numpy
to the reference); ``visualization_geometry`` and
``mode_animation_frames`` are equal.  ``save_mesh_png`` writes a PNG in
its four cases: 2D with a nodal field, 2D with a per-element field, 3D
deformed, and 3D with a per-triangle field, where the reference raises
(it calls ``ndarray.ptp``, which NumPy 2 removed).
"""

import numpy as np
import pytest
import torch

from meshfem_tpu import vis as rvis
from meshfem_tpu.mesh import FEMMesh as RFEMMesh
from meshfem_tpu.mesh import generators as rgen

from meshfem_tpu_torch import vis as pvis
from meshfem_tpu_torch.mesh import FEMMesh

TITLE = "viewer"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    """(port, reference) meshes: grid_tri(5, 4) P2 and grid_tet(3, 2, 2)
    P2."""
    out = {}
    for name, (V, F) in (("tri", rgen.grid_tri(5, 4)),
                         ("tet", rgen.grid_tet(3, 2, 2))):
        out[name] = (FEMMesh(V, F, degree=2), RFEMMesh(V, F, degree=2))
    return out


@pytest.mark.parametrize("name", ["tri", "tet"])
def test_visualization_geometry(meshes, name):
    p, r = meshes[name]
    for a, b in zip(pvis.visualization_geometry(p),
                    rvis.visualization_geometry(r)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_html_viewer_2d_is_the_reference_file(meshes, tmp_path):
    p, r = meshes["tri"]
    rng = np.random.default_rng(0)
    field = rng.standard_normal(p.num_nodes)
    mode = rng.standard_normal((p.num_vertices, 2))
    pvis.write_html_viewer(tmp_path / "p.html", p, field=torch.tensor(field),
                           mode=torch.tensor(mode), title=TITLE)
    rvis.write_html_viewer(tmp_path / "r.html", r, field=field, mode=mode,
                           title=TITLE)
    assert (tmp_path / "p.html").read_bytes() == \
        (tmp_path / "r.html").read_bytes()


def test_html_viewer_3d_is_the_reference_file(meshes, tmp_path):
    p, r = meshes["tet"]
    rng = np.random.default_rng(1)
    field = rng.standard_normal(p.num_boundary_elements)
    deformation = 0.01 * rng.standard_normal((p.num_vertices, 3))
    pvis.write_html_viewer(tmp_path / "p.html", p, field=torch.tensor(field),
                           deformation=torch.tensor(deformation),
                           title=TITLE)
    rvis.write_html_viewer(tmp_path / "r.html", r, field=field,
                           deformation=deformation, title=TITLE)
    assert (tmp_path / "p.html").read_bytes() == \
        (tmp_path / "r.html").read_bytes()


def test_mode_animation_frames(meshes):
    p, r = meshes["tri"]
    mode = np.random.default_rng(2).standard_normal((p.num_nodes, 2))
    for a, b in zip(pvis.mode_animation_frames(p, torch.tensor(mode), 5),
                    rvis.mode_animation_frames(r, mode, 5)):
        np.testing.assert_array_equal(a, b)


def _png_cases(mesh):
    rng = np.random.default_rng(3)
    if mesh.K == 2:
        return {"nodal": dict(field=rng.random(mesh.num_nodes)),
                "element": dict(field=rng.random(mesh.num_elements))}
    return {"deformed": dict(deformation=0.01 * rng.standard_normal(
                (mesh.num_nodes, 3))),
            "element": dict(field=rng.random(mesh.num_boundary_elements))}


@pytest.mark.parametrize("name", ["tri", "tet"])
def test_save_mesh_png(meshes, name, tmp_path):
    p, r = meshes[name]
    for case, kw in _png_cases(p).items():
        path = tmp_path / f"{case}.png"
        pvis.save_mesh_png(path, p, **{k: torch.tensor(v)
                                       for k, v in kw.items()})
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", case
        if name == "tet" and case == "element":
            with pytest.raises(AttributeError, match="ptp"):
                rvis.save_mesh_png(tmp_path / "r.png", r, **kw)
        else:
            rvis.save_mesh_png(tmp_path / "r.png", r, **kw)
