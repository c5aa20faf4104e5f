"""The port's small dense kernels (``utils/linalg.py``) and the SPSD facade
(``solvers/spsd.py``) against the reference's on the CPU.

Same inputs (numpy, from a seed) through both packages.  Tolerances:
``linalg`` 1e-12 of max (eigenvectors compared directly: same order, same
signs); SPSD solves 1e-10 of max.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from meshfem_tpu.mesh import FEMMesh as RFEMMesh, generators as rgen
from meshfem_tpu.ops import operators as rops
from meshfem_tpu.solvers import spsd as rspsd
from meshfem_tpu.utils import linalg as rla

from meshfem_tpu_torch.mesh import FEMMesh
from meshfem_tpu_torch.ops import operators
from meshfem_tpu_torch.solvers import spsd
from meshfem_tpu_torch.utils import linalg as la


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread: the suite runs six test processes on eight
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sym(rng, shape):
    A = rng.standard_normal(shape)
    return A + np.swapaxes(A, -1, -2)


# -- utils/linalg -----------------------------------------------------------

def _linalg_cases():
    rng = np.random.default_rng(0)
    A3 = rng.standard_normal((4, 5, 3, 3))
    A6 = rng.standard_normal((3, 6, 6))
    b6 = rng.standard_normal((3, 6, 2))
    S5, S6 = _sym(rng, (2, 5, 5)), _sym(rng, (3, 6, 6))
    S7 = _sym(rng, (3, 7, 7))
    Bf = rng.standard_normal((3, 7, 4))
    B7 = Bf @ np.swapaxes(Bf, -1, -2)               # rank 4 of 7: PSD
    Z = rng.standard_normal((20, 5))
    return {
        "det": (lambda m, A: m.det(A), (A3,)),
        "det2": (lambda m, A: m.det(A), (A3[..., :2, :2],)),
        "inv": (lambda m, A: m.inv(A), (A6,)),
        "solve": (lambda m, A, b: m.solve(A, b), (A6, b6)),
        "solve_vec": (lambda m, A, b: m.solve(A, b), (A6, b6[..., 0])),
        "eigh_jacobi": (lambda m, A: m.eigh_jacobi(A, sweeps=8), (S5,)),
        "eigh_jacobi_par_even": (lambda m, A: m.eigh_jacobi_par(A), (S6,)),
        "eigh_jacobi_par_odd": (lambda m, A: m.eigh_jacobi_par(A), (S7,)),
        "generalized_eigh": (lambda m, A, B: m.generalized_eigh(A, B),
                             (S7, B7)),
        "orthonormalize": (lambda m, Z: m.orthonormalize(Z), (Z,)),
    }


@pytest.mark.parametrize("name", sorted(_linalg_cases()))
def test_linalg_against_reference(name):
    """Each small dense kernel, batched, equals the reference's to 1e-12 of
    max (eigenvectors compared directly: same order, same signs)."""
    fn, args = _linalg_cases()[name]
    ref = fn(rla, *[jnp.asarray(a) for a in args])
    out = fn(la, *[torch.as_tensor(a) for a in args])
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for r, o in zip(ref, out):
        assert _rel(_np(o), r) <= 1e-12, name


def test_round_robin_schedule():
    for n in (2, 6, 8):
        np.testing.assert_array_equal(la._round_robin_schedule(n),
                                      rla._round_robin_schedule(n))


# -- SPSD facade -------------------------------------------------------------

@pytest.fixture(scope="module")
def lap44():
    V, F = rgen.grid_tri(4, 4)
    rm, pm = RFEMMesh(V, F, degree=1), FEMMesh(V, F, degree=1)
    return rm, pm, rops.laplacian(rm), operators.laplacian(pm, device="cpu")


@pytest.mark.parametrize("case", ["fixed_cg", "fixed_direct", "constrained",
                                  "multi_rhs", "multi_rhs_block",
                                  "scipy_multi_inhomogeneous"])
def test_spsd_against_reference(lap44, case):
    """``SPSDSystem``: fixed variables (CG and direct), a homogeneous mean
    constraint, multi-RHS through column applies and through the block
    apply, and the scipy path with inhomogeneous fixed values, each equal
    to the reference's to 1e-10 of max."""
    rm, pm, rL, L = lap44
    rng = np.random.default_rng(1)
    n = pm.num_nodes
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 3))
    A = L.to_scipy()
    rhs = B if case.startswith(("multi", "scipy")) else b
    if case == "constrained":
        rhs = b - b.mean()

    def build(mod, op):
        if case in ("fixed_direct", "scipy_multi_inhomogeneous"):
            s = mod.SPSDSystem(A) if mod is rspsd else \
                mod.SPSDSystem(A, device="cpu")
        elif mod is rspsd:
            s = mod.SPSDSystem(lambda u: op(u), n=n)
        elif case == "multi_rhs_block":
            s = mod.SPSDSystem(op, n=n, device="cpu")     # the block apply
        else:
            s = mod.SPSDSystem(lambda u: op(u), n=n, device="cpu")
        if case == "constrained":
            s.set_constrained(np.ones((1, n)))
        else:
            s.fix_variables(pm.bdry_nodes, 0.5 if case.startswith("scipy")
                            else 0.0)
        return s

    direct = case == "fixed_direct"
    ref = np.asarray(build(rspsd, rL).solve(jnp.asarray(rhs), tol=1e-13,
                                            direct=direct))
    out = _np(build(spsd, L).solve(rhs, tol=1e-13, direct=direct))
    assert _rel(out, ref) <= 1e-10, case
    if case == "constrained":
        assert abs(out.mean()) < 1e-10


def test_spsd_scipy_large_multi_rhs():
    """Above the direct-solve threshold a scipy matrix runs through CG on
    the host apply (the reference's traceable case), single and multi
    RHS, equal to the reference's to 1e-10 of max."""
    n = 25000
    A = sp.diags([np.full(n, 4.0), np.full(n - 1, -1.0),
                  np.full(n - 1, -1.0)], [0, -1, 1]).tocsr()
    B = np.random.default_rng(0).standard_normal((n, 2))
    ref = np.asarray(rspsd.SPSDSystem(A).solve(jnp.asarray(B), tol=1e-10))
    out = _np(spsd.SPSDSystem(A, device="cpu").solve(B, tol=1e-10))
    assert _rel(out, ref) <= 1e-10
    assert np.abs(A @ out - B).max() < 1e-7
    x1 = _np(spsd.SPSDSystem(A, device="cpu").solve(B[:, 0], tol=1e-10))
    assert np.abs(A @ x1 - B[:, 0]).max() < 1e-7
