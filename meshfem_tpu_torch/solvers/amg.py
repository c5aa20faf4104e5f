"""Multilevel preconditioner for arbitrary unstructured P2 meshes, every
level's work on the device (counterpart of ``meshfem_tpu/solvers/amg.py``,
the reference's "full CHOLMOD role on arbitrary meshes"):

  level 0   P2 fine: the routed operator (``sparse/routed_ebe``);
  level 1   P1 on the same mesh (exactly nested in P2: every edge node is
            its edge's midpoint, so the Galerkin coarse operator is the P1
            stiffness, ``solvers/twolevel.py``), itself a float32 routed
            operator with its own RCB order; the P2 <-> P1 transfers run on
            kernel A (the prolongation: one gather of the ``2 Nf`` endpoint
            rows) and kernel B (the restriction: the ``2 Nf`` halves summed
            into the P1 rows in a fixed order), where the reference runs
            its routed ``plan_copy`` / ``plan_reduce`` (:303-304);
  level 2+  aggregation levels: spatially chunked (RCB) aggregates with a
            rigid-body near-nullspace tentative prolongator (Vanek / Mandel /
            Brezina smoothed-aggregation construction, unsmoothed P) and
            Galerkin block operators in padded block-ELL form; a
            restriction is the per-unit ``[b_f, b_c]`` product, then kernel
            B through a plan sorted by aggregate (never ``index_add_``: on
            CUDA it adds with float atomics, in no fixed order); a
            prolongation is kernel A on the aggregate ids, then the product;
  coarsest  dense pseudo-inverse (host, once at build), applied as a
            device matmul.

Chebyshev / Jacobi smoothing at every level (``ops/structured_mg.
_chebyshev``, fixed degree: linear and symmetric, so the V-cycle is a valid
plain-CG preconditioner).  Host work happens once at build (the P1 scipy
assembly, per-aggregate QRs, the Galerkin triple products, the ``pinv``);
``solve`` is then MG-PCG in the fine routed operator's internal order, one
host sync an iteration (``solvers/cg.py``), where the reference jits one
dispatch (``_amg_pcg`` :488-501).  The V-cycle's products run in full
float32: ``config`` switches TF32 off (the reference sets the matmul
precision to "highest", :406-412: the cycle amplifies low modes ~1e3x).
The P2 Gershgorin row sums run through kernel B in float64.

The near-nullspace's rotations are placed at the simulator's own positions
(``sim.node_positions``; the reference takes the mesh's stored vertices,
:284-285, the same for a simulator at the mesh's positions).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import config
from ..kernels import gather_rows
from ..ops.structured_mg import _chebyshev
from ..sparse.routed_ebe import RoutedEBE
from ..sparse.scatter import ScatterPlan
from . import cg as cg_mod


# ---------------------------------------------------------------------------
# Aggregation-level pieces
# ---------------------------------------------------------------------------

class AggLevel:
    """One aggregation level (reference :55-95): the transfer FROM the
    parent level (``n_units`` blocks of ``b_f`` dofs) into ``n_agg``
    aggregates of ``b_c`` dofs, and this level's Galerkin operator in
    padded block-ELL form.  The last level carries no ELL operator
    (``vals is None``): its correction is the dense coarsest solve."""

    def __init__(self, Pblk, agg_of, plan, vals, nbr, diag, lam, n_agg):
        self.Pblk = Pblk              # [n_units, b_f, b_c] masked tentative P
        self.agg_of = agg_of          # [n_units] int32 aggregate of each unit
        self.plan = plan              # units -> aggregates (kernel B)
        self.vals = vals              # [n_agg, K, b_c, b_c] ELL blocks
        self.nbr = nbr                # [n_agg, K] long neighbour (pad n_agg)
        self.diag = diag              # [n_agg, b_c] point diagonal
        self.lam = lam                # Gershgorin bound on lam(D^-1 A)
        self.n_agg = int(n_agg)

    def restrict(self, r):
        """Parent residual [n_units, b_f] -> aggregate space [n_agg, b_c]:
        the per-unit product, then kernel B in the plan's fixed order."""
        contrib = torch.einsum("vij,vi->vj", self.Pblk.to(r.dtype), r)
        return self.plan.sum_rows(contrib.contiguous())

    def prolong(self, uc):
        """[n_agg, b_c] -> parent space [n_units, b_f]: kernel A on the
        aggregate ids, then the per-unit product."""
        g = gather_rows(uc.contiguous(), self.agg_of)
        return torch.einsum("vij,vj->vi", self.Pblk.to(uc.dtype), g)

    def apply(self, u):
        """Block-ELL SpMV at this level: u [n_agg, b_c] -> A u (a gather
        and a batched product, as the reference's XLA einsum)."""
        up = torch.cat([u, u.new_zeros((1, u.shape[1]))])
        return torch.einsum("akij,akj->ai", self.vals.to(u.dtype),
                            up[self.nbr])


def _rcb_chunks(pos, size):
    """Aggregate unit ids into spatially compact chunks of ~``size`` along
    the recursive-coordinate-bisection order (reference :98-111).  Returns
    (agg_of [n], n_agg)."""
    from ..mesh.reorder import rcb_order

    n = len(pos)
    order = rcb_order(np.asarray(pos))
    n_agg = max(1, -(-n // size))
    agg_of = np.empty(n, np.int64)
    # equal-size contiguous chunks along the RCB order
    bounds = np.linspace(0, n, n_agg + 1).astype(np.int64)
    for a in range(n_agg):
        agg_of[order[bounds[a]:bounds[a + 1]]] = a
    return agg_of, n_agg


def _rigid_modes(pos, d):
    """[n, d, n_modes] rigid translation + rotation near-nullspace."""
    n = len(pos)
    nm = 3 if d == 2 else 6
    B = np.zeros((n, d, nm))
    for c in range(d):
        B[:, c, c] = 1.0
    if d == 2:
        B[:, 0, 2] = -pos[:, 1]
        B[:, 1, 2] = pos[:, 0]
    else:
        for axis in range(3):
            a, b = (axis + 1) % 3, (axis + 2) % 3
            B[:, a, 3 + axis] = -pos[:, b]
            B[:, b, 3 + axis] = pos[:, a]
    return B


def _tentative_prolongator(B, agg_of, n_agg):
    """Per-aggregate QR of the near-nullspace (reference :132-158):
    B [n_units, b_f, nm] (already masked at fixed dofs) -> (Pblk [n_units,
    b_f, nm] with orthonormal per-aggregate columns, B_coarse [n_agg, nm,
    nm] the R factors, the coarse near-nullspace)."""
    n_units, b_f, nm = B.shape
    Pblk = np.zeros((n_units, b_f, nm))
    Bc = np.zeros((n_agg, nm, nm))
    order = np.argsort(agg_of, kind="stable")
    bounds = np.searchsorted(agg_of[order], np.arange(n_agg + 1))
    for a in range(n_agg):
        rows = order[bounds[a]:bounds[a + 1]]
        M = B[rows].reshape(len(rows) * b_f, nm)
        if M.shape[0] < nm:      # degenerate tiny aggregate: pad rows
            M = np.concatenate([M, np.zeros((nm - M.shape[0], nm))])
        Q, R = np.linalg.qr(M)
        Q = Q[: len(rows) * b_f]
        # rank guard: null columns (fully fixed aggregates, degenerate
        # geometry) get zero weight; their coarse dof goes dead and
        # _to_ell gives it an identity row
        keep = np.abs(np.diagonal(R)) > 1e-10 * max(
            np.abs(np.diagonal(R)).max(), 1e-300)
        Q = Q * keep[None, :]
        R = R * keep[:, None]
        Pblk[rows] = Q.reshape(len(rows), b_f, nm)
        Bc[a] = R
    return Pblk, Bc


def _scipy_P(Pblk, agg_of, n_agg):
    """The tentative prolongator as a scipy CSR matrix [n_units b_f, n_agg
    nm]."""
    import scipy.sparse as sp

    n_units, b_f, nm = Pblk.shape
    rows = np.repeat(np.arange(n_units * b_f), nm)
    cols = (agg_of[:, None, None] * nm
            + np.broadcast_to(np.arange(nm), (n_units, b_f, nm))).reshape(-1)
    return sp.coo_matrix(
        (Pblk.reshape(-1), (rows, cols)),
        shape=(n_units * b_f, n_agg * nm)).tocsr()


def _to_ell(A, b):
    """scipy CSR [n b, n b] -> padded block-ELL (vals [n, K, b, b], nbr [n,
    K] with pad id n, point diag [n, b], Gershgorin lam), reference
    :173-204."""
    n = A.shape[0] // b
    Ab = A.tobsr(blocksize=(b, b))
    counts = np.diff(Ab.indptr)
    K = max(int(counts.max()), 1)
    vals = np.zeros((n, K, b, b))
    nbr = np.full((n, K), n, np.int64)
    for i in range(n):
        lo, hi = Ab.indptr[i], Ab.indptr[i + 1]
        vals[i, : hi - lo] = Ab.data[lo:hi]
        nbr[i, : hi - lo] = Ab.indices[lo:hi]
    diag = A.diagonal().reshape(n, b)
    # dead dofs (zero diagonal, rank-dropped coarse modes): identity
    dead = diag <= 0
    if dead.any():
        di, db = np.nonzero(dead)
        diag[dead] = 1.0
        # 1.0 on the diagonal inside the self block (create one if the
        # row is empty)
        for i, c in zip(di, db):
            slot = np.nonzero(nbr[i] == i)[0]
            if len(slot) == 0:
                slot = np.nonzero(nbr[i] == n)[0][:1]
                nbr[i, slot[0]] = i
            vals[i, slot[0], c, c] = 1.0
    absA = abs(A)
    rowsum = np.asarray(absA.sum(axis=1)).reshape(-1)
    dflat = diag.reshape(-1)
    lam = float(np.max(rowsum / np.where(dflat > 0, dflat, 1.0))) * 1.05
    return vals, nbr, diag, lam


# ---------------------------------------------------------------------------
# The hierarchy
# ---------------------------------------------------------------------------

class UnstructuredMG:
    """Multilevel V-cycle preconditioner and MG-PCG solver for unstructured
    P2 meshes.  Works in the FINE ROUTED OPERATOR'S internal order:
    ``precondition`` maps internal residuals [Nf, d] to internal
    corrections; ``solve`` converts once each way.  ``timings``: host
    seconds of the build's stages."""

    def __init__(self, rk_f, diag_f, free_f, ids_ab, plan_r, rk_c, diag_c,
                 free_c, levels, Cinv, lam, nu, d, Nf, NC, timings=None):
        self.rk_f = rk_f              # fine P2 operator (internal order)
        self.diag_f = diag_f          # [Nf, d]
        self.free_f = free_f          # [Nf, d] 1.0 / 0.0
        self.ids_ab = ids_ab          # [2 Nf] int32: P1 ends cA, then cB
        self.plan_r = plan_r          # 2 Nf halves -> NC P1 rows (kernel B)
        self.rk_c = rk_c              # P1 operator (its own internal order)
        self.diag_c = diag_c          # [NC, d]
        self.free_c = free_c          # [NC, d]
        self.levels = tuple(levels)   # AggLevel...
        self.Cinv = Cinv              # dense coarsest pseudo-inverse
        self.lam = tuple(lam)         # Gershgorin bounds (P2, P1), float64
        self.nu = int(nu)
        self.d = int(d)
        self.Nf = int(Nf)
        self.NC = int(NC)
        self.timings = timings or {}

    # -- build -----------------------------------------------------------
    @classmethod
    def build(cls, sim, fixed_mask=None, nu: int = 3, agg_size: int = 32,
              coarse_target: int = 1600, rk=None,
              dtype=config.SOLVE) -> "UnstructuredMG":
        """sim: ElasticitySimulator (any dof map, periodic included).

        ``fixed_mask [num_dofs, d]`` bool (None -> ``sim.dirichlet_mask``);
        the hierarchy is masked to the free subspace at every level (fixed
        fine dofs zero the prolongator rows, so coarse operators act on
        free interpolants only).  ``rk``: the fine routed operator (default
        ``sim.routed_kernel()``).  ``dtype``: the smoothers', transfers' and
        coarse operators' precision (the routed operators are float32)."""
        from ..ops import element_matrices as em
        from ..sparse import assembly

        t_start = time.perf_counter()
        timings = {}
        mesh = sim.mesh
        dev = sim.device
        d = sim.dim
        ND = sim.num_dofs
        dof_map = np.asarray(sim.dof_map)
        if fixed_mask is None:
            fixed_mask = sim.dirichlet_mask
        fixed = torch.as_tensor(fixed_mask).cpu().numpy().astype(bool) \
            .reshape(ND, d)

        # fine routed operator (internal RCB / first-touch order)
        rk_f = sim.routed_kernel() if rk is None else rk
        order_f = (np.arange(ND) if rk_f.order is None
                   else rk_f.order.cpu().numpy())
        free_f = torch.as_tensor((~fixed)[order_f], dtype=dtype, device=dev)
        diag_f = rk_f.diagonal().to(dtype)

        # ---- P1 level (exactly nested) --------------------------------
        t0 = time.perf_counter()
        # coarse dofs = unique vertex dofs under the dof map
        vdofs = dof_map[np.asarray(mesh.vertex_nodes)]
        cuniq, cidx = np.unique(vdofs, return_inverse=True)
        NC = len(cuniq)
        ep = mesh.node_endpoint_vertices()               # [N, 2] vertices
        first = np.zeros(ND, np.int64)
        u_dofs, firsts = np.unique(dof_map, return_index=True)
        first[u_dofs] = firsts
        epd = ep[first]                                  # per-dof endpoints
        cA_dof, cB_dof = cidx[epd[:, 0]], cidx[epd[:, 1]]

        g = sim.geom
        Ke1 = em.element_elasticity(g.grad_lambda, g.volume, sim.D, 1)
        elem_c = cidx[np.asarray(mesh.F)]                # [E, K+1] P1 dofs
        # representative position per P1 dof (periodic mates coincide
        # modulo the cell; any representative keeps RCB locality)
        pos_c = np.zeros((NC, sim.node_positions.shape[1]))
        pos_c[cidx] = sim.node_positions[np.asarray(mesh.vertex_nodes)]
        rk_c = RoutedEBE.build(Ke1, elem_c, NC, d, coords=pos_c, device=dev)
        order_c = (np.arange(NC) if rk_c.order is None
                   else rk_c.order.cpu().numpy())
        rank_c = np.empty(NC, np.int64)
        rank_c[order_c] = np.arange(NC)
        diag_c = rk_c.diagonal().to(dtype)
        fixed_c = fixed[cuniq][order_c]                  # [NC, d] internal
        free_c = torch.as_tensor(~fixed_c, dtype=dtype, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timings["p1_operator_s"] = time.perf_counter() - t0

        # P2 <-> P1 transfers (internal orders on both sides): fine dof k
        # prolongs from the P1 rows cA[k] and cB[k] (kernel A on the 2 Nf
        # ids) and restricts its half into each (kernel B, the plan's rows
        # 2 Nf renumbered k -> k mod Nf so they read r's own rows)
        t0 = time.perf_counter()
        cA_i = rank_c[cA_dof[order_f]]
        cB_i = rank_c[cB_dof[order_f]]
        ends = np.concatenate([cA_i, cB_i])
        ids_ab = torch.as_tensor(ends.astype(np.int32), device=dev)
        plan_r = ScatterPlan.build(ends, NC, dev).renumbered(
            torch.arange(2 * ND, device=dev) % ND)
        timings["transfers_s"] = time.perf_counter() - t0

        # ---- aggregation levels on the host (set-up only) --------------
        t0 = time.perf_counter()
        A1 = assembly.assemble_scipy(Ke1.cpu().numpy(), elem_c, NC, d=d)
        A1 = A1.tocsr()
        # permute into rk_c's internal order so the host Galerkin products
        # match the device-side unit indexing
        pvec = (order_c[:, None] * d + np.arange(d)).reshape(-1)
        A1 = A1[pvec][:, pvec].tocsr()
        timings["p1_assembly_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        nm = 3 if d == 2 else 6
        B = _rigid_modes(pos_c[order_c], d)              # [NC, d, nm]
        B = B * (~fixed_c)[:, :, None]                   # mask fixed rows
        levels = []
        A_lvl = A1
        pos_lvl = pos_c[order_c]
        b_f = d
        n_units = NC
        while n_units * nm > coarse_target and n_units > 2 * agg_size:
            agg_of, n_agg = _rcb_chunks(pos_lvl, agg_size)
            Pblk, Bc = _tentative_prolongator(B.reshape(n_units, b_f, nm),
                                              agg_of, n_agg)
            P = _scipy_P(Pblk, agg_of, n_agg)
            A_next = (P.T @ A_lvl @ P).tocsr()
            # aggregate centroids for the next clustering round
            cnt = np.bincount(agg_of, minlength=n_agg).astype(float)
            cent = np.zeros((n_agg, pos_lvl.shape[1]))
            np.add.at(cent, agg_of, pos_lvl)
            cent /= np.maximum(cnt, 1.0)[:, None]
            levels.append((Pblk, agg_of, n_agg, A_next))
            A_lvl, pos_lvl = A_next, cent
            B = Bc                                       # [n_agg, nm, nm]
            b_f, n_units = nm, n_agg
        timings["galerkin_s"] = time.perf_counter() - t0

        # device AggLevels; the LAST level gets the dense pseudo-inverse
        # instead of an ELL operator
        t0 = time.perf_counter()
        agg_levels = []
        for i, (Pblk, agg_of, n_agg, A_next) in enumerate(levels):
            plan = ScatterPlan.build(agg_of, n_agg, dev)
            Pt = torch.as_tensor(Pblk, dtype=dtype, device=dev)
            at = torch.as_tensor(agg_of.astype(np.int32), device=dev)
            if i + 1 < len(levels):
                vals, nbr, diag, lam = _to_ell(A_next, nm)
                agg_levels.append(AggLevel(
                    Pt, at, plan,
                    torch.as_tensor(vals, dtype=dtype, device=dev),
                    torch.as_tensor(nbr, device=dev),
                    torch.as_tensor(diag, dtype=dtype, device=dev),
                    lam, n_agg))
            else:
                agg_levels.append(AggLevel(Pt, at, plan, None, None, None,
                                           None, n_agg))
        timings["ell_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if levels:
            # masked by construction: the P1 -> agg prolongator rows are
            # zero at fixed P1 dofs, so the Galerkin chain sees only the
            # free subspace (dead coarse dofs get identity rows below)
            Ad = np.asarray(levels[-1][3].todense())
        else:
            # tiny problems: P1 is already the coarsest; dense-solve the
            # MASKED operator (an unmasked coarse solve returns corrections
            # that violate the Dirichlet data and the V-cycle stalls near
            # the boundary)
            m1 = (~fixed_c).astype(float).reshape(-1)
            Ad = np.asarray(A_lvl.todense()) * m1[:, None] * m1[None, :]
        dead = Ad.diagonal() <= 0
        if dead.any():
            Ad = Ad + np.diag(dead.astype(float))
        Cinv = torch.as_tensor(np.linalg.pinv(Ad, rcond=1e-10,
                                              hermitian=True),
                               dtype=dtype, device=dev)
        timings["pinv_s"] = time.perf_counter() - t0

        # ---- spectral bounds (Gershgorin) -------------------------------
        t0 = time.perf_counter()
        # P1: exact from the assembled matrix
        rowsum1 = np.asarray(abs(A1).sum(axis=1)).reshape(-1)
        d1 = A1.diagonal()
        lam1 = float(np.max(rowsum1 / np.where(d1 > 0, d1, 1.0))) * 1.05
        # P2: |Ke| row sums scattered in float64 by kernel B on the EBE
        # plan (they upper-bound the assembled row sums)
        lam0 = float(_p2_gershgorin(sim)) * 1.05
        timings["gershgorin_s"] = time.perf_counter() - t0
        timings["total_s"] = time.perf_counter() - t_start
        return cls(rk_f, diag_f, free_f, ids_ab, plan_r, rk_c, diag_c,
                   free_c, agg_levels, Cinv, (lam0, lam1), nu, d, ND, NC,
                   timings)

    # -- transfers ---------------------------------------------------------
    def _prolong_f(self, uc):
        """P1 internal [NC, d] -> P2 internal [Nf, d]: kernel A on the
        endpoint ids, then the midpoint average."""
        rows = gather_rows(uc.contiguous(), self.ids_ab)
        return 0.5 * (rows[:self.Nf] + rows[self.Nf:])

    def _restrict_f(self, r):
        """P2 internal [Nf, d] -> P1 internal [NC, d], the adjoint: kernel
        B over the 2 Nf halves."""
        return self.plan_r.sum_rows((0.5 * r).contiguous())

    def _apply_f(self, v):
        return self.rk_f(v).to(v.dtype)

    def _apply_c(self, v):
        return self.rk_c(v).to(v.dtype)

    # -- V-cycle -----------------------------------------------------------
    def precondition(self, r):
        """Internal fine residual [Nf, d] -> correction: one symmetric
        V-cycle (linear, SPD on the free subspace).  Every product runs in
        full float32 (TF32 is off, ``config``)."""
        return self._vcycle(r)

    def _vcycle(self, r):
        mask = self.free_f
        S = _chebyshev(self._apply_f, self.diag_f, mask, self.lam[0],
                       self.nu)
        r = r * mask
        x = S(r)
        res = (r - self._apply_f(x)) * mask
        rc = self._restrict_f(res) * self.free_c
        xc = self._cycle_p1(rc)
        x = x + self._prolong_f(xc) * mask
        x = x + S((r - self._apply_f(x)) * mask)
        return x

    def _cycle_p1(self, rc):
        if not self.levels:
            return self._coarse_solve(rc)
        S = _chebyshev(self._apply_c, self.diag_c, self.free_c, self.lam[1],
                       self.nu)
        x = S(rc)
        res = (rc - self._apply_c(x)) * self.free_c
        r2 = self.levels[0].restrict(res)
        x2 = self._cycle_agg(0, r2)
        x = x + self.levels[0].prolong(x2) * self.free_c
        x = x + S((rc - self._apply_c(x)) * self.free_c)
        return x

    def _cycle_agg(self, i, r):
        lvl = self.levels[i]
        if i == len(self.levels) - 1:
            return self._coarse_solve(r)
        ones = torch.ones_like(r)   # agg levels are mask-free (masked P)
        S = _chebyshev(lvl.apply, lvl.diag, ones, lvl.lam, self.nu)
        x = S(r)
        res = r - lvl.apply(x)
        nxt = self.levels[i + 1]
        rc = nxt.restrict(res)
        xc = self._cycle_agg(i + 1, rc)
        x = x + nxt.prolong(xc)
        x = x + S(r - lvl.apply(x))
        return x

    def _coarse_solve(self, r):
        return (self.Cinv.to(r.dtype) @ r.reshape(-1)).reshape(r.shape)

    # -- end-to-end solve --------------------------------------------------
    def solve(self, b, fixed_values=None, tol: float = 1e-8,
              maxiter: int = 400):
        """MG-PCG on user-ordered b [ND, d] with the free-mask projector;
        returns (u [ND, d] in USER dof order, CGResult).  ``fixed_values``
        [ND, d]: Dirichlet values (read at the fixed dofs).  The
        reference's ``project`` argument, which its solve ignores, is not
        carried over."""
        rk = self.rk_f
        dt = self.diag_f.dtype
        mask = self.free_f
        b_i = rk.permute_in(torch.as_tensor(b, device=mask.device).to(dt))
        u_d = None
        if fixed_values is not None:
            vals_i = rk.permute_in(torch.as_tensor(
                fixed_values, device=mask.device).to(dt))
            u_d = vals_i * (1.0 - mask)
            b_i = b_i - self._apply_f(u_d)
        res = cg_mod.cg(self._apply_f, b_i, M_inv=self.precondition,
                        project=lambda v: v * mask, tol=tol, maxiter=maxiter)
        x = res.x if u_d is None else res.x + u_d
        return rk.permute_out(x), cg_mod.CGResult(x, res.iters, res.resnorm)


def _p2_gershgorin(sim):
    """max over dofs of (sum_j |K_ij|, element by element) / K_ii: the |Ke|
    row sums summed by kernel B in float64 on the EBE plan, over the
    float64 diagonal."""
    E, nd, _ = sim.Ke.shape
    Keabs = sim.Ke.abs().sum(dim=2)                      # [E, n * d]
    rs = sim._kernel.plan.sum_rows(Keabs.reshape(-1, sim.dim).contiguous())
    df = sim.K_diagonal()
    return float((rs / torch.where(df > 0, df, torch.ones_like(df))).max())
