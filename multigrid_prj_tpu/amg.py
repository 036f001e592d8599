"""Classical algebraic multigrid: setup (strength, coarsening, interpolation,
Galerkin RAP) on the host, solve cycles on device.

Capability parity with the reference's AMG sub-project (``AMG/``):

* **Strength of connection** (``AMG/include/AMG.hpp:105-147``): ``j`` is
  strong for ``i`` iff ``|a_ij| >= theta * max_{k != i} |a_ik|``,
  ``theta = EPSILON = 0.2`` (``AMG.hpp:21``) -> :func:`strength_mask`,
  vectorised over the whole CSR at once.
* **C/F coarsening** (``AMG.hpp:150-198``): the reference runs a greedy
  sequential loop from a *random* seed node (``getRandomInit``,
  ``AMG/src/Utilities.cpp:30-40``).  :func:`coarsen_greedy` reproduces that
  algorithm deterministically (seeded); :func:`coarsen_pmis` is the
  data-parallel replacement — PMIS independent-set selection with hashed
  deterministic weights, the standard parallel coarsening.
* **Direct interpolation** (``AMG.hpp:230-300``): coarse row -> 1 at its
  coarse column; fine row ``i`` -> weights
  ``alpha * a_ik / sum_k(alpha * a_ik)`` over strong coarse neighbors with
  ``alpha = sum_{j != i} a_ij / sum_sc a_ik`` — which algebraically reduces
  to ``w_k = a_ik / sum_sc a_ik`` (row sums to 1).  :func:`build_prolongation`
  implements exactly that.  Deviation recorded: a fine node with no strong
  coarse neighbor divides by zero in the reference; here it is promoted to
  coarse instead.
* **Galerkin product** ``Ac = P^T A P`` (``AMG.hpp:303-369``) via the
  vectorised host SpGEMM in ``ops/sparse.py`` (the reference's hottest setup
  loop, SURVEY.md §3.4).
* **Solve** (``AMG/src/AMG.cpp:277-308``): the reference runs one sawtooth
  pass that restricts the *solution* (``x_{l+1} = P^T x_l``), smooths
  10/200/10 Gauss-Seidel sweeps, and corrects ``x_l += P x_{l+1}`` —
  reproduced in :meth:`AMGSolver.reference_sawtooth_pass` (compat mode).
  The default :meth:`AMGSolver.solve` is the standard residual-correction
  V-cycle (pre/post smoothing, ``P^T r`` restriction), which converges
  strictly faster and is what SURVEY.md §7.4.7 prescribes.

Design: setup runs once on the host (NumPy, mirroring the reference's
setup/solve split); every level's operator is shipped to device as a padded
ELL matrix, the lexicographic Gauss-Seidel becomes *multicolor* Gauss-Seidel
by default (greedy host coloring, one fused masked update per color;
Chebyshev and damped Jacobi are the alternatives), and the whole V-cycle is
a single jitted computation recording the per-iteration residual history.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from multigrid_prj_tpu.ops.sparse import ELLMatrix, HostCSR, rap, to_device

THETA_DEFAULT = 0.2  # AMG/include/AMG.hpp:21 (EPSILON)

# Static residual-history buffer length recorded inside the solve loops
# (tol/maxit are traced, so the buffer cannot size itself off maxit; past
# the cap the last slot keeps the newest value).
HIST_CAP = 512


class AMGSolveResult(tuple):
    """``(x, iterations, rel_residual)`` triple with a ``history`` attribute.

    Unpacks exactly like the historical 3-tuple return of
    :meth:`AMGSolver.solve` (``x, k, rel = solver.solve(b)``), and carries
    the per-iteration relative residual norms — the AMG analog of the GMG
    ``SolveResult.history`` / the reference's ``MGGS4.txt`` artifact
    (``GeometricMultigrid/src/main.cpp:74,87,127``; the reference's AMG
    prints residuals but never records them, ``AMG/src/AMG.cpp:256-275``).

    ``history_truncated`` is True when the solve ran past the fixed
    ``HIST_CAP`` in-jit buffer (tol/maxit are traced, so the buffer cannot
    size itself off maxit): the final entries collapse into the last slot
    and per-iteration convergence factors computed from ``history`` are
    unreliable past the cap.
    """

    history: np.ndarray
    history_truncated: bool

    def __new__(cls, x, iterations: int, rel_residual: float, history,
                history_truncated: bool = False):
        self = super().__new__(cls, (x, iterations, rel_residual))
        self.history = np.asarray(history)
        self.history_truncated = bool(history_truncated)
        return self

    @property
    def x(self):
        return self[0]

    @property
    def iterations(self) -> int:
        return self[1]

    @property
    def rel_residual(self) -> float:
        return self[2]


# ---------------------------------------------------------------------------
# Setup phase (host, NumPy)
# ---------------------------------------------------------------------------


def strength_mask(A: HostCSR, theta: float = THETA_DEFAULT) -> np.ndarray:
    """Boolean mask over ``A.data``: entry is a strong off-diagonal connection.

    Vectorised form of ``strong_connections_in_row`` (``AMG.hpp:105-130``).
    """
    n = A.shape[0]
    rows = np.repeat(np.arange(n), A.row_lengths)
    offdiag = rows != A.indices
    absval = np.abs(A.data)
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows[offdiag], absval[offdiag])
    return offdiag & (absval >= theta * row_max[rows]) & (row_max[rows] > 0)


def _strong_lists(A: HostCSR, strong: np.ndarray):
    """Per-row strong neighbor lists as (indptr-style offsets, flat cols)."""
    n = A.shape[0]
    rows = np.repeat(np.arange(n), A.row_lengths)
    s_rows = rows[strong]
    s_cols = A.indices[strong]
    counts = np.bincount(s_rows, minlength=n)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptr[1:])
    return ptr, s_cols


def coarsen_greedy(
    A: HostCSR, theta: float = THETA_DEFAULT, seed: int = 0
) -> np.ndarray:
    """The reference's greedy sequential coarsening, made deterministic.

    Reproduces ``select_coarse_nodes`` (``AMG.hpp:150-198``): per-node
    counter = #strong connections; start from a (seeded) random node; mark
    it coarse, its strong neighbors fine, bump their strong neighbors'
    counters by 2; next pivot = highest-index node with nonzero counter
    (the reference's scan keeps overwriting, ``AMG.hpp:184-192``).

    Returns labels: 1 = coarse, 0 = fine.
    """
    n = A.shape[0]
    strong = strength_mask(A, theta)
    ptr, s_cols = _strong_lists(A, strong)
    rng = np.random.default_rng(seed)
    idx = int(rng.integers(0, n + 1)) % n  # getRandomInit range is [0, max]

    from multigrid_prj_tpu import native

    if native.available() and n:
        labels = native.greedy_coarsen(ptr, s_cols, n, idx)
    else:
        counter = np.diff(ptr).astype(np.int64)  # undecided iff counter > 0
        fine = np.zeros(n, dtype=bool)
        while counter[idx] > 0:
            counter[idx] = 0
            for c in s_cols[ptr[idx]: ptr[idx + 1]]:
                if counter[c] > 0:
                    fine[c] = True
                    counter[c] = 0
                    for c2 in s_cols[ptr[c]: ptr[c + 1]]:
                        if counter[c2] > 0:
                            counter[c2] += 2
            nz = np.flatnonzero(counter > 0)
            if nz.size == 0:
                break
            idx = int(nz[-1])
        labels = (~fine).astype(np.int8)  # untouched (isolated) nodes stay coarse
    # The reference divides by zero when a fine node has no strong *coarse*
    # neighbor (strength is not symmetric, SURVEY.md §7.5); promote such
    # orphans to coarse so interpolation is always well defined.
    rows = np.repeat(np.arange(n), A.row_lengths)
    has_c = np.zeros(n, dtype=bool)
    sel = strong & (labels[A.indices] == 1)
    has_c[rows[sel]] = True
    labels[(labels == 0) & ~has_c] = 1
    return labels


def coarsen_pmis(
    A: HostCSR, theta: float = THETA_DEFAULT, seed: int = 0
) -> np.ndarray:
    """Deterministic PMIS coarsening (parallel-friendly; the data-parallel
    replacement for the reference's sequential loop, SURVEY.md §7.4.3).

    Independent-set selection on the symmetrised strength graph with hashed
    random weights; fine nodes with no coarse strong neighbor are promoted
    so interpolation is always well defined.
    """
    n = A.shape[0]
    strong = strength_mask(A, theta)
    rows = np.repeat(np.arange(n), A.row_lengths)
    sr, sc = rows[strong], A.indices[strong]
    # symmetrise: i ~ j if either direction is strong
    er = np.concatenate([sr, sc])
    ec = np.concatenate([sc, sr])
    lam = np.bincount(er, minlength=n).astype(np.float64)  # degree weight
    rng = np.random.default_rng(seed)
    w = lam + rng.random(n)
    state = np.zeros(n, dtype=np.int8)  # 0 undecided, 1 coarse, 2 fine
    state[lam == 0] = 1  # isolated nodes are coarse (interpolated by identity)
    # active edge set shrinks permanently: a decided endpoint never reverts,
    # so its edges can never contribute to a later round's nbr_max — the
    # rounds cost O(remaining edges), not O(all edges) each (measured 3.7 s
    # -> ~0.6 s on the 1M-row FD system; identical selection sequence)
    aer, aec = er, ec
    for _ in range(n):
        und = state == 0
        if not und.any():
            break
        both = und[aer] & und[aec]
        aer, aec = aer[both], aec[both]
        # a node wins if its weight beats every undecided neighbor's weight
        nbr_max = np.zeros(n)
        np.maximum.at(nbr_max, aer, w[aec])
        winners = und & (w > nbr_max)
        if not winners.any():  # ties (measure-zero with random weights)
            winners = und & (w >= nbr_max)
        state[winners] = 1
        # undecided neighbors of new coarse nodes become fine
        new_fine = (state[aer] == 0) & (state[aec] == 1)
        state[aer[new_fine]] = 2
    # guarantee every fine node has a strong coarse neighbor
    has_c = np.zeros(n, dtype=bool)
    has_c[sr[state[sc] == 1]] = True
    orphan = (state == 2) & ~has_c
    state[orphan] = 1
    return (state == 1).astype(np.int8)


def build_prolongation(
    A: HostCSR, labels: np.ndarray, theta: float = THETA_DEFAULT
) -> HostCSR:
    """Direct interpolation P (n_fine x n_coarse), reference weight formula.

    Coarse row: single 1 at its coarse column (``AMG.hpp:243-247``).
    Fine row i: ``w_k = a_ik / sum_{strong coarse k} a_ik``
    (``AMG.hpp:249-293``; the alpha factor cancels — see module docstring).
    """
    n = A.shape[0]
    labels = np.asarray(labels, dtype=np.int8)
    coarse_ids = np.flatnonzero(labels == 1)
    col_of = -np.ones(n, dtype=np.int64)
    col_of[coarse_ids] = np.arange(coarse_ids.size)
    strong = strength_mask(A, theta)
    rows = np.repeat(np.arange(n), A.row_lengths)
    # entries of P from fine rows: strong connections to coarse nodes
    sel = strong & (labels[A.indices] == 1) & (labels[rows] == 0)
    pr, pc, pv = rows[sel], col_of[A.indices[sel]], A.data[sel]
    denom = np.zeros(n)
    np.add.at(denom, pr, pv)
    if np.any((labels == 0) & (denom == 0)):
        # orphaned fine rows should have been promoted by the coarsener
        bad = np.flatnonzero((labels == 0) & (denom == 0))
        raise ValueError(f"fine nodes with no strong coarse neighbor: {bad[:10]}")
    pv = pv / denom[pr]
    # coarse rows: identity
    cr = coarse_ids
    cc = col_of[coarse_ids]
    cv = np.ones(coarse_ids.size)
    return HostCSR.from_coo(
        np.concatenate([pr, cr]),
        np.concatenate([pc, cc]),
        np.concatenate([pv, cv]),
        (n, coarse_ids.size),
    )


def smooth_prolongation(A: HostCSR, P: HostCSR, lmax: float,
                        omega_factor: float = 4.0 / 3.0,
                        drop_tol: float = 0.02,
                        coarse_rows: np.ndarray | None = None) -> HostCSR:
    """Jacobi-smoothed interpolation ``P_s = (I - omega D^{-1} A) P``.

    The standard smoothed-aggregation upgrade applied to the classical
    direct-interpolation P: one damped-Jacobi application of the fine
    operator smooths the interpolation basis, which repairs the weak
    two-level rate of pure direct weights (measured on the 512^2 FD
    Poisson system with PMIS + Chebyshev(3): rho/cycle 0.88 with direct
    weights -> 0.113 smoothed; 10 V-cycles to 1e-10).
    ``omega = omega_factor / lmax(D^{-1} A)`` (4/3 is the SA classic).

    With ``coarse_rows`` given (the solver always passes it), smoothing
    applies to F-rows only — Jacobi-smoothed *classical* interpolation:
    C-rows keep their exact identity entry, so no column can be emptied
    and singular Galerkin operators cannot arise (see
    :func:`_inv_diag_guarded`).  Measured: F-row-only smoothing also
    *improves* the cycle (less Galerkin fill, faster coarsening,
    coarse-level condition numbers 1e22 -> 7e1 on the 512^2 chain).

    The reference's AMG has no analog (its interpolation is direct-only,
    ``AMG/include/AMG.hpp:230-300``); construction beyond the reference,
    same capability class.  ``drop_tol``: entries of the smoothed P below
    ``drop_tol * max|row|`` are dropped to bound Galerkin fill (relative
    row-wise filtering, the standard SA practice).
    """
    omega = omega_factor / float(lmax)
    n = A.shape[0]
    inv_d = _inv_diag_guarded(A)  # weak-diagonal rows smooth as identity
    if coarse_rows is not None:
        # Jacobi-smoothed CLASSICAL interpolation smooths F-rows only:
        # every C-row keeps its exact identity entry, so no P column can
        # ever be emptied (by smoothing or by the drop filter) — an empty
        # column is an exactly singular Galerkin coarse operator.
        inv_d = inv_d.copy()
        inv_d[np.asarray(coarse_rows)] = 0.0
    # form the smoother S = I - omega D^{-1} A explicitly (A's structure
    # with scaled values, +1 on the diagonal) and take ONE SpGEMM S @ P —
    # the previous A @ P + triplet-concat + re-sort form cost two extra
    # O(nnz log nnz) coalescing passes (a measured setup hot spot).
    # Identical contribution multiset per (i, j) entry.
    rows_a = np.repeat(np.arange(n), A.row_lengths)
    on_diag = rows_a == A.indices
    if int(on_diag.sum()) != n:
        # a row without a structural diagonal cannot host the identity
        # entry in-place; no such matrix arises from FD/FEM/Galerkin
        # operators, but fall back to an explicit identity concat safely
        rows = np.concatenate([rows_a, np.arange(n)])
        cols = np.concatenate([A.indices, np.arange(n)])
        vals = np.concatenate([(-omega * inv_d[rows_a]) * A.data, np.ones(n)])
        S = HostCSR.from_coo(rows, cols, vals, (n, n))
    else:
        s_vals = (-omega * inv_d[rows_a]) * A.data
        s_vals[on_diag] += 1.0
        keep_s = s_vals != 0.0  # unsmoothed (C/weak) rows: pure identity
        counts = np.bincount(rows_a[keep_s], minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        S = HostCSR(indptr=indptr, indices=A.indices[keep_s],
                    data=s_vals[keep_s], shape=(n, n))
    Ps = S.matmul(P)
    if drop_tol > 0 and Ps.nnz:
        r2 = np.repeat(np.arange(Ps.shape[0]), Ps.row_lengths)
        row_max = np.zeros(Ps.shape[0])
        np.maximum.at(row_max, r2, np.abs(Ps.data))
        keep = np.abs(Ps.data) >= drop_tol * row_max[r2]
        # rescale kept entries so each row sum is preserved (partition of
        # unity — dropping without rescaling breaks interpolation of
        # constants and diverges)
        sum_before = np.bincount(r2, weights=Ps.data,
                                 minlength=Ps.shape[0])
        sum_after = np.bincount(r2[keep], weights=Ps.data[keep],
                                minlength=Ps.shape[0])
        scale = np.where(np.abs(sum_after) > 1e-12 * np.abs(sum_before),
                         sum_before / np.where(sum_after == 0, 1.0, sum_after),
                         1.0)
        # rows of Ps are already sorted: rebuild the CSR directly instead
        # of another from_coo sort
        counts = np.bincount(r2[keep], minlength=Ps.shape[0])
        indptr = np.zeros(Ps.shape[0] + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        Ps = HostCSR(indptr=indptr, indices=Ps.indices[keep],
                     data=Ps.data[keep] * scale[r2[keep]], shape=Ps.shape)
    return Ps


def greedy_coloring(A: HostCSR) -> tuple[np.ndarray, int]:
    """Greedy graph coloring of the matrix adjacency (host, setup-time).

    Powers the multicolor Gauss-Seidel smoother — the parallel equivalent of
    the reference's sequential sweep (``AMG/include/Utilities.hpp:38-98``).
    Dispatches to the native C++ implementation when built.
    """
    n = A.shape[0]
    from multigrid_prj_tpu import native

    if native.available() and n:
        return native.greedy_coloring(A.indptr, A.indices, n)
    colors = -np.ones(n, dtype=np.int64)
    for i in range(n):
        cols, _ = A.row(i)
        used = set(colors[c] for c in cols if c != i and colors[c] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    return colors, int(colors.max()) + 1 if n else 0


# ---------------------------------------------------------------------------
# Device-side hierarchy
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ColorBlock:
    """The rows of one color, stored as a contiguous ELL sub-block so a
    multicolor GS sweep touches every nonzero exactly once (a full sweep
    costs ONE SpMV-equivalent instead of ``n_colors`` full SpMVs)."""

    rows: jax.Array  # (nc,) int32 global row ids of this color
    cols: jax.Array  # (nc, K) int32
    vals: jax.Array  # (nc, K)
    inv_diag: jax.Array  # (nc,)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AMGLevel:
    """One AMG level on device."""

    A: ELLMatrix
    diag: jax.Array
    color: jax.Array  # (n,) int32 color ids for multicolor GS
    n_colors: int = dataclasses.field(metadata=dict(static=True))
    P: Optional[ELLMatrix] = None  # to the NEXT (coarser) level
    Pt: Optional[ELLMatrix] = None
    rhs: Optional[jax.Array] = None  # reference-compat coarse rhs (P^T...rhs)
    lmax: float = dataclasses.field(default=0.0, metadata=dict(static=True))
    # largest eigenvalue estimate of D^-1 A (Chebyshev smoother interval)
    color_blocks: Tuple[ColorBlock, ...] = ()


def _to_device_level(A: HostCSR, dtype=jnp.float64,
                     with_colors: bool = True) -> tuple:
    ell = ELLMatrix.from_host_csr(A, dtype=dtype)
    diag_np = A.diagonal()
    diag = to_device(diag_np, dtype)
    if not with_colors:
        # the coloring (and per-color ELL blocks) only power the mcgs
        # smoother; skip the O(nnz) host pass + device copies otherwise
        return ell, diag, jnp.zeros(A.shape[0], jnp.int32), 0, ()
    colors, n_colors = greedy_coloring(A)
    cols_np = np.asarray(ell.cols)
    vals_np = np.asarray(ell.vals, dtype=np.float64)
    blocks = []
    safe_diag = np.where(diag_np == 0, 1.0, diag_np)
    for c in range(n_colors):
        rows_c = np.flatnonzero(colors == c).astype(np.int32)
        blocks.append(ColorBlock(
            rows=to_device(rows_c),
            cols=to_device(cols_np[rows_c]),
            vals=to_device(vals_np[rows_c], dtype),
            inv_diag=to_device(1.0 / safe_diag[rows_c], dtype),
        ))
    return ell, diag, to_device(colors, jnp.int32), n_colors, tuple(blocks)


def mc_gs_sweep(level: AMGLevel, x: jax.Array, b: jax.Array) -> jax.Array:
    """One multicolor Gauss-Seidel sweep: per color, the exact GS update
    ``x_c <- x_c + (b - A x)_c / diag_c`` with the freshest ``x`` — but
    computed on that color's row block only, so the whole sweep streams each
    nonzero once (the reference's sequential sweep costs the same,
    ``AMG/include/Utilities.hpp:38-98``; the naive parallel form costs
    ``n_colors`` full SpMVs)."""
    for blk in level.color_blocks:
        ax = jnp.sum(blk.vals * jnp.take(x, blk.cols, axis=0), axis=1)
        delta = (jnp.take(b, blk.rows) - ax) * blk.inv_diag
        x = x.at[blk.rows].add(delta, unique_indices=True)
    return x


def jacobi_sweep(level: AMGLevel, x: jax.Array, b: jax.Array,
                 omega: float = 2.0 / 3.0) -> jax.Array:
    r = b - level.A.spmv(x)
    return x + omega * r / level.diag


def chebyshev_smooth(level: AMGLevel, x: jax.Array, b: jax.Array,
                     degree: int = 3, lmin_ratio: float = 0.30) -> jax.Array:
    """Degree-``degree`` Chebyshev polynomial smoother on
    ``[lmin_ratio * lmax, 1.05 * lmax]`` of ``D^{-1} A``.

    The standard parallel AMG smoother (cf. "Optimal Polynomial Smoothers
    for Parallel AMG", PAPERS.md): no sequential dependences, ``degree``
    SpMVs per application, no inner products.  ``lmax`` is
    estimated once at setup by power iteration.
    """
    lmax = 1.05 * level.lmax
    lmin = lmin_ratio * level.lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = b - level.A.spmv(x)
    p = (r / level.diag) / theta
    x = x + p
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        r = b - level.A.spmv(x)
        p = (rho_new * rho) * p + (2.0 * rho_new / delta) * (r / level.diag)
        x = x + p
        rho = rho_new
    return x


def _inv_diag_guarded(A: HostCSR) -> np.ndarray:
    """``1/diag(A)`` with entries zeroed where the diagonal is pathologically
    small relative to the row magnitude (``|d_i| <= 0.1 max_j |a_ij|``).

    Galerkin coarse operators of smoothed-P hierarchies are not M-matrices;
    a near-zero diagonal does occur in practice (512^2 FD chain, level 2:
    d = 6.9e-3 against off-diagonals ~15).  An unguarded ``omega/d`` there
    blows the smoothed-P row up to ~1e5, the drop filter then removes the
    row's own coarse entry, and the column vanishes — planting an exactly
    empty row (singular coarse operator) two levels down.  Zeroing the
    inverse for such rows makes every D^{-1}-based operation treat them as
    unsmoothed, which is always safe.
    """
    n = A.shape[0]
    d = A.diagonal()
    rows = np.repeat(np.arange(n), A.row_lengths)
    row_max = np.zeros(n)
    np.maximum.at(row_max, rows, np.abs(A.data))
    # 0.1: Jacobi smoothing assumes rough diagonal dominance; rows far
    # from it (the observed pathological case: d/row_max = 4.5e-4) turn
    # omega*D^{-1} into an amplifier, not a smoother
    weak = np.abs(d) <= 0.1 * row_max
    return np.where(weak, 0.0, 1.0 / np.where(d == 0.0, 1.0, d))


def _estimate_lmax(A: HostCSR, iters: int = 12, seed: int = 7) -> float:
    """Power iteration on ``D^{-1} A`` (host, setup-time; guarded D).

    The row-segment index is computed once and the SpMV runs through
    ``np.bincount`` (one fused pass) instead of ``HostCSR.spmv``'s
    per-call ``np.repeat`` + ``np.add.at`` — ~5x on the 1M-row FD system,
    where the estimate was a measured setup hot spot.
    12 iterations: the estimate's consumers both carry safety margins
    (Chebyshev interval uses ``1.05 * lmax``; the SA omega tolerates a few
    percent either way), so the last digits of a 25-iteration estimate buy
    nothing."""
    n = A.shape[0]
    inv_d = _inv_diag_guarded(A)
    rows = np.repeat(np.arange(n), A.row_lengths)
    idx, dat = A.indices, A.data
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = np.bincount(rows, weights=dat * v[idx], minlength=n) * inv_d
        nw = np.linalg.norm(w)
        if nw == 0:
            return 1.0
        lam = nw
        v = w / nw
    return float(lam)


class AMGSolver:
    """Classical AMG: host setup, jitted device solve.

    Mirrors the reference's constructor contract ``AMG(A, x, levels, rhs)``
    (``AMG/include/AMG.hpp:33-41``) with the setup loop of
    ``AMG::initialization`` (``AMG/src/AMG.cpp:76-120``).
    """

    def __init__(
        self,
        A: HostCSR,
        num_levels: int = 5,
        theta: float = THETA_DEFAULT,
        coarsening: str = "pmis",  # "pmis" | "greedy" (reference-compat)
        interp: str = "smoothed",  # "smoothed" | "direct" (reference-compat)
        smoother: str = "auto",  # "auto" | "mcgs" | "jacobi" | "chebyshev"
        cheb_degree: int = 3,
        seed: int = 0,
        min_coarse: int = 8,
        dtype=None,
        rhs: Optional[np.ndarray] = None,
        reorder: str = "none",  # "none" | "rcm"
    ):
        self.theta = theta
        # f64 exists only with x64 enabled; JAX would silently downcast an
        # f64 request otherwise — refuse it instead.
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        elif dtype == jnp.float64 and not jax.config.jax_enable_x64:
            raise ValueError(
                "dtype=float64 requested but jax_enable_x64 is off — enable "
                "x64, or use dtype=float32 and solve_refined() for "
                "extended-precision residuals"
            )
        self.dtype = dtype
        # "auto": multicolor GS (sequential-GS-quality smoothing, one
        # SpMV-equivalent per sweep)
        if smoother == "auto":
            smoother = "mcgs"
        self.smoother_name = smoother
        self.cheb_degree = int(cheb_degree)
        coarsen = {"pmis": coarsen_pmis, "greedy": coarsen_greedy}[coarsening]

        # optional RCM reordering (banded levels; the sharded solver's
        # layout).  The permutation is internal — every public entry point
        # translates b in and x out.
        self._perm = None
        if reorder == "rcm":
            self._perm = A.rcm_permutation()
            A = A.permute(self._perm)
            if rhs is not None:
                rhs = np.asarray(rhs)[self._perm]

        self.host_matrices: List[HostCSR] = [A]
        self.host_P: List[HostCSR] = []
        # lmax is needed per level by BOTH smoothed-P and the Chebyshev
        # smoother interval — estimate each level's once
        lmax_cache: dict[int, float] = {}

        def lmax_of(i: int, M: HostCSR) -> float:
            if i not in lmax_cache:
                lmax_cache[i] = _estimate_lmax(M)
            return lmax_cache[i]

        cur = A
        for li in range(num_levels - 1):
            if cur.shape[0] <= min_coarse:
                break
            labels = coarsen(cur, theta, seed)
            if labels.sum() == cur.shape[0]:  # no coarsening progress
                break
            P = build_prolongation(cur, labels, theta)
            if interp == "smoothed":
                P = smooth_prolongation(cur, P, lmax_of(li, cur),
                                        coarse_rows=np.flatnonzero(labels == 1))
            cur = rap(P, cur)
            self.host_P.append(P)
            self.host_matrices.append(cur)

        # device levels
        self.levels: List[AMGLevel] = []
        rhs_l = None if rhs is None else np.asarray(rhs, dtype=np.float64)
        for i, M in enumerate(self.host_matrices):
            ell, diag, colors, n_colors, blocks = _to_device_level(
                M, dtype, with_colors=(smoother == "mcgs"))
            lmax = lmax_of(i, M) if smoother == "chebyshev" else 0.0
            P = Pt = None
            Pt_host = None
            if i < len(self.host_P):
                Pt_host = self.host_P[i].transpose()  # once per level
                P = ELLMatrix.from_host_csr(self.host_P[i], dtype=dtype)
                Pt = ELLMatrix.from_host_csr(Pt_host, dtype=dtype)
            lvl_rhs = None
            if rhs_l is not None:
                lvl_rhs = to_device(rhs_l, dtype)
                if Pt_host is not None:
                    rhs_l = Pt_host.spmv(rhs_l)
            self.levels.append(
                AMGLevel(A=ell, diag=diag, color=colors, n_colors=n_colors,
                         P=P, Pt=Pt, rhs=lvl_rhs, lmax=lmax,
                         color_blocks=blocks)
            )

        # dense coarsest-operator INVERSE for the direct bottom solve: one
        # matrix-vector product per cycle instead of an LU factorization
        # per visit (inverted once on the host in f64)
        bottom = self.host_matrices[-1].to_dense()
        try:
            inv_bottom = np.linalg.inv(bottom)
        except np.linalg.LinAlgError:
            # a (numerically) singular bottom operator must not kill setup;
            # the pseudo-inverse solves the consistent part and the outer
            # cycle corrects the rest
            inv_bottom = np.linalg.pinv(bottom)
        self._coarse_dense = to_device(inv_bottom, dtype)
        # Level data is passed as pytree ARGUMENTS, never closed over:
        # closure capture would bake O(nnz) arrays into the executable as
        # constants (bloating it and defeating buffer sharing).
        self._jit_vcycle = jax.jit(self._vcycle_args)
        # tol/maxit are traced (dynamic) so changing them never recompiles
        # the V-cycle chain.
        self._jit_solve = jax.jit(self._solve_impl)
        self._jit_pcg = jax.jit(self._pcg_impl)

    # -- diagnostics ---------------------------------------------------------

    @property
    def level_sizes(self) -> list[int]:
        return [M.shape[0] for M in self.host_matrices]

    @property
    def operator_complexity(self) -> float:
        return sum(M.nnz for M in self.host_matrices) / self.host_matrices[0].nnz

    # -- solve: standard residual-correction V-cycle -------------------------

    def _smooth(self, lvl: AMGLevel, x, b, sweeps: int):
        for _ in range(sweeps):
            if self.smoother_name == "mcgs":
                x = mc_gs_sweep(lvl, x, b)
            elif self.smoother_name == "chebyshev":
                x = chebyshev_smooth(lvl, x, b, degree=self.cheb_degree)
            else:
                x = jacobi_sweep(lvl, x, b)
        return x

    def _vcycle_impl(self, levels, coarse_dense, x, b, nu1=1, nu2=1,
                     _level=0):
        lvl = levels[_level]
        if _level == len(levels) - 1:
            # coarse_dense holds the PRECOMPUTED inverse (setup, host f64);
            # HIGHEST keeps a float32 product out of TF32 on GPUs
            return jnp.matmul(coarse_dense, b,
                              precision=jax.lax.Precision.HIGHEST)
        x = self._smooth(lvl, x, b, nu1)
        r = b - lvl.A.spmv(x)
        bc = lvl.Pt.spmv(r)
        xc = self._vcycle_impl(levels, coarse_dense, jnp.zeros_like(bc), bc,
                               nu1, nu2, _level + 1)
        x = x + lvl.P.spmv(xc)
        return self._smooth(lvl, x, b, nu2)

    def _vcycle_args(self, levels, coarse_dense, x, b, nu1=1, nu2=1):
        return self._vcycle_impl(levels, coarse_dense, x, b, nu1, nu2)

    def _args(self):
        return tuple(self.levels), self._coarse_dense

    def vcycle(self, x, b, nu1: int = 1, nu2: int = 1):
        return self._jit_vcycle(*self._args(), x, b, nu1, nu2)

    def _solve_impl(self, levels, coarse_dense, x, b, tol, maxit):
        b2 = jnp.sum(b * b)

        def rel_of(rn2):
            return jnp.sqrt(jnp.where(b2 > 0, rn2 / b2, 0.0))

        def rn2_of(x):
            r = b - levels[0].A.spmv(x)
            return jnp.sum(r * r)

        r0 = rn2_of(x)
        hist = jnp.full((HIST_CAP + 1,), jnp.nan, b.dtype)
        hist = hist.at[0].set(rel_of(r0))

        def body(state):
            x, k, _, hist = state
            x = self._vcycle_impl(levels, coarse_dense, x, b)
            rn2 = rn2_of(x)
            hist = hist.at[jnp.minimum(k + 1, HIST_CAP)].set(rel_of(rn2))
            return x, k + 1, rn2, hist

        def cond(state):
            _, k, rn2, _ = state
            return (k < maxit) & (rn2 > tol * tol * b2)

        x, k, rn2, hist = jax.lax.while_loop(
            cond, body, (x, jnp.int32(0), r0, hist)
        )
        return x, k, rel_of(rn2), hist

    def _pcg_impl(self, levels, coarse_dense, b, x0, tol, maxit):
        from multigrid_prj_tpu.ops.krylov import cg_arrays

        lvl0 = levels[0]
        # maxit is TRACED (hist_cap sizes the buffer) so distinct maxit
        # values share one executable — consistent with solve/solve_refined
        return cg_arrays(
            lambda v: lvl0.A.spmv(v), b, x0=x0, tol=tol, maxit=maxit,
            M=lambda r: self._vcycle_impl(levels, coarse_dense,
                                          jnp.zeros_like(r), r),
            history=True, hist_cap=HIST_CAP,
        )


    # -- permutation translation (internal RCM frame <-> caller frame) -------

    def _perm_in(self, v):
        if self._perm is None:
            return v
        if isinstance(v, jax.Array):
            # device arrays permute on device (no host round trip)
            if not hasattr(self, "_perm_dev"):
                self._perm_dev = to_device(self._perm, jnp.int32)
            return jnp.take(v, self._perm_dev)
        return np.asarray(v)[self._perm]

    def _perm_out(self, x):
        if self._perm is None:
            return x
        if isinstance(x, jax.Array):
            # un-permute on device: the result stays where the caller's
            # next operation runs
            if not hasattr(self, "_inv_perm_dev"):
                inv = np.empty_like(self._perm)
                inv[self._perm] = np.arange(self._perm.size)
                self._inv_perm_dev = to_device(inv, jnp.int32)
            return jnp.take(x, self._inv_perm_dev)
        out = np.empty_like(np.asarray(x))
        out[self._perm] = np.asarray(x)
        return out

    def solve(self, b, x0=None, tol: float = 1e-10, maxit: int = 100):
        """V-cycle iteration to relative residual ``tol``.

        Returns an :class:`AMGSolveResult` — unpacks as
        ``(x, iterations, rel_residual)`` and carries ``.history``.
        """
        from multigrid_prj_tpu.utils.guards import check_finite

        check_finite(b, "rhs b")
        b = jnp.asarray(self._perm_in(b), dtype=self.dtype)
        if x0 is None:
            x0 = jnp.zeros_like(b)
        else:
            x0 = jnp.asarray(self._perm_in(x0), dtype=self.dtype)
        x, k, rel, hist = self._jit_solve(
            *self._args(), x0, b, jnp.asarray(tol, dtype=self.dtype),
            jnp.asarray(maxit, jnp.int32)
        )
        k, rel, hist = jax.device_get((k, rel, hist))  # one round trip
        k = int(k)
        return AMGSolveResult(self._perm_out(x), k, float(rel),
                              np.asarray(hist)[: min(k, HIST_CAP) + 1],
                              history_truncated=k > HIST_CAP)

    def solve_refined(self, b, tol: float = 1e-10, maxit: int = 100):
        """Iterative refinement with ff32 extended-precision residuals.

        For f32 solves: the V-cycle runs in plain f32 but the outer
        residual ``r = b - A x`` is evaluated with error-free transformations
        (``ops/sparse_extended.py``) and the iterate is carried as an f32
        pair, so convergence is not floored at ``eps_f32 * kappa(A)``.
        Returns ``(x, iterations, rel_residual)`` like :meth:`solve`;
        ``x`` is the pair combined on the host in f64 (a NumPy array) so the
        extended precision survives the return — summing on device would
        round back to f32 and re-floor the result.
        """
        from multigrid_prj_tpu.ops.sparse_extended import (
            ELLPair,
            ell_residual_ff,
            ff_pair_from_f64,
        )
        from multigrid_prj_tpu.ops.extended import ff_add_f
        from multigrid_prj_tpu.utils.guards import check_finite

        check_finite(b, "rhs b")
        b = self._perm_in(b)
        if not hasattr(self, "_ell_pair"):
            self._ell_pair = ELLPair.from_host_csr(self.host_matrices[0])
        A2 = self._ell_pair
        b_hi, b_lo = ff_pair_from_f64(np.asarray(b, dtype=np.float64))
        f32 = jnp.float32

        if not hasattr(self, "_jit_solve_ff"):

            def _impl(levels, coarse_dense, A2, b_hi, b_lo, tol, maxit):
                b2 = jnp.sum(b_hi.astype(f32) ** 2)

                def rel_of(rn2):
                    return jnp.sqrt(jnp.where(b2 > 0, rn2 / b2, 0.0))

                # residual-carry: ONE extended-precision evaluation per
                # iteration (the eval at the end of iteration k IS the
                # residual iteration k+1 corrects)
                def body(state):
                    x_hi, x_lo, r, k, _, hist = state
                    e = self._vcycle_impl(
                        levels, coarse_dense,
                        jnp.zeros_like(r, dtype=self.dtype),
                        r.astype(self.dtype),
                    ).astype(f32)
                    x_hi, x_lo = ff_add_f(x_hi, x_lo, e)
                    r = ell_residual_ff(A2, b_hi, b_lo, x_hi, x_lo)
                    rn2 = jnp.sum(r * r)
                    hist = hist.at[jnp.minimum(k + 1, HIST_CAP)].set(
                        rel_of(rn2))
                    return x_hi, x_lo, r, k + 1, rn2, hist

                def cond(state):
                    _, _, _, k, rn2, _ = state
                    return (k < maxit) & (rn2 > tol * tol * b2)

                hist = jnp.full((HIST_CAP + 1,), jnp.nan, f32)
                hist = hist.at[0].set(jnp.asarray(1.0, f32))  # x0 = 0
                x_hi = jnp.zeros_like(b_hi)
                r0 = ell_residual_ff(A2, b_hi, b_lo, x_hi, x_hi)
                x_hi, x_lo, _, k, rn2, hist = jax.lax.while_loop(
                    cond, body, (x_hi, x_hi, r0, jnp.int32(0), b2, hist)
                )
                return x_hi, x_lo, k, rel_of(rn2), hist

            self._jit_solve_ff = jax.jit(_impl)

        x_hi, x_lo, k, rel, hist = self._jit_solve_ff(
            *self._args(), A2, b_hi, b_lo, jnp.asarray(tol, f32),
            jnp.asarray(maxit, jnp.int32)
        )
        x_hi, x_lo, k, rel, hist = jax.device_get(
            (x_hi, x_lo, k, rel, hist))  # one round trip
        x = np.asarray(x_hi, np.float64) + np.asarray(x_lo, np.float64)
        k = int(k)
        return AMGSolveResult(self._perm_out(x), k, float(rel),
                              np.asarray(hist)[: min(k, HIST_CAP) + 1],
                              history_truncated=k > HIST_CAP)

    def solve_pcg(self, b, x0=None, tol: float = 1e-10, maxit: int = 200):
        """AMG-preconditioned conjugate gradients.

        One V(1,1) cycle as the preconditioner — the standard acceleration
        that makes even weak interpolation (e.g. PMIS + the reference's
        direct weights) converge in O(10) iterations.  Returns
        ``(x, iterations, rel_residual)``.
        """
        b = jnp.asarray(self._perm_in(b), dtype=self.dtype)
        if x0 is None:
            x0 = jnp.zeros_like(b)
        else:
            x0 = jnp.asarray(self._perm_in(x0), dtype=self.dtype)
        x, k, rel, hist = self._jit_pcg(
            *self._args(), b, x0, jnp.asarray(tol, self.dtype),
            jnp.asarray(maxit, jnp.int32),
        )
        k, rel, hist = jax.device_get((k, rel, hist))  # one round trip
        k = int(k)
        return AMGSolveResult(self._perm_out(x), k, float(rel),
                              np.asarray(hist)[: min(k, HIST_CAP) + 1],
                              history_truncated=k > HIST_CAP)

    # -- reference-compat sawtooth pass --------------------------------------

    def reference_sawtooth_pass(
        self, x, pre: int = 10, coarse: int = 200, post: int = 10
    ):
        """One pass of the reference's solve scheme (``AMG/src/AMG.cpp:277-308``):
        down-leg {smooth ``pre`` sweeps on (A_l, rhs_l); restrict the
        *solution* ``x_{l+1} = P^T x_l``}, ``coarse`` sweeps at the bottom,
        up-leg {``x_l += P x_{l+1}``; smooth ``post`` sweeps}.

        Requires the solver to have been built with ``rhs=`` so the per-level
        right-hand sides ``P^T ... P^T rhs`` exist (the reference builds them
        during setup, ``AMG/src/AMG.cpp:100-109``).
        """
        if self.levels[0].rhs is None:
            raise ValueError("reference_sawtooth_pass needs rhs= at setup")
        xs = [jnp.asarray(self._perm_in(x), dtype=self.dtype)]
        L = len(self.levels)
        for l in range(L - 1):
            lvl = self.levels[l]
            xs[l] = self._smooth(lvl, xs[l], lvl.rhs, pre)
            xs.append(lvl.Pt.spmv(xs[l]))
        xs[L - 1] = self._smooth(
            self.levels[L - 1], xs[L - 1], self.levels[L - 1].rhs, coarse
        )
        for l in range(L - 2, -1, -1):
            lvl = self.levels[l]
            xs[l] = xs[l] + lvl.P.spmv(xs[l + 1])
            xs[l] = self._smooth(lvl, xs[l], lvl.rhs, post)
        return self._perm_out(xs[0])

    def residual_norm(self, x, b) -> float:
        r = jnp.asarray(self._perm_in(b), self.dtype) - self.levels[0].A.spmv(
            jnp.asarray(self._perm_in(x), self.dtype)
        )
        return float(jnp.sqrt(jnp.sum(r * r)))
