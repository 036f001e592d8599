"""Multi-chip algebraic multigrid: block-row sharded ELL levels with banded
halo exchange over a 1D device mesh.

The reference's AMG is single-process (OpenMP loop pragmas only, SURVEY.md
§2.4); the row-partitionable CSR (``AMG/include/CSRMatrix.hpp:62-121``) is
the structure this layer distributes:

* the solver RCM-reorders the system (``HostCSR.rcm_permutation``), so every
  level's matrix is BANDED; a block-row partition then needs only a narrow
  band of remote ``x`` entries per neighbor;
* each level's operator (and its P / P^T grid transfers) becomes a
  :class:`ShardedELL`: rows partitioned over mesh axis ``"x"``, column ids
  stored RELATIVE to the owner's input block minus its halo, so the local
  apply is one gather into ``concat(left_halo, x_local, right_halo)``;
* halos move via ``jax.lax.ppermute`` (fixed-neighbor transfers); the
  halo width per level is measured at setup from the actual band — a level
  whose band exceeds one neighbor block falls back to replicated execution
  (standard practice: deep levels are tiny);
* norms / loop control are ``lax.psum`` reductions, so the entire V-cycle
  iteration to tolerance runs as ONE jitted ``shard_map`` program — no host
  round-trips;
* smoothing is Chebyshev or damped Jacobi (SpMV-based, no sequential
  dependence — the parallel-AMG standard); multicolor GS stays a
  single-device feature (its per-color updates would need one halo exchange
  per color).

Padding: every sharded level is padded to ``P * rows_per_shard`` with
identity rows (diag 1, rhs 0, zero P/P^T coupling), which the smoothers fix
instantly and the transfers ignore — the same dead-zone trick as the padded
GMG layout (``grids.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multigrid_prj_tpu.amg import (
    THETA_DEFAULT,
    build_prolongation,
    coarsen_greedy,
    coarsen_pmis,
)
from multigrid_prj_tpu.ops.sparse import ELLMatrix, HostCSR, rap

AXIS = "x"


# ---------------------------------------------------------------------------
# Sharded ELL operator
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedELL:
    """Row-partitioned ELL operator with a banded halo contract.

    ``cols_rel[r, k]`` indexes into ``concat(left_halo, x_local,
    right_halo)`` of row ``r``'s OWNER device; ``halo`` is the per-neighbor
    band width in input rows.  Outside ``shard_map`` the arrays carry the
    full padded shapes (shard with ``P("x", None)`` / ``P("x")``).
    """

    vals: jax.Array  # (out_n_pad, K)
    cols_rel: jax.Array  # (out_n_pad, K) int32
    halo: int = dataclasses.field(metadata=dict(static=True))
    in_rows: int = dataclasses.field(metadata=dict(static=True))
    out_rows: int = dataclasses.field(metadata=dict(static=True))


def build_sharded_ell(
    csr: HostCSR, out_n_pad: int, in_n_pad: int, p: int, dtype
) -> Optional[ShardedELL]:
    """Partition ``csr`` rows over ``p`` shards; ``None`` if any row needs
    columns beyond the immediate neighbors (single-hop halo contract)."""
    n, m = csr.shape
    out_rows = out_n_pad // p
    in_rows = in_n_pad // p
    lengths = csr.row_lengths
    k = max(1, int(lengths.max()) if n else 1)
    cols = np.zeros((out_n_pad, k), dtype=np.int64)
    vals = np.zeros((out_n_pad, k), dtype=np.float64)
    rows = np.repeat(np.arange(n), lengths)
    slot = np.arange(csr.nnz, dtype=np.int64) - np.repeat(csr.indptr[:-1], lengths)
    cols[rows, slot] = csr.indices
    vals[rows, slot] = csr.data
    dev = np.arange(out_n_pad) // out_rows
    # padding slots/rows point at the owner's block start (always local)
    own_start = dev * in_rows
    pad_mask = np.ones((out_n_pad, k), dtype=bool)
    pad_mask[rows, slot] = False
    cols = np.where(pad_mask, own_start[:, None], cols)
    lo = cols.min(axis=1)
    hi = cols.max(axis=1)
    halo = int(max(
        (own_start - lo).max(initial=0),
        (hi - (own_start + in_rows) + 1).max(initial=0),
        0,
    ))
    if halo > in_rows:
        return None
    rel = cols - (own_start - halo)[:, None]
    assert rel.min() >= 0 and rel.max() < in_rows + 2 * halo
    return ShardedELL(
        vals=jnp.asarray(vals, dtype=dtype),
        cols_rel=jnp.asarray(rel.astype(np.int32)),
        halo=halo,
        in_rows=in_rows,
        out_rows=out_rows,
    )


def _exchange_halos(m: ShardedELL, x_local: jax.Array, axis: str):
    """``concat(left_halo, x_local, right_halo)`` via fixed-neighbor
    ppermute (zeros beyond the global ends)."""
    h = m.halo
    if not h:
        return x_local
    p = lax.axis_size(axis)
    left = lax.ppermute(x_local[-h:], axis,
                        [(i, i + 1) for i in range(p - 1)])
    right = lax.ppermute(x_local[:h], axis,
                         [(i, i - 1) for i in range(1, p)])
    return jnp.concatenate([left, x_local, right])


def sharded_ell_apply(m: ShardedELL, x_local: jax.Array,
                      axis: str = AXIS) -> jax.Array:
    """``y_local = (A x)_local`` inside ``shard_map``: one banded halo
    exchange per neighbor, then a local gather + row reduction."""
    x_ext = _exchange_halos(m, x_local, axis)
    return jnp.sum(m.vals * jnp.take(x_ext, m.cols_rel, axis=0), axis=1)


# ---------------------------------------------------------------------------
# Sharded level + solver
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ShardedAMGLevel:
    A: ShardedELL
    inv_diag: jax.Array  # (n_pad,)
    lmax: float = dataclasses.field(metadata=dict(static=True))
    P: Optional[ShardedELL] = None  # coarse -> this level
    Pt: Optional[ShardedELL] = None  # this level -> coarse


def _leaf_spec(x):
    if isinstance(x, jax.Array) or isinstance(x, np.ndarray):
        return P(AXIS, *([None] * (x.ndim - 1)))
    return None


class ShardedAMGSolver:
    """Block-row sharded AMG V-cycle solver over a 1D device mesh.

    Host setup mirrors :class:`multigrid_prj_tpu.amg.AMGSolver` (RCM +
    strength/coarsening/direct interpolation/Galerkin RAP); the solve phase
    runs ``num_sharded`` fine levels distributed and the remaining levels
    replicated after an ``all_gather``.
    """

    def __init__(
        self,
        A: HostCSR,
        mesh: Mesh,
        num_levels: int = 5,
        theta: float = THETA_DEFAULT,
        coarsening: str = "pmis",
        interp: str = "smoothed",  # "smoothed" | "direct" (as AMGSolver)
        smoother: str = "chebyshev",  # "chebyshev" | "jacobi"
        cheb_degree: int = 3,
        nu1: int = 1,
        nu2: int = 1,
        seed: int = 0,
        min_coarse: int = 8,
        min_rows_per_shard: int = 64,
        dtype=jnp.float32,
        tol: float = 1e-8,
        maxit: int = 100,
    ):
        from multigrid_prj_tpu.amg import _estimate_lmax

        self.mesh = mesh
        self.p = int(mesh.devices.size)
        self.dtype = dtype
        self.smoother_name = smoother
        self.cheb_degree = int(cheb_degree)
        self.nu1, self.nu2 = int(nu1), int(nu2)
        self.tol, self.maxit = float(tol), int(maxit)

        # -- host setup (RCM + coarsening chain), as AMGSolver -------------
        self._perm = A.rcm_permutation()
        A = A.permute(self._perm)
        coarsen = {"pmis": coarsen_pmis, "greedy": coarsen_greedy}[coarsening]
        self.host_matrices: List[HostCSR] = [A]
        self.host_P: List[HostCSR] = []
        cur = A
        for _ in range(num_levels - 1):
            if cur.shape[0] <= min_coarse:
                break
            labels = coarsen(cur, theta, seed)
            if labels.sum() == cur.shape[0]:
                break
            Pm = build_prolongation(cur, labels, theta)
            if interp == "smoothed":
                from multigrid_prj_tpu.amg import smooth_prolongation

                # F-rows only, exactly as AMGSolver (identical hierarchy =>
                # identical iteration counts; see smooth_prolongation)
                Pm = smooth_prolongation(
                    cur, Pm, _estimate_lmax(cur),
                    coarse_rows=np.flatnonzero(labels == 1))
            cur = rap(Pm, cur)
            self.host_P.append(Pm)
            self.host_matrices.append(cur)

        # -- choose how many levels stay sharded ---------------------------
        pads = [-(-M.shape[0] // self.p) * self.p for M in self.host_matrices]
        self.n_pads = pads
        num_sharded = 0
        for l, M in enumerate(self.host_matrices[:-1]):
            if pads[l] // self.p < min_rows_per_shard:
                break
            ok = build_sharded_ell(M, pads[l], pads[l], self.p, dtype)
            okP = build_sharded_ell(self.host_P[l], pads[l], pads[l + 1],
                                    self.p, dtype)
            okPt = build_sharded_ell(self.host_P[l].transpose(), pads[l + 1],
                                     pads[l], self.p, dtype)
            if ok is None or okP is None or okPt is None:
                break
            num_sharded += 1
        if num_sharded == 0:
            raise ValueError(
                f"level 0 ({A.shape[0]} rows) not shardable over {self.p} "
                f"devices (band too wide or < {min_rows_per_shard} rows/shard)"
            )
        self.num_sharded = num_sharded

        # -- build device data ---------------------------------------------
        def inv_diag_padded(M, n_pad):
            d = M.diagonal()
            d = np.where(d == 0, 1.0, d)
            out = np.ones(n_pad)
            out[: d.size] = d
            return jnp.asarray(1.0 / out, dtype=dtype)

        self.sharded_levels: List[ShardedAMGLevel] = []

        for l in range(num_sharded):
            M = self.host_matrices[l]
            lmax = _estimate_lmax(M) if smoother == "chebyshev" else 0.0
            A_sh = build_sharded_ell(M, pads[l], pads[l], self.p, dtype)
            P_sh = build_sharded_ell(self.host_P[l], pads[l], pads[l + 1],
                                     self.p, dtype)
            Pt_sh = build_sharded_ell(self.host_P[l].transpose(),
                                      pads[l + 1], pads[l], self.p, dtype)
            self.sharded_levels.append(ShardedAMGLevel(
                A=A_sh,
                inv_diag=inv_diag_padded(M, pads[l]),
                lmax=float(lmax),
                P=P_sh,
                Pt=Pt_sh,
            ))

        # replicated tail: plain ELL levels from num_sharded down
        self.tail_matrices = self.host_matrices[num_sharded:]
        self.tail_P = self.host_P[num_sharded:]
        self._tail = []
        for i, M in enumerate(self.tail_matrices):
            lmax = _estimate_lmax(M) if smoother == "chebyshev" else 0.0
            ell = ELLMatrix.from_host_csr(M, dtype=dtype)
            d = M.diagonal()
            idg = jnp.asarray(1.0 / np.where(d == 0, 1.0, d), dtype=dtype)
            Pe = Pte = None
            if i < len(self.tail_P):
                Pe = ELLMatrix.from_host_csr(self.tail_P[i], dtype=dtype)
                Pte = ELLMatrix.from_host_csr(self.tail_P[i].transpose(),
                                              dtype=dtype)
            self._tail.append((ell, idg, float(lmax), Pe, Pte))
        self._coarse_dense = jnp.asarray(
            self.host_matrices[-1].to_dense(), dtype=dtype
        )

        self.sharding = NamedSharding(mesh, P(AXIS))
        specs = jax.tree.map(_leaf_spec, self.sharded_levels,
                             is_leaf=lambda x: isinstance(x, (jax.Array,
                                                              np.ndarray)))
        self._jit_solve = jax.jit(jax.shard_map(
            self._solve_local,
            mesh=mesh,
            in_specs=(P(AXIS), tuple(specs)),
            out_specs=(P(AXIS), P(), P()),
        ))
        self._jit_step = jax.jit(jax.shard_map(
            lambda b, levels: self._v_local(jnp.zeros_like(b), b, levels, 0),
            mesh=mesh,
            in_specs=(P(AXIS), tuple(specs)),
            out_specs=P(AXIS),
        ))

    # -- smoothers (local blocks, halo exchange inside the applies) --------

    def _smooth(self, lvl: ShardedAMGLevel, x, b, sweeps: int):
        for _ in range(sweeps):
            if self.smoother_name == "chebyshev":
                x = self._cheb(lvl, x, b)
            else:
                r = b - sharded_ell_apply(lvl.A, x)
                x = x + (2.0 / 3.0) * r * lvl.inv_diag
        return x

    def _cheb(self, lvl: ShardedAMGLevel, x, b, lmin_ratio: float = 0.30):
        lmax = 1.05 * lvl.lmax
        lmin = lmin_ratio * lvl.lmax
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - sharded_ell_apply(lvl.A, x)
        p_ = (r * lvl.inv_diag) / theta
        x = x + p_
        for _ in range(self.cheb_degree - 1):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - sharded_ell_apply(lvl.A, x)
            p_ = (rho_new * rho) * p_ + (2.0 * rho_new / delta) * (
                r * lvl.inv_diag
            )
            x = x + p_
            rho = rho_new
        return x

    # -- replicated tail V-cycle (plain ELL on gathered vectors) -----------

    def _tail_vcycle(self, x, b, idx: int):
        ell, idg, lmax, Pe, Pte = self._tail[idx]

        def smooth(x, b, sweeps):
            for _ in range(sweeps):
                if self.smoother_name == "chebyshev" and lmax > 0:
                    hi = 1.05 * lmax
                    lo = 0.30 * lmax
                    th, de = 0.5 * (hi + lo), 0.5 * (hi - lo)
                    sg = th / de
                    rho = 1.0 / sg
                    r = b - ell.spmv(x)
                    p_ = (r * idg) / th
                    x = x + p_
                    for _ in range(self.cheb_degree - 1):
                        rho_n = 1.0 / (2.0 * sg - rho)
                        r = b - ell.spmv(x)
                        p_ = (rho_n * rho) * p_ + (2.0 * rho_n / de) * (r * idg)
                        x = x + p_
                        rho = rho_n
                else:
                    r = b - ell.spmv(x)
                    x = x + (2.0 / 3.0) * r * idg
            return x

        if idx == len(self._tail) - 1:
            return jnp.linalg.solve(self._coarse_dense, b)
        x = smooth(x, b, self.nu1)
        r = b - ell.spmv(x)
        bc = Pte.spmv(r)
        ec = self._tail_vcycle(jnp.zeros_like(bc), bc, idx + 1)
        x = x + Pe.spmv(ec)
        return smooth(x, b, self.nu2)

    # -- sharded V-cycle -----------------------------------------------------

    def _v_local(self, x, b, levels: Tuple[ShardedAMGLevel, ...], l: int):
        lvl = levels[l]
        x = self._smooth(lvl, x, b, self.nu1)
        r = b - sharded_ell_apply(lvl.A, x)
        rc = sharded_ell_apply(lvl.Pt, r)
        if l + 1 < self.num_sharded:
            ec = self._v_local(jnp.zeros_like(rc), rc, levels, l + 1)
        else:
            r_full = lax.all_gather(rc, AXIS, axis=0, tiled=True)
            nc = self.tail_matrices[0].shape[0]
            e_full = self._tail_vcycle(
                jnp.zeros((nc,), rc.dtype), r_full[:nc], 0
            )
            e_pad = jnp.zeros((self.n_pads[self.num_sharded],), rc.dtype)
            e_pad = e_pad.at[:nc].set(e_full)
            i = lax.axis_index(AXIS)
            rows_c = self.n_pads[self.num_sharded] // self.p
            ec = lax.dynamic_slice_in_dim(e_pad, i * rows_c, rows_c)
        x = x + sharded_ell_apply(lvl.P, ec)
        return self._smooth(lvl, x, b, self.nu2)

    def _solve_local(self, b, levels):
        lvl0 = levels[0]
        b2 = lax.psum(jnp.sum(b * b), AXIS)

        def rel2(x):
            r = b - sharded_ell_apply(lvl0.A, x)
            return lax.psum(jnp.sum(r * r), AXIS)

        tol2 = jnp.asarray(self.tol**2, b.dtype)

        def cond(st):
            _, k, rn2 = st
            return (k < self.maxit) & (rn2 > tol2 * b2)

        def body(st):
            x, k, _ = st
            x = self._v_local(x, b, levels, 0)
            return x, k + 1, rel2(x)

        x = jnp.zeros_like(b)
        x, k, rn2 = lax.while_loop(cond, body, (x, jnp.int32(0), b2))
        rel = jnp.sqrt(jnp.where(b2 > 0, rn2 / b2, 0.0))
        return x, k, rel

    # -- public API ----------------------------------------------------------

    @property
    def level_sizes(self) -> list[int]:
        return [M.shape[0] for M in self.host_matrices]

    def solve(self, b) -> tuple[jax.Array, int, float]:
        """Solve ``A x = b`` (caller frame) to the configured tolerance.

        Returns ``(x, iterations, rel_residual)`` like ``AMGSolver.solve``.
        """
        from multigrid_prj_tpu.utils.guards import check_finite

        check_finite(b, "rhs b")
        n = self.host_matrices[0].shape[0]
        bp = np.zeros(self.n_pads[0])
        bp[:n] = np.asarray(b)[self._perm]
        b_dev = jax.device_put(jnp.asarray(bp, dtype=self.dtype),
                               self.sharding)
        x, k, rel = self._jit_solve(b_dev, tuple(self.sharded_levels))
        xh = np.asarray(x)[:n]
        out = np.empty(n)
        out[self._perm] = xh
        return jnp.asarray(out, dtype=self.dtype), int(k), float(rel)

    def step(self, b) -> jax.Array:
        """One sharded V-cycle from zero (benchmark / multi-chip dryrun)."""
        n = self.host_matrices[0].shape[0]
        bp = np.zeros(self.n_pads[0])
        bp[:n] = np.asarray(b)[self._perm]
        b_dev = jax.device_put(jnp.asarray(bp, dtype=self.dtype),
                               self.sharding)
        return self._jit_step(b_dev, tuple(self.sharded_levels))
