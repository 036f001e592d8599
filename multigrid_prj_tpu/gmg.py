"""Geometric multigrid cycles and the outer solver driver.

Capability parity with the reference's cycle/driver layer:

* ``sawtooth_cycle`` reproduces ``SawtoothMGIteration``
  (``GeometricMultigrid/include/multigrid.hpp:89-157``): one residual
  evaluation on the finest grid, a stationary coarse solve of the error
  equation (rel. tol 1e-1, maxit 2000, ``multigrid.hpp:123``), then per level
  up: prolongate the error and apply ``nu = 5`` smoother sweeps on
  ``A_level err = res`` (``multigrid.hpp:105,134-139``), finally
  ``sol += err`` (``:141-144``).  Restriction is injection, exactly like the
  reference's shared masked residual vector (``multigrid.hpp:112-114``).
* ``stationary_solve`` reproduces ``Solver`` (``solvers.hpp:310-353``):
  smoother sweeps until the relative residual drops below ``tol`` or
  ``maxit`` is exhausted, with a convergence flag.
* ``GMGSolver.solve`` reproduces the outer driver loop
  (``src/main.cpp:77-116``): 2 pre-smoothing sweeps on the fine system, one
  cycle, residual-history append, stop at ``TOL = 1e-11``
  (``solvers.hpp:5``) or 1000 iterations.

Beyond parity the module adds the standard correction-scheme ``v_cycle`` /
``w_cycle`` / ``fmg`` with full-weighting restriction — the cycles
``BASELINE.json`` config 2 asks for.

Design: a cycle is a pure function over per-level dense arrays;
the level loop is unrolled at trace time (level count is static), the coarse
solve is a ``lax.while_loop``, and the outer iteration is a single
``lax.while_loop`` with a fixed-size history buffer — the whole solve is ONE
XLA computation with no host round-trips.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
from jax import lax

from multigrid_prj_tpu.grids import GridLevel, build_hierarchy
from multigrid_prj_tpu.ops.residual import norm2, rel_residual_norm
from multigrid_prj_tpu.ops.smoothers import make_smoother
from multigrid_prj_tpu.ops.stencil import poisson_residual
from multigrid_prj_tpu.ops.transfer import (
    crop_to,
    pad_to,
    prolong,
    prolong_padded,
    restrict_full_weighting,
    restrict_fw_padded,
    restrict_inject,
)

Smoother = Callable[..., jax.Array]  # (u, b, alpha, h, sweeps, logical_shape)


def stationary_solve(
    e0: jax.Array,
    b: jax.Array,
    alpha: float,
    h: float,
    smoother: Smoother,
    tol: float,
    maxit: int,
    sweeps_per_check: int = 1,
    logical_shape=None,
):
    """Iterate ``smoother`` on ``A e = b`` until ``||b - A e|| <= tol ||b||``.

    Returns ``(e, iterations, rel_norm)``.  Mirrors ``Solver``
    (``solvers.hpp:324-342``; ``m_step`` = ``sweeps_per_check``).
    """
    b2 = norm2(b)
    tol2 = (tol * tol) * b2

    def cond(state):
        _, k, rn2 = state
        return (k < maxit) & (rn2 > tol2)

    def body(state):
        e, k, _ = state
        e = smoother(e, b, alpha, h, sweeps_per_check,
                     logical_shape=logical_shape)
        rn2 = norm2(poisson_residual(e, b, alpha, h, logical_shape))
        return e, k + 1, rn2

    e, k, rn2 = lax.while_loop(cond, body, (e0, jnp.int32(0), b2))
    rel = jnp.sqrt(jnp.where(b2 > 0, rn2 / b2, 0.0))
    return e, k, rel


def _logical(lev: GridLevel):
    """logical_shape argument for masked ops: None in the exact layout."""
    return lev.shape if lev.padded_shape is not None else None


def restrict_level(r: jax.Array, lev: GridLevel, nxt: GridLevel,
                   exact_restrict=restrict_full_weighting) -> jax.Array:
    """Restriction honoring each level's layout (padded halving or exact)."""
    if lev.padded_shape is not None:
        rc = restrict_fw_padded(r, lev.shape)
        if nxt.padded_shape is None:
            rc = crop_to(rc, nxt.shape)
        return rc
    return exact_restrict(r)


def prolong_level(e: jax.Array, nxt: GridLevel, lev: GridLevel) -> jax.Array:
    """Prolongation from level ``nxt`` (coarse) up to ``lev`` (fine)."""
    if lev.padded_shape is not None:
        if nxt.padded_shape is None:
            e = pad_to(e, tuple(p // 2 for p in lev.padded_shape))
        return prolong_padded(e)
    return prolong(e, lev.shape)


def sawtooth_cycle(
    u: jax.Array,
    b: jax.Array,
    levels: Sequence[GridLevel],
    alpha: float,
    smoother: Smoother,
    nu: int = 5,
    coarse_tol: float = 1e-1,
    coarse_maxit: int = 2000,
    restrict=restrict_full_weighting,
) -> jax.Array:
    """One sawtooth multigrid cycle on the error equation (reference parity).

    Restriction note: the reference restricts the residual by *injection*
    (every level reads the shared fine-residual vector through its index
    mask).  With its sequential lexicographic GS that converges at
    rho ~ 0.08/iteration (measured by running the reference binary at
    ``-n 65 -ml 4 -test 0``: 11 iterations, ratios 0.087, 0.083, 0.081...).
    With the parallel red-black smoother, injection aliases the
    oscillatory residual onto the coarse grids and stalls at rho ~ 0.86, so
    the default here is full weighting — which reproduces the reference's
    convergence behavior almost exactly (ratios 0.080-0.083, 11-12
    iterations to 1e-11).  Pass ``restrict=restrict_inject`` for the strict
    structural-compat mode (SURVEY.md §7.4.7).
    """
    r = poisson_residual(u, b, alpha, levels[0].h, _logical(levels[0]))
    rs = [r]
    for j, lev in enumerate(levels[1:], start=1):
        rc = restrict_level(rs[-1], levels[j - 1], lev, exact_restrict=restrict)
        assert rc.shape == lev.physical, (rc.shape, lev.physical)
        rs.append(rc)
    e = jnp.zeros_like(rs[-1])
    e, _, _ = stationary_solve(
        e, rs[-1], alpha, levels[-1].h, smoother, coarse_tol, coarse_maxit,
        logical_shape=_logical(levels[-1]),
    )
    for j in range(len(levels) - 2, -1, -1):
        e = prolong_level(e, levels[j + 1], levels[j])
        e = smoother(e, rs[j], alpha, levels[j].h, nu,
                     logical_shape=_logical(levels[j]))
    return u + e


def v_cycle(
    u: jax.Array,
    b: jax.Array,
    levels: Sequence[GridLevel],
    alpha: float,
    smoother: Smoother,
    nu1: int = 2,
    nu2: int = 2,
    coarse_sweeps: int = 100,
    restrict=restrict_full_weighting,
    gamma: int = 1,
    coarse_apply=None,
    _level: int = 0,
) -> jax.Array:
    """Standard correction-scheme V-cycle (``gamma = 2`` gives the W-cycle).

    ``coarse_apply``: optional exact bottom solve ``b -> A^{-1} b`` (e.g. a
    precomputed dense inverse, see ``GMGSolver(coarse="direct")``).  Replaces
    the ``coarse_sweeps`` smoother iteration with one matrix-vector product.
    """
    lev = levels[_level]
    h = lev.h
    logical = _logical(lev)
    if _level == len(levels) - 1:
        if coarse_apply is not None:
            return coarse_apply(b)
        return smoother(u, b, alpha, h, coarse_sweeps, logical_shape=logical)
    u = smoother(u, b, alpha, h, nu1, logical_shape=logical)
    r = poisson_residual(u, b, alpha, h, logical)
    rc = restrict_level(r, lev, levels[_level + 1], exact_restrict=restrict)
    ec = jnp.zeros_like(rc)
    for _ in range(gamma):
        ec = v_cycle(
            ec, rc, levels, alpha, smoother,
            nu1=nu1, nu2=nu2, coarse_sweeps=coarse_sweeps,
            restrict=restrict, gamma=gamma, coarse_apply=coarse_apply,
            _level=_level + 1,
        )
    u = u + prolong_level(ec, levels[_level + 1], lev)
    u = smoother(u, b, alpha, h, nu2, logical_shape=logical)
    return u


def w_cycle(u, b, levels, alpha, smoother, **kw):
    kw.setdefault("gamma", 2)
    return v_cycle(u, b, levels, alpha, smoother, **kw)


def fmg(
    b: jax.Array,
    levels: Sequence[GridLevel],
    alpha: float,
    smoother: Smoother,
    n_vcycles: int = 1,
    restrict=restrict_full_weighting,
    **vkw,
) -> jax.Array:
    """Full multigrid: coarsest-first nested iteration, then V-cycles per level."""
    bs = [b]
    for j, lev in enumerate(levels[1:], start=1):
        bs.append(restrict_level(bs[-1], levels[j - 1], lev,
                                 exact_restrict=restrict))
    u = jnp.zeros_like(bs[-1])
    for j in range(len(levels) - 1, -1, -1):
        if j < len(levels) - 1:
            u = prolong_level(u, levels[j + 1], levels[j])
        for _ in range(n_vcycles):
            u = v_cycle(u, bs[j], levels[j:], alpha, smoother, restrict=restrict, **vkw)
    return u


@dataclasses.dataclass
class SolveResult:
    """Outcome of an outer multigrid solve.

    ``converged`` mirrors the reference's ``Solver::flag``
    (``solvers.hpp:335-338``); ``history`` is the per-iteration relative
    residual norm the reference writes to ``MGGS4.txt``
    (``src/main.cpp:74,87,127``).  ``u_lo`` is set only by a float-float
    solve without x64: the low half of the solution pair ``u + u_lo``.
    """

    u: jax.Array
    history: jax.Array  # shape (iterations + 1,)
    iterations: int
    converged: bool
    u_lo: jax.Array | None = None

    @property
    def convergence_factor(self) -> float:
        """Geometric-mean residual reduction per outer iteration."""
        h = self.history
        if len(h) < 2 or float(h[0]) == 0.0:
            return 0.0
        return float((h[-1] / h[0]) ** (1.0 / (len(h) - 1)))


class GMGSolver:
    """Geometric multigrid solver for the Dirichlet Poisson problem.

    Parameters mirror the reference CLI (``utilities.hpp:16-21``): grid
    ``shape`` (``-n``), diffusion ``alpha`` (``-a``), domain ``length``
    (``-w``), ``num_levels`` (``-ml``), ``smoother`` (``-smt``).
    """

    def __init__(
        self,
        shape: Sequence[int],
        length: float = 10.0,
        alpha: float = 10.0,
        num_levels: int = 2,
        smoother: str = "gs",
        cycle: str = "sawtooth",
        nu: int = 5,
        pre_sweeps: int = 2,
        omega: float = 1.0,
        tol: float = 1e-11,
        maxit: int = 1000,
        coarse_tol: float = 1e-1,
        coarse_maxit: int = 2000,
        smoother_dtype=None,
        pad_align: int | None = None,
        coarse: str = "direct",
    ):
        """``smoother_dtype``: run smoothing sweeps in a lower precision
        (e.g. ``jnp.bfloat16``) while residuals/corrections stay in the
        outer dtype — the mixed-precision mode of BASELINE.json config 4.

        ``pad_align``: store levels in aligned padded buffers (e.g. 256);
        the logical 2^k+1 grid keeps its odd-size hierarchy inside them.
        """
        self.levels = build_hierarchy(shape, length, num_levels,
                                      pad_align=pad_align)
        self.alpha = float(alpha)
        self.length = float(length)
        self.tol = float(tol)
        self.maxit = int(maxit)
        self.nu = int(nu)
        self.pre_sweeps = int(pre_sweeps)
        self.cycle = cycle
        self.coarse_tol = float(coarse_tol)
        self.coarse_maxit = int(coarse_maxit)
        self.smoother = make_smoother(smoother, omega=omega)
        self.smoother_dtype = smoother_dtype
        self._logical0 = (self.levels[0].shape
                          if self.levels[0].padded_shape is not None else None)
        # Direct bottom solve for the correction cycles: precompute the dense
        # inverse of the coarsest-level operator (Dirichlet identity rows
        # included) so the bottom of every V/W-cycle is ONE matmul instead of
        # a ~100-sweep smoother iteration.  The inverse is passed to the
        # jitted solve as an ARGUMENT (never closed over — closure capture
        # would bake it into the executable as a constant).
        self._coarse_inv = None
        if coarse == "direct" and cycle in ("v", "w"):
            self._coarse_inv = self._build_coarse_inverse()
        self._jit_solve = jax.jit(self._solve_impl)

    def _build_coarse_inverse(self, max_nodes: int = 4608):
        # 4608 admits the 66^2/65^2 coarsest buffers of the 8193^2/16385^2
        # 8/9-level hierarchies (np.linalg.inv at 4356 nodes ~ 5 s host,
        # one-time; the alternative is 100 smoother sweeps at the bottom of
        # EVERY cycle)
        """Dense inverse of the coarsest-level stencil operator.

        Rows follow the masked operator exactly (``ops/stencil.py``):
        interior nodes get ``2*ndim*c`` on the diagonal and ``-c`` per
        neighbor; logical-boundary and padded dead-zone nodes are identity.
        Built in f64 on the host, stored in the backend default dtype.
        Returns ``None`` when the coarse buffer exceeds ``max_nodes`` (the
        sweep iteration stays in that case).
        """
        import numpy as np

        lev = self.levels[-1]
        shape = lev.physical
        n_nodes = int(np.prod(shape))
        if n_nodes > max_nodes:
            return None
        logical = lev.shape
        c = self.alpha / (lev.h * lev.h)
        idx = np.arange(n_nodes).reshape(shape)
        coords = np.indices(shape)
        interior = np.ones(shape, dtype=bool)
        for d in range(len(shape)):
            interior &= (coords[d] >= 1) & (coords[d] <= logical[d] - 2)
        A = np.eye(n_nodes)
        rows = idx[interior]
        A[rows, rows] = 2 * len(shape) * c
        for d in range(len(shape)):
            for off in (-1, +1):
                nb = np.roll(idx, -off, axis=d)  # nb[p] = idx at p + off
                A[rows, nb[interior]] = -c
        inv = np.linalg.inv(A)
        return jnp.asarray(inv)

    def _coarse_apply_of(self, cinv):
        if cinv is None:
            return None

        def apply_inv(bb):
            # HIGHEST: a float32 product may otherwise run in TF32 on GPUs,
            # which would cap the bottom solve at ~3 decimal digits
            x = jnp.matmul(cinv.astype(bb.dtype), bb.reshape(-1),
                           precision=lax.Precision.HIGHEST)
            return x.reshape(bb.shape)

        return apply_inv

    def _cycle(self, u, b, cinv=None):
        if self.cycle == "sawtooth":
            return sawtooth_cycle(
                u, b, self.levels, self.alpha, self.smoother,
                nu=self.nu, coarse_tol=self.coarse_tol,
                coarse_maxit=self.coarse_maxit,
            )
        if self.cycle == "v":
            return v_cycle(u, b, self.levels, self.alpha, self.smoother,
                           nu1=self.pre_sweeps, nu2=self.nu,
                           coarse_apply=self._coarse_apply_of(cinv))
        if self.cycle == "w":
            return w_cycle(u, b, self.levels, self.alpha, self.smoother,
                           nu1=self.pre_sweeps, nu2=self.nu,
                           coarse_apply=self._coarse_apply_of(cinv))
        raise ValueError(f"unknown cycle {self.cycle!r}")

    def step(self, u, b, cinv=None):
        """One outer iteration: pre-smooths + one cycle (``main.cpp:85``).

        ``cinv``: coarse-inverse array for the direct bottom solve.  The
        jitted solve loops pass it as a traced argument; external callers
        (preconditioner closures, benchmarks) may omit it and get the
        stored inverse.

        Mixed precision (``smoother_dtype`` set) runs as defect correction:
        the residual is computed in the outer dtype, the whole cycle solves
        the *error equation* in the low dtype (where the error's small
        magnitude keeps relative precision useful), and the correction is
        added back in the outer dtype.  Quantizing the solution itself would
        floor convergence at the low dtype's epsilon (measured: bf16 stalls
        at rel. residual ~0.4 that way).
        """
        if cinv is None:
            cinv = self._coarse_inv
        h0 = self.levels[0].h
        if self.smoother_dtype is not None:
            r = poisson_residual(u, b, self.alpha, h0, self._logical0)
            e = self._error_cycle(r.astype(self.smoother_dtype), cinv)
            return u + e.astype(u.dtype)
        if self.cycle == "sawtooth":
            u = self.smoother(u, b, self.alpha, h0, self.pre_sweeps,
                              logical_shape=self._logical0)
        return self._cycle(u, b, cinv)

    def _error_cycle(self, r, cinv=None):
        """One cycle applied to the error equation ``A e = r`` from ``e = 0``
        (the defect-correction inner solve used by the mixed-precision and
        extended-precision outer loops)."""
        e = jnp.zeros_like(r)
        if self.cycle == "sawtooth":
            e = self.smoother(e, r, self.alpha, self.levels[0].h,
                              self.pre_sweeps, logical_shape=self._logical0)
        return self._cycle(e, r, cinv)

    def _solve_impl(self, u, b, cinv=None):
        # logical-shape operands are padded here (inside the jit) so a solve
        # is one device dispatch with no eager pad/crop roundtrips
        lev0 = self.levels[0]
        padded = lev0.padded_shape is not None
        if padded and tuple(b.shape) == lev0.shape:
            b = pad_to(b, lev0.padded_shape)
        if padded and tuple(u.shape) == lev0.shape:
            u = pad_to(u, lev0.padded_shape)
        h0 = self.levels[0].h
        dtype = b.dtype
        hist = jnp.full((self.maxit + 1,), jnp.nan, dtype=dtype)
        hist = hist.at[0].set(
            rel_residual_norm(u, b, self.alpha, h0, self._logical0)
        )

        def cond(state):
            _, k, hist = state
            return (k < self.maxit) & (hist[k] > self.tol)

        def body(state):
            u, k, hist = state
            u = self.step(u, b, cinv)
            rn = rel_residual_norm(u, b, self.alpha, h0, self._logical0)
            hist = hist.at[k + 1].set(rn)
            return u, k + 1, hist

        u, k, hist = lax.while_loop(cond, body, (u, jnp.int32(0), hist))
        if padded:
            u = crop_to(u, lev0.shape)
        return u, k, hist

    def _solve_impl_ff(self, b_logical, cinv=None, inner_cg: int = 0):
        """Iterative refinement: f32 cycles against a float-float residual
        (ops/extended.py) — reaches ~1e-8 relative residual on grids where
        plain f32 floors at eps_f32 * kappa(A).

        The WHOLE refined solve (padding, ``b/c`` pair setup, the refinement
        loop, final crop) is one traced computation —
        ``solve_refined`` jits it, so a solve is ONE device dispatch.  The
        residual is carried across the loop: each iteration evaluates the
        extended residual once (for the next correction AND the history
        entry), not twice.
        """
        from multigrid_prj_tpu.ops.extended import (
            ff_accumulate,
            ff_from_div,
            ff_poisson_residual,
        )

        lev0 = self.levels[0]
        b = (pad_to(b_logical, lev0.padded_shape)
             if lev0.padded_shape is not None
             and tuple(b_logical.shape) == lev0.shape else b_logical)
        c = self.alpha / (lev0.h * lev0.h)
        d_hi, d_lo = ff_from_div(b, c)
        h0 = lev0.h
        b2 = norm2(b)

        def residual(u_hi, u_lo):
            return ff_poisson_residual(u_hi, u_lo, d_hi, d_lo, b, self.alpha,
                                       h0, self._logical0)

        def rel(r):
            return jnp.sqrt(norm2(r) / b2)

        u_hi = jnp.zeros_like(b)
        u_lo = jnp.zeros_like(b)
        r = residual(u_hi, u_lo)
        hist = jnp.full((self.maxit + 1,), jnp.nan, dtype=b.dtype)
        hist = hist.at[0].set(rel(r))

        def cond(state):
            _, _, _, k, hist = state
            return (k < self.maxit) & (hist[k] > self.tol)

        if inner_cg:
            # inner correction solve = ``inner_cg`` iterations of V-cycle-
            # preconditioned CG on the f32 error equation A e = r, instead
            # of a single V-cycle.  At large kappa (8193^2: the plain cycle's
            # f32 error reduction degrades to ~0.78/cycle) CG squeezes far
            # more reduction out of the same number of cycles, and the
            # expensive extended residual is evaluated once per OUTER
            # iteration either way.  Composition of the framework's own
            # Krylov component (ops/krylov.py; reference analog
            # GeometricMultigrid/include/solvers.hpp:86-216) with MG.
            from multigrid_prj_tpu.ops.krylov import cg_arrays
            from multigrid_prj_tpu.ops.stencil import boundary_mask, poisson_apply

            bmask = boundary_mask(b.shape, self._logical0)

            def inner_solve(r):
                # A with Dirichlet identity rows is NOT symmetric on the
                # full space (interior rows couple to boundary columns but
                # not vice versa) — CG breaks down there (measured: stall/
                # NaN at 257^2).  On the zero-boundary subspace A is exactly
                # the SPD interior operator, and A, M both preserve that
                # subspace; so run CG on the interior part and solve the
                # identity rows directly.
                r_i = jnp.where(bmask, 0.0, r)
                e, _, _, _ = cg_arrays(
                    lambda v: poisson_apply(v, self.alpha, h0, self._logical0),
                    r_i, tol=0.0, maxit=inner_cg,
                    M=lambda rr: self._error_cycle(rr, cinv),
                )
                return jnp.where(bmask, r, e)
        else:
            def inner_solve(r):
                return self._error_cycle(r, cinv)

        def body(state):
            u_hi, u_lo, r, k, hist = state
            e = inner_solve(r)
            u_hi, u_lo = ff_accumulate(u_hi, u_lo, e)
            r = residual(u_hi, u_lo)
            hist = hist.at[k + 1].set(rel(r))
            return u_hi, u_lo, r, k + 1, hist

        u_hi, u_lo, _, k, hist = lax.while_loop(
            cond, body, (u_hi, u_lo, r, jnp.int32(0), hist)
        )
        if lev0.padded_shape is not None:
            u_hi, u_lo = crop_to(u_hi, lev0.shape), crop_to(u_lo, lev0.shape)
        if jax.config.jax_enable_x64:
            # combined on the device; the pair's precision survives in f64
            return (u_hi.astype(jnp.float64) + u_lo.astype(jnp.float64),
                    None, k, hist)
        return u_hi, u_lo, k, hist

    def solve_refined(self, b: jax.Array, inner_cg: int = 0) -> SolveResult:
        """Solve with float-float ("ff32") outer residuals.

        For f32 solves whose plain floor ``~6e-8 * (N/pi)^2`` sits above the
        requested tolerance.  Costs ~1 extended residual evaluation per
        cycle on top of the f32 cycle itself.  With x64 enabled the returned
        ``u`` is the solution pair combined on the device in float64.
        Without it ``u`` is the pair's high half (the f32 rounding of the
        solution) and ``u_lo`` its low half: callers that need the extended
        precision combine ``u + u_lo`` in float64 themselves.

        Convergence model (measured): the outer rate is
        ``max(cycle_rate, C * eps_f32 * kappa(A))`` because the inner f32
        cycle's own roundoff caps how accurately each correction solves the
        error equation.  Through 2049^2 that keeps the full multigrid rate;
        at 8193^2 the plain rate degrades to ~0.78 per cycle — pass
        ``inner_cg = k > 0`` there to replace each refinement's single
        V-cycle with ``k`` iterations of MG-preconditioned CG on the f32
        error equation, which recovers most of the lost rate per
        extended-residual evaluation.
        """
        if not hasattr(self, "_jit_solve_ff_cache"):
            self._jit_solve_ff_cache = {}
        if inner_cg not in self._jit_solve_ff_cache:
            self._jit_solve_ff_cache[inner_cg] = jax.jit(
                partial(self._solve_impl_ff, inner_cg=inner_cg))
        u, u_lo, k, hist = self._jit_solve_ff_cache[inner_cg](
            b, self._coarse_inv)
        k, hist_np = jax.device_get((k, hist))  # u stays on the device
        k = int(k)
        hist_np = hist_np[: k + 1]
        return SolveResult(u=u, history=hist_np, iterations=k,
                           converged=bool(hist_np[-1] <= self.tol),
                           u_lo=u_lo)

    def solve(self, b: jax.Array, u0: jax.Array | None = None,
              fmg_start: bool = False) -> SolveResult:
        """Solve to tolerance.  ``b`` (and ``u0``) are LOGICAL-shape arrays;
        padding in the aligned layout is handled internally and the returned
        solution is cropped back to the logical grid.

        ``fmg_start``: initialize with one full-multigrid pass (nested
        iteration) before the outer loop — usually saves 2-3 outer cycles.
        """
        from multigrid_prj_tpu.utils.guards import check_finite

        check_finite(b, "rhs b")
        lev0 = self.levels[0]
        if fmg_start and u0 is None:
            bp = (pad_to(b, lev0.padded_shape)
                  if lev0.padded_shape is not None
                  and tuple(b.shape) == lev0.shape else b)
            u0 = jax.jit(
                lambda bb: fmg(bb, self.levels, self.alpha, self.smoother,
                               nu1=self.pre_sweeps, nu2=self.nu)
            )(bp)
        if u0 is None:
            u0 = jnp.zeros_like(b)
        # padding/cropping happens inside the jitted solve (one dispatch)
        u, k, hist = self._jit_solve(u0, b, self._coarse_inv)
        k, hist_np = jax.device_get((k, hist))
        k = int(k)
        hist_np = hist_np[: k + 1]
        return SolveResult(
            u=u,
            history=hist_np,
            iterations=k,
            converged=bool(hist_np[-1] <= self.tol),
        )
