"""Multi-device geometric multigrid: block-slab sharding + halo exchange,
for 2D and 3D grids.

This is the distribution layer the reference never had (its only parallelism
was OpenMP loop pragmas, SURVEY.md §2.4).  Design, following the standard
JAX recipe:

* the fine grid (``(n, m)`` or ``(n, m, k)``) is block-sharded on its
  LEADING axis over the mesh — rows in 2D, slabs in 3D;
* the mesh may be 1D (``("x",)`` — the devices of one host, e.g. GPUs
  joined all to all by NVLink) or 2D (``("dcn", "x")`` — multi-host: "x"
  is the fast intra-host axis, "dcn" the slower cross-host network).
  Slabs are laid out dcn-major, so almost every halo exchange is a
  fixed-neighbor ``ppermute`` within a host; only the per-group edge slab
  crosses hosts (one extra ppermute pair);
* every stencil/smoother sweep exchanges ONE halo slab per neighbor; the
  sweep is split into an INTERIOR part (no remote dependence — XLA's
  latency-hiding scheduler overlaps it with the in-flight ppermute) and the
  two edge slabs that consume the halos (SURVEY.md §7.4.4 overlap);
* norms and convergence checks are ``lax.psum`` reductions over all mesh
  axes, so the whole outer solve (pre-smooths + V-cycle + residual history
  + while_loop control) is ONE jitted ``shard_map`` program;
* grid transfer stays local while the per-shard slab count is even; deeper
  levels are ``all_gather``-ed and run replicated (they are tiny);
* edge shards receive zero halos; those slabs are exactly the global
  Dirichlet boundary, which every kernel masks to identity.

Multi-host bring-up is env-driven and optional —
``parallel/distributed.py:maybe_initialize_distributed``.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multigrid_prj_tpu.gmg import SolveResult, v_cycle as replicated_v_cycle
from multigrid_prj_tpu.grids import GridLevel, build_hierarchy
from multigrid_prj_tpu.ops.smoothers import make_smoother
from multigrid_prj_tpu.ops.transfer import _fw_axis, _refine_axis

AXIS = "x"  # the fast intra-host axis; an optional "dcn" axis majors it


def row_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the leading grid axis is sharded over (dcn-major)."""
    return ("dcn", AXIS) if "dcn" in mesh.axis_names else (AXIS,)


def _axes_size(axes) -> jax.Array:
    s = 1
    for a in axes:
        s = s * lax.axis_size(a)
    return s


def global_shard_index(axes) -> jax.Array:
    """Linear shard id over (possibly) two mesh axes, minor axis fastest."""
    idx = lax.axis_index(axes[-1])
    if len(axes) == 2:
        idx = idx + lax.axis_index(axes[0]) * lax.axis_size(axes[-1])
    return idx


# ---------------------------------------------------------------------------
# Halo exchange (leading axis; 2D rows or 3D planes)
# ---------------------------------------------------------------------------


def _halo_slabs(u: jax.Array, axes: Tuple[str, ...], w: int = 1):
    """(top, bottom) neighbor halo slabs of ``w`` rows; zeros at the global
    ends.

    1D mesh: one ppermute pair on the "x" axis.  2D (dcn, x) mesh: the
    within-group edges stay on "x"; each group's boundary slab additionally
    crosses the "dcn" axis (bounced via the group's x-0 / x-last shard).
    """
    ici = axes[-1]
    pi = lax.axis_size(ici)
    top = lax.ppermute(u[-w:], ici, [(i, i + 1) for i in range(pi - 1)])
    bot = lax.ppermute(u[:w], ici, [(i, i - 1) for i in range(1, pi)])
    if len(axes) == 2:
        dcn = axes[0]
        pd = lax.axis_size(dcn)
        if pd > 1:
            # group d's LAST slab -> group d+1's x-0 shard (its top halo):
            # bounce to x-0 within the group, then one "dcn" hop.
            t1 = lax.ppermute(u[-w:], ici, [(pi - 1, 0)])
            t2 = lax.ppermute(t1, dcn, [(d, d + 1) for d in range(pd - 1)])
            # group d's FIRST slab -> group d-1's x-last shard (bottom halo)
            b1 = lax.ppermute(u[:w], ici, [(0, pi - 1)])
            b2 = lax.ppermute(b1, dcn, [(d, d - 1) for d in range(1, pd)])
            ii = lax.axis_index(ici)
            top = jnp.where(ii == 0, t2, top)
            bot = jnp.where(ii == pi - 1, b2, bot)
    return top, bot


def norm2_psum(x: jax.Array, axes: Tuple[str, ...]) -> jax.Array:
    return lax.psum(jnp.sum(x * x), axes)


# ---------------------------------------------------------------------------
# Local (per-shard) building blocks — rank-generic (2D / 3D)
# ---------------------------------------------------------------------------


def _global_coords(shape_local, axes):
    """Per-point global index arrays (leading axis globalized)."""
    i = global_shard_index(axes)
    coords = []
    for ax in range(len(shape_local)):
        c = jax.lax.broadcasted_iota(jnp.int32, tuple(shape_local), ax)
        if ax == 0:
            c = c + i * shape_local[0]
        coords.append(c)
    return coords


def _boundary_mask_local(shape_local, global_shape, axes):
    coords = _global_coords(shape_local, axes)
    m = None
    for c, n in zip(coords, global_shape):
        this = (c == 0) | (c == n - 1)
        m = this if m is None else (m | this)
    return m


def _shift_local(a, ax, off):
    """Zero-padded shift along a LOCAL (non-leading) axis."""
    sl = [slice(None)] * a.ndim
    pad = [(0, 0)] * a.ndim
    if off == +1:
        sl[ax] = slice(1, None)
        pad[ax] = (0, 1)
    else:
        sl[ax] = slice(None, -1)
        pad[ax] = (1, 0)
    return jnp.pad(a[tuple(sl)], pad)


def _neighbor_sum_local(u, top, bot):
    """Sum of the 2*ndim neighbors, halos supplying the leading-axis edges."""
    north = jnp.concatenate([top, u[:-1]], axis=0)
    south = jnp.concatenate([u[1:], bot], axis=0)
    s = north + south
    for ax in range(1, u.ndim):
        s = s + _shift_local(u, ax, +1) + _shift_local(u, ax, -1)
    return s


def _neighbor_sum_inner(u):
    """Neighbor sum for the interior slabs ``u[1:-1]`` only — needs NO halo,
    so XLA can overlap it with the in-flight ppermute (SURVEY §7.4.4)."""
    s = u[:-2] + u[2:]
    inner = u[1:-1]
    for ax in range(1, u.ndim):
        s = s + _shift_local(inner, ax, +1) + _shift_local(inner, ax, -1)
    return s


def poisson_apply_local(u, alpha, h, global_shape, axes):
    c = alpha / (h * h)
    top, bot = _halo_slabs(u, axes)
    bmask = _boundary_mask_local(u.shape, global_shape, axes)
    diag = 2.0 * u.ndim
    interior = c * (diag * u - _neighbor_sum_local(u, top, bot))
    return jnp.where(bmask, u, interior)


def residual_local(u, b, alpha, h, global_shape, axes):
    return b - poisson_apply_local(u, alpha, h, global_shape, axes)


def rbgs_local(u, b, alpha, h, global_shape, axes, sweeps: int = 1,
               overlap: bool = True):
    """Red-black GS, one halo exchange per color pass, interior/edge split
    so the exchange overlaps the interior update (SURVEY §7.4.4).

    ``overlap=False`` keeps the exchange-then-compute reference schedule
    (the whole-block neighbor sum data-depends on the ppermute results, so
    no compute can be issued until the halos arrive) — numerically
    IDENTICAL, used as the A/B baseline by ``benchmarks/overlap_ab.py``
    and ``tests/test_sharded_gmg.py``.
    """
    c = alpha / (h * h)
    bmask = _boundary_mask_local(u.shape, global_shape, axes)
    coords = _global_coords(u.shape, axes)
    parity = sum(coords) % 2
    inv_diag = 1.0 / (2.0 * u.ndim)
    b_over_c = b / c

    def one_color(u, color):
        top, bot = _halo_slabs(u, axes)  # issued before interior compute
        if overlap:
            # interior slabs depend only on local data: XLA's latency-hiding
            # scheduler runs this while the ppermute is in flight
            gs_inner = (b_over_c[1:-1] + _neighbor_sum_inner(u)) * inv_diag
            first = u[:1]
            last = u[-1:]
            ns_first = top + u[1:2]
            ns_last = u[-2:-1] + bot
            for ax in range(1, u.ndim):
                ns_first = ns_first + _shift_local(first, ax, +1) + _shift_local(first, ax, -1)
                ns_last = ns_last + _shift_local(last, ax, +1) + _shift_local(last, ax, -1)
            gs_first = (b_over_c[:1] + ns_first) * inv_diag
            gs_last = (b_over_c[-1:] + ns_last) * inv_diag
            gs = jnp.concatenate([gs_first, gs_inner, gs_last], axis=0)
        else:
            # whole-block update consumes the halos up front — every element
            # of the neighbor sum data-depends on the collective
            gs = (b_over_c + _neighbor_sum_local(u, top, bot)) * inv_diag
        u = jnp.where((parity == color) & ~bmask, gs, u)
        return jnp.where(bmask, b, u)

    def one_sweep(u):
        u = one_color(u, 0)
        return one_color(u, 1)

    if sweeps <= 8:
        for _ in range(sweeps):
            u = one_sweep(u)
        return u
    return lax.fori_loop(0, sweeps, lambda _, v: one_sweep(v), u)


# ---------------------------------------------------------------------------
# Wide-halo grouped sweeps: ONE halo exchange per sweep group (+ fused
# residual/restrict).
#
# rbgs_local exchanges halos per COLOR pass (4 ppermutes per sweep on a 1D
# mesh) and residual/restrict re-exchange twice more — 12 ppermute ops per
# down-leg at nu=2.  Here one exchange ships ``w = 2*sweeps + 2`` slabs of u
# (plus b's, reused across groups), the sweeps run collective-free on the
# extended block (outer rows go stale by one slab per color pass — the
# center stays EXACT while ``2*sweeps + 2 <= w``), and the residual +
# restriction read the still-valid +-1 halo rows: 4 ppermutes per down-leg.
# Where per-collective latency times count dominates a cycle, this is the
# structural fix; where it does not, the per-color schedule is cheaper.
# ---------------------------------------------------------------------------

_MAX_GROUP_SWEEPS = 4


def _split_groups(sweeps: int):
    full, rem = divmod(sweeps, _MAX_GROUP_SWEEPS)
    return [_MAX_GROUP_SWEEPS] * full + ([rem] if rem else [])


def group_supported(R: int, sweeps: int, extra: int = 2) -> bool:
    """Feasibility: every group's halo width must fit the local slab count
    (a w-slab halo only reaches the NEAREST neighbor shard)."""
    w_max = 2 * min(max(sweeps, 1), _MAX_GROUP_SWEEPS) + extra
    return R % 2 == 0 and w_max <= R


def group_max_w(sweeps: int, tail_extra: int) -> int:
    """Widest halo any group of a ``sweeps``-sweep run requests (the shared
    ``b_halos`` exchange must cover it)."""
    groups = _split_groups(sweeps) or [0]
    return max(2 * s + (tail_extra if i == len(groups) - 1 else 0)
               for i, s in enumerate(groups))


def _rbgs_sweeps_ext(ue, be, row0, global_shape, alpha, h, sweeps: int):
    """``sweeps`` whole-block RB-GS sweeps on a halo-extended block — no
    collectives; float-op-for-float-op the schedule of
    ``rbgs_local(overlap=False)``, so rows that remain valid are bitwise
    equal to the per-color-exchange path.  Rows whose global index falls
    outside the domain are pinned to ``be`` (zeros from the edge halo
    exchange) and can never contaminate the interior: the Dirichlet row 0 /
    n-1 between them and the interior is re-pinned every color pass."""
    c = alpha / (h * h)
    shape_ext = tuple(ue.shape)
    coords = []
    for ax in range(len(shape_ext)):
        cc = jax.lax.broadcasted_iota(jnp.int32, shape_ext, ax)
        if ax == 0:
            cc = cc + row0
        coords.append(cc)
    lead = coords[0]
    bmask = (lead < 0) | (lead > global_shape[0] - 1)
    for cc, n in zip(coords, global_shape):
        bmask = bmask | (cc == 0) | (cc == n - 1)
    parity = sum(coords) % 2
    inv_diag = 1.0 / (2.0 * ue.ndim)
    b_over_c = be / c

    def nsum(u):
        z = jnp.zeros_like(u[:1])
        s = jnp.concatenate([z, u[:-1]], axis=0) + jnp.concatenate(
            [u[1:], z], axis=0)
        for ax in range(1, u.ndim):
            s = s + _shift_local(u, ax, +1) + _shift_local(u, ax, -1)
        return s

    u = ue
    for _ in range(sweeps):
        for color in (0, 1):
            gs = (b_over_c + nsum(u)) * inv_diag
            u = jnp.where((parity == color) & ~bmask, gs, u)
            u = jnp.where(bmask, be, u)
    return u


def _residual_ext(ue, be, row0, global_shape, alpha, h):
    """Residual on the interior rows ``ue[1:-1]`` of an extended block —
    collective-free; same float schedule as :func:`residual_local`.
    ``row0`` is the global index of ``ue``'s first row."""
    c = alpha / (h * h)
    inner = ue[1:-1]
    ns = ue[:-2] + ue[2:]
    for ax in range(1, ue.ndim):
        ns = ns + _shift_local(inner, ax, +1) + _shift_local(inner, ax, -1)
    shape_in = tuple(inner.shape)
    coords = []
    for ax in range(len(shape_in)):
        cc = jax.lax.broadcasted_iota(jnp.int32, shape_in, ax)
        if ax == 0:
            cc = cc + row0 + 1
        coords.append(cc)
    lead = coords[0]
    bmask = (lead < 0) | (lead > global_shape[0] - 1)
    for cc, n in zip(coords, global_shape):
        bmask = bmask | (cc == 0) | (cc == n - 1)
    diag = 2.0 * ue.ndim
    Au = jnp.where(bmask, inner, c * (diag * inner - ns))
    return be[1:-1] - Au


def _grouped_sweeps(u, b, alpha, h, global_shape, axes, sweeps: int,
                    tail_extra: int, b_halos=None):
    """Run grouped wide-halo sweeps; returns ``(u, ue, be, w_last)`` where
    ``ue``/``be`` are the LAST group's extended blocks (halo width
    ``w_last = 2*s + tail_extra``, so ``tail_extra`` rows each side are
    still valid for a fused residual).

    ``b_halos = (bt_W, bb_W, W)``: pre-exchanged ``W``-slab halos of ``b``
    (``W >=`` any group's width) — ``b`` is the level's RHS, constant
    through a level visit, so the caller exchanges it ONCE and both the
    down-leg and post-smoothing slice what they need (one ppermute pair
    fewer per level visit)."""
    R = u.shape[0]
    gsi = global_shard_index(axes)
    groups = _split_groups(sweeps) or [0]
    ue = be = None
    w = 0
    for gi, s in enumerate(groups):
        last = gi == len(groups) - 1
        w = 2 * s + (tail_extra if last else 0)
        ut, ub = _halo_slabs(u, axes, w)
        if b_halos is not None:
            bt_w, bb_w, W = b_halos
            bt, bb = bt_w[W - w:], bb_w[:w]
        else:
            bt, bb = _halo_slabs(b, axes, w)
        ue = jnp.concatenate([ut, u, ub], axis=0)
        be = jnp.concatenate([bt, b, bb], axis=0)
        if s:
            ue = _rbgs_sweeps_ext(ue, be, gsi * R - w, global_shape,
                                  alpha, h, s)
        u = ue[w: w + R]
    return u, ue, be, w


def downleg_group_local(u, b, alpha, h, global_shape, axes, sweeps: int,
                        b_halos=None):
    """Fused down-leg (grouped sweeps + residual + full-weighting restrict):
    4 ppermutes total on a 1D mesh (2 with shared ``b_halos``) vs
    rbgs_local+residual+restrict's ``4*sweeps + 4``.
    Returns ``(u_smoothed, r_coarse)``."""
    R = u.shape[0]
    gsi = global_shard_index(axes)
    u, ue, be, w = _grouped_sweeps(u, b, alpha, h, global_shape, axes,
                                   sweeps, tail_extra=2, b_halos=b_halos)
    # residual on rows gsi*R - 1 .. gsi*R + R (the restriction's rp)
    rp = _residual_ext(ue[w - 2: w + R + 2], be[w - 2: w + R + 2],
                       gsi * R - 2, global_shape, alpha, h)
    return u, _restrict_from_rp(rp, global_shape, axes)


def postsmooth_group_local(u, b, alpha, h, global_shape, axes, sweeps: int,
                           resnorm: bool = False, b_halos=None):
    """Grouped post-smoothing; with ``resnorm`` the LOCAL residual
    sum-of-squares comes fused (no extra exchange) — the caller psums."""
    R = u.shape[0]
    gsi = global_shard_index(axes)
    u, ue, be, w = _grouped_sweeps(u, b, alpha, h, global_shape, axes,
                                   sweeps, tail_extra=1 if resnorm else 0,
                                   b_halos=b_halos)
    if not resnorm:
        return u
    r = _residual_ext(ue[w - 1: w + R + 1], be[w - 1: w + R + 1],
                      gsi * R - 1, global_shape, alpha, h)
    return u, jnp.sum(r * r)


def _restrict_from_rp(rp, global_shape, axes):
    """Full-weighting restriction given the halo-extended residual ``rp``
    (``R + 2`` slabs: 1 top halo, R local, 1 bottom halo) — collective-free;
    trailing axes are fully local (ops/transfer._fw_axis semantics)."""
    R = rp.shape[0] - 2
    n_global = global_shape[0]
    rows = 0.25 * rp[0:R:2] + 0.5 * rp[1: R + 1: 2] + 0.25 * rp[2: R + 2: 2]
    i = global_shard_index(axes)
    Rc = R // 2
    nc = (n_global + 1) // 2
    grow = i * Rc + jax.lax.broadcasted_iota(jnp.int32, rows.shape, 0)
    # global low edge: inject (true Dirichlet slab).  High edge: inject for
    # odd n; ZERO for even n (fake coarse boundary must carry no residual —
    # see ops/transfer._fw_axis).
    rows = jnp.where(grow == 0, rp[1: R + 1: 2], rows)
    if n_global % 2 == 0:
        rows = jnp.where(grow == nc - 1, 0.0, rows)
    else:
        rows = jnp.where(grow == nc - 1, rp[1: R + 1: 2], rows)
    for ax in range(1, rp.ndim):
        rows = _fw_axis(rows, ax)
    return rows


def restrict_fw_local(r, global_shape, axes):
    """Full-weighting restriction of a leading-axis shard (R slabs -> R/2)."""
    top, bot = _halo_slabs(r, axes)
    return _restrict_from_rp(jnp.concatenate([top, r, bot], axis=0),
                             global_shape, axes)


def prolong_local(e, fine_slabs: int, fine_trailing: Tuple[int, ...],
                  axes: Tuple[str, ...]):
    """Linear prolongation of a coarse shard (Rc slabs) to its fine shard
    (R = 2 Rc slabs), pulling one coarse halo slab from the next shard;
    trailing axes refine locally."""
    _, bot = _halo_slabs(e, axes)
    # last shard clamps to its own last slab (general-n edge handling)
    idx = global_shard_index(axes)
    p = _axes_size(axes)
    bot = jnp.where(idx == p - 1, e[-1:], bot)
    nxt = jnp.concatenate([e[1:], bot], axis=0)
    mid = 0.5 * (e + nxt)
    Rc = e.shape[0]
    inter = jnp.stack([e, mid], axis=1).reshape((2 * Rc,) + e.shape[1:])
    out = inter[:fine_slabs]
    for ax, target in enumerate(fine_trailing, start=1):
        out = _refine_axis(out, ax, int(target))
    return out


# ---------------------------------------------------------------------------
# The sharded solver
# ---------------------------------------------------------------------------


class ShardedGMGSolver:
    """Block-slab-sharded GMG V-cycle solver over a 1D ``("x",)`` or 2D
    ``("dcn", "x")`` device mesh, for 2D and 3D Poisson problems.

    ``num_sharded_levels`` levels run distributed with ppermute halo
    exchange; deeper levels are gathered and run replicated.  Requires the
    leading extent divisible by ``2^(num_sharded - 1) * n_shards``.
    """

    def __init__(
        self,
        shape: Sequence[int],
        mesh: Mesh,
        length: float = 10.0,
        alpha: float = 10.0,
        num_levels: int = 4,
        nu1: int = 2,
        nu2: int = 2,
        coarse_sweeps: int = 100,
        tol: float = 1e-6,
        maxit: int = 100,
        min_rows_per_shard: int = 8,
        use_grouped: bool | str = False,
    ):
        if len(shape) not in (2, 3):
            raise ValueError("sharded solver supports 2D and 3D grids")
        # Wide-halo grouped sweeps (one exchange per group, fused residual/
        # restrict): 28 vs 84 collective-permutes per V(2,2) cycle, at the
        # price of redundant compute on the extended blocks.  False = the
        # per-color schedule.  "measure" A/B-times one full cycle per
        # schedule ON THE ACTUAL MESH at construction and picks the faster;
        # the decision (and both timings) is recorded in
        # ``self.schedule_decision``.
        if use_grouped not in (True, False, "measure"):
            raise ValueError(f"use_grouped must be True, False or "
                             f"'measure', not {use_grouped!r}")
        self._measure_schedule_requested = use_grouped == "measure"
        self.use_grouped = use_grouped is True
        self.schedule_decision = {
            "mode": "fixed",
            "chosen": "grouped" if self.use_grouped else "per_color",
        }
        self.mesh = mesh
        self._axes = row_axes(mesh)
        self.p = int(math.prod(mesh.shape[a] for a in self._axes))
        self.levels = build_hierarchy(shape, length, num_levels)
        self.alpha = float(alpha)
        self.nu1, self.nu2 = nu1, nu2
        self.coarse_sweeps = coarse_sweeps
        self.tol, self.maxit = float(tol), int(maxit)

        # How many levels can stay sharded: a sharded level restricts R ->
        # R/2 slabs locally, so it needs n divisible by 2*P (even local slab
        # count) and enough slabs per shard to be worth distributing.
        ls = 0
        for lev in self.levels[:-1]:
            n = lev.shape[0]
            if n % (2 * self.p) == 0 and n // self.p >= min_rows_per_shard:
                ls += 1
            else:
                break
        if ls == 0:
            raise ValueError(
                f"leading extent {shape[0]} not shardable over {self.p} "
                f"shards (need divisibility and >= {min_rows_per_shard} "
                "slabs/shard)"
            )
        self.num_sharded = min(ls, len(self.levels))
        self.smoother = make_smoother("gs")
        trailing = (None,) * (len(shape) - 1)
        self.spec = P(self._axes, *trailing)
        self.sharding = NamedSharding(mesh, self.spec)
        self._jit_solve = jax.jit(
            jax.shard_map(
                self._solve_local,
                mesh=mesh,
                in_specs=(self.spec, self.spec),
                out_specs=(self.spec, P(), P()),
            )
        )
        self._jit_step = jax.jit(
            jax.shard_map(
                lambda u, b: self._v_local(u, b, 0),
                mesh=mesh,
                in_specs=(self.spec, self.spec),
                out_specs=self.spec,
            )
        )
        if self._measure_schedule_requested:
            self._measure_schedule()

    def _measure_schedule(self, chain: int = 8, reps: int = 3) -> None:
        """A/B-time one ``chain``-cycle program per sweep schedule on the
        actual mesh and set ``use_grouped`` from the measurement (recorded
        in ``schedule_decision``).  Costs two extra compiles at
        construction — use ``use_grouped="measure"`` to opt in."""
        import time

        b = jax.device_put(
            jnp.ones(self.levels[0].shape, jnp.float32), self.sharding)
        u0 = jnp.zeros_like(b)
        times = {}
        prev = self.use_grouped
        try:
            for name, g in (("grouped", True), ("per_color", False)):
                self.use_grouped = g

                def local(u, bb):
                    return lax.fori_loop(
                        0, chain, lambda _, uu: self._v_local(uu, bb, 0), u)

                f = jax.jit(jax.shard_map(
                    local, mesh=self.mesh,
                    in_specs=(self.spec, self.spec), out_specs=self.spec))
                jax.block_until_ready(f(u0, b))  # compile
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    jax.block_until_ready(f(u0, b))
                    best = min(best, time.perf_counter() - t0)
                times[name] = best / chain
        finally:
            self.use_grouped = prev
        self.use_grouped = times["grouped"] <= times["per_color"]
        self.schedule_decision = {
            "mode": "measured",
            "chosen": "grouped" if self.use_grouped else "per_color",
            "grouped_cycle_s": times["grouped"],
            "per_color_cycle_s": times["per_color"],
        }

    # -- sharded V-cycle -----------------------------------------------------

    def _downleg(self, u, b, gshape, h, b_halos=None):
        """Pre-smooth + residual + restrict with the fewest collectives the
        shard shape allows."""
        a, axes = self.alpha, self._axes
        if self.use_grouped and group_supported(u.shape[0], self.nu1,
                                                extra=2):
            return downleg_group_local(u, b, a, h, gshape, axes, self.nu1,
                                       b_halos=b_halos)
        u = rbgs_local(u, b, a, h, gshape, axes, self.nu1)
        r = residual_local(u, b, a, h, gshape, axes)
        return u, restrict_fw_local(r, gshape, axes)

    def _postsmooth(self, u, b, gshape, h, resnorm: bool = False,
                    b_halos=None):
        a, axes = self.alpha, self._axes
        if self.use_grouped and group_supported(
                u.shape[0], self.nu2, extra=1 if resnorm else 0):
            return postsmooth_group_local(u, b, a, h, gshape, axes,
                                          self.nu2, resnorm=resnorm,
                                          b_halos=b_halos)
        u = rbgs_local(u, b, a, h, gshape, axes, self.nu2)
        if not resnorm:
            return u
        r = residual_local(u, b, a, h, gshape, axes)
        return u, jnp.sum(r * r)

    def _shared_b_halos(self, u, b, resnorm: bool):
        """Exchange b's halos ONCE per level visit when both grouped legs
        will run (b is the level RHS — constant between the down-leg and
        the post-smoothing), at the widest width either requests."""
        if not self.use_grouped:
            return None
        R = u.shape[0]
        if not (group_supported(R, self.nu1, extra=2)
                and group_supported(R, self.nu2,
                                    extra=1 if resnorm else 0)):
            return None
        W = max(group_max_w(self.nu1, 2),
                group_max_w(self.nu2, 1 if resnorm else 0))
        if W > R:
            return None
        bt, bb = _halo_slabs(b, self._axes, W)
        return bt, bb, W

    def _v_local(self, u, b, level: int, resnorm: bool = False):
        lev = self.levels[level]
        gshape = lev.shape
        h = lev.h
        a = self.alpha
        axes = self._axes
        b_halos = self._shared_b_halos(u, b, resnorm)
        u, rc = self._downleg(u, b, gshape, h, b_halos=b_halos)
        nlev = self.levels[level + 1]
        if level + 1 < self.num_sharded:
            ec = self._v_local(jnp.zeros_like(rc), rc, level + 1)
        else:
            # gather the coarse residual, run the remaining levels replicated
            r_full = lax.all_gather(rc, axes, axis=0, tiled=True)
            e_full = replicated_v_cycle(
                jnp.zeros_like(r_full), r_full, self.levels[level + 1:],
                a, self.smoother, nu1=self.nu1, nu2=self.nu2,
                coarse_sweeps=self.coarse_sweeps,
            )
            rc_rows = nlev.shape[0] // self.p
            i = global_shard_index(axes)
            ec = lax.dynamic_slice_in_dim(e_full, i * rc_rows, rc_rows, axis=0)
        u = u + prolong_local(ec, u.shape[0], gshape[1:], axes)
        return self._postsmooth(u, b, gshape, h, resnorm=resnorm,
                                b_halos=b_halos)

    def _solve_local(self, u, b):
        lev0 = self.levels[0]
        gshape = lev0.shape
        a, h = self.alpha, lev0.h
        axes = self._axes
        b2 = norm2_psum(b, axes)

        def rel(u):
            r = residual_local(u, b, a, h, gshape, axes)
            return jnp.sqrt(norm2_psum(r, axes) / b2)

        hist = jnp.full((self.maxit + 1,), jnp.nan, dtype=b.dtype)
        hist = hist.at[0].set(rel(u))

        def cond(st):
            _, k, hist = st
            return (k < self.maxit) & (hist[k] > self.tol)

        def body(st):
            u, k, hist = st
            # the convergence residual comes fused out of the level-0
            # post-smoothing (no extra halo exchange per iteration on the
            # grouped path)
            u, rn2_local = self._v_local(u, b, 0, resnorm=True)
            rn = jnp.sqrt(lax.psum(rn2_local, axes) / b2)
            hist = hist.at[k + 1].set(rn)
            return u, k + 1, hist

        u, k, hist = lax.while_loop(cond, body, (u, jnp.int32(0), hist))
        return u, k, hist

    # -- public API ----------------------------------------------------------

    def solve(self, b: jax.Array, u0: jax.Array | None = None) -> SolveResult:
        b = jax.device_put(b, self.sharding)
        if u0 is None:
            u0 = jnp.zeros_like(b)
        u, k, hist = self._jit_solve(u0, b)
        k = int(k)
        return SolveResult(
            u=u, history=hist[: k + 1], iterations=k,
            converged=bool(hist[k] <= self.tol),
        )

    def step(self, u: jax.Array, b: jax.Array) -> jax.Array:
        """One sharded V-cycle (for benchmarking / the multi-chip dryrun)."""
        return self._jit_step(u, b)
