"""Sharded GMG on the 8-device virtual CPU mesh: the shard_map halo-exchange
solver must converge and agree with the single-device solver."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from multigrid_prj_tpu.gmg import GMGSolver
from multigrid_prj_tpu.models.poisson import assemble_rhs
from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

pytestmark = pytest.mark.multidevice

N = 128
LEN, ALPHA = 10.0, 10.0


def make_mesh(p):
    devs = jax.devices()
    if len(devs) < p:
        pytest.skip(f"need {p} devices, have {len(devs)}")
    return Mesh(np.array(devs[:p]), axis_names=("x",))


@pytest.fixture(scope="module")
def problem():
    solver = GMGSolver(shape=(N, N), length=LEN, alpha=ALPHA, num_levels=4,
                       cycle="v", nu=2, pre_sweeps=2, tol=1e-10)
    b = assemble_rhs(solver.levels[0], LEN, test=1, dtype=jnp.float64)
    return solver, b


@pytest.mark.parametrize("p", [2, 8])
def test_sharded_solve_matches_single_device(problem, p):
    single, b = problem
    mesh = make_mesh(p)
    sh = ShardedGMGSolver(
        shape=(N, N), mesh=mesh, length=LEN, alpha=ALPHA, num_levels=4,
        nu1=2, nu2=2, tol=1e-10, maxit=60,
    )
    assert sh.num_sharded >= 2
    out = sh.solve(b)
    assert out.converged, f"hist={np.asarray(out.history)[:8]}"
    ref = single.solve(b)
    du = np.abs(np.asarray(out.u) - np.asarray(ref.u)).max()
    scale = np.abs(np.asarray(ref.u)).max()
    assert du / scale < 1e-8, du / scale


def test_sharded_history_matches_replicated_math(problem):
    """Same V(2,2) cycle: sharded and single-device histories should track
    each other closely (identical smoothers, transfer, coarse solve)."""
    single, b = problem
    mesh = make_mesh(8)
    sh = ShardedGMGSolver(
        shape=(N, N), mesh=mesh, length=LEN, alpha=ALPHA, num_levels=4,
        nu1=2, nu2=2, tol=1e-10, maxit=60,
    )
    out = sh.solve(b)
    # single-device v-cycle with same parameters
    sref = GMGSolver(shape=(N, N), length=LEN, alpha=ALPHA, num_levels=4,
                     cycle="v", nu=2, pre_sweeps=2, tol=1e-10)
    ref = sref.solve(b)
    k = min(out.iterations, ref.iterations, 5)
    hs = np.asarray(out.history)[1: k + 1]
    hr = np.asarray(ref.history)[1: k + 1]
    np.testing.assert_allclose(hs, hr, rtol=0.3)


def test_unshardable_config_raises():
    mesh = make_mesh(8)
    with pytest.raises(ValueError, match="not shardable"):
        ShardedGMGSolver(shape=(100, 100), mesh=mesh, num_levels=3)


def test_one_sharded_cycle_matches_replicated_tight(problem):
    """One sharded V-cycle vs the replicated V-cycle, f64: the halo math
    must agree to roundoff (pins restrict/prolong/smoother edge handling)."""
    from multigrid_prj_tpu.gmg import v_cycle
    from multigrid_prj_tpu.ops.smoothers import make_smoother

    single, b = problem
    mesh = make_mesh(8)
    sh = ShardedGMGSolver(
        shape=(N, N), mesh=mesh, length=LEN, alpha=ALPHA, num_levels=4,
        nu1=2, nu2=2, coarse_sweeps=100,
    )
    u0 = jnp.zeros_like(b)
    got = np.asarray(sh.step(u0, b))
    want = np.asarray(jax.jit(
        lambda u, bb: v_cycle(u, bb, sh.levels, ALPHA, make_smoother("gs"),
                              nu1=2, nu2=2, coarse_sweeps=100)
    )(u0, b))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() < 1e-12 * scale


def test_sharded_3d_solve():
    """3D block-slab sharding (the 2D-only restriction is lifted)."""
    mesh = make_mesh(4)
    n = 32
    sh = ShardedGMGSolver(shape=(n, n, n), mesh=mesh, length=10.0,
                          alpha=10.0, num_levels=3, nu1=2, nu2=2,
                          tol=1e-8, maxit=40, min_rows_per_shard=4)
    assert sh.num_sharded >= 1
    from tests.test_gmg_3d import rhs_3d

    b = rhs_3d((n, n, n), 10.0)
    out = sh.solve(b)
    assert out.converged
    single = GMGSolver(shape=(n, n, n), length=10.0, alpha=10.0,
                       num_levels=3, cycle="v", nu=2, pre_sweeps=2, tol=1e-8)
    ref = single.solve(b)
    du = np.abs(np.asarray(out.u) - np.asarray(ref.u)).max()
    assert du / np.abs(np.asarray(ref.u)).max() < 1e-6


def test_sharded_two_axis_mesh(problem):
    """(dcn, x) 2-axis mesh: dcn-major slab layout, group-edge halos cross
    the dcn axis; results identical to the 1D mesh."""
    from multigrid_prj_tpu.parallel.distributed import make_mesh as mk

    single, b = problem
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("need 8 devices")
    mesh2 = mk(n_ici=4, n_dcn=2, devices=devs)
    assert mesh2.axis_names == ("dcn", "x")
    sh = ShardedGMGSolver(
        shape=(N, N), mesh=mesh2, length=LEN, alpha=ALPHA, num_levels=4,
        nu1=2, nu2=2, tol=1e-10, maxit=60,
    )
    assert sh.p == 8
    out = sh.solve(b)
    assert out.converged
    ref = single.solve(b)
    du = np.abs(np.asarray(out.u) - np.asarray(ref.u)).max()
    assert du / np.abs(np.asarray(ref.u)).max() < 1e-8


def test_sharded_3d_two_axis_mesh():
    from multigrid_prj_tpu.parallel.distributed import make_mesh as mk

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("need 8 devices")
    mesh2 = mk(n_ici=2, n_dcn=4, devices=devs)
    n = 32
    sh = ShardedGMGSolver(shape=(n, n, n), mesh=mesh2, num_levels=2,
                          nu1=2, nu2=2, tol=1e-8, maxit=40,
                          min_rows_per_shard=2)
    from tests.test_gmg_3d import rhs_3d

    b = rhs_3d((n, n, n), 10.0)
    out = sh.solve(b)
    assert out.converged


def test_overlap_schedule_bitwise_identical(problem):
    """overlap=True (interior/edge split) and overlap=False
    (exchange-then-compute) are the same arithmetic in a different
    schedule — results must be bitwise equal (benchmarks/overlap_ab.py
    relies on this)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multigrid_prj_tpu.parallel.sharded_gmg import AXIS, rbgs_local

    mesh = make_mesh(8)
    spec = P("x", None)
    _, b = problem
    b = jnp.asarray(b, jnp.float64)
    u = jnp.zeros_like(b)
    gshape = (N, N)
    h = LEN / (N - 1)

    outs = {}
    for ov in (True, False):
        f = jax.jit(jax.shard_map(
            lambda u, b, ov=ov: rbgs_local(u, b, ALPHA, h, gshape, (AXIS,),
                                           sweeps=3, overlap=ov),
            mesh=mesh, in_specs=(spec, spec), out_specs=spec))
        sharding = NamedSharding(mesh, spec)
        outs[ov] = np.asarray(f(jax.device_put(u, sharding),
                                jax.device_put(b, sharding)))
    assert np.array_equal(outs[True], outs[False])


@pytest.mark.parametrize("nu", [2, 5])
def test_grouped_downleg_bitwise_matches_per_color(nu):
    """Wide-halo grouped sweeps + fused residual/restrict (ONE exchange per
    group) vs the per-color-exchange composition: same float ops on every
    row that stays valid, so agreement is at the 1-2-ulp level (XLA may
    contract mul+add to FMA differently across the two program shapes —
    exact bitwise equality is not guaranteed between separately compiled
    programs)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multigrid_prj_tpu.parallel import sharded_gmg as sg

    p = 4
    mesh = make_mesh(p)
    n = 64
    gshape = (n, n)
    h = LEN / (n - 1)
    rng = np.random.default_rng(1)
    spec = P("x", None)
    sh = NamedSharding(mesh, spec)
    u = jax.device_put(jnp.asarray(
        rng.standard_normal(gshape), jnp.float32), sh)
    b = jax.device_put(jnp.asarray(
        rng.standard_normal(gshape), jnp.float32), sh)

    def grouped(u, b):
        return sg.downleg_group_local(u, b, ALPHA, h, gshape, ("x",), nu)

    def composed(u, b):
        u2 = sg.rbgs_local(u, b, ALPHA, h, gshape, ("x",), nu,
                           overlap=False)
        r = sg.residual_local(u2, b, ALPHA, h, gshape, ("x",))
        return u2, sg.restrict_fw_local(r, gshape, ("x",))

    with mesh:
        outs = {}
        for name, fn in (("grouped", grouped), ("composed", composed)):
            f = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec),
                                      out_specs=(spec, spec)))
            u2, rc = f(u, b)
            outs[name] = (np.asarray(u2), np.asarray(rc))
    np.testing.assert_allclose(outs["grouped"][0], outs["composed"][0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(outs["grouped"][1], outs["composed"][1],
                               rtol=1e-6, atol=1e-6)


def test_postsmooth_resnorm_matches_explicit_residual():
    """The fused post-smoothing residual norm equals the explicit
    residual_local norm (to ulp-level reassociation)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multigrid_prj_tpu.parallel import sharded_gmg as sg

    p = 4
    mesh = make_mesh(p)
    n = 64
    gshape = (n, n)
    h = LEN / (n - 1)
    rng = np.random.default_rng(2)
    spec = P("x", None)
    shd = NamedSharding(mesh, spec)
    u = jax.device_put(jnp.asarray(
        rng.standard_normal(gshape), jnp.float32), shd)
    b = jax.device_put(jnp.asarray(
        rng.standard_normal(gshape), jnp.float32), shd)

    def fused(u, b):
        u2, rn2 = sg.postsmooth_group_local(u, b, ALPHA, h, gshape, ("x",),
                                            2, resnorm=True)
        return u2, jax.lax.psum(rn2, "x")

    def explicit(u, b):
        u2 = sg.rbgs_local(u, b, ALPHA, h, gshape, ("x",), 2, overlap=False)
        r = sg.residual_local(u2, b, ALPHA, h, gshape, ("x",))
        return u2, sg.norm2_psum(r, ("x",))

    with mesh:
        res = {}
        for name, fn in (("fused", fused), ("explicit", explicit)):
            f = jax.jit(jax.shard_map(
                fn, mesh=mesh, in_specs=(spec, spec),
                out_specs=(spec, P())))
            u2, rn2 = f(u, b)
            res[name] = (np.asarray(u2), float(rn2))
    np.testing.assert_allclose(res["fused"][0], res["explicit"][0],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res["fused"][1], res["explicit"][1],
                               rtol=1e-5)


def test_grouped_permute_count_pinned():
    """The grouped schedule's collective budget is a designed quantity:
    shared per-level-visit b-halo exchange brings a
    V(2,2) cycle on 4 sharded levels to 28 collective-permutes (was 36;
    per-color measures 84).  Count from the lowered StableHLO so a schedule
    regression cannot land silently."""
    import re

    mesh = make_mesh(4)
    p = 4
    counts = {}
    for grouped in (True, False):
        s = ShardedGMGSolver(shape=(64 * p, 128), mesh=mesh, num_levels=3,
                             nu1=2, nu2=2, maxit=2, tol=0.0,
                             use_grouped=grouped)
        b = jnp.ones(s.levels[0].shape, jnp.float32)
        bs = jax.device_put(b, s.sharding)
        u0 = jax.device_put(jnp.zeros_like(b), s.sharding)
        txt = s._jit_step.lower(u0, bs).as_text()
        counts[grouped] = (
            len(re.findall(r"stablehlo\.collective_permute\b", txt)),
            s.num_sharded)
    n_g, L = counts[True]
    n_p, _ = counts[False]
    assert n_g == 7 * L, (n_g, L)   # 28 at 4 levels
    assert n_p == 21 * L, (n_p, L)  # 84 at 4 levels


def test_measured_schedule_decision_recorded():
    """use_grouped="measure" A/B-times both schedules on the actual mesh and
    records the decision; the chosen schedule must solve correctly."""
    mesh = make_mesh(4)
    s = ShardedGMGSolver(shape=(32 * 4, 64),
                         mesh=mesh, num_levels=2, nu1=2, nu2=2,
                         tol=1e-3, maxit=50, use_grouped="measure")
    d = s.schedule_decision
    assert d["mode"] == "measured"
    assert d["chosen"] in ("grouped", "per_color")
    assert d["grouped_cycle_s"] > 0 and d["per_color_cycle_s"] > 0
    b = jnp.ones(s.levels[0].shape, jnp.float32)
    out = s.solve(b)
    assert out.converged
