"""What the GPU bring-up decided, checked on the CPU: extended-precision
transforms that stay exact under FMA contraction, one platform-free policy
per choice, the compile-cache location, the bandwidth table, and every
``chip_smoke.py`` phase at a tiny size."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- error-free transforms ------------------------------------------------------

def _f32_spread(n, seed, lo=-20, hi=20):
    """f32 values with a wide spread of exponents and full mantissas."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 2.0 ** rng.integers(lo, hi, n)).astype(
        np.float32)


def test_split_mask_is_exact_with_short_halves():
    from multigrid_prj_tpu.ops.extended import split_mask

    a = _f32_spread(4096, 0)
    hi, lo = (np.asarray(v) for v in jax.jit(split_mask)(jnp.asarray(a)))
    np.testing.assert_array_equal(hi.astype(np.float64) + lo, a)
    # at most 12 significant bits in each half: exact after rounding the
    # mantissa to 12 bits
    for part in (hi, lo):
        m, _ = np.frexp(part.astype(np.float64))
        np.testing.assert_array_equal(np.round(m * 2.0 ** 12), m * 2.0 ** 12)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_two_prod_is_exact(seed):
    from multigrid_prj_tpu.ops.extended import two_prod

    a, b = _f32_spread(4096, seed), _f32_spread(4096, seed + 10)
    p, e = (np.asarray(v, np.float64)
            for v in jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b)))
    exact = a.astype(np.float64) * b.astype(np.float64)  # 48 bits: exact
    np.testing.assert_array_equal(p + e, exact)


@pytest.mark.parametrize("c", [6710886.4, 1638.4, 10.0 / 3.0])
def test_ff_from_div_matches_f64_quotient(c):
    """The pair is b / c with c taken in float64 — not the f32-rounded c."""
    from multigrid_prj_tpu.ops.extended import ff_from_div

    b = _f32_spread(2048, 4, -5, 5)
    hi, lo = jax.jit(lambda v: ff_from_div(v, c))(jnp.asarray(b))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    want = b.astype(np.float64) / c
    assert np.abs(got - want).max() <= 2.0 ** -44 * np.abs(want).max()


def _exact_stencil_residual(u_hi, u_lo, b, alpha, h, logical=None):
    """``b - A u`` in long double for the pair ``u = u_hi + u_lo``."""
    U = u_hi.astype(np.longdouble) + u_lo.astype(np.longdouble)
    B = b.astype(np.longdouble)
    c = np.longdouble(alpha) / (np.longdouble(h) * np.longdouble(h))
    logical = logical or U.shape
    core = tuple(slice(1, n - 1) for n in logical)
    R = B - U
    au = 2 * U.ndim * U[core]
    for ax in range(U.ndim):
        for d in (-1, 1):
            sl = list(core)
            sl[ax] = slice(core[ax].start + d, core[ax].stop + d)
            au = au - U[tuple(sl)]
    R[core] = B[core] - c * au
    return R.astype(np.float64)


@pytest.mark.parametrize("shape,logical", [((257, 257), None),
                                           ((40, 40, 40), None),
                                           ((128, 128), (97, 65))],
                         ids=["2d", "3d", "2d-pad"])
def test_ff_stencil_residual_matches_extended_exact(shape, logical):
    """The float-float residual of a smooth near-solution agrees with the
    exact residual to ~1e-13 of ||b|| — where plain f32 is off by ~1e-7
    times kappa."""
    from multigrid_prj_tpu.ops.extended import (
        ff_from_div,
        ff_poisson_residual,
    )

    lg = logical or shape
    alpha, h = 10.0, 10.0 / (lg[0] - 1)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape],
                        indexing="ij")
    u = np.exp(grids[0]) * np.cos(2 * grids[-1])
    u_hi = u.astype(np.float32)
    u_lo = (u - u_hi).astype(np.float32)
    # b = A u rounded to f32: the residual is pure cancellation
    b = (-_exact_stencil_residual(u_hi, u_lo, np.zeros(shape), alpha, h,
                                  logical)).astype(np.float32)
    c = alpha / (h * h)
    r = jax.jit(lambda a, bb, v: ff_poisson_residual(
        a, bb, *ff_from_div(v, c), v, alpha, h, logical))(
        jnp.asarray(u_hi), jnp.asarray(u_lo), jnp.asarray(b))
    want = _exact_stencil_residual(u_hi, u_lo, b, alpha, h, logical)
    err = np.linalg.norm(np.asarray(r, np.float64) - want)
    assert err <= 1e-12 * np.linalg.norm(b), err / np.linalg.norm(b)


@pytest.mark.parametrize("kind", ["fd", "random"])
def test_ff_ell_residual_matches_f64(kind):
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr
    from multigrid_prj_tpu.ops.sparse import HostCSR
    from multigrid_prj_tpu.ops.sparse_extended import (
        ELLPair,
        ell_residual_ff,
        ff_pair_from_f64,
    )

    rng = np.random.default_rng(20)
    if kind == "fd":
        A = poisson_fd_csr(30)
    else:
        n = 500
        A = HostCSR.from_coo(rng.integers(0, n, 3000),
                             rng.integers(0, n, 3000),
                             rng.standard_normal(3000), (n, n))
    x = rng.standard_normal(A.shape[0])
    b = A.spmv(x) + 1e-9 * rng.standard_normal(A.shape[0])
    xh, xl = ff_pair_from_f64(x)
    bh, bl = ff_pair_from_f64(b)
    r = np.asarray(jax.jit(ell_residual_ff)(ELLPair.from_host_csr(A), bh, bl,
                                            xh, xl), np.float64)
    want = b - A.spmv(x)  # ~1e-9 * ||b||: f32 alone could not see it
    assert np.linalg.norm(r - want) <= 1e-3 * np.linalg.norm(want)


# -- one policy per choice, no platform names -----------------------------------

def test_amg_auto_smoother_is_mcgs():
    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    s = AMGSolver(poisson_fd_csr(10), num_levels=2)
    assert s.smoother_name == "mcgs"
    assert s._perm is None  # no reordering unless asked for


def test_sharded_gmg_default_schedule_is_per_color():
    from multigrid_prj_tpu.parallel.distributed import make_mesh
    from multigrid_prj_tpu.parallel.sharded_gmg import ShardedGMGSolver

    s = ShardedGMGSolver((64, 64), make_mesh(2), num_levels=3)
    assert not s.use_grouped
    assert s.schedule_decision == {"mode": "fixed", "chosen": "per_color"}
    with pytest.raises(ValueError, match="use_grouped"):
        ShardedGMGSolver((64, 64), make_mesh(2), num_levels=3,
                         use_grouped="auto")


def _dot_precisions(jaxpr):
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            found.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found.extend(_dot_precisions(sub))
    return found


def _highest(p):
    return p is not None and all(
        x == jax.lax.Precision.HIGHEST for x in (p if isinstance(p, tuple)
                                                 else (p,)))


def test_gmg_coarse_solve_dot_is_highest_precision():
    from multigrid_prj_tpu.gmg import GMGSolver

    s = GMGSolver((33, 33), num_levels=3, cycle="v")
    assert s._coarse_inv is not None
    b = jnp.ones((33, 33), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda u, bb: s.step(u, bb))(b, b).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs and all(_highest(p) for p in precs), precs


def test_amg_coarse_solve_dot_is_highest_precision():
    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    s = AMGSolver(poisson_fd_csr(16), num_levels=3, dtype=jnp.float32)
    b = jnp.ones(256, jnp.float32)
    jaxpr = jax.make_jaxpr(
        lambda lv, cd, x, bb: s._vcycle_impl(lv, cd, x, bb))(
        *s._args(), b, b).jaxpr
    precs = _dot_precisions(jaxpr)
    assert precs and all(_highest(p) for p in precs), precs


def test_pcg_inner_products_are_highest_precision():
    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    s = AMGSolver(poisson_fd_csr(16), num_levels=3, dtype=jnp.float32)
    b = jnp.ones(256, jnp.float32)
    jaxpr = jax.make_jaxpr(s._pcg_impl)(
        *s._args(), b, b, jnp.float32(1e-6), jnp.int32(10)).jaxpr
    precs = _dot_precisions(jaxpr)
    assert len(precs) > 1 and all(_highest(p) for p in precs), precs


def test_cli_auto_precision_is_f64(tmp_path, monkeypatch):
    from multigrid_prj_tpu.cli import gmg_main
    from multigrid_prj_tpu.utils.io import load_vector

    monkeypatch.chdir(tmp_path)
    assert gmg_main.main(["-n", "17", "-ml", "3", "-test", "1"]) == 0
    assert jax.config.jax_enable_x64
    # 1e-11 is the f64 tolerance; an f32 run would have been capped at 1e-6
    assert load_vector("MGGS4.txt")[-1] <= 1e-11


# -- compile cache ---------------------------------------------------------------

_CACHE_PROBE = """
import jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu")
from multigrid_prj_tpu.utils.cache import enable_compile_cache
print(enable_compile_cache())
jax.jit(lambda x: jnp.sin(x) * 3.0 + {salt})(jnp.ones(7)).block_until_ready()
"""


def _probe(env, salt):
    out = subprocess.run([sys.executable, "-c",
                          _CACHE_PROBE.format(salt=salt)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.strip().splitlines()[-1]


def test_cache_lands_in_env_dir(tmp_path):
    env = {**os.environ, "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c"),
           "PYTHONPATH": REPO}
    assert _probe(env, 0.25) == str(tmp_path / "c")
    assert os.listdir(tmp_path / "c")  # the compiled entry is there


def test_cache_defaults_to_repo_dir():
    from multigrid_prj_tpu.utils.cache import REPO_CACHE

    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    assert _probe(env, 0.5) == REPO_CACHE == os.path.join(REPO, ".jax_cache")
    assert os.path.isdir(REPO_CACHE) and os.listdir(REPO_CACHE)


# -- bench.py's bandwidth table ----------------------------------------------------

def test_bandwidth_of_h100():
    import bench

    assert bench.device_bandwidth("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "Unknown Accelerator X", "NVIDIA A100-SXM4-80GB"])
def test_bandwidth_of_unknown_kind_raises(kind):
    import bench

    with pytest.raises(ValueError, match="no memory bandwidth"):
        bench.device_bandwidth(kind)


def test_bench_refuses_cpu(capsys):
    import bench

    assert bench.main(["--cells", "copy"]) == 2
    assert "needs a GPU" in capsys.readouterr().err


# -- chip_smoke.py at tiny sizes -------------------------------------------------

TINY_PHASES = {
    "gmg2d": dict(n=129, num_levels=4),
    "gmg3d": dict(n=17, num_levels=3),
    "gmg_cli": dict(n=65, ml=4),
    "amg_fd": dict(n_grid=32, num_levels=4, min_coarse=50),
    "amg_fem": dict(n=33, n_cli=17),
    "sharded1": dict(n=64, num_levels=3),
    "ops": dict(n2=65, n3=17, n_fd=16, n_copy=64),
    "multi_gmg": dict(n=64, num_levels=3),
    "multi_amg": dict(n_grid=32, num_levels=3, min_coarse=50),
}


@pytest.mark.parametrize("name", list(TINY_PHASES))
def test_chip_smoke_phase_tiny(name, tmp_path, monkeypatch):
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    rec = getattr(chip_smoke, "phase_" + name)(**TINY_PHASES[name])
    json.dumps(rec, default=float)
    assert rec["ok"], rec


def _drop_gmg_halos(monkeypatch):
    """Each shard mirrors its own edge slabs instead of receiving its
    neighbours': a decoupled problem the sharded solver still converges
    on, by its own residual."""
    from multigrid_prj_tpu.parallel import sharded_gmg

    monkeypatch.setattr(sharded_gmg, "_halo_slabs", lambda u, axes, w=1: (
        u[:w][::-1], u[-w:][::-1]))


def _drop_amg_halos(monkeypatch):
    from multigrid_prj_tpu.parallel import sharded_amg

    def exchange(m, x_local, axis):
        z = jnp.zeros_like(x_local[:m.halo])
        return jnp.concatenate([z, x_local, z]) if m.halo else x_local

    monkeypatch.setattr(sharded_amg, "_exchange_halos", exchange)


@pytest.mark.parametrize("name,drop", [("multi_gmg", _drop_gmg_halos),
                                       ("multi_amg", _drop_amg_halos)],
                         ids=["gmg", "amg"])
def test_chip_smoke_multi_phase_catches_dropped_exchange(name, drop,
                                                         monkeypatch):
    """With the halo exchange between shards dropped, each shard solves
    its own decoupled problem; the host residual of the whole system
    exposes it, whatever the solver's own residual says."""
    import chip_smoke

    drop(monkeypatch)
    rec = getattr(chip_smoke, "phase_" + name)(**TINY_PHASES[name],
                                               devices=2)
    assert not rec["ok"], rec
    assert rec["sharded_host_rel_residual"] > rec["tol"], rec
    if name == "multi_gmg":  # converged by its own residual all the same
        assert rec["sharded_iterations"] < chip_smoke.SHARDED_MAXIT, rec


@pytest.mark.parametrize("x64", [True, False], ids=["x64", "x32"])
def test_gmg_solve_refined_keeps_the_pair(x64):
    """With x64 the float-float pair comes back combined on the device in
    f64; without it the halves come back apart, and only their f64 sum
    holds the extended precision."""
    import chip_smoke
    from multigrid_prj_tpu.gmg import GMGSolver
    from multigrid_prj_tpu.models.poisson import assemble_rhs

    n, tol = 129, 1e-9
    with jax.enable_x64(x64):
        s = GMGSolver((n, n), num_levels=4, cycle="v", nu=2, pre_sweeps=2,
                      tol=tol, maxit=40)
        b = assemble_rhs(s.levels[0], 10.0, test=1, dtype=jnp.float32)
        out = s.solve_refined(b)
    assert isinstance(out.u, jax.Array) and out.converged
    if x64:
        assert out.u.dtype == jnp.float64 and out.u_lo is None
        u = np.asarray(out.u)
    else:
        assert out.u.dtype == out.u_lo.dtype == jnp.float32
        hi_only = chip_smoke.host_stencil_residual(out.u, b, 10.0, 10.0)
        assert hi_only > 100 * tol  # f32 alone floors far above tol
        u = np.asarray(out.u, np.float64) + np.asarray(out.u_lo, np.float64)
    assert chip_smoke.host_stencil_residual(u, b, 10.0, 10.0) <= 2 * tol


def test_chip_smoke_phase_lists_cover_every_phase():
    import chip_smoke

    names = [n for n, _ in chip_smoke.DEFAULT_PHASES + chip_smoke.MULTI_PHASES]
    assert sorted(names) == sorted(TINY_PHASES)


def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke

    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert out.out == ""  # no result line
    assert "needs a GPU" in out.err
