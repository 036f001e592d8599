"""Sharded AMG on the 8-virtual-CPU-device mesh: convergence equivalence
with the single-device solver and halo-contract invariants."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from multigrid_prj_tpu.amg import AMGSolver
from multigrid_prj_tpu.ops.sparse import HostCSR
from multigrid_prj_tpu.parallel.sharded_amg import (
    ShardedAMGSolver,
    build_sharded_ell,
    sharded_ell_apply,
)


def fd_poisson(n):
    N = n * n
    rows, cols, vals = [], [], []
    for i in range(n):
        for j in range(n):
            r = i * n + j
            rows.append(r); cols.append(r); vals.append(4.0)
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < n and 0 <= jj < n:
                    rows.append(r); cols.append(ii * n + jj); vals.append(-1.0)
    return HostCSR.from_coo(rows, cols, vals, (N, N))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices("cpu")[:8]), axis_names=("x",))


def test_sharded_ell_apply_matches_oracle(mesh):
    """The sharded banded apply equals the host SpMV for any banded matrix."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    A = fd_poisson(24)  # 576 rows, band 24
    perm = A.rcm_permutation()
    Ap = A.permute(perm)
    n_pad = 576  # divisible by 8
    m = build_sharded_ell(Ap, n_pad, n_pad, 8, jnp.float64)
    assert m is not None and 0 < m.halo <= m.in_rows
    rng = np.random.default_rng(0)
    x = rng.standard_normal(576)

    f = jax.jit(shard_map(
        lambda mm, xx: sharded_ell_apply(mm, xx),
        mesh=mesh,
        in_specs=(jax.tree.map(lambda a: P("x"), m,
                               is_leaf=lambda a: isinstance(a, jax.Array)),
                  P("x")),
        out_specs=P("x"),
    ))
    got = np.asarray(f(m, jnp.asarray(x)))
    np.testing.assert_allclose(got, Ap.spmv(x), rtol=1e-12, atol=1e-12)


def test_sharded_amg_converges_and_matches_single_device(mesh):
    A = fd_poisson(32)  # 1024 rows
    rng = np.random.default_rng(1)
    b = rng.standard_normal(A.shape[0])

    sharded = ShardedAMGSolver(
        A, mesh, num_levels=3, smoother="chebyshev", dtype=jnp.float64,
        tol=1e-10, maxit=60, min_rows_per_shard=32,
    )
    assert sharded.num_sharded >= 1
    x_s, it_s, rel_s = sharded.solve(b)
    assert rel_s <= 1e-10

    single = AMGSolver(A, num_levels=3, smoother="chebyshev",
                       dtype=jnp.float64, reorder="rcm")
    x_1, it_1, rel_1 = single.solve(b, tol=1e-10, maxit=60)
    # identical hierarchy and smoother => same iteration count (+-1 for the
    # padded rows' no-op arithmetic) and the same solution
    assert abs(it_s - it_1) <= 1
    np.testing.assert_allclose(np.asarray(x_s), np.asarray(x_1),
                               rtol=1e-8, atol=1e-9)
    want = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(x_s), want, rtol=1e-6, atol=1e-7)


def test_sharded_amg_jacobi_smoother(mesh):
    A = fd_poisson(24)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(A.shape[0])
    solver = ShardedAMGSolver(A, mesh, num_levels=3, smoother="jacobi",
                              nu1=2, nu2=2, dtype=jnp.float64, tol=1e-9,
                              maxit=100, min_rows_per_shard=16)
    x, it, rel = solver.solve(b)
    assert rel <= 1e-9
    want = np.linalg.solve(A.to_dense(), b)
    np.testing.assert_allclose(np.asarray(x), want, rtol=1e-5, atol=1e-6)


def test_sharded_amg_deterministic(mesh):
    A = fd_poisson(24)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    solver = ShardedAMGSolver(A, mesh, num_levels=2, dtype=jnp.float64,
                              tol=1e-8, maxit=30, min_rows_per_shard=16)
    x1, k1, _ = solver.solve(b)
    x2, k2, _ = solver.solve(b)
    assert k1 == k2
    np.testing.assert_array_equal(np.asarray(x1), np.asarray(x2))
