"""Sparse container/kernel tests against scipy oracles."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from multigrid_prj_tpu.ops.sparse import ELLMatrix, HostCSR, coo_spmv, rap


def random_sparse(n, m, density=0.1, seed=0):
    rng = np.random.default_rng(seed)
    S = sp.random(n, m, density=density, random_state=rng, format="csr")
    S.data = rng.standard_normal(S.data.size)
    return S


def to_host(S) -> HostCSR:
    S = S.tocsr()
    return HostCSR(
        indptr=S.indptr.astype(np.int64),
        indices=S.indices.astype(np.int64),
        data=S.data.astype(np.float64),
        shape=S.shape,
    )


def test_from_coo_sums_duplicates():
    rows = [0, 0, 1, 2, 0]
    cols = [1, 1, 2, 0, 1]
    vals = [1.0, 2.0, 3.0, 4.0, -3.0]
    A = HostCSR.from_coo(rows, cols, vals, (3, 3))
    # (0,1): 1+2-3 = 0 -> dropped entirely
    assert A.nnz == 2
    assert A.coeff(0, 1) == 0.0
    assert A.coeff(1, 2) == 3.0
    assert A.coeff(2, 0) == 4.0


def test_spmv_and_dense_roundtrip():
    S = random_sparse(40, 30, seed=1)
    A = to_host(S)
    x = np.random.default_rng(2).standard_normal(30)
    np.testing.assert_allclose(A.spmv(x), S @ x, rtol=1e-12)
    np.testing.assert_allclose(A.to_dense(), S.toarray(), rtol=1e-12)
    np.testing.assert_allclose(A.diagonal(), S.toarray().diagonal()[:30], rtol=1e-12)


def test_transpose_matches_scipy():
    S = random_sparse(25, 35, seed=3)
    A = to_host(S)
    np.testing.assert_allclose(A.transpose().to_dense(), S.T.toarray(), rtol=1e-12)


@pytest.mark.parametrize("seed", [4, 5])
def test_matmul_matches_scipy(seed):
    S1 = random_sparse(30, 40, density=0.15, seed=seed)
    S2 = random_sparse(40, 20, density=0.15, seed=seed + 10)
    C = to_host(S1).matmul(to_host(S2))
    np.testing.assert_allclose(C.to_dense(), (S1 @ S2).toarray(), rtol=1e-12, atol=1e-14)


def test_rap_matches_dense_triple_product():
    A = random_sparse(50, 50, density=0.1, seed=6)
    P = random_sparse(50, 12, density=0.3, seed=7)
    Ac = rap(to_host(P), to_host(A))
    want = P.T.toarray() @ A.toarray() @ P.toarray()
    np.testing.assert_allclose(Ac.to_dense(), want, rtol=1e-12, atol=1e-13)


def test_ell_spmv_matches_host():
    S = random_sparse(64, 64, density=0.12, seed=8)
    A = to_host(S)
    E = ELLMatrix.from_host_csr(A, dtype=jnp.float64)
    x = np.random.default_rng(9).standard_normal(64)
    y = np.asarray(E.spmv(jnp.asarray(x)))
    np.testing.assert_allclose(y, S @ x, rtol=1e-12)
    # round-trip back to CSR preserves the matrix
    np.testing.assert_allclose(E.to_host_csr().to_dense(), S.toarray(), rtol=1e-12)


def test_ell_padding_is_harmless():
    S = random_sparse(16, 16, density=0.2, seed=10)
    A = to_host(S)
    E = ELLMatrix.from_host_csr(A, k=int(A.row_lengths.max()) + 3, dtype=jnp.float64)
    x = np.random.default_rng(11).standard_normal(16)
    np.testing.assert_allclose(np.asarray(E.spmv(jnp.asarray(x))), S @ x, rtol=1e-12)


def test_coo_spmv_segment_sum():
    S = random_sparse(32, 32, density=0.15, seed=12).tocoo()
    x = np.random.default_rng(13).standard_normal(32)
    y = np.asarray(
        coo_spmv(
            jnp.asarray(S.row, dtype=jnp.int32),
            jnp.asarray(S.col, dtype=jnp.int32),
            jnp.asarray(S.data),
            jnp.asarray(x),
            32,
        )
    )
    np.testing.assert_allclose(y, S @ x, rtol=1e-12)


def test_spmm_matches_scipy():
    S = random_sparse(60, 40, seed=7)
    A = to_host(S)
    rng = np.random.default_rng(8)
    X = rng.standard_normal((40, 6))
    np.testing.assert_allclose(A.spmm(X), S @ X, rtol=1e-12, atol=1e-12)


def test_ell_spmm_matches_host():
    S = random_sparse(50, 50, seed=9)
    A = to_host(S)
    E = ELLMatrix.from_host_csr(A, dtype=jnp.float64)
    rng = np.random.default_rng(10)
    X = rng.standard_normal((50, 4))
    got = np.asarray(E.spmm(jnp.asarray(X)))
    np.testing.assert_allclose(got, A.spmm(X), rtol=1e-10, atol=1e-10)


def test_native_spgemm_matches_python_hierarchy():
    """Pin: the native Gustavson SpGEMM path must produce the
    same AMG hierarchy (level sizes, operator complexity, structure) as the
    pure-Python expansion path — values to the last ulp, structure exact."""
    import multigrid_prj_tpu.native as native
    from multigrid_prj_tpu.amg import AMGSolver
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    if not native.available():
        pytest.skip("native library not built")
    A = poisson_fd_csr(64)
    builds = {}
    sav = native.available
    try:
        for tag, avail in (("native", sav), ("python", lambda: False)):
            native.available = avail
            builds[tag] = AMGSolver(A, num_levels=4, reorder="none")
    finally:
        native.available = sav
    a, b = builds["native"], builds["python"]
    assert a.level_sizes == b.level_sizes
    assert abs(a.operator_complexity - b.operator_complexity) < 1e-12
    for Ma, Mb in zip(a.host_matrices, b.host_matrices):
        np.testing.assert_array_equal(Ma.indptr, Mb.indptr)
        np.testing.assert_array_equal(Ma.indices, Mb.indices)
        np.testing.assert_allclose(Ma.data, Mb.data, rtol=1e-13, atol=0)
