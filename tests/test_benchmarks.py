"""Smoke tests for the benchmark harnesses (CPU, tiny sizes).

These keep the benchmark entry points importable and structurally correct;
the real numbers come from running them on the GPU.
"""

import json

import numpy as np


def test_amg_bench_fd_smoke():
    from benchmarks.amg_bench import bench_fd

    rec = bench_fd(48, tol=1e-6)
    assert rec["rows"] == 48 * 48
    assert rec["solve_f32_iters"] >= 1
    assert rec["solve_f32_rel"] <= 1e-6
    assert rec["solve_ff32_rel"] <= 1e-6
    assert rec["pcg_iters"] >= 1
    json.dumps(rec)  # JSON-serializable


def test_scale_sweep_record_shape():
    from benchmarks.scale_bench import sweep

    rec = sweep(rows_per_dev=64)
    assert [s["devices"] for s in rec["sweep"]] == [1, 2, 4, 8]
    assert all(s["cycle_s"] > 0 for s in rec["sweep"])
    assert 0 < rec["weak_scaling_efficiency"]
    json.dumps(rec)


def test_fd_csr_matches_dense_operator():
    """poisson_fd_csr is the standard interior-node 5-point Laplacian."""
    from multigrid_prj_tpu.models.poisson import poisson_fd_csr

    A = poisson_fd_csr(3)  # 9 interior nodes
    D = A.to_dense()
    assert D.shape == (9, 9)
    np.testing.assert_array_equal(np.diag(D), 4.0)
    assert D[0, 1] == -1.0 and D[0, 3] == -1.0 and D[0, 4] == 0.0
    np.testing.assert_array_equal(D, D.T)
    assert A.nnz == 9 + 2 * 12  # 4-neighborhood edges
