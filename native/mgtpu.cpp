// Native runtime components for multigrid_prj_tpu.
//
// The reference implements its whole solver in C++ (GeometricMultigrid/,
// AMG/).  In this design the *compute* path lives in XLA;
// what stays native are the host-side runtime pieces that feed it — the
// data loader (gmsh parser replacing AMG/src/FEM.cpp:3-316), sparse-format
// compression (replacing CSRMatrix::copy_from, AMG/src/CSRMatrix.cpp:3-22),
// and the setup-phase graph algorithms that are inherently sequential
// (greedy coloring for the multicolor smoother, reverse-Cuthill-McKee
// bandwidth reduction for ELL locality, and the reference's greedy
// coarsening loop, AMG/include/AMG.hpp:150-198).
//
// Exposed as a plain C ABI consumed through ctypes
// (multigrid_prj_tpu/native.py); every function has a pure-Python fallback
// so the framework works without the shared library.
//
// Build: make -C native        (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <numeric>
#include <string>
#include <vector>

extern "C" {

void mgtpu_free(void *p) { std::free(p); }

// ---------------------------------------------------------------------------
// COO -> CSR compression: sort by (row, col), sum duplicates, drop zeros.
// Returns nnz, or -1 on error.  Outputs are malloc'd; caller frees.
// ---------------------------------------------------------------------------
long long mgtpu_coo_to_csr(long long n_rows, long long nnz_in,
                           const long long *rows, const long long *cols,
                           const double *vals, long long **out_indptr,
                           long long **out_indices, double **out_data) {
  std::vector<long long> order(nnz_in);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](long long a, long long b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  std::vector<long long> r2, c2;
  std::vector<double> v2;
  r2.reserve(nnz_in);
  c2.reserve(nnz_in);
  v2.reserve(nnz_in);
  for (long long k = 0; k < nnz_in; ++k) {
    long long e = order[k];
    if (!r2.empty() && r2.back() == rows[e] && c2.back() == cols[e]) {
      v2.back() += vals[e];
    } else {
      r2.push_back(rows[e]);
      c2.push_back(cols[e]);
      v2.push_back(vals[e]);
    }
  }
  // drop exact zeros (the reference's copy_from skips them)
  long long m = 0;
  for (size_t k = 0; k < v2.size(); ++k) {
    if (v2[k] != 0.0) {
      r2[m] = r2[k];
      c2[m] = c2[k];
      v2[m] = v2[k];
      ++m;
    }
  }
  auto *indptr =
      static_cast<long long *>(std::malloc(sizeof(long long) * (n_rows + 1)));
  auto *indices = static_cast<long long *>(std::malloc(sizeof(long long) * m));
  auto *data = static_cast<double *>(std::malloc(sizeof(double) * m));
  if (!indptr || !indices || !data) return -1;
  std::memset(indptr, 0, sizeof(long long) * (n_rows + 1));
  for (long long k = 0; k < m; ++k) {
    if (r2[k] < 0 || r2[k] >= n_rows) return -1;
    indptr[r2[k] + 1]++;
    indices[k] = c2[k];
    data[k] = v2[k];
  }
  for (long long i = 0; i < n_rows; ++i) indptr[i + 1] += indptr[i];
  *out_indptr = indptr;
  *out_indices = indices;
  *out_data = data;
  return m;
}

// ---------------------------------------------------------------------------
// SpGEMM: C = A (n x k) * B (k x m), CSR in / CSR out, Gustavson with a
// dense accumulator.  Accumulation visits A's row entries and B's rows in
// CSR order — the same contribution ORDER as the Python expansion +
// stable-sort + reduceat path (ops/sparse.py HostCSR.matmul); sums agree
// to the last ulp (reduceat's pairwise segment summation can differ by
// 1 ulp), structure (indptr/indices) is identical.  Exact zeros are
// dropped (copy_from semantics); each output row is sorted by column.
// Returns nnz or -1.
// ---------------------------------------------------------------------------
long long mgtpu_spgemm(long long n, long long m_out,
                       const long long *a_indptr, const long long *a_indices,
                       const double *a_data, const long long *b_indptr,
                       const long long *b_indices, const double *b_data,
                       long long **out_indptr, long long **out_indices,
                       double **out_data) {
  std::vector<long long> next(m_out, -2);  // -2 = untouched this row
  std::vector<double> accum(m_out, 0.0);
  std::vector<long long> c_cols;
  std::vector<double> c_vals;
  auto *indptr =
      static_cast<long long *>(std::malloc(sizeof(long long) * (n + 1)));
  if (!indptr) return -1;
  indptr[0] = 0;
  std::vector<long long> touched;
  std::vector<std::pair<long long, double>> row_buf;
  for (long long i = 0; i < n; ++i) {
    touched.clear();
    for (long long ka = a_indptr[i]; ka < a_indptr[i + 1]; ++ka) {
      long long k = a_indices[ka];
      double a = a_data[ka];
      for (long long kb = b_indptr[k]; kb < b_indptr[k + 1]; ++kb) {
        long long j = b_indices[kb];
        if (j < 0 || j >= m_out) { std::free(indptr); return -1; }
        if (next[j] == -2) {
          next[j] = 1;
          accum[j] = a * b_data[kb];
          touched.push_back(j);
        } else {
          accum[j] += a * b_data[kb];
        }
      }
    }
    row_buf.clear();
    for (long long j : touched) {
      if (accum[j] != 0.0) row_buf.emplace_back(j, accum[j]);
      next[j] = -2;
    }
    std::sort(row_buf.begin(), row_buf.end());
    for (auto &cv : row_buf) {
      c_cols.push_back(cv.first);
      c_vals.push_back(cv.second);
    }
    indptr[i + 1] = (long long)c_cols.size();
  }
  long long nnz = (long long)c_cols.size();
  auto *indices =
      static_cast<long long *>(std::malloc(sizeof(long long) * nnz));
  auto *data = static_cast<double *>(std::malloc(sizeof(double) * nnz));
  if (!indices || !data) { std::free(indptr); return -1; }
  std::memcpy(indices, c_cols.data(), sizeof(long long) * nnz);
  std::memcpy(data, c_vals.data(), sizeof(double) * nnz);
  *out_indptr = indptr;
  *out_indices = indices;
  *out_data = data;
  return nnz;
}

// ---------------------------------------------------------------------------
// CSR transpose via counting sort: (n x m) -> (m x n), O(nnz), rows of the
// output sorted by construction.  Returns 0 or -1.
// ---------------------------------------------------------------------------
int mgtpu_csr_transpose(long long n, long long m, const long long *indptr,
                        const long long *indices, const double *data,
                        long long *out_indptr, long long *out_indices,
                        double *out_data) {
  long long nnz = indptr[n];
  std::memset(out_indptr, 0, sizeof(long long) * (m + 1));
  for (long long k = 0; k < nnz; ++k) {
    long long j = indices[k];
    if (j < 0 || j >= m) return -1;
    out_indptr[j + 1]++;
  }
  for (long long j = 0; j < m; ++j) out_indptr[j + 1] += out_indptr[j];
  std::vector<long long> pos(out_indptr, out_indptr + m);
  for (long long i = 0; i < n; ++i) {
    for (long long k = indptr[i]; k < indptr[i + 1]; ++k) {
      long long p = pos[indices[k]]++;
      out_indices[p] = i;
      out_data[p] = data[k];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy graph coloring over a CSR adjacency (diagonal ignored).
// Returns the number of colors, or -1 on error.
// ---------------------------------------------------------------------------
int mgtpu_greedy_coloring(long long n, const long long *indptr,
                          const long long *indices, int *colors) {
  std::fill(colors, colors + n, -1);
  std::vector<int> mark;  // mark[c] == i  <=>  color c used by a neighbor of i
  int n_colors = 0;
  for (long long i = 0; i < n; ++i) {
    for (long long k = indptr[i]; k < indptr[i + 1]; ++k) {
      long long j = indices[k];
      if (j == i || j < 0 || j >= n) continue;
      int cj = colors[j];
      if (cj >= 0) {
        if (cj >= (int)mark.size()) mark.resize(cj + 1, -1);
        mark[cj] = (int)i;
      }
    }
    int c = 0;
    while (c < (int)mark.size() && mark[c] == (int)i) ++c;
    colors[i] = c;
    n_colors = std::max(n_colors, c + 1);
  }
  return n_colors;
}

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee ordering.  perm[k] = old index of new position k.
// ---------------------------------------------------------------------------
int mgtpu_rcm(long long n, const long long *indptr, const long long *indices,
              long long *perm) {
  std::vector<long long> degree(n);
  for (long long i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
  std::vector<char> visited(n, 0);
  long long pos = 0;
  std::vector<long long> nbrs;
  for (;;) {
    // next start: unvisited node of minimum degree
    long long start = -1, best = -1;
    for (long long i = 0; i < n; ++i)
      if (!visited[i] && (start < 0 || degree[i] < best)) {
        start = i;
        best = degree[i];
      }
    if (start < 0) break;
    std::deque<long long> queue{start};
    visited[start] = 1;
    while (!queue.empty()) {
      long long u = queue.front();
      queue.pop_front();
      perm[pos++] = u;
      nbrs.clear();
      for (long long k = indptr[u]; k < indptr[u + 1]; ++k) {
        long long v = indices[k];
        if (v >= 0 && v < n && !visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      std::sort(nbrs.begin(), nbrs.end(), [&](long long a, long long b) {
        return degree[a] < degree[b];
      });
      for (long long v : nbrs) queue.push_back(v);
    }
  }
  std::reverse(perm, perm + n);  // the "reverse" in RCM
  return 0;
}

// ---------------------------------------------------------------------------
// Greedy C/F coarsening — the reference's sequential algorithm
// (AMG/include/AMG.hpp:150-198) on a precomputed strong-connection graph.
// labels[i] = 1 coarse, 0 fine.  seed_index selects the deterministic start.
// ---------------------------------------------------------------------------
int mgtpu_greedy_coarsen(long long n, const long long *s_ptr,
                         const long long *s_cols, long long seed_index,
                         signed char *labels) {
  std::vector<long long> counter(n);
  for (long long i = 0; i < n; ++i) counter[i] = s_ptr[i + 1] - s_ptr[i];
  std::vector<char> fine(n, 0);
  long long idx = seed_index % (n > 0 ? n : 1);
  while (idx >= 0 && counter[idx] > 0) {
    counter[idx] = 0;
    for (long long k = s_ptr[idx]; k < s_ptr[idx + 1]; ++k) {
      long long c = s_cols[k];
      if (counter[c] > 0) {
        fine[c] = 1;
        counter[c] = 0;
        for (long long k2 = s_ptr[c]; k2 < s_ptr[c + 1]; ++k2) {
          long long c2 = s_cols[k2];
          if (counter[c2] > 0) counter[c2] += 2;
        }
      }
    }
    idx = -1;
    for (long long i = 0; i < n; ++i)
      if (counter[i] > 0) idx = i;  // reference keeps the LAST nonzero
  }
  for (long long i = 0; i < n; ++i) labels[i] = fine[i] ? 0 : 1;
  return 0;
}

// ---------------------------------------------------------------------------
// gmsh 4.1 ASCII parser (the data loader).  Returns 0 on success.
// Outputs malloc'd: nodes (n*2 doubles), tris (m*3 int64), on_boundary (n).
// ---------------------------------------------------------------------------
int mgtpu_parse_msh(const char *path, double **out_nodes, long long *out_n,
                    long long **out_tris, long long *out_m,
                    unsigned char **out_bnd, char *err, long long errlen) {
  auto fail = [&](const char *msg) {
    std::snprintf(err, (size_t)errlen, "%s", msg);
    return 1;
  };
  FILE *fh = std::fopen(path, "rb");
  if (!fh) return fail("cannot open file");
  std::fseek(fh, 0, SEEK_END);
  long sz = std::ftell(fh);
  std::fseek(fh, 0, SEEK_SET);
  std::string buf(sz, '\0');
  if (std::fread(buf.data(), 1, sz, fh) != (size_t)sz) {
    std::fclose(fh);
    return fail("read error");
  }
  std::fclose(fh);

  const char *p = buf.c_str();
  auto find_block = [&](const char *tag) -> const char * {
    const char *q = std::strstr(p, tag);
    if (!q) return nullptr;
    q = std::strchr(q, '\n');
    return q ? q + 1 : nullptr;
  };
  auto next_ll = [](const char *&q) {
    char *end;
    long long v = std::strtoll(q, &end, 10);
    q = end;
    return v;
  };
  auto next_d = [](const char *&q) {
    char *end;
    double v = std::strtod(q, &end);
    q = end;
    return v;
  };

  const char *q = find_block("$MeshFormat");
  if (!q) return fail("missing $MeshFormat");
  double version = next_d(q);
  if (version < 4.0 || version >= 5.0) return fail("unsupported gmsh version");

  q = find_block("$Nodes");
  if (!q) return fail("missing $Nodes");
  long long nblocks = next_ll(q), nnodes = next_ll(q);
  long long min_tag = next_ll(q), max_tag = next_ll(q);
  std::vector<double> coords(2 * (max_tag + 1), 0.0);
  std::vector<char> seen(max_tag + 1, 0);
  for (long long b = 0; b < nblocks; ++b) {
    next_ll(q);  // dim
    next_ll(q);  // entity tag
    next_ll(q);  // parametric
    long long nb = next_ll(q);
    std::vector<long long> tags(nb);
    for (long long k = 0; k < nb; ++k) tags[k] = next_ll(q);
    for (long long k = 0; k < nb; ++k) {
      double x = next_d(q), y = next_d(q);
      next_d(q);  // z
      if (tags[k] < min_tag || tags[k] > max_tag) return fail("bad node tag");
      coords[2 * tags[k]] = x;
      coords[2 * tags[k] + 1] = y;
      seen[tags[k]] = 1;
    }
  }
  for (long long t = min_tag; t <= max_tag; ++t)
    if (!seen[t]) return fail("non-contiguous node tags unsupported");

  q = find_block("$Elements");
  if (!q) return fail("missing $Elements");
  nblocks = next_ll(q);
  next_ll(q);  // total elements
  next_ll(q);
  next_ll(q);
  std::vector<long long> tris;
  std::vector<unsigned char> bnd(nnodes, 0);
  for (long long b = 0; b < nblocks; ++b) {
    next_ll(q);  // dim
    next_ll(q);  // entity
    long long etype = next_ll(q);
    long long nb = next_ll(q);
    for (long long k = 0; k < nb; ++k) {
      next_ll(q);  // element tag
      if (etype == 1) {
        long long a = next_ll(q) - min_tag, c = next_ll(q) - min_tag;
        if (a >= 0 && a < nnodes) bnd[a] = 1;
        if (c >= 0 && c < nnodes) bnd[c] = 1;
      } else if (etype == 2) {
        long long t3[3] = {next_ll(q) - min_tag, next_ll(q) - min_tag,
                           next_ll(q) - min_tag};
        std::sort(t3, t3 + 3);  // the reference stores sorted vertex triples
        tris.insert(tris.end(), t3, t3 + 3);
      } else if (etype == 15) {
        long long a = next_ll(q) - min_tag;
        if (a >= 0 && a < nnodes) bnd[a] = 1;
      } else {
        // skip unknown element: consume rest of line
        while (*q && *q != '\n') ++q;
      }
    }
  }

  long long m = (long long)tris.size() / 3;
  auto *nodes = static_cast<double *>(std::malloc(sizeof(double) * 2 * nnodes));
  auto *tris_out =
      static_cast<long long *>(std::malloc(sizeof(long long) * 3 * m));
  auto *bnd_out = static_cast<unsigned char *>(std::malloc(nnodes));
  if (!nodes || !tris_out || !bnd_out) return fail("alloc failure");
  for (long long i = 0; i < nnodes; ++i) {
    nodes[2 * i] = coords[2 * (min_tag + i)];
    nodes[2 * i + 1] = coords[2 * (min_tag + i) + 1];
  }
  std::memcpy(tris_out, tris.data(), sizeof(long long) * 3 * m);
  std::memcpy(bnd_out, bnd.data(), nnodes);
  *out_nodes = nodes;
  *out_n = nnodes;
  *out_tris = tris_out;
  *out_m = m;
  *out_bnd = bnd_out;
  return 0;
}

}  // extern "C"
