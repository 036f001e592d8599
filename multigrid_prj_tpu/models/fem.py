"""P1 finite-element front-end: gmsh import, assembly, Dirichlet lifting,
VTU export.

Capability parity with the reference's FEM layer (``AMG/``):

* **gmsh 4.1 ASCII import** (``AMG/src/FEM.cpp:3-316``): ``$Nodes`` /
  ``$Elements`` blocks; 1D (type 1) elements mark boundary nodes
  (``FEM.cpp:143-151``); 2D (type 2) elements are the triangles
  (``FEM.cpp:153-183``).  Higher-order dof generation (``FEM.cpp:185-270``)
  is not reproduced: the reference's Quadratic/ThirdOrder elements have no
  basis functions and cannot assemble (SURVEY.md §7.5), so P1 is the whole
  working surface.
* **Separate boundary/interior numbering** (``set_index``,
  ``FEM.cpp:287-303``): interior nodes are numbered 0..n_int-1 in node
  order; the assembled system contains interior dofs only.
* **P1 assembly** (``AMG/src/main.cpp:34-88``): vertex quadrature
  (points = vertices, weights = area/3, ``FEM.hpp:237-239``), constant
  gradients per element, ``A[i,j] += alpha(q) (grad_i . grad_j) w_q``;
  ``rhs[i] += f(x_i, y_i) phi_i(q) w_q`` — note the reference evaluates the
  forcing at the *dof* location, reproduced here.
* **Dirichlet lifting** (``main.cpp:89-116``):
  ``rhs[i] -= g(x_j, y_j) alpha(q) (grad_i . grad_j) w_q`` for boundary
  ``j``.
* **Problem definition** (``AMG/src/Utilities.cpp:3-27``):
  ``g = sin(5 r)``, ``f = -5 (cos(5r)/r - 5 sin(5r))``, ``alpha = 1``.
* **VTU export** (``FEM.cpp:318-412``): XML ``UnstructuredGrid`` with the
  point scalar ``u`` — boundary nodes get ``g``, interior get the solution.

Design: assembly is fully vectorised over elements (the
reference's per-element scatter loop becomes batched geometry + one
duplicate-summing COO->CSR compression); the assembled operator then ships
to device as ELL for the AMG solve phase.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

from multigrid_prj_tpu.ops.sparse import HostCSR


# -- reference problem functions (AMG/src/Utilities.cpp:3-27) ----------------


def default_boundary_function(x, y):
    return np.sin(5.0 * np.sqrt(x * x + y * y))


def default_forcing_term(x, y):
    r = np.sqrt(x * x + y * y)
    r_safe = np.where(r == 0.0, 1.0, r)
    val = -5.0 * (np.cos(5.0 * r) / r_safe - 5.0 * np.sin(5.0 * r))
    return np.where(r == 0.0, 0.0, val)


def default_alpha(x, y):
    return np.ones_like(np.asarray(x, dtype=np.float64))


# -- mesh ---------------------------------------------------------------------


@dataclasses.dataclass
class TriangularMesh:
    """P1 triangular mesh with the reference's boundary/interior split."""

    nodes: np.ndarray  # (N, 2)
    triangles: np.ndarray  # (M, 3) node ids, each row sorted ascending
    on_boundary: np.ndarray  # (N,) bool

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elements(self) -> int:
        return self.triangles.shape[0]

    @property
    def n_boundary_nodes(self) -> int:
        return int(self.on_boundary.sum())

    @property
    def set_index(self) -> np.ndarray:
        """Per-node index in its class (interior / boundary), node order —
        the reference's ``set_index`` numbering (``FEM.cpp:287-303``)."""
        idx = np.zeros(self.n_nodes, dtype=np.int64)
        idx[~self.on_boundary] = np.arange((~self.on_boundary).sum())
        idx[self.on_boundary] = np.arange(self.on_boundary.sum())
        return idx


def parse_msh(path: str, use_native: bool = True) -> TriangularMesh:
    """Parse a gmsh 4.1 ASCII file (``$Nodes``/``$Elements``; element type 1
    = boundary line, type 2 = triangle).  Mirrors ``import_from_msh``
    (``AMG/src/FEM.cpp:3-316``) without its fixed-size parsing loops.

    Uses the native C++ loader (``native/mgtpu.cpp``) when built; this
    Python implementation is the behavior-identical fallback."""
    if use_native:
        from multigrid_prj_tpu import native

        if native.available():
            nodes, tris, bnd = native.parse_msh(path)
            return TriangularMesh(nodes=nodes, triangles=tris, on_boundary=bnd)
    with open(path) as fh:
        lines = fh.read().split("\n")
    i = 0

    def seek(tag):
        nonlocal i
        while i < len(lines) and lines[i].strip() != tag:
            i += 1
        if i == len(lines):
            raise ValueError(f"{path}: missing {tag} block")
        i += 1

    seek("$MeshFormat")
    version = lines[i].split()[0]
    if not version.startswith("4"):
        raise ValueError(f"{path}: unsupported gmsh version {version} (need 4.x)")

    seek("$Nodes")
    num_blocks, num_nodes, min_tag, max_tag = (int(t) for t in lines[i].split())
    i += 1
    coords = np.zeros((max_tag + 1, 2))
    seen = np.zeros(max_tag + 1, dtype=bool)
    for _ in range(num_blocks):
        _dim, _etag, _param, n_in_block = (int(t) for t in lines[i].split())
        i += 1
        tags = [int(lines[i + k]) for k in range(n_in_block)]
        i += n_in_block
        for k in range(n_in_block):
            parts = lines[i + k].split()
            coords[tags[k]] = (float(parts[0]), float(parts[1]))
            seen[tags[k]] = True
        i += n_in_block

    seek("$Elements")
    num_blocks, _num_elems, _emin, _emax = (int(t) for t in lines[i].split())
    i += 1
    boundary_tags: list[int] = []
    tri_rows: list[list[int]] = []
    for _ in range(num_blocks):
        _dim, _etag, etype, n_in_block = (int(t) for t in lines[i].split())
        i += 1
        for k in range(n_in_block):
            parts = [int(t) for t in lines[i + k].split()]
            if etype == 1:  # 2-node line: boundary marker
                boundary_tags.extend(parts[1:3])
            elif etype == 2:  # 3-node triangle
                tri_rows.append(sorted(parts[1:4]))  # sorted like FEM.cpp:153-183
            elif etype == 15:  # point element: its node is on the boundary
                boundary_tags.append(parts[1])
        i += n_in_block

    if not seen[min_tag: max_tag + 1].all():
        raise ValueError(f"{path}: non-contiguous node tags unsupported")

    # re-index tags -> 0-based node ids
    nodes = coords[min_tag: max_tag + 1]
    on_boundary = np.zeros(num_nodes, dtype=bool)
    on_boundary[np.asarray(boundary_tags, dtype=np.int64) - min_tag] = True
    tris = np.asarray(tri_rows, dtype=np.int64) - min_tag
    return TriangularMesh(nodes=nodes, triangles=tris, on_boundary=on_boundary)


def structured_unit_square_mesh(n: int) -> TriangularMesh:
    """n x n node structured triangulation of the unit square (test utility —
    gives the framework a mesh source independent of gmsh files)."""
    xs = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(xs, xs, indexing="xy")
    nodes = np.stack([X.ravel(), Y.ravel()], axis=1)
    # per cell (a = lower-left node): triangles (a, a+1, a+n) and
    # (a+1, a+n, a+n+1), vertex ids ascending
    a = (np.arange(n - 1)[:, None] * n + np.arange(n - 1)[None, :]).ravel()
    tris = np.stack([np.stack([a, a + 1, a + n], axis=1),
                     np.stack([a + 1, a + n, a + n + 1], axis=1)],
                    axis=1).reshape(-1, 3)
    on_b = (
        (nodes[:, 0] == 0) | (nodes[:, 0] == 1)
        | (nodes[:, 1] == 0) | (nodes[:, 1] == 1)
    )
    return TriangularMesh(
        nodes=nodes, triangles=np.asarray(tris, dtype=np.int64), on_boundary=on_b
    )


# -- assembly -----------------------------------------------------------------


def _p1_geometry(mesh: TriangularMesh):
    """Vectorised element geometry: areas (M,), basis gradients (M, 3, 2)."""
    p = mesh.nodes[mesh.triangles]  # (M, 3, 2)
    x, y = p[..., 0], p[..., 1]
    signed_area = 0.5 * (
        (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
        - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    )
    inv2A = 1.0 / (2.0 * signed_area)
    grads = np.empty((mesh.n_elements, 3, 2))
    grads[:, 0, 0] = (y[:, 1] - y[:, 2]) * inv2A
    grads[:, 0, 1] = (x[:, 2] - x[:, 1]) * inv2A
    grads[:, 1, 0] = (y[:, 2] - y[:, 0]) * inv2A
    grads[:, 1, 1] = (x[:, 0] - x[:, 2]) * inv2A
    grads[:, 2, 0] = (y[:, 0] - y[:, 1]) * inv2A
    grads[:, 2, 1] = (x[:, 1] - x[:, 0]) * inv2A
    return np.abs(signed_area), grads


def assemble_p1(
    mesh: TriangularMesh,
    f: Callable = default_forcing_term,
    g: Callable = default_boundary_function,
    alpha: Callable = default_alpha,
) -> Tuple[HostCSR, np.ndarray]:
    """Assemble the interior-dof stiffness matrix and lifted RHS.

    Returns ``(A, rhs)`` with ``A`` of size n_interior x n_interior —
    exactly the system the reference hands to ``AMG`` (``main.cpp:126``).
    """
    areas, grads = _p1_geometry(mesh)
    p = mesh.nodes[mesh.triangles]  # (M, 3, 2)
    # vertex quadrature: sum_q alpha(q) w_q with w_q = area / 3
    alpha_q = alpha(p[..., 0], p[..., 1])  # (M, 3)
    alpha_int = (areas / 3.0) * np.sum(np.broadcast_to(alpha_q, p[..., 0].shape), axis=1)
    # local stiffness K[e, i, j] = (grad_i . grad_j) * integral(alpha)
    K = np.einsum("eid,ejd->eij", grads, grads) * alpha_int[:, None, None]

    set_index = mesh.set_index
    interior = ~mesh.on_boundary
    tri_interior = interior[mesh.triangles]  # (M, 3)
    tri_sidx = set_index[mesh.triangles]  # (M, 3) class-local ids

    ii = np.broadcast_to(tri_sidx[:, :, None], K.shape)
    jj = np.broadcast_to(tri_sidx[:, None, :], K.shape)
    mask_ii = np.broadcast_to(tri_interior[:, :, None], K.shape)
    mask_jj = np.broadcast_to(tri_interior[:, None, :], K.shape)

    n_int = int(interior.sum())
    both = mask_ii & mask_jj
    A = HostCSR.from_coo(ii[both], jj[both], K[both], (n_int, n_int))

    # rhs: f evaluated at the dof location (main.cpp:77-88), phi_i(q_j) = delta
    rhs = np.zeros(n_int)
    fvals = f(p[..., 0], p[..., 1]) * (areas[:, None] / 3.0)  # (M, 3)
    sel = tri_interior
    np.add.at(rhs, tri_sidx[sel], fvals[sel])

    # Dirichlet lifting (main.cpp:89-116): i interior, j boundary
    lift = mask_ii & ~mask_jj
    if lift.any():
        gvals = g(p[..., 0], p[..., 1])  # (M, 3) value of g at vertex j
        gj = np.broadcast_to(gvals[:, None, :], K.shape)
        np.subtract.at(rhs, ii[lift], (gj * K)[lift])
    return A, rhs


def solution_on_mesh(mesh: TriangularMesh, sol_interior: np.ndarray,
                     g: Callable = default_boundary_function) -> np.ndarray:
    """Full nodal field: boundary nodes get ``g``, interior get the solution
    (the VTU writer's rule, ``FEM.cpp:318-412``)."""
    u = np.zeros(mesh.n_nodes)
    u[~mesh.on_boundary] = np.asarray(sol_interior)
    bx, by = mesh.nodes[mesh.on_boundary, 0], mesh.nodes[mesh.on_boundary, 1]
    u[mesh.on_boundary] = g(bx, by)
    return u


def _write_vtu(path: str, points: np.ndarray, conn: np.ndarray,
               cell_type: int, u: np.ndarray) -> None:
    """Shared XML ``UnstructuredGrid`` writer (``FEM.cpp:318-412``): points,
    cell connectivity/offsets/types, one point scalar ``u``.  ``conn`` is
    ``(n_cells, dofs_per_cell)``; ``cell_type`` is the VTK cell type id
    (5 = linear triangle, 22 = quadratic triangle)."""
    n, m = points.shape[0], conn.shape[0]
    per = conn.shape[1] if m else 0
    with open(path, "w") as fh:
        fh.write('<?xml version="1.0"?>\n')
        fh.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                 'byte_order="LittleEndian">\n')
        fh.write("  <UnstructuredGrid>\n")
        fh.write(f'    <Piece NumberOfPoints="{n}" NumberOfCells="{m}">\n')
        fh.write("      <Points>\n")
        fh.write('        <DataArray type="Float64" NumberOfComponents="3" '
                 'format="ascii">\n')
        for x, y in points:
            fh.write(f"          {x} {y} 0\n")
        fh.write("        </DataArray>\n      </Points>\n")
        fh.write("      <Cells>\n")
        fh.write('        <DataArray type="Int32" Name="connectivity" '
                 'format="ascii">\n')
        for row in conn:
            fh.write("          " + " ".join(str(v) for v in row) + "\n")
        fh.write("        </DataArray>\n")
        fh.write('        <DataArray type="Int32" Name="offsets" format="ascii">\n')
        for k in range(1, m + 1):
            fh.write(f"          {per * k}\n")
        fh.write("        </DataArray>\n")
        fh.write('        <DataArray type="UInt8" Name="types" format="ascii">\n')
        for _ in range(m):
            fh.write(f"          {cell_type}\n")
        fh.write("        </DataArray>\n      </Cells>\n")
        fh.write('      <PointData Scalars="u">\n')
        fh.write('        <DataArray type="Float64" Name="u" format="ascii">\n')
        for v in u:
            fh.write(f"          {v}\n")
        fh.write("        </DataArray>\n      </PointData>\n")
        fh.write("    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n")


def export_vtu(path: str, mesh: TriangularMesh, sol_interior: np.ndarray,
               g: Callable = default_boundary_function) -> None:
    """VTU export of a P1 solution (cell type 5) — ``FEM.cpp:318-412``."""
    u = solution_on_mesh(mesh, sol_interior, g)
    _write_vtu(path, mesh.nodes, mesh.triangles, 5, u)


# -- P2 (quadratic) elements ---------------------------------------------------
#
# The reference declares ``QuadraticFE`` but never implements its basis
# functions or gradients — higher-order assembly is impossible there
# (``AMG/include/FEM.hpp:261-327``, SURVEY.md §7.5).  This completes the
# capability: P2 Lagrange elements with deduplicated edge-midpoint dofs
# (the vectorised analog of the reference's ``visited_pairs`` edge-dof
# generation, ``AMG/src/FEM.cpp:185-270``), midpoint-rule assembly (exact
# for the degree-2 integrands of constant-coefficient P2 stiffness and
# load), Dirichlet lifting, and quadratic-triangle VTU export.


@dataclasses.dataclass
class P2Mesh:
    """P2 dof layout over a :class:`TriangularMesh`: vertex dofs first
    (mesh node order), then one dof per unique edge (midpoint)."""

    base: TriangularMesh
    dof_coords: np.ndarray  # (n_dofs, 2)
    tri_dofs: np.ndarray  # (M, 6): v0 v1 v2, e01 e12 e02 (local edges)
    dof_on_boundary: np.ndarray  # (n_dofs,) bool

    @property
    def n_dofs(self) -> int:
        return self.dof_coords.shape[0]

    @property
    def set_index(self) -> np.ndarray:
        """Class-local (interior / boundary) dof numbering, dof order —
        the P2 extension of the reference's ``set_index`` rule."""
        idx = np.zeros(self.n_dofs, dtype=np.int64)
        idx[~self.dof_on_boundary] = np.arange((~self.dof_on_boundary).sum())
        idx[self.dof_on_boundary] = np.arange(self.dof_on_boundary.sum())
        return idx


def p2_mesh(mesh: TriangularMesh) -> P2Mesh:
    """Generate P2 dofs: vertices + deduplicated edge midpoints.

    An edge midpoint is a boundary dof iff its edge belongs to exactly one
    triangle (the topological boundary of a conforming triangulation) —
    equivalent to the reference's line-element marking for meshes whose
    boundary line elements trace the mesh boundary.
    """
    tris = mesh.triangles
    # local edges (0,1), (1,2), (0,2) — rows already sorted ascending, so
    # each pair is sorted too and dedup is a plain unique over rows
    edges = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]], axis=0
    )
    uniq, inv, counts = np.unique(edges, axis=0, return_inverse=True,
                                  return_counts=True)
    n_v, n_e, m = mesh.n_nodes, uniq.shape[0], mesh.n_elements
    edge_dof = n_v + inv.reshape(3, m).T  # (M, 3): e01, e12, e02
    tri_dofs = np.concatenate([tris, edge_dof], axis=1)
    mid = 0.5 * (mesh.nodes[uniq[:, 0]] + mesh.nodes[uniq[:, 1]])
    dof_coords = np.concatenate([mesh.nodes, mid], axis=0)
    on_b = np.concatenate([mesh.on_boundary, counts == 1])
    return P2Mesh(base=mesh, dof_coords=dof_coords, tri_dofs=tri_dofs,
                  dof_on_boundary=on_b)


def _p2_gradient_coefficients() -> np.ndarray:
    """B[q, a, i]: gradient of P2 basis ``a`` at quadrature point ``q`` as a
    combination of the element's (constant) P1 gradients ``grad lambda_i``:
    ``grad phi_a(q) = sum_i B[q, a, i] grad lambda_i``.

    Basis: vertex_i = lambda_i (2 lambda_i - 1); edge_(i,j) = 4 lambda_i
    lambda_j.  Quadrature q = edge midpoints (weights area/3) — degree-2
    exact, so constant-alpha P2 stiffness entries are integrated exactly.
    """
    # barycentric coordinates of the three midpoints m01, m12, m02
    lam = np.array([[0.5, 0.5, 0.0],
                    [0.0, 0.5, 0.5],
                    [0.5, 0.0, 0.5]])
    edges_local = ((0, 1), (1, 2), (0, 2))
    B = np.zeros((3, 6, 3))
    for q in range(3):
        for i in range(3):  # vertex dofs
            B[q, i, i] = 4.0 * lam[q, i] - 1.0
        for a, (i, j) in enumerate(edges_local, start=3):
            B[q, a, j] = 4.0 * lam[q, i]
            B[q, a, i] = 4.0 * lam[q, j]
    return B


def assemble_p2(
    p2: P2Mesh,
    f: Callable = default_forcing_term,
    g: Callable = default_boundary_function,
    alpha: Callable = default_alpha,
) -> Tuple[HostCSR, np.ndarray]:
    """Assemble the interior-dof P2 stiffness matrix and lifted RHS.

    Same contract as :func:`assemble_p1` (the system the reference's AMG
    consumes), one polynomial degree up.  Fully vectorised over elements:
    per-element 6x6 stiffness via one einsum over the constant gradient-
    coefficient tensor, then a duplicate-summing COO->CSR compression.
    ``f`` is integrated with the midpoint rule (phi_edge(m_q) = delta_eq
    and the vertex basis integrates to zero — both exact for degree 2).
    """
    mesh = p2.base
    areas, grads = _p1_geometry(mesh)  # grads = grad lambda_i, (M, 3, 2)
    B = _p2_gradient_coefficients()  # (3, 6, 3)
    gp = np.einsum("qai,eid->eqad", B, grads)  # grad phi_a at q, (M,3,6,2)
    mid_xy = p2.dof_coords[p2.tri_dofs[:, 3:]]  # (M, 3, 2) midpoint coords
    w_alpha = (areas[:, None] / 3.0) * alpha(mid_xy[..., 0], mid_xy[..., 1])
    K = np.einsum("eqad,eqbd,eq->eab", gp, gp, w_alpha)  # (M, 6, 6)

    set_index = p2.set_index
    interior = ~p2.dof_on_boundary
    td_interior = interior[p2.tri_dofs]  # (M, 6)
    td_sidx = set_index[p2.tri_dofs]  # (M, 6)

    ii = np.broadcast_to(td_sidx[:, :, None], K.shape)
    jj = np.broadcast_to(td_sidx[:, None, :], K.shape)
    mask_ii = np.broadcast_to(td_interior[:, :, None], K.shape)
    mask_jj = np.broadcast_to(td_interior[:, None, :], K.shape)

    n_int = int(interior.sum())
    both = mask_ii & mask_jj
    A = HostCSR.from_coo(ii[both], jj[both], K[both], (n_int, n_int))

    # load: rhs_a = sum_q w_q f(x_q) phi_a(x_q); phi_edge(m_q) = delta,
    # vertex basis vanish at midpoints
    rhs = np.zeros(n_int)
    fvals = f(mid_xy[..., 0], mid_xy[..., 1]) * (areas[:, None] / 3.0)
    sel = td_interior[:, 3:]
    np.add.at(rhs, td_sidx[:, 3:][sel], fvals[sel])

    # Dirichlet lifting: i interior, j boundary (vertex or midpoint dof)
    lift = mask_ii & ~mask_jj
    if lift.any():
        xy = p2.dof_coords[p2.tri_dofs]  # (M, 6, 2)
        gvals = g(xy[..., 0], xy[..., 1])  # (M, 6)
        gj = np.broadcast_to(gvals[:, None, :], K.shape)
        np.subtract.at(rhs, ii[lift], (gj * K)[lift])
    return A, rhs


def p2_solution_on_dofs(p2: P2Mesh, sol_interior: np.ndarray,
                        g: Callable = default_boundary_function) -> np.ndarray:
    """Full dof field: boundary dofs get ``g``, interior get the solution."""
    u = np.zeros(p2.n_dofs)
    u[~p2.dof_on_boundary] = np.asarray(sol_interior)
    bx = p2.dof_coords[p2.dof_on_boundary, 0]
    by = p2.dof_coords[p2.dof_on_boundary, 1]
    u[p2.dof_on_boundary] = g(bx, by)
    return u


def export_vtu_p2(path: str, p2: P2Mesh, sol_interior: np.ndarray,
                  g: Callable = default_boundary_function) -> None:
    """VTU writer for quadratic triangles (VTK cell type 22, connectivity
    v0 v1 v2 m01 m12 m20) — the higher-order extension of ``export_to_vtu``
    (``AMG/src/FEM.cpp:318-412``)."""
    u = p2_solution_on_dofs(p2, sol_interior, g)
    conn = p2.tri_dofs[:, [0, 1, 2, 3, 4, 5]]  # e02 == edge (2,0)
    _write_vtu(path, p2.dof_coords, conn, 22, u)


# -- P3 (cubic) elements --------------------------------------------------------
#
# The reference also declares ``ThirdOrderFE`` (edge third-points + one
# interior dof, ``AMG/include/FEM.hpp:301-326``) with no basis functions —
# it too cannot assemble.  This implements the full cubic Lagrange element:
# 10 dofs (3 vertices, 2 per edge at the third-points, 1 barycenter),
# degree-4 Dunavant quadrature (exact for the degree-4 stiffness integrand,
# so cubic manufactured solutions reproduce to round-off).

# 6-point Dunavant rule, degree-4 exact; weights sum to 1 (x area)
_DUNAVANT4_A1, _DUNAVANT4_W1 = 0.445948490915965, 0.223381589678011
_DUNAVANT4_A2, _DUNAVANT4_W2 = 0.091576213509771, 0.109951743655322


def _dunavant4():
    lam = []
    w = []
    for a, wt in ((_DUNAVANT4_A1, _DUNAVANT4_W1),
                  (_DUNAVANT4_A2, _DUNAVANT4_W2)):
        for perm in ((a, a, 1 - 2 * a), (a, 1 - 2 * a, a), (1 - 2 * a, a, a)):
            lam.append(perm)
            w.append(wt)
    return np.asarray(lam), np.asarray(w)


_P3_EDGES_LOCAL = ((0, 1), (1, 2), (0, 2))


def _p3_phi(lam: np.ndarray) -> np.ndarray:
    """P3 basis values at barycentric points ``lam`` (Q, 3) -> (Q, 10).

    Dof order: v0 v1 v2, then per local edge (i, j) the node nearer i
    (lam_i = 2/3) then nearer j, then the barycenter."""
    Q = lam.shape[0]
    phi = np.zeros((Q, 10))
    for i in range(3):
        li = lam[:, i]
        phi[:, i] = 0.5 * li * (3 * li - 1) * (3 * li - 2)
    for a, (i, j) in enumerate(_P3_EDGES_LOCAL):
        li, lj = lam[:, i], lam[:, j]
        phi[:, 3 + 2 * a] = 4.5 * li * lj * (3 * li - 1)
        phi[:, 3 + 2 * a + 1] = 4.5 * li * lj * (3 * lj - 1)
    phi[:, 9] = 27.0 * lam[:, 0] * lam[:, 1] * lam[:, 2]
    return phi


def _p3_dphi(lam: np.ndarray) -> np.ndarray:
    """C[q, a, i] = d phi_a / d lambda_i at ``lam`` (Q, 3) -> (Q, 10, 3),
    so that grad phi_a(q) = sum_i C[q, a, i] grad lambda_i."""
    Q = lam.shape[0]
    C = np.zeros((Q, 10, 3))
    for i in range(3):
        li = lam[:, i]
        C[:, i, i] = 0.5 * (27 * li * li - 18 * li + 2)
    for a, (i, j) in enumerate(_P3_EDGES_LOCAL):
        li, lj = lam[:, i], lam[:, j]
        C[:, 3 + 2 * a, i] = 4.5 * lj * (6 * li - 1)
        C[:, 3 + 2 * a, j] = 4.5 * li * (3 * li - 1)
        C[:, 3 + 2 * a + 1, i] = 4.5 * lj * (3 * lj - 1)
        C[:, 3 + 2 * a + 1, j] = 4.5 * li * (6 * lj - 1)
    l0, l1, l2 = lam[:, 0], lam[:, 1], lam[:, 2]
    C[:, 9, 0] = 27.0 * l1 * l2
    C[:, 9, 1] = 27.0 * l0 * l2
    C[:, 9, 2] = 27.0 * l0 * l1
    return C


@dataclasses.dataclass
class P3Mesh:
    """P3 dof layout: vertices, then 2 dofs per unique edge (third-points,
    lower-vertex-first), then one barycenter dof per element."""

    base: TriangularMesh
    dof_coords: np.ndarray  # (n_dofs, 2)
    tri_dofs: np.ndarray  # (M, 10)
    dof_on_boundary: np.ndarray  # (n_dofs,) bool

    @property
    def n_dofs(self) -> int:
        return self.dof_coords.shape[0]

    @property
    def set_index(self) -> np.ndarray:
        idx = np.zeros(self.n_dofs, dtype=np.int64)
        idx[~self.dof_on_boundary] = np.arange((~self.dof_on_boundary).sum())
        idx[self.dof_on_boundary] = np.arange(self.dof_on_boundary.sum())
        return idx


def p3_mesh(mesh: TriangularMesh) -> P3Mesh:
    """Generate P3 dofs: the vectorised analog of the reference's
    third-point dof generation with shared-edge dedup
    (``AMG/src/FEM.cpp:185-270``), plus the barycenter dofs."""
    tris = mesh.triangles
    edges = np.concatenate(
        [tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]], axis=0
    )
    uniq, inv, counts = np.unique(edges, axis=0, return_inverse=True,
                                  return_counts=True)
    n_v, n_e, m = mesh.n_nodes, uniq.shape[0], mesh.n_elements
    # per unique edge: dof n_v + 2e at lower + (upper-lower)/3,
    #                  dof n_v + 2e + 1 at 2/3 — orientation-independent
    # because the edge key (lower, upper) is global
    e_ids = inv.reshape(3, m).T  # (M, 3) unique-edge id per local edge
    # local edges have v_i < v_j (triangle rows sorted), so "nearer i" is
    # always "nearer the lower global id" = the edge's first dof
    tri_edge_dofs = np.stack(
        [n_v + 2 * e_ids[:, 0], n_v + 2 * e_ids[:, 0] + 1,
         n_v + 2 * e_ids[:, 1], n_v + 2 * e_ids[:, 1] + 1,
         n_v + 2 * e_ids[:, 2], n_v + 2 * e_ids[:, 2] + 1], axis=1)
    center_dofs = n_v + 2 * n_e + np.arange(m)
    tri_dofs = np.concatenate(
        [tris, tri_edge_dofs, center_dofs[:, None]], axis=1)
    lo, hi = mesh.nodes[uniq[:, 0]], mesh.nodes[uniq[:, 1]]
    third = np.empty((2 * n_e, 2))
    third[0::2] = lo + (hi - lo) / 3.0
    third[1::2] = lo + 2.0 * (hi - lo) / 3.0
    centers = mesh.nodes[tris].mean(axis=1)
    dof_coords = np.concatenate([mesh.nodes, third, centers], axis=0)
    edge_b = np.repeat(counts == 1, 2)
    on_b = np.concatenate(
        [mesh.on_boundary, edge_b, np.zeros(m, dtype=bool)])
    return P3Mesh(base=mesh, dof_coords=dof_coords, tri_dofs=tri_dofs,
                  dof_on_boundary=on_b)


def assemble_p3(
    p3: P3Mesh,
    f: Callable = default_forcing_term,
    g: Callable = default_boundary_function,
    alpha: Callable = default_alpha,
) -> Tuple[HostCSR, np.ndarray]:
    """Assemble the interior-dof P3 stiffness matrix and lifted RHS
    (same contract as :func:`assemble_p1` / :func:`assemble_p2`)."""
    mesh = p3.base
    areas, grads = _p1_geometry(mesh)
    lam, wq = _dunavant4()  # (Q, 3), (Q,)
    C = _p3_dphi(lam)  # (Q, 10, 3)
    phi = _p3_phi(lam)  # (Q, 10)
    gp = np.einsum("qai,eid->eqad", C, grads)  # (M, Q, 10, 2)
    pv = mesh.nodes[mesh.triangles]  # (M, 3, 2)
    xq = np.einsum("qi,eid->eqd", lam, pv)  # (M, Q, 2) quadrature points
    w_alpha = areas[:, None] * wq[None, :] * alpha(xq[..., 0], xq[..., 1])
    K = np.einsum("eqad,eqbd,eq->eab", gp, gp, w_alpha)  # (M, 10, 10)

    set_index = p3.set_index
    interior = ~p3.dof_on_boundary
    td_interior = interior[p3.tri_dofs]
    td_sidx = set_index[p3.tri_dofs]

    ii = np.broadcast_to(td_sidx[:, :, None], K.shape)
    jj = np.broadcast_to(td_sidx[:, None, :], K.shape)
    mask_ii = np.broadcast_to(td_interior[:, :, None], K.shape)
    mask_jj = np.broadcast_to(td_interior[:, None, :], K.shape)

    n_int = int(interior.sum())
    both = mask_ii & mask_jj
    A = HostCSR.from_coo(ii[both], jj[both], K[both], (n_int, n_int))

    # load: rhs_a = sum_q area w_q f(x_q) phi_a(q)
    rhs = np.zeros(n_int)
    wf = areas[:, None] * wq[None, :] * f(xq[..., 0], xq[..., 1])  # (M, Q)
    fvals = np.einsum("eq,qa->ea", wf, phi)  # (M, 10)
    np.add.at(rhs, td_sidx[td_interior], fvals[td_interior])

    # Dirichlet lifting over all boundary dofs
    lift = mask_ii & ~mask_jj
    if lift.any():
        xy = p3.dof_coords[p3.tri_dofs]  # (M, 10, 2)
        gvals = g(xy[..., 0], xy[..., 1])
        gj = np.broadcast_to(gvals[:, None, :], K.shape)
        np.subtract.at(rhs, ii[lift], (gj * K)[lift])
    return A, rhs


def p3_solution_on_dofs(p3: P3Mesh, sol_interior: np.ndarray,
                        g: Callable = default_boundary_function) -> np.ndarray:
    u = np.zeros(p3.n_dofs)
    u[~p3.dof_on_boundary] = np.asarray(sol_interior)
    bx = p3.dof_coords[p3.dof_on_boundary, 0]
    by = p3.dof_coords[p3.dof_on_boundary, 1]
    u[p3.dof_on_boundary] = g(bx, by)
    return u


def export_vtu_p3(path: str, p3: P3Mesh, sol_interior: np.ndarray,
                  g: Callable = default_boundary_function) -> None:
    """Export the P3 solution's vertex trace as a linear-triangle VTU
    (legacy VTK has no fixed cubic-triangle cell; the full dof field is
    available via :func:`p3_solution_on_dofs`)."""
    u = p3_solution_on_dofs(p3, sol_interior, g)
    export_vtu_field(path, p3.base, u[: p3.base.n_nodes])


def export_vtu_field(path: str, mesh: TriangularMesh,
                     u_nodes: np.ndarray) -> None:
    """P1 VTU writer for an arbitrary full nodal field."""
    _write_vtu(path, mesh.nodes, mesh.triangles, 5, u_nodes)
