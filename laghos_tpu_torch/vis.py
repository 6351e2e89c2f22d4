"""Live GLVis visualization over the MFEM socket protocol.

The counterpart of `laghos_tpu.vis`, with the same payloads.  Equivalent
of the reference's VisualizeField / socketstream plumbing
(laghos_solver.cpp:43-94, laghos.cpp:691-738): each field gets its own
TCP connection to a running `glvis` server (default localhost:19916)
and receives `solution\n<mesh><gridfunction>` streams every vis step,
with window title/geometry/keys sent on first open.  A failed
connection disables that window for the rest of the run (mirroring the
reference's `if (!sock.is_open()) visualization = false` behaviour) —
runs never crash because no viewer is listening.

The payload is genuine MFEM ASCII format: the mesh is emitted with a
high-order `nodes` section carrying the CURRENT (deformed) kinematic
coordinates, and grid functions are emitted in MFEM's global dof
numbering (vertex dofs, then edge dofs in min->max vertex direction,
then face/interior dofs — rebuilt here from the element connectivity,
including MFEM's quad-face orientation dof permutations at any order,
see `mfem_h1_dofs`).  GLVis therefore renders the moving high-order
mesh exactly as it renders the reference's (whose VisualizeField
streams any order, laghos_solver.cpp:43-94).
"""

from __future__ import annotations

import socket

import numpy as np


def _np(t):
    return t.detach().cpu().numpy()


# MFEM geometry constants (mfem/fem/geom.cpp): local edge / face vertex
# lists for SQUARE and CUBE, in MFEM's element vertex numbering.
_EDGES = {
    2: [(0, 1), (1, 2), (2, 3), (3, 0)],
    3: [(0, 1), (1, 2), (3, 2), (0, 3), (4, 5), (5, 6), (7, 6), (4, 7),
        (0, 4), (1, 5), (2, 6), (3, 7)],
}
_HEX_FACES = [(3, 2, 1, 0), (0, 1, 5, 4), (1, 2, 6, 5),
              (2, 3, 7, 6), (3, 0, 4, 7), (4, 5, 6, 7)]


def _enumerate_edges(mesh):
    """Edge ids by first appearance over (element, local edge) — MFEM's
    Mesh::GetElementToEdgeTable order.  Returns {frozenset(v0,v1): id}."""
    eid = {}
    for row in mesh.elems:
        for (a, b) in _EDGES[mesh.dim]:
            key = frozenset((int(row[a]), int(row[b])))
            if key not in eid:
                eid[key] = len(eid)
    return eid


def _enumerate_faces(mesh):
    """Face ids + stored vertex orderings by first appearance over
    (element, local face) — MFEM's GenerateFaces/GetElementToFaceTable
    order: the generating element's local face vertex list (hex FaceVert
    table, = _HEX_FACES) becomes the face's stored orientation.
    Returns {frozenset(verts): (id, (v0, v1, v2, v3))}."""
    faces = {}
    for row in mesh.elems:
        for quad in _HEX_FACES:
            verts = tuple(int(row[a]) for a in quad)
            key = frozenset(verts)
            if key not in faces:
                faces[key] = (len(faces), verts)
    return faces


def mfem_h1_dofs(space):
    """Map our H1 numbering to MFEM's.

    Returns `ours_of_mfem`, an int array of length ndof with
    `mfem_values[i] = our_values[ours_of_mfem[i]]`.  MFEM global H1
    dofs are ordered: all vertex dofs (by vertex id), then per-edge
    interior dofs (edges by first-appearance order, dofs running from
    the lower- to the higher-numbered vertex), then quad-face interior
    dofs (3D; lexicographic in the STORED face's frame — s along
    v0->v1 running fastest, t along v0->v3 — so an element seeing the
    face in another orientation maps its local lattice coordinates
    through the dihedral transform, which is exactly what MFEM's
    H1_FECollection::DofOrderForOrientation permutations encode), then
    element-interior dofs in local lex order.  Cross-element
    consistency of shared face dofs is asserted below.
    """
    mesh, p = space.mesh, space.p
    d, nv = mesh.dim, mesh.num_verts
    n1 = p + 1
    edges = _enumerate_edges(mesh)
    n_edofs = len(edges) * (p - 1)
    faces = _enumerate_faces(mesh) if d == 3 else {}
    n_fdofs = len(faces) * (p - 1) ** 2
    off_face = nv + n_edofs
    off_int = off_face + n_fdofs
    nint = (p - 1) ** d
    ndof_mfem = off_int + mesh.num_elems * nint
    assert ndof_mfem == space.ndof, (ndof_mfem, space.ndof)

    # local lattice coordinates, x fastest (matches space.gather order)
    rng = np.arange(n1)
    grids = np.meshgrid(*([rng] * d), indexing="ij")
    lat = np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
    corners = mesh.corners_lattice()  # (NE, 2^d) vertex ids, lattice order

    ours_of_mfem = np.full(space.ndof, -1, dtype=np.int64)
    for e in range(mesh.num_elems):
        cl = corners[e]
        for n in range(n1 ** d):
            ic = lat[n]
            free = [dd for dd in range(d) if 0 < ic[dd] < p]
            bits = [1 if ic[dd] == p else 0 for dd in range(d)]
            if not free:                                    # vertex dof
                c = sum(bits[dd] << dd for dd in range(d))
                g = int(cl[c])
            elif len(free) == 1:                            # edge dof
                dd = free[0]
                c0 = sum((bits[k] if k != dd else 0) << k for k in range(d))
                c1 = c0 | (1 << dd)
                v0, v1 = int(cl[c0]), int(cl[c1])
                eidx = edges[frozenset((v0, v1))]
                t = ic[dd] if v0 < v1 else p - ic[dd]
                g = nv + eidx * (p - 1) + (t - 1)
            elif d == 3 and len(free) == 2:                 # face dof
                dd = [k for k in range(d) if k not in free][0]
                f0, f1 = free
                base = bits[dd] << dd
                quad = [base,
                        base | (1 << f0),
                        base | (1 << f0) | (1 << f1),
                        base | (1 << f1)]
                gids = [int(cl[c]) for c in quad]
                fidx, stored = faces[frozenset(gids)]
                # this element's face coordinates: (a, b) with corner
                # k of `quad` at AB[k]
                a, b = int(ic[f0]), int(ic[f1])
                AB = ((0, 0), (p, 0), (p, p), (0, p))
                pos = {g_: k for k, g_ in enumerate(gids)}
                o = AB[pos[stored[0]]]          # stored v0 in (a,b)

                def _along(to):
                    """Dof coordinate along the stored-face axis
                    o -> to, expressed in this element's (a, b)."""
                    if to[0] != o[0]:
                        return a if to[0] > o[0] else p - a
                    return b if to[1] > o[1] else p - b

                s = _along(AB[pos[stored[1]]])  # v0 -> v1 (fastest)
                t = _along(AB[pos[stored[3]]])  # v0 -> v3
                g = (off_face + fidx * (p - 1) ** 2
                     + (t - 1) * (p - 1) + (s - 1))
            else:                                           # interior dof
                loc = 0
                for k in reversed(free):
                    loc = loc * (p - 1) + (ic[k] - 1)
                g = off_int + e * nint + loc
            mine = space.gather[e, n]
            # shared dofs (vertex/edge/face) must resolve identically
            # from every element that touches them — this is the
            # orientation-permutation consistency gate
            assert ours_of_mfem[g] in (-1, mine), (e, n, g)
            ours_of_mfem[g] = mine
    assert (ours_of_mfem >= 0).all()
    return ours_of_mfem


def _fmt(vals):
    return "\n".join(repr(float(v)) for v in vals) + "\n"


def gridfunction_str(fec_name, vdim, values, ordering=0):
    """MFEM GridFunction ASCII serialization (gridfunc.cpp Save)."""
    head = ("FiniteElementSpace\n"
            f"FiniteElementCollection: {fec_name}\n"
            f"VDim: {vdim}\nOrdering: {ordering}\n\n")
    return head + _fmt(np.asarray(values).reshape(-1))


def mesh_str(mesh, nodes_fec=None, nodes_vals=None):
    """MFEM mesh v1.0 with an optional curved `nodes` section.

    `nodes_vals`: (nnodes, dim) coordinates in MFEM dof order —
    serialized byVDIM (Ordering 1), MFEM's convention for mesh nodes.
    """
    d = mesh.dim
    geom = {1: 1, 2: 3, 3: 5}[d]
    bgeom = {1: 0, 2: 1, 3: 3}[d]
    out = [f"MFEM mesh v1.0\n\ndimension\n{d}\n\n"]
    out.append(f"elements\n{mesh.num_elems}\n")
    for row in mesh.elems:
        out.append("1 %d %s\n" % (geom, " ".join(str(int(v)) for v in row)))
    out.append(f"\nboundary\n{mesh.bdr_verts.shape[0]}\n")
    for attr, row in zip(mesh.bdr_attr, mesh.bdr_verts):
        out.append("%d %d %s\n"
                   % (attr, bgeom, " ".join(str(int(v)) for v in row)))
    if nodes_vals is None:
        out.append(f"\nvertices\n{mesh.num_verts}\n{d}\n")
        for v in mesh.verts:
            out.append(" ".join(repr(float(c)) for c in v) + "\n")
    else:
        out.append(f"\nvertices\n{mesh.num_verts}\n\nnodes\n")
        out.append(gridfunction_str(nodes_fec, d, nodes_vals, ordering=1))
    return "".join(out)


class GLVisWindow:
    """One GLVis window = one persistent socket (VisualizeField,
    laghos_solver.cpp:43-94)."""

    def __init__(self, host="localhost", port=19916, title="",
                 x=0, y=0, w=500, h=500, keys=None):
        self.host, self.port, self.title = host, port, title
        self.geom = (x, y, w, h)
        self.keys = keys
        self.sock = None
        self.newly_opened = True
        self.good = True

    def _connect(self):
        try:
            self.sock = socket.create_connection(
                (self.host, self.port), timeout=2.0)
        except OSError:
            self.sock = None
            self.good = False    # disable for the rest of the run
        return self.sock is not None

    def send(self, payload: str):
        if not self.good:
            return False
        if self.sock is None and not self._connect():
            print(f"GLVis: unable to connect to "
                  f"{self.host}:{self.port} — disabling '{self.title}'")
            return False
        extra = ""
        if self.newly_opened:
            x, y, w, h = self.geom
            extra = (f"window_title '{self.title}'\n"
                     f"window_geometry {x} {y} {w} {h}\n")
            if self.keys:
                extra += f"keys {self.keys}\n"
            self.newly_opened = False
        try:
            self.sock.sendall((payload + extra).encode())
        except OSError:
            self.good = False
            return False
        return True

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class GLVisSession:
    """The reference driver's three vis windows (laghos.cpp:691-738):
    density, specific internal energy, velocity magnitude."""

    def __init__(self, hydro, host="localhost", port=19916):
        self.h = hydro
        self.ours_of_mfem = mfem_h1_dofs(hydro.h1)
        d, pv, pe = hydro.dim, hydro.h1.p, hydro.opt.order_e
        self.h1_name = f"H1_{d}D_P{pv}"
        # L2 state (e) and density coefficients live in the Bernstein
        # ("Positive") basis, BasisType::Positive = 2 (laghos.cpp:494)
        self.l2_name = (f"L2_T2_{d}D_P{pe}")
        ws, offx = 500, 510
        self.windows = {
            "rho": GLVisWindow(host, port, "Density", 0, 0, ws, ws,
                               keys="mmaaAcl" if d == 2 else "mmaaAcl"),
            "e": GLVisWindow(host, port, "Specific Internal Energy",
                             offx, 0, ws, ws),
            "v": GLVisWindow(host, port, "Velocity", 2 * offx, 0, ws, ws),
        }

    def _mesh_payload(self, S):
        x = _np(S["x"])[:, self.ours_of_mfem].T            # (ndof, d)
        return mesh_str(self.h.mesh, self.h1_name, x)

    def step(self, S):
        h = self.h
        mesh_s = None
        for name, win in self.windows.items():
            if not win.good:
                continue
            if mesh_s is None:
                mesh_s = self._mesh_payload(S)
            if name == "rho":
                vals = _np(h.compute_density(S)).reshape(-1)
                gf = gridfunction_str(self.l2_name, 1, vals)
            elif name == "e":
                gf = gridfunction_str(self.l2_name, 1,
                                      _np(S["e"]).reshape(-1))
            else:
                v = _np(S["v"])[:, self.ours_of_mfem]         # (d, ndof)
                gf = gridfunction_str(self.h1_name, h.dim, v, ordering=0)
            win.send("solution\n" + mesh_s + gf)

    def close(self):
        for win in self.windows.values():
            win.close()
