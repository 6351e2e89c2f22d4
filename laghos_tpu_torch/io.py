"""Output writers: VTU (unstructured XML VTK) + NPZ data collections, and
the memory figures of -mb.

The counterpart of `laghos_tpu.io`: the reference's VisItDataCollection
(laghos.cpp:691-701, 866-871) becomes VTU time series any ParaView or VisIt
reads, and its `-print` dumps (laghos.cpp:873-900) NPZ snapshots of the
fields.  The high-order fields are sampled at the H1 nodes of each element,
as GLVis renders high-order data too.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .fem import basis as fb
from .fem.quadrature import gauss_lobatto


def _np(t):
    return t.detach().cpu().numpy()


def _vtu_cells(dim, n):
    """Sub-cell connectivity of an n^dim lattice per element."""
    if dim == 1:
        cells = [[i, i + 1] for i in range(n - 1)]
        ctype = 3  # VTK_LINE
    elif dim == 2:
        cells = []
        for j in range(n - 1):
            for i in range(n - 1):
                a = i + n * j
                cells.append([a, a + 1, a + 1 + n, a + n])
        ctype = 9  # VTK_QUAD
    else:
        cells = []
        for k in range(n - 1):
            for j in range(n - 1):
                for i in range(n - 1):
                    a = i + n * (j + n * k)
                    b = a + n * n
                    cells.append([a, a + 1, a + 1 + n, a + n,
                                  b, b + 1, b + 1 + n, b + n])
        ctype = 12  # VTK_HEXAHEDRON
    return np.array(cells, dtype=np.int64), ctype


def _bernstein_at_nodes(u, Bl, NE, l1d, d):
    """(NE, l1d^d) Bernstein coefficients -> values at the H1 lattice."""
    ut = u.reshape((NE,) + (l1d,) * d)
    for k in range(d):
        ax = ut.ndim - 1 - k
        ut = np.moveaxis(np.tensordot(ut, Bl, axes=[[ax], [1]]), -1, ax)
    return ut.reshape(NE, -1)


def write_vtu(path, hydro, S, fields=("rho", "v", "e")):
    """Write the state S of `hydro` as an unstructured VTU file."""
    d = hydro.dim
    n = hydro.nd1
    NE = hydro.NE
    gather = hydro.h1.gather

    xyz = np.zeros((NE, n**d, 3))
    xyz[:, :, :d] = np.moveaxis(_np(S["x"])[:, gather], 0, 2)
    vv = np.zeros((NE, n**d, 3))
    vv[:, :, :d] = np.moveaxis(_np(S["v"])[:, gather], 0, 2)

    # e and rho at the H1 lattice (Bernstein evaluation)
    Bl, _ = fb.bernstein_tables(hydro.opt.order_e, gauss_lobatto(n))
    e_pts = _bernstein_at_nodes(_np(S["e"]), Bl, NE, hydro.l1d, d)
    rho_pts = _bernstein_at_nodes(_np(hydro.compute_density(S)), Bl, NE,
                                  hydro.l1d, d)

    cells1, ctype = _vtu_cells(d, n)
    npts1 = n**d
    conn = (cells1[None, :, :] + npts1 * np.arange(NE)[:, None, None])
    conn = conn.reshape(-1, cells1.shape[1])
    npts = NE * npts1
    ncells = NE * cells1.shape[0]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
                'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
        f.write(f'<Piece NumberOfPoints="{npts}" NumberOfCells="{ncells}">\n')
        f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
                'format="ascii">\n')
        np.savetxt(f, xyz.reshape(-1, 3), fmt="%.16g")
        f.write('</DataArray></Points>\n<Cells>\n')
        f.write('<DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n')
        np.savetxt(f, conn, fmt="%d")
        f.write('</DataArray>\n<DataArray type="Int64" Name="offsets" '
                'format="ascii">\n')
        np.savetxt(f, np.arange(1, ncells + 1) * cells1.shape[1],
                   fmt="%d")
        f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
                'format="ascii">\n')
        np.savetxt(f, np.full(ncells, ctype), fmt="%d")
        f.write('</DataArray>\n</Cells>\n<PointData>\n')
        if "v" in fields:
            f.write('<DataArray type="Float64" Name="velocity" '
                    'NumberOfComponents="3" format="ascii">\n')
            np.savetxt(f, vv.reshape(-1, 3), fmt="%.16g")
            f.write('</DataArray>\n')
        if "e" in fields:
            f.write('<DataArray type="Float64" Name="specific_internal_'
                    'energy" format="ascii">\n')
            np.savetxt(f, e_pts.reshape(-1, 1), fmt="%.16g")
            f.write('</DataArray>\n')
        if "rho" in fields:
            f.write('<DataArray type="Float64" Name="density" '
                    'format="ascii">\n')
            np.savetxt(f, rho_pts.reshape(-1, 1), fmt="%.16g")
            f.write('</DataArray>\n')
        f.write('</PointData>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n')


class DataCollection:
    """VisItDataCollection equivalent: a .pvd time series of VTU dumps and
    NPZ snapshots of the raw state."""

    def __init__(self, basename, hydro):
        self.basename = basename
        self.hydro = hydro
        self.entries = []
        os.makedirs(os.path.dirname(basename) or ".", exist_ok=True)

    def save(self, cycle, t, S):
        vtu = f"{self.basename}_{cycle:06d}.vtu"
        write_vtu(vtu, self.hydro, S)
        np.savez(f"{self.basename}_{cycle:06d}.npz",
                 **{k: _np(S[k]) for k in ("x", "v", "e")}, t=t,
                 cycle=cycle)
        self.entries.append((t, os.path.basename(vtu)))
        with open(f"{self.basename}.pvd", "w") as f:
            f.write('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                    'version="0.1">\n<Collection>\n')
            for tt, name in self.entries:
                f.write(f'<DataSet timestep="{tt}" file="{name}"/>\n')
            f.write('</Collection>\n</VTKFile>\n')


def max_rss_mb() -> int:
    """Peak resident set size of this process in MB (the reference's -mb
    telemetry, laghos.cpp:1348-1358)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024


def device_memory_stats(device) -> dict:
    """Memory figures of a CUDA `device` from the caching allocator, in
    bytes: bytes_in_use and peak_bytes_in_use (since the last
    torch.cuda.reset_peak_memory_stats); {} for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device)}
