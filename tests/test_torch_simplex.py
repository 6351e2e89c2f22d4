"""The port's simplex solver (`laghos_tpu_torch.fem.simplex`,
`fem.simplex_mesh`, `simplex_hydro`) against the JAX package on the CPU.

Tolerances: quadrature and basis tables 1e-14 (the same NumPy code);
meshes, refinements and H1 maps exactly; `SimplexHydro` static arrays
1e-13; short runs (tri Sod, forced Taylor-Green, Rayleigh-Taylor, tet
static, tri Sedov RK2Avg) equal step counts and states at 1e-12, the
RK2Avg total-energy drift below 1e-11.  Meshes are built with
make_tri_mesh / make_tet_mesh, or written by the test.
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from laghos_tpu import cli as jcli
from laghos_tpu.fem import simplex as jsx
from laghos_tpu.fem import simplex_mesh as jsm
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.simplex_hydro import SimplexHydro as JSimplex
from laghos_tpu_torch import cli, data
from laghos_tpu_torch.fem import simplex as tsx
from laghos_tpu_torch.fem import simplex_mesh as tsm
from laghos_tpu_torch.hydro import Options
from laghos_tpu_torch.interop import (simplex_arrays,
                                      simplex_state_from_numpy,
                                      state_to_numpy)
from laghos_tpu_torch.simplex_hydro import SimplexHydro, TriHydro

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("p,order", [(1, 3), (2, 5), (3, 7)])
def test_tables_match_jax(p, order):
    for a, b in ((tsx.tri_quadrature(order), jsx.tri_quadrature(order)),
                 (tsx.tet_quadrature(order), jsx.tet_quadrature(order))):
        for u, v in zip(a, b):
            assert np.abs(u - v).max() <= 1e-14
    for name in ("h1_tri_tables", "l2_tri_tables", "h1_tet_tables",
                 "l2_tet_tables"):
        a, b = getattr(tsx, name)(p, order), getattr(jsx, name)(p, order)
        assert a.keys() == b.keys()
        for k in a:
            if k == "quad":
                continue
            assert np.abs(np.asarray(a[k]) - np.asarray(b[k])).max() \
                <= 1e-14 * max(1.0, np.abs(b[k]).max()), (name, k)
    X, Y, W = tsx.tri_quadrature(order)
    assert abs(W.sum() - 0.5) < 1e-14


def _assert_mesh_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    np.testing.assert_array_equal(a.verts, b.verts)
    for k in ("elems", "bdr_verts", "bdr_attr"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _assert_space_equal(a, b):
    assert a["ndof"] == b["ndof"]
    for k in ("gather", "coords", "ess"):
        np.testing.assert_array_equal(a[k], b[k])


def test_tri_meshes_and_spaces_match_jax():
    kw = dict(sizes=(0.5, 2.0), origin=(0.0, -1.0))
    a, b = tsm.make_tri_mesh((2, 3), **kw), jsm.make_tri_mesh((2, 3), **kw)
    for _ in range(2):
        _assert_mesh_equal(a, b)
        for p in (1, 2, 3):
            _assert_space_equal(tsm.build_tri_h1(a, p),
                                jsm.build_tri_h1(b, p))
        a, b = tsm.uniform_refine_tri(a), jsm.uniform_refine_tri(b)
    assert np.isclose(a.element_volumes().sum(), 1.0, atol=1e-12)


def test_tet_meshes_and_spaces_match_jax():
    a, b = tsm.make_tet_mesh((2, 1, 1), (2.0, 1.0, 1.0)), \
        jsm.make_tet_mesh((2, 1, 1), (2.0, 1.0, 1.0))
    for _ in range(2):
        _assert_mesh_equal(a, b)
        for p in (1, 2):
            _assert_space_equal(tsm.build_tet_h1(a, p),
                                jsm.build_tet_h1(b, p))
        a, b = tsm.uniform_refine_tet(a), jsm.uniform_refine_tet(b)
    assert np.isclose(a.element_volumes().sum(), 2.0, atol=1e-12)
    _assert_mesh_equal(data.get_mesh("cube01_tet"),
                       jsm.make_tet_mesh((2, 2, 2), (1.0, 1.0, 1.0)))


def _write_tri(path, m):
    """An MFEM v1.0 triangle mesh file of `m`."""
    with open(path, "w") as f:
        f.write("MFEM mesh v1.0\n\ndimension\n2\n\n")
        f.write(f"elements\n{m.num_elems}\n")
        for row in m.elems:
            f.write("1 2 %s\n" % " ".join(map(str, row)))
        f.write(f"\nboundary\n{m.bdr_verts.shape[0]}\n")
        for a, row in zip(m.bdr_attr, m.bdr_verts):
            f.write("%d 1 %s\n" % (a, " ".join(map(str, row))))
        f.write(f"\nvertices\n{m.verts.shape[0]}\n2\n")
        for x, y in m.verts:
            f.write(f"{float(x)!r} {float(y)!r}\n")


def test_simplex_file_through_get_mesh(tmp_path):
    path = str(tmp_path / "tri.mesh")
    _write_tri(path, jsm.make_tri_mesh((3, 2)))
    m = data.get_mesh(path)
    assert isinstance(m, tsm.TriMesh)
    _assert_mesh_equal(m, jsm.load_tri_mesh(path))
    _assert_mesh_equal(tsm.load_simplex_mesh(path),
                       jsm.load_simplex_mesh(path))


_CASES = {
    "tri_sod": (lambda M: M.make_tri_mesh((4, 4)),
                dict(problem=2, cg_tol=1e-12), 0.1, 6),
    "tri_taylor_green": (
        lambda M: M.uniform_refine_tri(M.make_tri_mesh((4, 4))),
        dict(problem=0, cg_tol=1e-12), 0.25, 5),
    "tri_rayleigh_taylor": (
        lambda M: M.make_tri_mesh((2, 8), sizes=(0.5, 2.0),
                                  origin=(0.0, -1.0)),
        dict(problem=7, cg_tol=1e-10), 0.5, 8),
    "tet_static": (lambda M: M.make_tet_mesh((2, 2, 2)),
                   dict(problem=3, cg_tol=1e-12), 0.3, 3),
    "tri_sedov_rk2avg": (
        lambda M: M.uniform_refine_tri(M.make_tri_mesh((2, 2))),
        dict(problem=1, ode_solver=7, cg_tol=1e-12), 0.3, 15),
}


def _pair(case):
    make, opt, _, _ = _CASES[case]
    th = SimplexHydro(make(tsm), Options(**opt), device="cpu")
    jh = JSimplex(make(jsm), JOptions(**opt))
    return th, jh


@pytest.mark.parametrize("case", ["tri_sedov_rk2avg", "tet_static",
                                  "tri_rayleigh_taylor"])
def test_static_arrays_match_jax(case):
    th, jh = _pair(case)
    a = simplex_arrays(th)
    for k in ("B", "G", "Bl", "W", "massD", "h1_dinv", "Me_inv", "rw",
              "Jac0inv"):
        assert _rel(a[k], getattr(jh, k)) <= 1e-13, k
    np.testing.assert_array_equal(a["gather"], np.asarray(jh.gather))
    assert abs(a["h0"] - jh.h0) <= 1e-15 * jh.h0
    for k in ("x", "v", "e"):
        assert _rel(a["S0"][k], jh.S0[k]) <= 1e-13, k
    if th.rt_rhs is not None:
        assert _rel(th.rt_rhs.numpy(), jh.rt_rhs) <= 1e-13
    # a state carried across from the JAX package
    S = simplex_state_from_numpy({k: np.asarray(v) for k, v in
                                  jh.S0.items()}, device="cpu")
    assert _rel(S["e"], th.S0["e"]) <= 1e-13


def _total_energy(h, S):
    ie, ke = h.energies(S)
    return float(ie) + float(ke)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_runs_match_jax(case):
    th, jh = _pair(case)
    _, _, t_final, ms = _CASES[case]
    St, tt, st = th.run(t_final, max_steps=ms)
    Sj, tj, sj = jh.run(t_final, max_steps=ms)
    assert st == sj and st > 2
    assert abs(tt - tj) <= 1e-14
    Sn = state_to_numpy(St)
    for k in ("x", "v", "e"):
        if np.abs(Sj[k]).max() < 1e-9:
            # round-off noise of a field that stays zero (tet static's v)
            assert np.abs(Sn[k] - Sj[k]).max() <= 1e-12, k
        else:
            assert _rel(Sn[k], Sj[k]) <= 1e-12, k
    if case == "tri_sedov_rk2avg":
        E0, E1 = _total_energy(th, th.S0), _total_energy(th, St)
        assert abs(E1 - E0) / abs(E0) < 1e-11
    if case == "tet_static":
        assert float(St["v"].abs().max()) < 1e-9


def test_repeatable_and_tri_alias():
    finals = []
    for _ in range(2):
        h = TriHydro(tsm.make_tri_mesh((3, 3)), Options(problem=2),
                     device="cpu")
        finals.append(h.run(0.05, max_steps=4)[0])
    for k in ("x", "v", "e"):
        assert torch.equal(finals[0][k], finals[1][k])


def _last_line(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().strip().splitlines()[-1]


def test_cli_cube01_tet_prints_the_jax_line():
    argv = ["-p", "1", "-m", "cube01_tet", "-rs", "0", "-ms", "3",
            "-cgt", "1e-12"]
    lt = _last_line(cli.main, ["-d", "cpu"] + argv)
    lj = _last_line(jcli.main, ["--device", "cpu"] + argv)
    pat = r"step\s+(\d+),\tt = (\S+),\t\|e\| = (\S+)"
    mt, mj = re.fullmatch(pat, lt), re.fullmatch(pat, lj)
    assert mt and mj, (lt, lj)
    assert mt.group(1, 2) == mj.group(1, 2)
    assert abs(float(mt.group(3)) / float(mj.group(3)) - 1.0) < 1e-9
