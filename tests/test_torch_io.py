"""The PyTorch port's command line and I/O on the CPU, each held to the JAX
package on the same inputs (or to itself where no JAX counterpart is
involved): mesh-file readers, checkpoints across packages and a bitwise
resume, VTU output, the GLVis payloads over a local socket, the Sedov exact
solution and its density error, the velocity error norms, the run
metadata, every CLI flag the port gained, and --debug-nans."""

import json
import re
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import checkpoint as jcheckpoint
from laghos_tpu import data as jdata
from laghos_tpu import io as jio
from laghos_tpu import sedov as jsedov
from laghos_tpu import verify as jverify
from laghos_tpu import vis as jvis
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import checkpoint as tcheckpoint
from laghos_tpu_torch import cli, driver
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch import io as tio
from laghos_tpu_torch import sedov as tsedov
from laghos_tpu_torch import timing as ttiming
from laghos_tpu_torch import verify as tverify
from laghos_tpu_torch import vis as tvis
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import state_from_numpy

torch.set_num_threads(1)

MESH = {2: "square01_quad", 3: "cube01_hex"}
# gather-path options, the same in both packages
GATHER = dict(structured_el=False, lattice_ops=False, precond="jacobi")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(dim, problem, rs=1, **kw):
    """(port Hydro, JAX Hydro, perturbed numpy state) on the same mesh."""
    mt, mj = tdata.get_mesh(MESH[dim]), jdata.get_mesh(MESH[dim])
    for _ in range(rs):
        mt, mj = tmesh.uniform_refine(mt), jmesh.uniform_refine(mj)
    ht = THydro(mt, TOptions(problem=problem, **kw), device="cpu")
    hj = JHydro(mj, JOptions(problem=problem, **kw))
    rng = np.random.default_rng(problem + 10 * dim)
    S0 = {k: np.asarray(v) for k, v in hj.S0.items()}
    S = {"x": S0["x"] + 0.005 * rng.normal(size=S0["x"].shape),
         "v": S0["v"] + 0.05 * rng.normal(size=S0["v"].shape),
         "e": S0["e"] + 0.5 + 0.1 * rng.random(S0["e"].shape)}
    return ht, hj, S


def _assert_mesh_equal(a, b):
    assert a.dim == b.dim
    for name in ("verts", "elems", "bdr_verts", "bdr_attr"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ------------------------------------------------------------- meshes --
@pytest.mark.parametrize("name,rs", [("segment01", 2), ("square01_quad", 1),
                                     ("cube01_hex", 1), ("rt2D", 0)])
def test_mfem_mesh_file_read_identically(name, rs, tmp_path):
    """A file written by the JAX package's write_mfem_mesh reads to the
    same mesh in both packages (and through get_mesh); the port's writer
    writes the same bytes."""
    mj = jdata.get_mesh(name)
    for _ in range(rs):
        mj = jmesh.uniform_refine(mj)
    path = tmp_path / "m.mesh"
    jmesh.write_mfem_mesh(mj, str(path))
    mt = tmesh.load_mfem_mesh(str(path))
    _assert_mesh_equal(mt, jmesh.load_mfem_mesh(str(path)))
    _assert_mesh_equal(tdata.get_mesh(str(path)), mt)
    _assert_mesh_equal(mt, mj)
    tmesh.write_mfem_mesh(mt, str(tmp_path / "t.mesh"))
    assert (tmp_path / "t.mesh").read_bytes() == path.read_bytes()


def test_mfem_nodes_variant_and_simplex(tmp_path):
    """The `nodes` vertex variant of the reference's data files reads as
    in the JAX package; the quad reader refuses a triangle mesh, which
    `data.get_mesh` then reads as a `TriMesh`."""
    txt = """MFEM mesh v1.0

dimension
2

elements
1
1 3 0 1 2 3

boundary
2
1 1 0 1
2 1 2 3

vertices
4

nodes
FiniteElementSpace
FiniteElementCollection: Linear
VDim: 2
Ordering: 0

0 1 1 0
0 0 1 1
"""
    path = tmp_path / "n.mesh"
    path.write_text(txt)
    _assert_mesh_equal(tmesh.load_mfem_mesh(str(path)),
                       jmesh.load_mfem_mesh(str(path)))
    tri = tmp_path / "tri.mesh"
    tri.write_text(txt.replace("1 3 0 1 2 3", "1 2 0 1 2"))
    with pytest.raises(NotImplementedError, match="simplex"):
        tmesh.load_mfem_mesh(str(tri))
    m = tdata.get_mesh(str(tri))
    assert m.num_elems == 1 and m.elems.tolist() == [[0, 1, 2]]


NETGEN = """areamesh2

4
1 1 2
1 2 3
2 3 4
2 4 1

2
1 4 1 2 5 4
1 4 2 3 6 5

6
0.0 0.0
0.5 0.0
1.0 0.0
0.0 1.0
0.5 1.0
1.0 1.0
"""


def test_netgen_read_identically(tmp_path):
    path = tmp_path / "ng.mesh"
    path.write_text(NETGEN)
    mt = tdata.get_mesh(str(path))
    _assert_mesh_equal(mt, jdata.get_mesh(str(path)))
    assert mt.num_elems == 2 and mt.num_verts == 6


# --------------------------------------------------------- checkpoints --
def test_checkpoints_load_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    S = {"x": rng.normal(size=(2, 9)), "v": rng.normal(size=(2, 9)),
         "e": rng.normal(size=(4, 4))}
    jcheckpoint.save(str(tmp_path / "j.npz"),
                     {k: jnp.asarray(v) for k, v in S.items()}, 0.25,
                     1e-3, 7)
    St, t, dt, step = tcheckpoint.load(str(tmp_path / "j.npz"))
    assert (t, dt, step) == (0.25, 1e-3, 7)
    for k in S:
        np.testing.assert_array_equal(St[k].numpy(), S[k])
    tcheckpoint.save(str(tmp_path / "t.npz"), state_from_numpy(S), 0.5,
                     2e-3, 9)
    Sj, t, dt, step = jcheckpoint.load(str(tmp_path / "t.npz"))
    assert (t, dt, step) == (0.5, 2e-3, 9)
    for k in S:
        np.testing.assert_array_equal(np.asarray(Sj[k]), S[k])


@pytest.mark.parametrize("extra", [[], ["-fa"]])
def test_resume_is_bitwise(extra, tmp_path):
    """5 steps with --checkpoint, then --restore and 5 more, equal the
    uninterrupted 10 steps bit for bit (state, t, dt, step numbering)."""
    base = ["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "1", "-s", "7",
            "-vs", "5"] + extra
    ck = str(tmp_path / "ck.npz")
    full = cli.main(base + ["-ms", "9"]).result
    first = cli.main(base + ["-ms", "4", "--checkpoint", ck]).result
    assert first.steps == 5
    resumed = cli.main(base + ["-ms", "4", "--restore", ck]).result
    assert resumed.steps == full.steps == 10
    assert (resumed.t, resumed.dt) == (full.t, full.dt)
    assert sorted(resumed.norms) == [10]
    for k in ("x", "v", "e"):
        assert torch.equal(resumed.S[k], full.S[k]), k


# ---------------------------------------------------------------- VTU --
def _vtu_arrays(path):
    txt = open(path).read()
    out = {}
    for m in re.finditer(r'<DataArray ([^>]*)>\n(.*?)</DataArray>', txt,
                         re.S):
        name = re.search(r'Name="([^"]*)"', m.group(1))
        key = name.group(1) if name else "points"
        out[key] = np.array(m.group(2).split(), dtype=np.float64)
    head = re.search(r'NumberOfPoints="(\d+)" NumberOfCells="(\d+)"', txt)
    return out, (int(head.group(1)), int(head.group(2)))


@pytest.mark.parametrize("dim", [2, 3])
def test_vtu_matches_jax(dim, tmp_path):
    ht, hj, S = _pair(dim, 1, **GATHER)
    tio.write_vtu(str(tmp_path / "t.vtu"), ht, state_from_numpy(S))
    jio.write_vtu(str(tmp_path / "j.vtu"), hj,
                  {k: jnp.asarray(v) for k, v in S.items()})
    at, ct = _vtu_arrays(tmp_path / "t.vtu")
    aj, cj = _vtu_arrays(tmp_path / "j.vtu")
    assert ct == cj == (ht.NE * ht.nd1**dim, ht.NE * (ht.nd1 - 1)**dim)
    assert sorted(at) == sorted(aj)
    for k in at:
        assert _rel(at[k], aj[k]) <= 1e-13, k


def test_data_collection_files(tmp_path):
    ht, _, S = _pair(2, 1, **GATHER)
    dc = tio.DataCollection(str(tmp_path / "out" / "run"), ht)
    dc.save(0, 0.0, ht.S0)
    dc.save(5, 0.1, state_from_numpy(S))
    pvd = (tmp_path / "out" / "run.pvd").read_text()
    assert pvd.count("<DataSet") == 2 and "run_000005.vtu" in pvd
    z = np.load(tmp_path / "out" / "run_000005.npz")
    np.testing.assert_array_equal(z["e"], S["e"])
    assert float(z["t"]) == 0.1


# -------------------------------------------------------------- GLVis --
class _Capture(threading.Thread):
    """A local listener standing in for a GLVis server: records each
    connection's byte stream."""

    def __init__(self):
        super().__init__(daemon=True)
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(8)
        self.port = self.srv.getsockname()[1]
        self.streams = []
        self.lock = threading.Lock()

    def run(self):
        while True:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._drain, args=(conn,),
                             daemon=True).start()

    def _drain(self, conn):
        buf = b""
        conn.settimeout(5.0)
        try:
            while True:
                chunk = conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
        except OSError:
            pass
        with self.lock:
            self.streams.append(buf.decode())


def _glvis_streams(session_cls, h, S):
    cap = _Capture()
    cap.start()
    sess = session_cls(h, "127.0.0.1", cap.port)
    sess.step(S)
    sess.close()
    for _ in range(100):
        with cap.lock:
            if len(cap.streams) == 3:
                break
        time.sleep(0.05)
    cap.srv.close()
    assert len(cap.streams) == 3
    return {re.search(r"window_title '([^']*)'", s).group(1): s
            for s in cap.streams}


def _blocks(stream):
    """(mesh text with its nodes, grid function header, values, window
    commands)."""
    mesh, gf = stream.rsplit("FiniteElementSpace\n", 1)
    gf_head, rest = gf.split("\n\n", 1)
    vals, cmds = rest.split("window_title", 1)
    return mesh, gf_head, vals.split(), cmds


@pytest.mark.parametrize("dim,p", [(2, 2), (2, 3), (3, 2)])
def test_glvis_payloads_match_jax(dim, p):
    ht, hj, S = _pair(dim, 1, order_v=p, order_e=p - 1, **GATHER)
    st = _glvis_streams(tvis.GLVisSession, ht, state_from_numpy(S))
    sj = _glvis_streams(jvis.GLVisSession, hj,
                        {k: jnp.asarray(v) for k, v in S.items()})
    assert sorted(st) == sorted(sj) == ["Density",
                                        "Specific Internal Energy",
                                        "Velocity"]
    np.testing.assert_array_equal(tvis.mfem_h1_dofs(ht.h1),
                                  jvis.mfem_h1_dofs(hj.h1))
    for title in st:
        mt, gt, vt, ct = _blocks(st[title])
        mj, gj, vj, cj = _blocks(sj[title])
        assert mt == mj and gt == gj and ct == cj, title
        assert len(vt) == len(vj)
        if title == "Density":      # through compute_density
            assert _rel(np.array(vt, float), np.array(vj, float)) <= 1e-13
        else:
            assert vt == vj, title


def test_glvis_without_server_goes_on():
    """-vis with no server listening: the windows disable themselves and
    the run completes."""
    run = cli.main(["-d", "cpu", "-p", "1", "-dim", "2", "-rs", "0", "-ms",
                    "2", "-vis", "--glvis", "127.0.0.1:1"])
    assert run.result.steps == 3


# -------------------------------------------- Sedov, norms, metadata --
@pytest.mark.parametrize("dim", [2, 3])
def test_sedov_solution_matches_jax(dim):
    st = tsedov.SedovSolution(dim, 1.4, 1.0, 1.0)
    sj = jsedov.SedovSolution(dim, 1.4, 1.0, 1.0)
    assert st.alpha == pytest.approx(sj.alpha, rel=1e-12)
    st.set_time(0.6)
    sj.set_time(0.6)
    r = np.linspace(0.0, 1.2, 97)
    for a, b in zip(st.eval(r), sj.eval(r)):
        assert _rel(a, b) <= 1e-12


def test_sedov_density_error_matches_jax():
    ht, hj, S = _pair(3, 1, **GATHER)
    et = tsedov.sedov_density_l2_error(ht, state_from_numpy(S), 0.1, 1.0)
    ej = jsedov.sedov_density_l2_error(
        hj, {k: jnp.asarray(v) for k, v in S.items()}, 0.1, 1.0)
    assert et == pytest.approx(ej, rel=1e-12)


@pytest.mark.parametrize("dim,problem", [(2, 0), (3, 0), (2, 4)])
def test_velocity_error_norms_match_jax(dim, problem):
    ht, hj, S = _pair(dim, problem, **GATHER)
    nt = tverify.velocity_error_norms(ht, state_from_numpy(S))
    nj = jverify.velocity_error_norms(
        hj, {k: jnp.asarray(v) for k, v in S.items()})
    for a, b in zip(nt, nj):
        assert a == pytest.approx(b, rel=1e-13)


def test_run_metadata_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run = cli.main(["-d", "cpu", "-p", "1", "-dim", "2", "-rs", "0", "-ms",
                    "2", "-f"])
    meta = json.loads((tmp_path / "laghos_run_metadata.json").read_text())
    for key in ("launchdate", "cmdline", "python", "torch_version",
                "device", "config", "options", "fom", "NE", "steps",
                "t_final", "e_norm"):
        assert key in meta, key
    assert meta["steps"] == run.result.steps
    assert meta["options"]["p_assembly"] is True
    assert set(meta["fom"]) >= {"FOM", "FOM1", "FOM2", "FOM3"}
    assert ttiming.run_metadata()["torch_version"] == torch.__version__


# --------------------------------------------------------------- CLI --
_SMALL = ["-d", "cpu", "-p", "1", "-rs", "0", "-ms", "2"]
FLAG_CASES = {
    "nx-ny-nz": ["-dim", "3", "-nx", "3", "-ny", "2", "-nz", "2"],
    "Sx-Sy-Sz": ["-dim", "3", "-Sx", "2", "-Sy", "1", "-Sz", "1"],
    "ftz": ["-dim", "2", "-ftz", "1e-9"],
    "dtol": ["-dim", "2", "-dtol", "1e-10"],
    "fa-2d": ["-dim", "2", "-fa"],
    "fa-3d": ["-dim", "3", "-fa"],
    "fa-f32": ["-dim", "2", "-fa", "--dtype", "f32"],
    # Sod repeats its first steps: 11 attempts give a few accepted ones
    "dim1": ["-dim", "1", "-nx", "8", "-p", "2", "-ms", "10"],
    "dim1-f32": ["-dim", "1", "-nx", "8", "-p", "2", "-ms", "10",
                 "--dtype", "f32"],
    "iv": ["-dim", "2", "-p", "4", "-iv"],
    "mesh-file": None,
    "mb": ["-dim", "2", "-mb"],
    "err": ["-dim", "3", "-err"],
    "debug-nans": ["-dim", "3", "--debug-nans"],
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_cli_ported_flags_run(case, tmp_path, capsys):
    argv = FLAG_CASES[case]
    if argv is None:
        path = tmp_path / "sq.mesh"
        tmesh.write_mfem_mesh(tdata.get_mesh("square01_quad"), str(path))
        argv = ["-m", str(path)]
    run = cli.main(_SMALL + argv)
    out = capsys.readouterr().out
    h, res = run.hydro, run.result
    assert res.steps >= 3 and np.isfinite(res.e_norm)
    if case == "nx-ny-nz":
        assert h.NE == 12
    if case == "Sx-Sy-Sz":
        assert float(h.S0["x"][0].max()) == 2.0
    if case.startswith(("fa", "dim1")):
        assert not h.p_assembly and h._lat is None
        assert h._h1_csr.values().dtype == h.dtype
    if case.endswith("f32"):
        assert h.dtype == torch.float32
        assert res.S["v"].dtype == torch.float32
    if case.startswith("dim1"):
        assert h.dim == 1 and h.NE == 8
    if case == "iv":
        assert h.use_visc
    if case == "mb":
        assert "Maximum memory resident set size" in out
    if case == "err":
        err = float(re.search(r"Density L2 error: (\S+)", out).group(1))
        assert np.isfinite(err) and err > 0
    if case == "debug-nans":
        assert h.debug_nans


def test_cli_output_flags(tmp_path):
    """-visit -print -k write the VTU/PVD/NPZ series at every vis step;
    --profile writes a trace; p0 prints the velocity error norms."""
    base = str(tmp_path / "out" / "sedov")
    run = cli.main(_SMALL + ["-dim", "2", "-vs", "1", "-visit", "-print",
                             "-k", base, "--profile",
                             str(tmp_path / "prof")])
    n = run.result.steps
    assert (tmp_path / "out" / "sedov.pvd").read_text().count(
        "<DataSet") == n + 1
    arrays, counts = _vtu_arrays(f"{base}_{n:06d}.vtu")
    h = run.hydro
    assert counts == (h.NE * h.nd1**2, h.NE * (h.nd1 - 1)**2)
    assert arrays["density"].size == counts[0]
    z = np.load(f"{base}_{n:06d}.npz")
    np.testing.assert_array_equal(z["e"], run.result.S["e"].numpy())
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


def test_cli_prints_velocity_norms(capsys):
    cli.main(["-d", "cpu", "-p", "0", "-dim", "2", "-rs", "0", "-ms", "2"])
    out = capsys.readouterr().out
    for name in ("L_inf", "L_1  ", "L_2  "):
        assert re.search(name + r"\s+error: \S+", out), name


@pytest.mark.parametrize("phase", ["q-update", "force F^T.v"])
def test_debug_nans_names_the_phase(phase, monkeypatch):
    """A NaN injected into the state stops the run at the q-update; one
    injected into the element force transpose, at the F^T.v phase; the
    message names the phase and the step."""
    from laghos_tpu_torch.ops import force as tforce

    h = THydro(tmesh.cartesian(2, (2, 2), (1.0, 1.0)),
               TOptions(problem=1, **GATHER), device="cpu")
    h.debug_nans = True
    if phase == "q-update":
        h.S0["e"][1, 2] = float("nan")
    else:
        real = tforce.force_mult_transpose

        def poisoned(*args, **kw):
            out = real(*args, **kw)
            out[0, 0] = float("nan")
            return out
        monkeypatch.setattr(tforce, "force_mult_transpose", poisoned)
    with pytest.raises(FloatingPointError,
                       match=re.escape(f"after the {phase} at step 1")):
        driver.run(h, t_final=0.6, max_steps=3)
