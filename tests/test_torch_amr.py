"""The port's AMR variant (`laghos_tpu_torch.amr`) against the JAX package
(`laghos_tpu.amr`) on the CPU.

Tolerances: forest leaf lists and the hanging-node spaces (gather, node
partition, masters, weights, essential masks) exactly; transfers of
polynomials 1e-12; the q-update and one RK step (RK2, RK4, RK6) from a
perturbed state at 1e-12; the P / P^T gathers at 1e-14; a 2D trajectory
with refinements and derefinements equal in its events and NE with |e| at
1e-10; BASELINE AMR row 1's 60-attempt prefix against the JAX package's
pinned 51 steps / NE 70 / |e| 390.4794540789 (rel 1e-8); resumes bit for
bit within the port and at 1e-12 across the packages; the CLI's -amr step
lines equal in step, t and dt and at 1e-10 in |e|.  The JAX runs sit in
module-scoped fixtures: each JAX AMRHydro compiles its step on first use.
"""

import contextlib
import io
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import cli as jcli
from laghos_tpu.amr import driver as jdrv
from laghos_tpu.amr.forest import Forest as JForest
from laghos_tpu.amr.solver import AMRHydro as JAMRHydro
from laghos_tpu.amr.transfer import (H1Transfer as JH1, L2Transfer as JL2,
                                     TransferPlan as JPlan)
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import cli
from laghos_tpu_torch.amr import driver as tdrv
from laghos_tpu_torch.amr.forest import Forest
from laghos_tpu_torch.amr.solver import AMRHydro
from laghos_tpu_torch.amr.transfer import H1Transfer, L2Transfer, TransferPlan
from laghos_tpu_torch.hydro import Options

torch.set_num_threads(1)

ROW1 = dict(problem=1, blast_energy=0.25, order_v=2, order_e=1, cg_tol=1e-8)
# the 2D trajectory: one uniform refinement, max depth 3, derefinement at
# 0.9 of the max density, so that 25 attempts refine and derefine; its
# velocity CG converges to 1e-12, so that the two packages' iterates agree
# to round-off (at -cgt 1e-8 their stops differ by an iteration or two)
TRAJ = dict(ROW1, cg_tol=1e-12, cg_max_iter=2000)
TRAJ_DEREF = 0.9
TRAJ_ATTEMPTS = 24          # max_steps: 25 attempts


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _graded(F, dim, levels, max_depth=None):
    """RefineAtVertex at the origin corner `levels` times, no balancing
    (the CLI's initial AMR mesh: non-2:1 grading)."""
    f = F(dim, (2,) * dim, (1.0,) * dim, max_depth=max_depth or levels)
    for _ in range(levels):
        corner = [k for k in f.leaf_list() if all(v == 0 for v in k[1])]
        f.refine(corner, balance=False)
    return f


def _traj_forest(F):
    f = F(2, (2, 2), (1.0, 1.0), max_depth=3)
    f.refine(list(f.leaf_list()))
    return f


def _jstate(h):
    """(xT, vT, e) of a JAX AMRHydro, unpadded NumPy."""
    return (np.asarray(h.state["x"])[:, :h.nt],
            np.asarray(h.state["v"])[:, :h.nt],
            np.asarray(h.state["e"])[:h.NE])


def _tstate(h):
    return tuple(h.state[k].numpy() for k in ("x", "v", "e"))


# ---------------------------------------------------------------- forest --
def test_forest_refine_balance_derefine_match_jax():
    for F in (Forest, JForest):
        f = F(2, (2, 2), (1.0, 1.0), max_depth=3)
        f.refine([(0, (0, 0))])
        f.refine([(1, (0, 0))])
        f.refine([(2, (0, 0))])
        assert f.balance_violations(1) == []
    a, b = Forest(3, (2, 2, 2), (1.0,) * 3, 3), JForest(3, (2, 2, 2),
                                                        (1.0,) * 3, 3)
    for f in (a, b):
        f.refine([(0, (0, 0, 0))])
        f.refine([(1, (0, 0, 0))], balance=False)
        f.refine([(2, (1, 1, 1))], balance=False)
    assert a.leaf_list() == b.leaf_list()
    assert a.balance_violations(1) == b.balance_violations(1) != []
    for f in (a, b):
        while f.balance_violations(1):
            f.refine(f.balance_violations(1))
        f.derefine([k for k in f.leaf_list() if k[0] == 3])
    assert a.leaf_list() == b.leaf_list()
    assert a.num_leaves == b.num_leaves
    f = Forest(2, (2, 2), (1.0, 1.0), max_depth=2)
    f.refine([(0, (1, 1))])
    assert f.num_leaves == 7
    f.derefine([k for k in f.leaf_list() if k[0] == 1])
    assert f.num_leaves == 4


@pytest.mark.parametrize("dim,order", [(2, 2), (2, 3), (3, 2), (3, 3)])
def test_build_space_matches_jax(dim, order):
    """The hanging-node space of a graded, non-2:1 forest equal to the JAX
    package's (its native unify_rows against the port's NumPy one), its
    constraint weights a partition of unity, and P exact on a degree-p
    tensor polynomial."""
    a = _graded(Forest, dim, 3).build_space(order)
    b = _graded(JForest, dim, 3).build_space(order)
    assert a.keys() == b.keys()
    for k in ("gather", "true_ids", "slave_ids", "masters", "weights",
              "t_of_n", "ess", "nn"):
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert _rel(a["coords"], b["coords"]) <= 1e-15
    assert a["slave_ids"].size
    assert np.allclose(a["weights"].sum(axis=1), 1.0, atol=1e-12)
    X = a["coords"]
    poly = np.prod([(1.0 + 0.3 * (k + 1) * X[:, k]) ** order
                    for k in range(dim)], axis=0)
    sv = np.einsum("sw,sw->s", poly[a["true_ids"]][a["masters"]],
                   a["weights"])
    assert np.allclose(sv, poly[a["slave_ids"]], atol=1e-11)


def test_transfer_matches_jax_and_blast_integral():
    """Refinement embeds exactly (|x| and the energy integral preserved,
    x the identity on the new nodes), the delta blast integrates to 0.25
    (undivided, amr/laghos.cpp:417-421), and the H1 / L2 transfers of a
    refine then a derefine equal the JAX package's at 1e-12."""
    opt = Options(**ROW1)
    h = AMRHydro(Forest(2, (2, 2), (1.0, 1.0), max_depth=2), opt,
                 device="cpu")

    def total_ie(h):
        e = h.state["e"].reshape((h.NE,) + (h.l1d,) * h.dim)
        from laghos_tpu_torch.ops import tensor as top

        eq = top.eval_values(e, h.tables["L2B"], h.dim).reshape(h.NE, -1)
        return float((h.ctx["rho0DetJ0w"] * eq).sum())

    ie0 = total_ie(h)
    assert np.isclose(ie0, 0.25, rtol=1e-12)
    h.apply_amr(refine_keys=[k for k in h.forest.leaf_list()
                             if k[1] == (0, 0)])
    assert np.isclose(total_ie(h), ie0, rtol=1e-12)
    sp = h.space
    assert np.allclose(h.state["x"].numpy().T, sp["coords"][sp["true_ids"]],
                       atol=1e-12)

    rng = np.random.default_rng(3)
    for dim, p in ((2, 2), (3, 2), (2, 3)):
        old = _graded(Forest, dim, 2, 3).leaf_list()
        f = _graded(Forest, dim, 2, 3)
        f.derefine([k for k in f.leaf_list() if k[0] == 2])
        f.refine([old[0]])
        new = f.leaf_list()
        plan, jplan = TransferPlan(old, new, dim), JPlan(old, new, dim)
        assert plan.entries == jplan.entries
        assert {e[0] for e in plan.entries} == {0, 1, 2}
        xe = rng.normal(size=(dim, len(old), (p + 1) ** dim))
        ee = rng.normal(size=(len(old), p ** dim))
        assert _rel(H1Transfer(p, dim).element_values(plan, xe),
                    JH1(p, dim).element_values(jplan, xe)) <= 1e-12
        assert _rel(L2Transfer(p - 1, dim).element_values(plan, ee),
                    JL2(p - 1, dim).element_values(jplan, ee)) <= 1e-12


# ---------------------------------------------------- operators vs JAX --
def _perturbed_pair(ode_solver, seed=0):
    """A graded 3D forest (RefineAtVertex once, then a 2:1 refinement of
    the finest far leaf), in both packages, with the same perturbed state.
    The velocity CG runs to convergence at 1e-12 (186 iterations): at
    -cgt 1e-8 the two packages' round-off (dot products summed in other
    orders) moves its stop by an iteration or two, and so its iterate by
    ~1e-8."""
    opt = dict(ROW1, ode_solver=ode_solver, cg_tol=1e-12, cg_max_iter=2000)
    fj, ft = _graded(JForest, 3, 1, 3), _graded(Forest, 3, 1, 3)
    for f in (fj, ft):
        f.refine([f.leaf_list()[-1]])
    hj = JAMRHydro(fj, JOptions(**opt), h0=0.25)
    ht = AMRHydro(ft, Options(**opt), h0=0.25, device="cpu")
    rng = np.random.default_rng(seed)
    xT, vT, e = _jstate(hj)
    xT = xT + 1e-3 * rng.normal(size=xT.shape)
    vT = 0.3 * rng.normal(size=vT.shape)
    vT[hj.space["ess"][:, hj.space["true_ids"]]] = 0.0
    e = e + 1.0 + rng.uniform(size=e.shape)
    hj.state = hj.pad_state(xT, vT, e)
    ht.state = ht.make_state(xT, vT, e)
    return hj, ht


@pytest.fixture(scope="module")
def rk_pairs():
    """{ode_solver: (JAX hydro, JAX result of one advance, port hydro,
    dt)}.  The three JAX steps compile in parallel threads (XLA compiles
    without the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    def one(s):
        hj, ht = _perturbed_pair(s)
        _, dtj, _ = hj._qupdate(hj.ctx, hj.state)
        dt = 0.5 * float(dtj)
        Sj, dtej, vj, _ = hj.advance(hj.state, dt, True)
        res = ({k: np.asarray(Sj[k]) for k in Sj}, float(dtej),
               np.asarray(vj)[:hj.NE])
        return s, (hj, res, ht, dt)

    with ThreadPoolExecutor(3) as pool:
        return dict(pool.map(one, (6, 4, 2)))


def test_qupdate_and_gathers_match_jax(rk_pairs):
    """amr_qupdate (stress, dt estimate, zone-max viscosity) at 1e-12,
    and P / P^T as gathers against the JAX package's set/scatter-add
    versions at 1e-14."""
    hj, _, ht, _ = rk_pairs[4]
    sj, dtj, vj = hj._qupdate(hj.ctx, hj.state)
    st, dtt, vt = ht.qupdate(ht.state)
    assert ht.space["slave_ids"].size and ht.ctx["pt_idx"].shape[1]
    assert _rel(st.numpy(), np.asarray(sj)[:hj.NE]) <= 1e-12
    assert abs(float(dtt) - float(dtj)) <= 1e-12 * float(dtj)
    assert _rel(vt.numpy(), np.asarray(vj)[:hj.NE]) <= 1e-12
    rng = np.random.default_rng(1)
    u = rng.normal(size=(3, ht.nt))
    up = np.zeros((3, hj.cap_nt))
    up[:, :ht.nt] = u
    pj = np.asarray(hj._p_apply(hj.ctx, jnp.asarray(up)))[:, :ht.nn]
    assert _rel(ht._p_apply(torch.tensor(u)).numpy(), pj) <= 1e-14
    y = rng.normal(size=(3, ht.nn))
    yp = np.zeros((3, hj.cap_nn))
    yp[:, :ht.nn] = y
    qj = np.asarray(hj._pT_apply(hj.ctx, jnp.asarray(yp)))[:, :ht.nt]
    assert _rel(ht._pT_apply(torch.tensor(y)).numpy(), qj) <= 1e-14


def test_indicators_match_jax(rk_pairs):
    """The refinement indicators the driver reads, computed on the
    state's device in the port and on the host in the JAX package: min
    and max |v| at the Gauss points, the projected density and its zone
    max at 1e-12, the blast-vertex elements equal, and `indicators`
    carrying the same values in one copy."""
    hj, _, ht, _ = rk_pairs[4]
    Sj, St = hj.state, ht.state
    for a, b in zip(ht.v_min_max(St), hj.v_min_max(Sj)):
        assert _rel(a.numpy(), b) <= 1e-12
    assert _rel(ht.compute_density(St).numpy(),
                hj.compute_density(Sj)) <= 1e-12
    assert _rel(ht.rho_max(St).numpy(), hj.rho_max(Sj)) <= 1e-12
    for size in (0.01, 0.3):
        near = ht.elements_with_vertex(St, (0.0, 0.0, 0.0), size)
        assert near.size and np.array_equal(
            near, hj.elements_with_vertex(Sj, (0.0, 0.0, 0.0), size))
    visc = ht.qupdate(St)[2]
    ind = ht.indicators(St, visc, (0.0, 0.0, 0.0), 0.01)
    assert np.array_equal(ind["est"], visc.numpy())
    assert np.array_equal(ind["v_min"], ht.v_min_max(St)[0].numpy())
    assert np.array_equal(ind["rho_max"], ht.rho_max(St).numpy())
    assert np.array_equal(np.where(ind["near_blast"])[0],
                          ht.elements_with_vertex(St, (0.0, 0.0, 0.0),
                                                  0.01))
    assert abs(ind["e_norm"] - hj.e_norm()) <= 1e-14 * hj.e_norm()


@pytest.mark.parametrize("ode_solver", [2, 4, 6])
def test_advance_matches_jax(rk_pairs, ode_solver):
    """One RK step from the perturbed state (count_stage1 on) at 1e-12:
    the state, the dt estimate and the viscosity estimator."""
    hj, (Sj, dtj, vj), ht, dt = rk_pairs[ode_solver]
    S, dte, visc, it = ht.advance(ht.state, dt, True)
    assert int(it) > 0
    assert _rel(S["x"].numpy(), Sj["x"][:, :ht.nt]) <= 1e-12
    assert _rel(S["v"].numpy(), Sj["v"][:, :ht.nt]) <= 1e-12
    assert _rel(S["e"].numpy(), Sj["e"][:ht.NE]) <= 1e-12
    assert abs(float(dte) - dtj) <= 1e-12 * dtj
    assert _rel(visc.numpy(), vj) <= 1e-12


def test_amr_hydro_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        AMRHydro(Forest(2, (2, 2), (1.0, 1.0), 1), Options(**ROW1))


# ---------------------------------------------------------- trajectories --
@pytest.fixture(scope="module")
def jax_traj():
    """The JAX package's 2D trajectory, and a checkpoint it wrote at
    attempt 12 (with its continuation to attempt 25)."""
    tr = []
    res = jdrv.run_amr(JAMRHydro(_traj_forest(JForest), JOptions(**TRAJ),
                                 h0=0.25),
                       t_final=0.8, max_steps=TRAJ_ATTEMPTS, vis_steps=5,
                       deref_threshold=TRAJ_DEREF, trace=tr)
    return res, tr


def _traj_port(**kw):
    tr = kw.pop("trace", [])
    h = kw.pop("hydro", None) or AMRHydro(_traj_forest(Forest),
                                          Options(**TRAJ), h0=0.25,
                                          device="cpu")
    res = tdrv.run_amr(h, t_final=0.8, vis_steps=5,
                       deref_threshold=TRAJ_DEREF, trace=tr,
                       **{"max_steps": TRAJ_ATTEMPTS, **kw})
    return res, tr, h


def test_trajectory_matches_jax(jax_traj):
    """25 attempts with refinements and derefinements: the same records
    (events, steps, NE, refine/derefine counts, t and dt at 1e-12) and |e|
    at 1e-10 at every step."""
    rj, tj = jax_traj
    rt, tt, _ = _traj_port()
    assert len(tt) == len(tj)
    assert any(r.get("n_deref") for r in tt if r.get("changed"))
    assert any(r.get("n_ref") for r in tt if r.get("changed"))
    for a, b in zip(tt, tj):
        assert a.keys() == b.keys()
        for k in a:
            if k in ("t", "dt", "e_norm"):
                tol = 1e-10 if k == "e_norm" else 1e-12
                assert abs(a[k] - b[k]) <= tol * abs(b[k]), (a, b)
            else:
                assert a[k] == b[k], (a, b)
    assert (rt["steps"], rt["NE"]) == (rj["steps"], rj["NE"])
    assert rt["norms"].keys() == rj["norms"].keys()
    assert abs(rt["e_norm"] - rj["e_norm"]) <= 1e-10 * rj["e_norm"]


def test_row1_prefix_pinned():
    """BASELINE AMR row 1 (2D square01_quad, rs4, Q2-Q1, -cgt 1e-8), its
    first 60 attempts: the JAX package's pinned trajectory
    (tests/test_amr.py::test_amr_golden_row1_prefix)."""
    h = AMRHydro(_graded(Forest, 2, 4), Options(**ROW1), h0=0.25,
                 device="cpu")
    assert h.NE == 16
    res = tdrv.run_amr(h, t_final=0.8, ref_threshold=2e-4, max_steps=60,
                       vis_steps=1000)
    assert res["steps"] == 51
    assert res["NE"] == 70
    assert np.isclose(res["e_norm"], 390.4794540789, rtol=1e-8)


def test_checkpoint_resume_bit_identical(tmp_path):
    """A run stopped at attempt 12 with a checkpoint and resumed repeats
    the straight 25-attempt run bit for bit: the trace, the state."""
    ra, ta, ha = _traj_port()
    cpath = str(tmp_path / "ck.pkl")
    _traj_port(max_steps=12, ckpt_path=cpath, ckpt_every=5)
    ck = tdrv.load_checkpoint(cpath)
    h2 = tdrv.resume_amr_hydro(ck, Options(**TRAJ), device="cpu")
    rb, tb, hb = _traj_port(hydro=h2, trace=list(ck["trace"]), resume=ck)
    assert (rb["steps"], rb["NE"], rb["e_norm"]) == (ra["steps"], ra["NE"],
                                                     ra["e_norm"])
    assert tb == ta
    for k in ("x", "v", "e"):
        assert torch.equal(ha.state[k], hb.state[k])


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint written by the JAX package at attempt 12, resumed by
    the port, continues as the JAX package's own resume does (state and
    trace at 1e-12); the port's checkpoint, read back by the JAX package,
    holds the port's state and resumes there too."""
    jpath = str(tmp_path / "jax.pkl")
    jdrv.run_amr(JAMRHydro(_traj_forest(JForest), JOptions(**TRAJ),
                           h0=0.25),
                 t_final=0.8, max_steps=12, vis_steps=5,
                 deref_threshold=TRAJ_DEREF, trace=[], ckpt_path=jpath)
    ck = jdrv.load_checkpoint(jpath)
    hj = jdrv.resume_amr_hydro(ck, JOptions(**TRAJ))
    trj = list(ck["trace"])
    rj = jdrv.run_amr(hj, t_final=0.8, max_steps=TRAJ_ATTEMPTS,
                      vis_steps=5, deref_threshold=TRAJ_DEREF, trace=trj,
                      resume=ck)
    ht = tdrv.resume_amr_hydro(ck, Options(**TRAJ), device="cpu")
    assert [np.array_equal(a, b) for a, b in zip(_tstate(ht), _jstate(
        jdrv.resume_amr_hydro(ck, JOptions(**TRAJ))))] == [True] * 3
    rt, trt, _ = _traj_port(hydro=ht, trace=list(ck["trace"]), resume=ck)
    assert (rt["steps"], rt["NE"]) == (rj["steps"], rj["NE"])
    assert [r["NE"] for r in trt] == [r["NE"] for r in trj]
    for a, b in zip(_tstate(ht), _jstate(hj)):
        assert _rel(a, b) <= 1e-12
    assert abs(rt["e_norm"] - rj["e_norm"]) <= 1e-12 * rj["e_norm"]

    tpath = str(tmp_path / "port.pkl")
    tdrv.save_checkpoint(tpath, ht, rt["t"], rt["dt"], 99, rt["steps"] + 1,
                         True, rt["norms"], trt)
    ck2 = jdrv.load_checkpoint(tpath)
    back = jdrv.resume_amr_hydro(ck2, JOptions(**TRAJ))
    for a, b in zip(_tstate(ht), _jstate(back)):
        assert np.array_equal(a, b)
    assert back.forest.leaf_list() == ht.forest.leaf_list()
    assert back._h0 == ht._h0 and np.array_equal(back.x0_T, ht.x0_T)


# ------------------------------------------------------------------- CLI --
_LINE = re.compile(r"step\s+(\d+),\s+t = ([\d.]+),\s+dt = ([\d.]+),\s+"
                   r"\|e\| = ([\deE+.-]+)\s+NE=(\d+)")


def _cli_lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    return out, [m.groups() for m in _LINE.finditer(out)]


def test_cli_amr_matches_jax():
    """`-amr` through both CLIs (square01_quad, rs2, 12 attempts): the
    zone count line, the step lines equal in step, t, dt and NE, |e| at
    1e-10, and the refinement lines."""
    argv = ["-p", "1", "-m", "square01_quad", "-rs", "2", "-tf", "0.8",
            "-amr", "-ms", "11", "-vs", "2"]
    ot, lt = _cli_lines(cli.main, ["-d", "cpu"] + argv)
    oj, lj = _cli_lines(jcli.main, ["--device", "cpu"] + argv)
    assert "Number of zones in the initial AMR mesh: 10" in ot
    assert len(lt) == len(lj) >= 4
    for a, b in zip(lt, lj):
        assert (a[0], a[1], a[2], a[4]) == (b[0], b[1], b[2], b[4])
        assert abs(float(a[3]) - float(b[3])) <= 1e-10 * float(b[3])
    assert ([s for s in ot.splitlines() if s.startswith("Refined")]
            == [s for s in oj.splitlines() if s.startswith("Refined")])
