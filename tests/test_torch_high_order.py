"""The port at high order, Q8-Q7 (the JAX package's `q8` row, BASELINE
configs[2]), against the JAX package on the CPU, at NE 8 (cube01_hex,
`-dim 3 -rs 0`): rule order 30, 16 Gauss points an axis, NQ 4,096 a zone.

Tolerances, each stated at its test:
* static arrays, operators on one state, Taylor-Green steps: the same
  arithmetic summed in another order (torch against XLA), 1e-12 to 1e-10;
* Sedov under partial assembly: the L2 (energy) CG stops at its
  `cg_max_iter` cap far from convergence at this order, so the two
  packages' round-off is amplified by the conditioning of the L2 mass
  (see `test_sedov_q8_pa_matches_jax`);
* Sedov under full assembly: the inverted element L2 masses carry the
  same conditioning (see `test_sedov_q8_fa_matches_jax`).

About 2 minutes in one process on an 8-core x86-64 CPU, most of it the
JAX package's full-assembly build and its first compiles.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu import driver as jdriver
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.ops import lattice as jlat
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch import driver as tdriver
from laghos_tpu_torch.fem import quadrature as tquad
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import (hydro_arrays, lattice_arrays,
                                      state_from_numpy, state_to_numpy)
from laghos_tpu_torch.ops import kernels
from laghos_tpu_torch.ops import lattice as tlat
from laghos_tpu_torch.ops import mass as tmass

torch.set_num_threads(1)

Q8 = dict(order_v=8, order_e=7, ode_solver=7, cg_tol=1e-11,
          precond="jacobi")
GATHER = dict(structured_el=False, lattice_ops=False)
_PAIRS = {}


def _pair(problem, **kw):
    """(port Hydro, JAX Hydro) at Q8-Q7 on cube01_hex (NE 8), built once
    per module."""
    key = (problem, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        opt = dict(Q8, problem=problem, **kw)
        _PAIRS[key] = (THydro(tdata.get_mesh("cube01_hex"), TOptions(**opt),
                              device="cpu"),
                       JHydro(jdata.get_mesh("cube01_hex"), JOptions(**opt)))
    return _PAIRS[key]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _state(ht, hj, seed):
    """The t=0 state with x and v perturbed from a numpy seed (v zero on
    the essential dofs) and e shifted, so the viscous branch and every
    term of the force are active."""
    rng = np.random.default_rng(seed)
    S0 = {k: np.asarray(v) for k, v in hj.S0.items()}
    return {"x": S0["x"] + 0.002 * rng.normal(size=S0["x"].shape),
            "v": np.where(ht.ess_mask, 0.0,
                          0.1 * rng.normal(size=S0["v"].shape)),
            "e": S0["e"] + 0.5}


# ------------------------------------------------------------ sizes -----
def test_q8_sizes_and_tables_match_jax():
    """Rule order 3*8 + 7 - 1 = 30 gives 16 Gauss points an axis; GL H1 at
    9 nodes, Bernstein L2 at 8; lattices 17^3 and 32^3 at NE 8; the
    tables bit for bit."""
    assert tquad.default_rule_order(8, 7, -1) == 30
    assert tquad.points_for_order(30) == 16
    ht, hj = _pair(1)
    assert (ht.nq1, ht.NQ, ht.nd1, ht.l1d, ht.ld) == (16, 4096, 9, 8, 512)
    assert (ht.NE, ht.ndof) == (8, 17 ** 3) == (hj.NE, hj.ndof)
    assert ht._lat_dims == tuple(hj._lat_dims) == (17, 17, 17)
    assert ht._lat["rw"].shape == (32, 32, 32)
    for k in ("H1B", "H1G", "L2B", "W"):
        np.testing.assert_array_equal(ht.tables[k].numpy(),
                                      np.asarray(hj.tables[k]))


# ----------------------------------------------------- static arrays ----
@pytest.mark.parametrize("problem", [0, 1])
def test_q8_static_arrays_match_jax(problem):
    """rho0DetJ0w, Jac0inv, h0, the Jacobi diagonal and the per-axis kron
    factors (each package's `build_kron_precond` on its own lattice data)
    at 1e-12; the gather map and essential masks bit for bit."""
    ht, hj = _pair(problem)
    a = hydro_arrays(ht)
    np.testing.assert_array_equal(a["ess_mask"], hj.ess_mask)
    for k in ("rho0DetJ0w", "Jac0inv", "massD", "h1_dinv"):
        assert _rel(a[k], getattr(hj, k)) <= 1e-12, k
    assert ht.h0 == pytest.approx(float(hj.h0), rel=1e-12)
    lt, lj = lattice_arrays(ht), hj._lat
    for k in ("Dq", "rw", "J0i9"):
        ref = np.stack(lj[k]) if k == "J0i9" else np.asarray(lj[k])
        assert _rel(lt[k], ref) <= 1e-12, k
    kt, et = tlat.build_kron_precond(np.asarray(ht.ess_mask, bool),
                                     ht._lat_dims, lt["Dq"], lt["Ts"])
    kj, ej = jlat.build_kron_precond(
        np.asarray(hj.ess_mask, bool), tuple(hj._lat_dims),
        np.asarray(lj["Dq"]), tuple(np.asarray(T) for T in lj["Ts"]))
    assert len(kt) == len(kj) == 3
    for x, y in zip(kt, kj):
        assert x.shape == (3, 17, 17) and _rel(x, y) <= 1e-12
    assert et == pytest.approx(ej, abs=1e-12) and et < 1e-10


# ------------------------------------------- operators on one state -----
@pytest.mark.parametrize("path", ["lattice", "gather"])
def test_q8_qupdate_and_force_pair_match_jax(path):
    """The q-update (sJit and the dt estimate), F.1 and F^T.v of Sedov on
    one perturbed state, on the whole-lattice path and on the gather path
    (the element layout), at 1e-12 against the JAX package's."""
    ht, hj = _pair(1, **(GATHER if path == "gather" else {}))
    assert (ht._lat is None) == (path == "gather") == (hj._lat is None)
    S = _state(ht, hj, 8)
    St = state_from_numpy(S, device="cpu")
    Sj = {k: jnp.asarray(v) for k, v in S.items()}
    s_t, d_t = ht._qupdate(St)
    s_j, d_j = hj._jq(Sj)
    assert _rel(s_t.numpy(), np.stack(s_j)) <= 1e-12
    assert float(d_t) == pytest.approx(float(d_j), rel=1e-12)
    assert _rel(ht._force_rhs_raw(s_t).numpy(), hj._jforce1(s_j)) <= 1e-12
    assert _rel(ht._force_transpose(s_t, St["v"]).numpy(),
                hj._jfT(s_j, Sj["v"])) <= 1e-12


@pytest.mark.parametrize("path", ["lattice", "gather"])
def test_q8_mass_applies_match_jax(path):
    """The H1 mass apply with its essential-dof elimination (banded on the
    lattice, element applies and the incidence gather elsewhere) and the
    L2 mass apply (8^3 Bernstein dofs to 16^3 points and back) on seeded
    vectors, at 1e-12."""
    ht, hj = _pair(1, **(GATHER if path == "gather" else {}))
    rng = np.random.default_rng(3)
    u = rng.normal(size=(3, ht.ndof))
    assert _rel(ht._h1_apply_bc(_t(u)).numpy(),
                jax.jit(hj._h1_apply_bc)(jnp.asarray(u))) <= 1e-12
    from laghos_tpu.ops import mass as jmass

    e = rng.normal(size=(ht.NE, ht.ld))
    y_t = tmass.mass_apply_e(_t(e), ht.massD, ht.tables["L2B"], 3)
    y_j = jax.jit(lambda x: jmass.mass_apply_e(
        x, hj.massD, hj.tables["L2B"], 3))(jnp.asarray(e))
    assert y_t.shape == (8, 512) and _rel(y_t.numpy(), y_j) <= 1e-12


# ------------------------------------------------- Taylor-Green steps ---
def _energy(h, S):
    ie, ke = h.energies(S)
    return float(ie) + float(ke)


def test_taylor_green_q8_steps_match_jax():
    """3D Taylor-Green (`-p 0`), the well-conditioned high-order form: 3
    memoized `advance` steps of RK2Avg at `cg_tol` 1e-11.  x and v at 1e-11,
    the dt estimates at 1e-12, H1 counts equal, L2 counts within 2 (the
    reason is `test_torch_lattice.test_q4q3_lattice_step_matches_jax`'s;
    here the L2 CG meets its 300 cap in both), total-energy drift <= 1e-12
    in both, |e| at 1e-10.  The e field: measured 3.3e-12 of max|e| after
    3 steps on an x86-64 CPU (torch 2.13, JAX 0.9; the capped L2 solve
    passes the packages' round-off through to it, smoothly); bound
    1e-11."""
    ht, hj = _pair(0)
    S = {k: np.asarray(v) for k, v in hj.S0.items()}
    St = state_from_numpy(S, device="cpu")
    Sj = {k: jnp.asarray(v) for k, v in S.items()}
    E0_t, E0_j = _energy(ht, St), _energy(hj, Sj)
    dt_t, sj_t = ht.dt_estimate_full(St)
    dt_j, sj_j = hj.dt_estimate_full(Sj)
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-12)
    dt = 0.5 * float(dt_j)
    for _ in range(3):
        St, est_t, (h1_t, l2_t), sj_t = ht.advance(St, dt, sJit1=sj_t)
        Sj, est_j, (h1_j, l2_j), sj_j = hj.advance(Sj, dt, sJit1=sj_j)
        assert int(h1_t) == int(h1_j)
        assert abs(int(l2_t) - int(l2_j)) <= 2
        assert float(est_t) == pytest.approx(float(est_j), rel=1e-12)
        Sn = state_to_numpy(St)
        for k in ("x", "v"):
            assert _rel(Sn[k], Sj[k]) <= 1e-11, k
        assert _rel(Sn["e"], Sj["e"]) <= 1e-11
        assert np.linalg.norm(Sn["e"]) == pytest.approx(
            float(jnp.linalg.norm(Sj["e"])), rel=1e-10)
        dt = 0.5 * float(est_j)
    for h, S_, E0 in ((ht, St, E0_t), (hj, Sj, E0_j)):
        assert abs(_energy(h, S_) - E0) <= 1e-12 * abs(E0)


# ------------------------------------------------------- Sedov runs -----
_LINE = re.compile(r"step\s+(\d+),\s+t = ([\d.]+),\s+dt = ([\d.]+),\s+"
                   r"\|e\| = ([\d.e+-]+)|Repeating step (\d+)")


def _driver_lines(drv, h):
    """driver.run to t_final 0.6, 3 step attempts (`-ms 2`), |e| at every
    step: (the printed lines, step lines as (step, t, dt) and "Repeating
    step" lines as their step, the |e| of the step lines, the result)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = drv.run(h, t_final=0.6, max_steps=2, vis_steps=1, verbose=True)
    found = _LINE.findall(buf.getvalue())
    lines = [ln[:3] if ln[0] else ln[4] for ln in found]
    assert sum(1 for ln in found if ln[0]) == res.steps > 0
    return lines, [float(ln[3]) for ln in found if ln[0]], res


def _sedov_runs(**kw):
    ht, hj = _pair(1, **kw)
    lt, et, rt = _driver_lines(tdriver, ht)
    lj, ej, rj = _driver_lines(jdriver, hj)
    assert lt == lj                  # steps, repeats, printed t and dt
    assert rt.steps == rj.steps
    return max(abs(a - b) / b for a, b in zip(et, ej))


def test_sedov_q8_pa_matches_jax():
    """3D Sedov at Q8-Q7 under partial assembly through `driver.run`: the
    same step lines (t and dt as printed) and the same repeated step; |e|
    within 1e-4 at every step.

    The bound comes from the L2 conditioning.  The Bernstein degree-7
    element mass has condition number ~6.4e3 in 1D, kappa ~ 2.7e11 in 3D;
    300 iterations of the unpreconditioned energy CG (the `cg_max_iter`
    cap, reached in every solve) leave it far from convergence, so its
    iterate rides on round-off instead of on `cg_tol`: at the first stage
    a 2.3e-16 difference of the packages' right-hand sides moves the
    solution by 8e-3 of max|de| (`test_l2_cg_capped_at_q8_converges_at_q4`).
    A stage moves e by dt * de / 2 (dt 8.7e-4, |de| ~ 650 |e0|), so one
    stage's solve can put |e| apart by ~4e-4; the second stage re-solves
    from the mid state and the step's average cancels most of it: on an
    x86-64 CPU (torch 2.13, JAX 0.9) |e| is 7.5e-6 apart at step 1 and
    4.8e-5 at step 2.
    1e-4 is twice the larger; with a converged energy solve (Q4-Q3, or
    Taylor-Green's smooth field) the packages agree to 1e-10 and better."""
    assert _sedov_runs() <= 1e-4


def test_sedov_q8_fa_matches_jax():
    """3D Sedov at Q8-Q7 under full assembly (`-fa`): 3 memoized `advance`
    steps.  The energy update applies the inverted element L2 masses,
    which each package inverts at the same conditioning (kappa ~ 2.7e11),
    so the packages' round-off in the element masses moves the inverses by
    up to kappa * u.  Measured on an x86-64 CPU (torch 2.13, JAX 0.9):
    6.1e-7 at step 1 through the CLIs, at most 1.1e-6 over a driver run's
    3 attempts and 9.4e-7 over these 3 steps; bound 1e-5, that rounded up
    to its decade.  x at 1e-12, the converged coupled velocity CG's v at
    1e-8, the dt estimates at 1e-10, the H1 counts equal."""
    ht, hj = _pair(1, p_assembly=False)
    assert ht._h1_csr is not None and ht.Me_inv is not None
    S = {k: np.asarray(v) for k, v in hj.S0.items()}
    St = state_from_numpy(S, device="cpu")
    Sj = {k: jnp.asarray(v) for k, v in S.items()}
    dt_t, sj_t = ht.dt_estimate_full(St)
    dt_j, sj_j = hj.dt_estimate_full(Sj)
    dt = 0.5 * float(dt_j)
    worst = 0.0
    for _ in range(3):
        St, est_t, (h1_t, _), sj_t = ht.advance(St, dt, sJit1=sj_t)
        Sj, est_j, (h1_j, _), sj_j = hj.advance(Sj, dt, sJit1=sj_j)
        assert int(h1_t) == int(h1_j)
        assert float(est_t) == pytest.approx(float(est_j), rel=1e-10)
        Sn = state_to_numpy(St)
        assert _rel(Sn["x"], Sj["x"]) <= 1e-12
        assert _rel(Sn["v"], Sj["v"]) <= 1e-8
        e_t, e_j = np.linalg.norm(Sn["e"]), float(jnp.linalg.norm(Sj["e"]))
        worst = max(worst, abs(e_t - e_j) / e_j)
        dt = 0.5 * float(est_j)
    assert worst <= 1e-5


# ------------------------------------------------------ the finding -----
def _first_stage_energy_solve(h, jax_side):
    """The energy solve of the first RK2Avg stage of the first step from
    S0 (dt the initial estimate): (solution, iterations, right-hand side)
    as numpy."""
    if jax_side:
        S = h.S0
        dt, _ = h.dt_estimate_full(S)
        sJ, _ = h._jq(S)
        dv, _ = h._jcg_v(h._jprep_v(h._jforce1(sJ)))
        V = S["v"] + 0.5 * float(dt) * dv
        rhs = h._jfT(sJ, V)
        de, it = h._jcg_e(rhs)
    else:
        S = h.S0
        dt, _ = h.dt_estimate_full(S)
        sJ, _ = h._qupdate(S)
        dv, _ = h._solve_velocity(sJ)
        V = S["v"] + 0.5 * float(dt) * dv
        rhs = h._force_transpose(sJ, V)
        de, it = h._cg_energy(rhs)
    return np.asarray(de), int(it), np.asarray(rhs)


@pytest.mark.parametrize("order", [(4, 3), (8, 7)])
def test_l2_cg_capped_at_q8_converges_at_q4(order):
    """The cause of the Sedov bound, in both packages: the first stage's
    energy CG (unpreconditioned, on the Bernstein L2 PA mass) converges
    below `cg_max_iter` at Q4-Q3 (relative residual within 10x `cg_tol`,
    solutions at 1e-10) and stops at the 300 cap at Q8-Q7 with its
    residual far above `cg_tol`, where right-hand sides equal to round-off
    give solutions apart by up to 1e-1 of max|de| (8e-3 on an x86-64 CPU,
    against 1e-10 at Q4-Q3)."""
    ov, oe = order
    kw = dict(order_v=ov, order_e=oe)
    if order == (8, 7):
        ht, hj = _pair(1)
    else:
        opt = dict(Q8, problem=1, **kw)
        ht = THydro(tdata.get_mesh("cube01_hex"), TOptions(**opt),
                    device="cpu")
        hj = JHydro(jdata.get_mesh("cube01_hex"), JOptions(**opt))
    cap, tol = ht.opt.cg_max_iter, ht.opt.cg_tol
    out = {}
    for side, h in (("port", ht), ("jax", hj)):
        de, it, rhs = _first_stage_energy_solve(h, side == "jax")
        r = rhs - tmass.mass_apply_e(_t(de), ht.massD, ht.tables["L2B"],
                                     3).numpy()
        out[side] = (de, it, np.linalg.norm(r) / np.linalg.norm(rhs))
    (de_t, it_t, res_t), (de_j, it_j, res_j) = out["port"], out["jax"]
    if order == (4, 3):
        assert it_t < cap and it_j < cap and abs(it_t - it_j) <= 2
        assert res_t <= 10 * tol and res_j <= 10 * tol
        assert _rel(de_t, de_j) <= 1e-10
    else:
        assert it_t == it_j == cap
        assert res_t > 1e3 * tol and res_j > 1e3 * tol
        assert _rel(de_t, de_j) <= 1e-1


# ------------------------------------------------- SASS instruction count --
def test_count_sass_filters_opcodes():
    """`kernels.count_sass` (the FP64-pipe bound of chip_smoke.py)
    counts each function's instructions, NOPs left out, and with `opcodes`
    only those whose opcode before its first "." is listed, predicated
    ones included."""
    text = """
        Function : _Z12qphys_kernelIdLi1ELb1ELb0EEv4ArgsIdE
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   DFMA R2, R4, R6, R8 ;
        /*0020*/              @!P0 DMUL R2, R4, R6 ;
        /*0030*/                   DSETP.GT.AND P0, PT, R2, RZ, PT ;
        /*0040*/                   FFMA R3, R5, R7, R9 ;
        /*0050*/                   NOP ;
        /*0060*/                   DEPBAR.LE SB0, 0x0 ;
        Function : _Z12split_kernelv
        /*0000*/                   EXIT ;
    """
    fp64 = {"DADD", "DMUL", "DFMA", "DSETP"}
    assert kernels.count_sass(text) == {
        "_Z12qphys_kernelIdLi1ELb1ELb0EEv4ArgsIdE": 6,
        "_Z12split_kernelv": 1}
    assert kernels.count_sass(text, fp64) == {
        "_Z12qphys_kernelIdLi1ELb1ELb0EEv4ArgsIdE": 3,
        "_Z12split_kernelv": 0}


def test_count_sass_per_opcode():
    """`kernels.count_sass(per_opcode=True)`, as phase 2 of chip_smoke.py
    reads the mass kernel's instances: each listed opcode counted apart
    (its suffixes and predicates folded in), per function; LDSM is not LDS,
    LDGDEPBAR not LDGSTS, and an instruction on "@!PT" (never run) is not
    counted."""
    text = """
        Function : _ZN11mass_kernelIdLi3ELi8ELi16EEEvPKT_S3_S3_PS1_iii
        /*0000*/                   LDS.128 R4, [R2] ;
        /*0010*/                   LDS.64 R8, [R3+0x50] ;
        /*0020*/               @P0 LDS R9, [R3] ;
        /*0030*/                   LDSM.16.M88.4 R12, [R3] ;
        /*0040*/                   DFMA R10, R4, R6, RZ ;
        /*0050*/                   DFMA R10, R4, R8, R10 ;
        /*0060*/                   DMUL R10, R10, R8 ;
        /*0070*/                   STS.64 [R5+0x1040], R10 ;
        /*0080*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0090*/                   LDGSTS.E.BYPASS.128 [R6], desc[UR4][R14.64] ;
        /*00a0*/                   LDGDEPBAR ;
        /*00b0*/                   NOP ;
        /*00c0*/              @!PT LDS RZ, [RZ] ;
        Function : _ZN11mass_kernelIfLi3ELi8ELi16EEEvPKT_S3_S3_PS1_iii
        /*0000*/                   FFMA R3, R5, R7, R9 ;
        /*0010*/                   EXIT ;
    """
    ops = ("LDS", "STS", "DFMA", "FFMA", "BAR", "LDGSTS")
    got = kernels.count_sass(text, ops, per_opcode=True)
    assert got == {
        "_ZN11mass_kernelIdLi3ELi8ELi16EEEvPKT_S3_S3_PS1_iii": dict(
            LDS=3, STS=1, DFMA=2, FFMA=0, BAR=1, LDGSTS=1),
        "_ZN11mass_kernelIfLi3ELi8ELi16EEEvPKT_S3_S3_PS1_iii": dict(
            LDS=0, STS=0, DFMA=0, FFMA=1, BAR=0, LDGSTS=0)}
    assert kernels.count_sass(text) == {
        "_ZN11mass_kernelIdLi3ELi8ELi16EEEvPKT_S3_S3_PS1_iii": 11,
        "_ZN11mass_kernelIfLi3ELi8ELi16EEEvPKT_S3_S3_PS1_iii": 2}
