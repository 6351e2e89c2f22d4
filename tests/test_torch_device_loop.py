"""The port's on-device adaptive-dt loop (`driver.run(device_loop=True)`,
`Hydro.run_segment`, `hydro.segment_loop`, the CLI's --device-loop) on the
CPU: bit for bit the port's host loop (states, steps, t, dt, `norms`, CG
totals and printed lines) on the lattice, gather and -fa paths, with
--checks pauses, rejected steps and a resume; and the JAX package's host
loop at 1e-12 in |e| with equal steps.
"""

import contextlib
import io

import pytest
import torch

from laghos_tpu import driver as jdriver
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import checkpoint, cli, driver
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro, Options

torch.set_num_threads(1)

PATHS = {"lattice": {},
         "gather": dict(structured_el=False, lattice_ops=False,
                        precond="jacobi"),
         "fa": dict(p_assembly=False)}


def _mesh(mod=tmesh, dim=2, rs=2):
    m = mod.cartesian(dim, (2,) * dim, (1.0,) * dim)
    for _ in range(rs):
        m = mod.uniform_refine(m)
    return m


def _hydro(path="lattice", **kw):
    return Hydro(_mesh(), Options(problem=1, blast_energy=1.0,
                                  **PATHS[path], **kw), device="cpu")


def _both(make, verbose=False, **kw):
    """(host, device) RunResults and their printed output."""
    out = []
    for dl in (False, True):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r = driver.run(make(), verbose=verbose, device_loop=dl, **kw)
        out.append((r, buf.getvalue()))
    return out


def _assert_same(a, b):
    assert (a.steps, a.t, a.dt) == (b.steps, b.t, b.dt)
    for k in ("x", "v", "e"):
        assert torch.equal(a.S[k], b.S[k]), k
    assert a.norms == b.norms
    assert (a.h1_iters, a.l2_iters) == (b.h1_iters, b.l2_iters)
    assert a.quad_steps == b.quad_steps
    assert a.energy_final == b.energy_final


@pytest.mark.parametrize("path", sorted(PATHS))
def test_device_loop_equals_host_loop(path):
    """The JAX package's device-loop setup (`tests/test_driver.py`): 2D
    Sedov rs2 to t = 0.1 with vis every 7 steps."""
    (rh, oh), (rd, od) = _both(lambda: _hydro(path), verbose=True,
                               t_final=0.1, vis_steps=7)
    _assert_same(rh, rd)
    lines = [ln for ln in oh.splitlines() if ln.startswith("step ")]
    assert oh == od and len(lines) == len(rh.norms) >= 2


def test_device_loop_check_pauses():
    """Pauses at the --checks steps (here arbitrary, not vis steps) sample
    |e| there, as the host loop does."""
    (rh, _), (rd, _) = _both(lambda: _hydro("gather"), t_final=0.6,
                             max_steps=12, vis_steps=100,
                             check_steps=(3, 8, 9))
    _assert_same(rh, rd)
    assert sorted(rd.norms) == [3, 8, 9, rd.steps]


def test_device_loop_rejections():
    """cfl 1 with RK2Avg rejects steps early; the rejection quirks of
    laghos.cpp:741-790 (the 0.85 backoff, the memoized q-data dropped,
    the last-step rule at -ms) come out equal, "Repeating step" lines
    included."""
    (rh, oh), (rd, od) = _both(lambda: _hydro(cfl=1.0, ode_solver=7),
                               verbose=True, t_final=0.6, max_steps=25,
                               vis_steps=3)
    _assert_same(rh, rd)
    assert oh == od and oh.count("Repeating step") >= 5


def test_device_loop_resume_is_bitwise(tmp_path):
    """Five device-loop steps with a checkpoint, then a resume from it to
    step 10, against ten uninterrupted steps."""
    full = driver.run(_hydro(), t_final=0.6, max_steps=9, vis_steps=5,
                      device_loop=True)
    ck = str(tmp_path / "ck.npz")
    first = driver.run(_hydro(), t_final=0.6, max_steps=4, vis_steps=5,
                       device_loop=True, checkpoint_path=ck)
    assert first.steps == 5
    S, t, dt, step = checkpoint.load(ck, device="cpu", dtype=torch.float64)
    h = _hydro()
    res = driver.run(h, t_final=0.6, max_steps=4, vis_steps=5,
                     device_loop=True, S_init=S, t_init=t, dt_init=dt,
                     step_init=step + 1)
    assert (res.steps, res.t, res.dt) == (full.steps, full.t, full.dt)
    for k in ("x", "v", "e"):
        assert torch.equal(res.S[k], full.S[k])
    assert res.norms == {10: full.norms[10]}


def test_device_loop_matches_jax_host_loop():
    rd = driver.run(_hydro(), t_final=0.1, vis_steps=7, device_loop=True)
    hj = JHydro(_mesh(jmesh), JOptions(problem=1, blast_energy=1.0))
    rj = jdriver.run(hj, t_final=0.1, vis_steps=7, verbose=False)
    assert rd.steps == rj.steps
    assert abs(rd.t - rj.t) < 1e-15
    assert abs(rd.e_norm - rj.e_norm) / rj.e_norm < 1e-12
    assert sorted(rd.norms) == sorted(rj.norms)
    assert rd.h1_iters == rj.h1_iters


def test_run_segment_runs_to_the_end():
    """With no vis or check pause, one segment runs the whole run: done,
    not crashed, t final, and the host loop's state, step count and CG
    totals; `steps` counts the attempts, rejected ones included."""
    h = _hydro()
    dt0, sj = h.dt_estimate_full(h.S0)
    (S, t, dt, ti, steps, _, _, done, crashed, h1, l2,
     _) = h.run_segment(h.S0, 0.0, dt0, 1, 0, sj, False, 0.05, -1, 10**6,
                        [-1])
    assert bool(done) and not bool(crashed) and float(t) == 0.05
    ref = driver.run(_hydro(), t_final=0.05, vis_steps=10**6)
    assert int(ti) - 1 == ref.steps and int(steps) >= ref.steps
    assert (int(h1), int(l2)) == (ref.h1_iters, ref.l2_iters)
    assert float(dt) == ref.dt
    for k in ("x", "v", "e"):
        assert torch.equal(S[k], ref.S[k])


def _cli_lines(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = cli.main(argv)
    return run, [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith(("step", "Repeating", "Checks",
                                   "Energy"))]


def test_cli_device_loop_prints_the_host_lines():
    """--device-loop with --checks (3D Sedov, the reference's goldens at
    steps 5 and 20, pauses off the vis steps): the same step lines, the
    checks pass, the states are bit for bit."""
    argv = ["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "0", "-chk",
            "-cgt", "1e-14", "-ms", "20", "-vs", "7"]
    rh, lh = _cli_lines(argv)
    rd, ld = _cli_lines(argv + ["--device-loop"])
    assert lh == ld and "Checks passed." in ld
    for k in ("x", "v", "e"):
        assert torch.equal(rh.result.S[k], rd.result.S[k])
