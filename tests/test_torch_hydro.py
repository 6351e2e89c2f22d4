"""The PyTorch port's hydro slice end to end on the CPU: stage pieces and
steps of the gather path against the JAX package, the reference's --checks
goldens, RK2Avg energy conservation and repeatability on both operator
paths (whole-lattice and gather), and the command line."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import cli, driver
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import state_from_numpy, state_to_numpy
from laghos_tpu_torch.verify import CHECKS_TABLE, run_checks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH = {2: "square01_quad", 3: "cube01_hex"}
# Options of the two operator paths: the default whole-lattice path, and
# the gather path pinned explicitly
PATHS = {"lattice": {},
         "gather": dict(structured_el=False, lattice_ops=False,
                        precond="jacobi")}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _assert_state_close(St, Sj, tol):
    Sn = state_to_numpy(St)
    for k in ("x", "v", "e"):
        assert _rel(Sn[k], Sj[k]) <= tol, k


@pytest.mark.parametrize("dim", [3, 2])
def test_stage_pieces_and_steps_match_jax(dim):
    """One perturbed state through every stage piece, then 3 steps of the
    memoized `advance`, in both packages."""
    ht = THydro(tdata.get_mesh(MESH[dim]),
                TOptions(problem=1, cg_tol=1e-14, **PATHS["gather"]),
                device="cpu")
    hj = JHydro(jdata.get_mesh(MESH[dim]),
                JOptions(problem=1, cg_tol=1e-14, structured_el=False,
                         lattice_ops=False, precond="jacobi"))
    rng = np.random.default_rng(1)
    S0 = {k: np.asarray(v) for k, v in hj.S0.items()}
    S = {"x": S0["x"] + 0.01 * rng.normal(size=S0["x"].shape),
         "v": np.where(ht.ess_mask, 0.0,
                       0.1 * rng.normal(size=S0["v"].shape)),
         "e": S0["e"] + 0.5}
    St = state_from_numpy(S)
    Sj = {k: jnp.asarray(v) for k, v in S.items()}

    sJ_t, dt_t = ht._qupdate(St)
    sJ_j, dt_j = hj._jq(Sj)
    sJ_jn = np.stack(sJ_j) if dim == 3 else np.asarray(sJ_j)
    assert _rel(sJ_t.numpy(), sJ_jn) <= 1e-13
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-13)

    raw_t = ht._force_rhs_raw(sJ_t)
    raw_j = hj._jforce1(sJ_j)
    assert _rel(raw_t.numpy(), raw_j) <= 1e-13
    dv_t, it_t = ht._cg_velocity(ht._prep_velocity_rhs(raw_t))
    dv_j, it_j = hj._jcg_v(hj._jprep_v(raw_j))
    assert int(it_t) == int(it_j)
    assert _rel(dv_t.numpy(), dv_j) <= 1e-12
    rhs_t = ht._force_transpose(sJ_t, St["v"])
    rhs_j = hj._jfT(sJ_j, Sj["v"])
    assert _rel(rhs_t.numpy(), rhs_j) <= 1e-13
    de_t, il_t = ht._cg_energy(rhs_t)
    de_j, il_j = hj._jcg_e(rhs_j)
    assert int(il_t) == int(il_j)
    assert _rel(de_t.numpy(), de_j) <= 1e-12

    dt = 0.5 * float(dt_j)
    sj_t, sj_j = sJ_t, sJ_j
    for _ in range(3):
        St, est_t, (h1_t, l2_t), sj_t = ht.advance(St, dt, sJit1=sj_t)
        Sj, est_j, (h1_j, l2_j), sj_j = hj.advance(Sj, dt, sJit1=sj_j)
        _assert_state_close(St, Sj, 1e-12)
        assert (int(h1_t), int(l2_t)) == (int(h1_j), int(l2_j))
        assert float(est_t) == pytest.approx(float(est_j), rel=1e-12)


def _checks_run(dim, problem, path):
    m = tmesh.cartesian(dim, (2,) * dim, (1.0,) * dim)
    h = THydro(m, TOptions(problem=problem, cg_tol=1e-14, **PATHS[path]),
               device="cpu")
    assert (h._lat is not None) == (path == "lattice")
    steps = tuple(s for s, _ in CHECKS_TABLE[dim][problem])
    res = driver.run(h, t_final=0.6, vis_steps=10**6, check_steps=steps)
    return h, res


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dim", [2, 3])
def test_sedov_checks_goldens(dim, path):
    """The reference --checks gate for p1 (laghos.cpp:1446): |e| at
    steps 5 and 15 (2D) / 5 and 20 (3D) to 1e-13."""
    _, res = _checks_run(dim, 1, path)
    assert run_checks(1, dim, res.norms, eps=1e-13)


_OTHER_ROWS = [(d, p) for d in (2, 3) for p in range(8) if p != 1]


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("dim,problem", _OTHER_ROWS)
def test_checks_goldens_other_problems(dim, problem, path):
    """The other 14 rows of the --checks table: the lattice path through
    the CLI (its default on these Cartesian meshes, Jacobi PCG), the
    gather path through the driver."""
    if path == "gather":
        res = _checks_run(dim, problem, path)[1]
    else:
        run = cli.main(["-d", "cpu", "-p", str(problem), "-dim", str(dim),
                        "-rs", "0", "-tf", "0.6", "-s", "4", "-cfl", "0.5",
                        "-cgt", "1e-14", "-chk", "-vs", "1000000"])
        assert run.hydro._lat is not None
        res = run.result
    assert run_checks(problem, dim, res.norms, eps=1e-13)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_rk2avg_energy_drift(path):
    m = tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    h = THydro(m, TOptions(problem=1, ode_solver=7, cg_tol=1e-14,
                           **PATHS[path]), device="cpu")
    res = driver.run(h, t_final=0.6, max_steps=10, vis_steps=10**6)
    assert res.steps >= 10
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    assert drift <= 1e-12


@pytest.mark.parametrize("path", sorted(PATHS))
def test_bitwise_repeatability(path):
    finals = [_checks_run(3, 1, path)[1].S for _ in range(2)]
    for k in ("x", "v", "e"):
        assert torch.equal(finals[0][k], finals[1][k])


def test_cli_subprocess_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "laghos_tpu_torch", "-d", "cpu", "-p", "1",
         "-dim", "3", "-rs", "0", "-ms", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step     3," in out.stdout or "step     4," in out.stdout
    assert "Energy  diff:" in out.stdout


@pytest.mark.parametrize("argv,item", [
    (["-amr", "-nd", "2"], "A11b"), (["-amr", "-nd", "4", "--halo"], "A11b"),
    (["-amr", "-rp", "1", "-nd", "2"], "A11b"),
    (["-amr", "-nd", "2", "-sfc"], "A11b"),
    (["-amr", "-nd", "4", "--halo", "--pencil", "2x2"], "A11b"),
    (["--mxu", "bf16"], "Not to port")])
def test_cli_refuses_unported_flags(argv, item):
    """What the port leaves out is refused naming its ROADMAP item: the
    AMR variant across ranks (A11b) and the TPU knob --mxu.  The other
    distribution flags run (tests/test_torch_dist_cli.py)."""
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["-d", "cpu"] + argv)


def test_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-d", "cuda", "-rs", "0", "-ms", "1"])


def test_hydro_defaults_to_the_card():
    """`Hydro` runs on the card unless the caller asks for the CPU: without
    one it raises, as the CLI does, instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    m = tmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        THydro(m, TOptions())
    assert THydro(m, TOptions(), device="cpu").device == torch.device("cpu")
