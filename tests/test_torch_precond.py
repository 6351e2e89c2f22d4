"""The port's solver options against the JAX package on the CPU: the
element-block additive Schwarz preconditioner (`precond="schwarz"`) on the
gather and the whole-lattice path, CG warm starts (`cg(x0=...)` and
`Options.cg_warm_start`).

Inputs come from numpy seeds.  Tolerances: the Schwarz apply 1e-13 and
its symmetry 1e-12 (relative); the Schwarz velocity solve 1e-12 with the
iteration count within one (torch and XLA sum in different orders,
ROADMAP C2); `cg(x0=...)` 1e-12 and the same iterations; the warm-start
run's |e| 1e-10 with the same step count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import driver as jdriver
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.solvers.cg import cg as jcg
from laghos_tpu_torch import driver
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.solvers.cg import cg as tcg

torch.set_num_threads(1)

PATHS = {"lattice": {},
         "gather": dict(structured_el=False, lattice_ops=False)}


def _opt(precond, **kw):
    return dict(problem=1, blast_energy=2.0, ode_solver=4, cg_tol=1e-12,
                precond=precond, **kw)


def _mesh(mod):
    return mod.uniform_refine(mod.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))


def _pair(precond, path, **kw):
    ht = THydro(_mesh(tmesh), TOptions(**_opt(precond, **PATHS[path], **kw)),
                device="cpu")
    hj = JHydro(_mesh(jmesh), JOptions(**_opt(precond, **PATHS[path], **kw)))
    return ht, hj


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module", params=sorted(PATHS))
def schwarz(request):
    ht, hj = _pair("schwarz", request.param)
    assert (ht._lat is not None) == (request.param == "lattice")
    assert ht._lat is None or "kron" not in ht._lat
    return request.param, ht, hj


def test_schwarz_symmetric_positive_and_matches_jax(schwarz):
    path, ht, hj = schwarz
    rng = np.random.default_rng(0)
    r1, r2 = (rng.normal(size=(3, ht.ndof)) for _ in range(2))
    t1, t2 = (torch.tensor(r) for r in (r1, r2))
    m1, m2 = ht._precond_velocity(t1), ht._precond_velocity(t2)
    a = float(torch.sum(m1 * t2))
    b = float(torch.sum(t1 * m2))
    assert abs(a - b) / abs(a) < 1e-12
    free = torch.where(ht.ess_mask_t, torch.zeros_like(t1), t1)
    assert float(torch.sum(ht._precond_velocity(free) * free)) > 0.0
    # the same residuals through the JAX package's apply
    for r, m in ((r1, m1), (r2, m2)):
        assert _rel(m.numpy(), hj._precond_velocity(jnp.asarray(r))) < 1e-13


def test_schwarz_velocity_solve_matches_jax(schwarz):
    path, ht, hj = schwarz
    sj, _ = hj._jq(hj.S0)
    B = np.asarray(hj._jprep_v(hj._jforce1(sj)))
    xj, itj = hj._jcg_v(jnp.asarray(B))
    xt, itt = ht._cg_velocity(torch.tensor(B))
    assert _rel(xt.numpy(), xj) < 1e-12
    assert abs(int(itt) - int(itj)) <= 1
    # the same answer as the port's Jacobi solve
    hjac = THydro(_mesh(tmesh), TOptions(**_opt("jacobi", **PATHS[path])),
                  device="cpu")
    xjac, _ = hjac._cg_velocity(torch.tensor(B))
    assert _rel(xt.numpy(), xjac.numpy()) < 1e-9


def _spd(rng, n):
    Q = rng.normal(size=(n, n))
    return Q @ Q.T + n * np.eye(n)


def test_cg_warm_start_matches_jax():
    """cg(x0=...) of both packages on one SPD system per column, with a
    Jacobi preconditioner: x at 1e-12 and the same iterations; x0=None
    is the cold solve."""
    rng = np.random.default_rng(4)
    n = 40
    A = np.stack([_spd(rng, n), _spd(rng, n)])           # (2, n, n)
    b = rng.normal(size=(2, n))
    x0 = np.linalg.solve(A, b[..., None])[..., 0] + 1e-3 * rng.normal(
        size=(2, n))
    dinv = 1.0 / np.einsum("cii->ci", A)

    def t_apply(u):
        return torch.einsum("cij,cj->ci", torch.tensor(A), u)

    def j_apply(u):
        return jnp.einsum("cij,cj->ci", jnp.asarray(A), u)

    for start in (None, x0):
        rt = tcg(t_apply, torch.tensor(b), 1e-10, 200,
                 precond=lambda r: r * torch.tensor(dinv),
                 x0=None if start is None else torch.tensor(start))
        rj = jcg(j_apply, jnp.asarray(b), 1e-10, 200,
                 precond=lambda r: r * jnp.asarray(dinv),
                 x0=None if start is None else jnp.asarray(start))
        assert _rel(rt.x.numpy(), rj.x) < 1e-12
        assert rt.iters.tolist() == np.asarray(rj.iters).tolist()
        assert bool(rt.converged.all())
    # a warm start near the solution needs fewer iterations
    cold = tcg(t_apply, torch.tensor(b), 1e-10, 200)
    warm = tcg(t_apply, torch.tensor(b), 1e-10, 200, x0=torch.tensor(x0))
    assert int(warm.iters.sum()) < int(cold.iters.sum())


@pytest.mark.parametrize("prev", [None, 3, 12, 40])
def test_cg_flag_reads_change_nothing(prev):
    """Reading the convergence flag only around the previous solve's stop
    (the device loop's `reads`; a stop that comes earlier or later than
    the previous one included) returns the same bits and counts as
    reading it every iteration; repeated solves of one system settle on
    stopping right after convergence."""
    rng = np.random.default_rng(5)
    A = torch.tensor(np.stack([_spd(rng, 30), _spd(rng, 30),
                               np.eye(30)]))
    b = torch.tensor(rng.normal(size=(3, 30)))

    applies = [0]

    def apply(u):
        applies[0] += 1
        return torch.einsum("cij,cj->ci", A, u)

    ref = tcg(apply, b, 1e-11, 100)
    n_ref = applies[0]
    reads = [prev]
    got = tcg(apply, b, 1e-11, 100, reads=reads)
    assert torch.equal(ref.x, got.x) and torch.equal(ref.iters, got.iters)
    assert ref.iters.tolist()[2] == 1
    stop = int(ref.iters.max()) + 1
    assert 1 <= reads[0] <= stop
    for _ in range(2):
        applies[0] = 0
        again = tcg(apply, b, 1e-11, 100, reads=reads)
        assert torch.equal(again.x, ref.x)
        assert torch.equal(again.iters, ref.iters)
    # settled: stops where the every-iteration solve stops, no extra apply
    assert reads[0] == stop and applies[0] == n_ref


def test_warm_start_run_matches_jax_and_saves_iterations():
    """12 steps with cg_warm_start against the JAX package's warm run:
    the same steps, |e| at 1e-10; fewer H1 iterations than the port's
    cold run, the same |e| to the CG tolerance."""
    ht, hj = _pair("jacobi", "lattice", cg_warm_start=True)
    rt = driver.run(ht, t_final=0.6, max_steps=12)
    rj = jdriver.run(hj, t_final=0.6, max_steps=12, verbose=False)
    assert rt.steps == rj.steps
    assert abs(rt.e_norm - rj.e_norm) / rj.e_norm < 1e-10
    hc = THydro(_mesh(tmesh), TOptions(**_opt("jacobi")), device="cpu")
    rc = driver.run(hc, t_final=0.6, max_steps=12)
    assert rc.steps == rt.steps
    assert rt.h1_iters < rc.h1_iters
    assert abs(rt.e_norm - rc.e_norm) / rc.e_norm < 1e-6
