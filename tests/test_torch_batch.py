"""The port's parameter sweeps (`laghos_tpu_torch.batch`) on the CPU: the
blast-energy batch of states against the JAX package's at 1e-15, sweep
members bit for bit separate `driver.run`s of the port, and the JAX
package's vmapped sweep on the same inputs (steps equal, |e| at 1e-11).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import batch as jbatch
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu_torch import batch, driver
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro, Options
from laghos_tpu_torch.interop import (batch_state_from_numpy,
                                      state_to_numpy, sweep_to_numpy)

torch.set_num_threads(1)

ENERGIES = [0.25, 0.5]


def _mesh(mod):
    return mod.uniform_refine(mod.cartesian(2, (2, 2), (1.0, 1.0)))


def _opt(blast=0.25):
    return dict(problem=1, blast_energy=blast, cg_tol=1e-12)


@pytest.fixture(scope="module")
def hydros():
    return (Hydro(_mesh(tmesh), Options(**_opt()), device="cpu"),
            JHydro(_mesh(jmesh), JOptions(**_opt())))


@pytest.fixture(scope="module")
def swept(hydros):
    h, _ = hydros
    Sb = batch.blast_states(h, ENERGIES)
    return Sb, batch.sweep(h, Sb, t_final=0.1, max_steps=8)


def test_blast_states_match_jax(hydros):
    h, hj = hydros
    Sb = state_to_numpy(batch.blast_states(h, ENERGIES + [2.0]))
    Sj = jbatch.blast_states(hj, ENERGIES + [2.0])
    for k in ("x", "v", "e"):
        a, b = Sb[k], np.asarray(Sj[k])
        assert a.shape == b.shape == (3,) + a.shape[1:]
        assert np.abs(a - b).max() <= 1e-15 * np.abs(b).max()
    # the same batch carried across to the port from the JAX arrays
    Sc = batch_state_from_numpy({k: np.asarray(v) for k, v in Sj.items()},
                                device="cpu")
    assert Sc["e"].shape == (3, h.NE, h.ld)


def test_sweep_members_equal_separate_runs(hydros, swept):
    h, _ = hydros
    Sb, out = swept
    assert out["steps"].shape == (2,)
    for i in range(len(ENERGIES)):
        S0 = {k: v[i].clone() for k, v in Sb.items()}
        r = driver.run(h, t_final=0.1, max_steps=8, S_init=S0,
                       vis_steps=10**6)
        assert not bool(out["crashed"][i])
        assert float(out["t"][i]) == r.t and float(out["dt"][i]) == r.dt
        assert int(out["h1_iters"][i]) == r.h1_iters
        assert int(out["l2_iters"][i]) == r.l2_iters
        assert int(out["steps"][i]) >= r.steps
        for k in ("x", "v", "e"):
            assert torch.equal(out["S"][k][i], r.S[k]), (i, k)
    # the energies genuinely diverge
    assert float((out["S"]["e"][0] - out["S"]["e"][1]).abs().max()) > 1e-3


def test_sweep_matches_jax_sweep(hydros, swept):
    h, hj = hydros
    _, out = swept
    oj = jbatch.sweep(hj, jbatch.blast_states(hj, ENERGIES), t_final=0.1,
                      max_steps=8)
    on = sweep_to_numpy(out)
    assert on["steps"].tolist() == np.asarray(oj["steps"]).tolist()
    assert np.allclose(on["t"], np.asarray(oj["t"]), rtol=1e-12, atol=0)
    assert not np.asarray(oj["crashed"]).any() and not on["crashed"].any()
    for i in range(len(ENERGIES)):
        et = np.sqrt((on["S"]["e"][i] ** 2).sum())
        ej = float(jnp.sqrt(jnp.sum(oj["S"]["e"][i] ** 2)))
        assert abs(et - ej) / ej < 1e-11
    assert on["h1_iters"].tolist() == np.asarray(oj["h1_iters"]).tolist()


def test_sweep_over_devices_raises(hydros):
    """sweep(n_devices=N) is a collective call on a group of N ranks:
    outside one (no comm, or a group of another size) it raises
    (tests/test_torch_dist_comm.py runs it over ranks)."""
    from laghos_tpu_torch.parallel import comm

    h, _ = hydros
    with pytest.raises(ValueError, match="group of 2 ranks"):
        batch.sweep(h, batch.blast_states(h, ENERGIES), t_final=0.1,
                    n_devices=2)
    with comm.single("gloo", "cpu") as c:
        with pytest.raises(ValueError, match="group of 2 ranks"):
            batch.sweep(h, batch.blast_states(h, ENERGIES), t_final=0.1,
                        n_devices=2, comm=c)
