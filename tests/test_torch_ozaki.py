"""The port's Ozaki f64 mode (`Options(ozaki=True)`, `--ozaki`) on the CPU:
the static splits and the banded Ozaki chains (`ops/lattice_oz.py`)
against the JAX package, the lattice-path `_mult` (with the mixed-precision
IR velocity solve) against the JAX package's Ozaki `_mult`, the gather
path and a short trajectory against the port's native f64 path, the
--checks goldens, the guards and the command line.

Tolerances: a product of 8 (6 for the q-update gradients) dynamic slices
truncates at ~2^-56 (~2^-42) of the row and column maxima, and the two
packages pick the dynamic exponents by different rules, so chains agree to
the f64 rounding of their stages: 1e-13 of max|y| at 8 and 7 slices, and
the truncation class 2^(-7S+4) at S = 6.  `_mult`: 1e-12 relative, the bound of the JAX package's own
Ozaki-vs-plain test (tests/test_ozaki_mode.py); trajectories 1e-11, its
slow trajectory bound.  A JAX Ozaki `_mult` costs about 45 s of XLA
compiles on the CPU, so it is built and run once per module."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu import data as jdata
from laghos_tpu.fem import basis as jbasis
from laghos_tpu.fem import mesh as jmesh
from laghos_tpu.hydro import Hydro as JHydro
from laghos_tpu.hydro import Options as JOptions
from laghos_tpu.ops import lattice_oz as jlzo
from laghos_tpu.ops import tensor as jtensor
from laghos_tpu_torch import cli, driver
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import ozaki_arrays, state_from_numpy
from laghos_tpu_torch.ops import lattice_oz as tlzo
from laghos_tpu_torch.ops import omm
from laghos_tpu_torch.verify import CHECKS_TABLE, OZAKI_CHECKS_EPS, run_checks

torch.set_num_threads(1)

# the tests/test_ozaki_mode.py setup
MODE = dict(problem=1, blast_energy=2.0, ode_solver=4, cg_tol=1e-12)
GATHER = dict(structured_el=False, lattice_ops=False, precond="jacobi")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _mode_mesh():
    return tmesh.uniform_refine(tmesh.cartesian(3, (2, 2, 2),
                                                (1.0, 1.0, 1.0)))


def _perturbed(h, seed=1):
    """The initial state perturbed by a numpy-seeded field (torch)."""
    rng = np.random.default_rng(seed)
    S0 = {k: v.numpy() for k, v in h.S0.items()}
    return state_from_numpy({
        "x": S0["x"] + 0.005 * rng.normal(size=S0["x"].shape),
        "v": np.where(h.ess_mask, 0.0, 0.1 * rng.normal(size=S0["v"].shape)),
        "e": S0["e"] + 0.5}, device="cpu")


# ------------------------------------------------------ static splits -----
def _split_equal(t, j):
    assert t["levels"] == tuple(j.levels) and t["e"] == tuple(j.e)
    assert t["n_slices"] == j.n_slices
    np.testing.assert_array_equal(t["scale"], np.asarray(j.scale))
    for a, b in zip(t["slices"] + t["stacks"], tuple(j.slices) + j.stacks):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_ozaki_static_splits_bitwise_equal_jax():
    """Every static split of an Ozaki Hydro (the dense element operators
    and the banded lattice tables) equals the JAX package's bit for bit,
    on the non-cubic box (a swapped lattice axis cannot hide)."""
    opt = dict(problem=1, ozaki=True, ozaki_slices=7)
    ht = THydro(tdata.get_mesh("box01_hex"), TOptions(**opt), device="cpu")
    hj = JHydro(jdata.get_mesh("box01_hex"), JOptions(**opt))
    a = ozaki_arrays(ht)
    for k, pair in hj.oz.items():
        for t, j in zip(a["oz"][k], pair):
            _split_equal(t, j)
    assert sorted(a["lat_oz"]) == sorted(hj._lat_oz)
    for k, v in hj._lat_oz.items():
        for t, j in zip(a["lat_oz"][k] if isinstance(v, tuple)
                        else (a["lat_oz"][k],), v if isinstance(v, tuple)
                        else (v,)):
            _split_equal(t, j)
    assert a["lat_oz"]["fwdB"][0]["n_slices"] == 7
    native = THydro(tdata.get_mesh("box01_hex"), TOptions(problem=1),
                    device="cpu")
    assert ozaki_arrays(native) is None


# -------------------------------------------------- lattice_oz chains -----
@pytest.fixture(scope="module")
def box():
    """Port Ozaki Hydro on box01_hex (rs0, 4x2x2) with its JAX lattice_oz
    build from the same tables, and seeded inputs."""
    h = THydro(tdata.get_mesh("box01_hex"), TOptions(problem=1, ozaki=True),
               device="cpu")
    assert h._lat_oz is not None
    nq = h.nq1
    h1b = jbasis.h1_gl_basis(2, nq)
    l2b = jbasis.l2_bernstein_basis(1, nq)
    l2bd, _ = jtensor.dense_ops(l2b.B, np.zeros_like(l2b.B), 3)
    jl = jlzo.build_lattice_oz(h1b.B, h1b.G, l2bd,
                               tuple(reversed(h._sm.dims)))
    rng = np.random.default_rng(3)
    dims = h._lat_dims
    qdims = tuple(h._lat["Dq"].shape)
    inp = {"u": rng.standard_normal((3,) + dims),
           "x": rng.standard_normal((3,) + dims),
           "sJ": rng.standard_normal((9,) + qdims),
           "e_b": rng.standard_normal((h.NE, h.ld)),
           "eq": rng.standard_normal((h.NE, h.NQ))}
    return h, jl, inp


def _case(name, h, jl, inp):
    """(port result, JAX result) of one lattice_oz entry point."""
    t = {k: torch.tensor(v) for k, v in inp.items()}
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    loz, dims = h._lat_oz, h._lat_dims
    Dq = h._lat["Dq"]
    if name == "mass":
        return (tlzo.mass_apply_lattice_oz(t["u"].reshape(3, -1), loz, Dq,
                                           dims),
                jlzo.mass_apply_lattice_oz(j["u"].reshape(3, -1), jl,
                                           jnp.asarray(Dq.numpy()), dims))
    if name == "mass_s6":
        return (tlzo.mass_apply_lattice_oz(t["u"].reshape(3, -1), loz, Dq,
                                           dims, n_slices=6),
                jlzo.mass_apply_lattice_oz(j["u"].reshape(3, -1), jl,
                                           jnp.asarray(Dq.numpy()), dims,
                                           n_slices=6))
    if name == "grad18":
        J9, dV9 = tlzo.grad18_lattice_oz(t["x"], t["u"], loz)
        Jj, dVj = jlzo.grad18_lattice_oz(j["x"], j["u"], jl)
        return torch.cat([J9, dV9]), np.stack(Jj + dVj)
    if name == "grad9":
        return (tlzo.grad9_lattice_oz(t["u"], loz),
                np.stack(jlzo.grad9_lattice_oz(j["u"], jl)))
    if name == "force_one":
        return (tlzo.force_one_lattice_oz(t["sJ"], loz),
                jlzo.force_one_lattice_oz(tuple(j["sJ"]), jl))
    if name == "force_one_s7":
        return (tlzo.force_one_lattice_oz(t["sJ"], loz, n_slices=7),
                jlzo.force_one_lattice_oz(tuple(j["sJ"]), jl, n_slices=7))
    if name == "l2_eval":
        return tlzo.l2_eval_oz(t["e_b"], loz), jlzo.l2_eval_oz(j["e_b"], jl)
    assert name == "l2_transpose"
    return (tlzo.l2_transpose_oz(t["eq"], loz),
            jlzo.l2_transpose_oz(j["eq"], jl))


@pytest.mark.parametrize("name", ["mass", "mass_s6", "grad18", "grad9",
                                  "force_one", "force_one_s7", "l2_eval",
                                  "l2_transpose"])
def test_lattice_oz_ops_match_jax(box, name):
    h, jl, inp = box
    got, ref = _case(name, h, jl, inp)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    # truncated chains (6 slices: mass_s6 and the grad18 default) differ
    # between the packages at their truncation class (observed 1.4e-13 =
    # 2^-42.7 for mass_s6), as their exponents differ
    S = {"mass_s6": 6, "grad18": 6, "force_one_s7": 7}.get(name, 8)
    assert _rel(got.numpy(), ref) <= max(1e-13, 2.0 ** (-omm.Q * S + 4))


def test_lattice_oz_ops_match_native(box):
    """The chains against the port's native f64 banded chains: the mass
    apply at 8 slices to f64 rounding, the 6-slice q-update gradients to
    their ~2^-42 truncation."""
    from laghos_tpu_torch.ops import lattice as tlat

    h, _, inp = box
    lat, dims = h._lat, h._lat_dims
    u = torch.tensor(inp["u"])
    y = tlzo.mass_apply_lattice_oz(u.reshape(3, -1), h._lat_oz, lat["Dq"],
                                   dims)
    y0 = tlat.mass_apply_lattice(u.reshape(3, -1), lat["Ts"], lat["Dq"],
                                 dims)
    assert _rel(y, y0) <= 1e-14
    J9, _ = tlzo.grad18_lattice_oz(u, u, h._lat_oz)
    J0 = torch.stack(tlat.grad9_lattice(u, lat["Ts"], lat["Tg"]))
    assert _rel(J9, J0) <= 1e-11


# ------------------------------------------------------------ _mult -------
@pytest.fixture(scope="module")
def jax_mult():
    """The JAX package's Ozaki `_mult` at S0 of the test_ozaki_mode setup
    (built and run once: ~45 s of XLA compiles)."""
    m = jmesh.uniform_refine(jmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0)))
    hj = JHydro(m, JOptions(ozaki=True, **MODE))
    dS, dt, (h1it, l2it) = hj._mult(hj.S0)
    return ({k: np.asarray(v) for k, v in dS.items()}, float(dt),
            int(h1it), int(l2it))


def test_lattice_mult_matches_jax_ozaki(jax_mult):
    dSj, dtj, h1j, l2j = jax_mult
    h = THydro(_mode_mesh(), TOptions(ozaki=True, **MODE), device="cpu")
    assert h._lat_oz is not None and h._lat32 is not None
    dS, dt, (h1it, l2it) = h._mult(h.S0)
    for k in ("x", "v", "e"):
        a, b = dS[k].numpy(), dSj[k]
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-30) < 1e-12, k
    assert abs(float(dt) - dtj) / dtj < 1e-12
    # L2 CG: the same f64 iteration.  H1: the IR count sums f32 inner
    # sweeps, whose round-off (torch's and XLA's f32 sums differ) can move
    # an inner stopping test by one sweep per outer
    assert int(l2it) == l2j
    assert abs(int(h1it) - h1j) <= 2
    st = h.ir_stats()
    assert st["solves"] == 1 and st["outers"] >= 1
    assert st["inner_sweeps"] + st["outer_applies"] == int(h1it)


@pytest.mark.parametrize("kw", [dict(cg_ir=False), dict(cg_ir_inc=False),
                                dict(ozaki_rhs_slices=7),
                                dict(precond="kron")])
def test_lattice_mult_options_match_native(kw):
    """The all-Ozaki CG, the non-incremental IR residual, 7 rhs slices and
    the f32 Kronecker inner preconditioner against the native f64 path at
    a perturbed state.  The q-update gradients run at 6 slices (~2^-42 of
    the row maxima), so the stress agrees to that class; the rest of the
    stage (force pair, velocity and energy solves) is held to 1e-12 on the
    same stress."""
    opt = dict(MODE, **{k: v for k, v in kw.items() if k == "precond"})
    h0 = THydro(_mode_mesh(), TOptions(**opt), device="cpu")
    h1 = THydro(_mode_mesh(), TOptions(ozaki=True, **dict(MODE, **kw)),
                device="cpu")
    S = _perturbed(h0)
    sJ0, dt0 = h0._qupdate(S)
    sJ1, dt1 = h1._qupdate(S)
    assert _rel(sJ1, sJ0) < 2.0 ** -36
    assert abs(float(dt1) - float(dt0)) / float(dt0) < 2.0 ** -36
    a, _, _ = h0._mult(S, sJ0)
    b, _, _ = h1._mult(S, sJ0)
    for k in ("x", "v", "e"):
        assert _rel(b[k], a[k]) < 1e-12, k
    if kw.get("precond") == "kron":
        assert "kron" in h1._lat32


def test_gather_mult_matches_native():
    h0 = THydro(_mode_mesh(), TOptions(**MODE, **GATHER), device="cpu")
    h1 = THydro(_mode_mesh(), TOptions(ozaki=True, **MODE, **GATHER),
                device="cpu")
    assert h1._lat is None and h1.oz is not None
    S = _perturbed(h0)
    a, dt0, (h1a, l2a) = h0._mult(S)
    b, dt1, (h1b, l2b) = h1._mult(S)
    for k in ("x", "v", "e"):
        assert _rel(b[k], a[k]) < 1e-12, k
    assert abs(float(dt1) - float(dt0)) / float(dt0) < 1e-12
    assert abs(int(h1b) - int(h1a)) <= 1 and abs(int(l2b) - int(l2a)) <= 1


def test_short_trajectory_matches_native():
    runs = []
    for oz in (False, True):
        h = THydro(_mode_mesh(), TOptions(ozaki=oz, **MODE), device="cpu")
        runs.append((h, driver.run(h, t_final=0.6, max_steps=15)))
    (h0, r0), (h1, r1) = runs
    assert r0.steps == r1.steps
    assert abs(r0.t - r1.t) / r0.t < 1e-11
    assert abs(r0.e_norm - r1.e_norm) / r0.e_norm < 1e-11
    assert h1.ir_stats()["solves"] > 0


# ------------------------------------------------------ goldens, CLI -----
def test_sedov_checks_goldens_ozaki():
    """The 3D Sedov --checks gate through --ozaki, on the lattice path with
    the IR velocity solve.  The q-update gradients truncate at 6 slices,
    so |e| departs from the native run by 2.9e-14 at step 5 and 1.46e-13
    at step 20 (measured on the CPU): the CLI gates at OZAKI_CHECKS_EPS =
    3e-13 against the goldens, not the native path's 1e-13."""
    run = cli.main(["-d", "cpu", "-p", "1", "-dim", "3", "-rs", "0", "-tf",
                    "0.6", "-s", "4", "-cfl", "0.5", "-cgt", "1e-14", "-chk",
                    "-vs", "1000000", "--ozaki"])
    assert run.hydro._lat_oz is not None
    assert set(run.result.norms) >= {s for s, _ in CHECKS_TABLE[3][1]}
    assert OZAKI_CHECKS_EPS == 3e-13
    assert run_checks(1, 3, run.result.norms, eps=OZAKI_CHECKS_EPS)
    with pytest.raises(AssertionError):
        run_checks(1, 3, run.result.norms, eps=1e-13)


def test_cli_ozaki_runs():
    run = cli.main(["-d", "cpu", "--ozaki", "-rs", "0", "-ms", "3"])
    assert run.hydro.opt.ozaki and run.hydro.oz is not None
    assert run.result.steps >= 3 and np.isfinite(run.result.e_norm)


@pytest.mark.parametrize("dim,dtype,kw", [
    (2, torch.float64, {}),
    (3, torch.float32, {}),
    (3, torch.float64, dict(ozaki_rhs_slices=9)),
    (3, torch.float64, dict(ozaki_rhs_slices=-1)),
    (3, torch.float64, dict(ozaki_slices=9)),
])
def test_guards(dim, dtype, kw):
    m = tmesh.cartesian(dim, (2,) * dim, (1.0,) * dim)
    with pytest.raises(ValueError):
        THydro(m, TOptions(problem=1, ozaki=True, **kw), dtype=dtype,
               device="cpu")


def test_split_counter_untouched_on_cpu():
    """A CPU run never counts kernel launches (the wrapper runs the plain
    twin for CPU tensors)."""
    before = omm.split_dyn.launches
    h = THydro(tdata.get_mesh("cube01_hex"), TOptions(problem=1, ozaki=True),
               device="cpu")
    h._mult(h.S0)
    assert omm.split_dyn.launches == before
