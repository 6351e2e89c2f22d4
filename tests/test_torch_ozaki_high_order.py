"""The port's Ozaki f64 mode at high order, Q8-Q7 (`--ozaki -ok 8 -ot 7`),
on the CPU at NE 8 (cube01_hex, rs0: lattice 17^3, q-lattice 32^3, NQ
4,096 a zone), against the JAX package and the port's native path.

What the Q8 shapes add to `test_torch_ozaki.py` (order 2): the banded
tables at p = 8 (band 9), the dense L2 tables (4096, 512), the dynamic
splits at k = 17 and 32 here and at k = 129, 256, 512 and 4,096 at the
production size (rs3), where the split kernel's chunked branch takes rows
longer than 512 (`csrc/split.cu`); its plain twin is held here at those
widths.

Tolerances, each stated at its test: static splits bit for bit; the
Ozaki chains against the JAX package's at `test_torch_ozaki.py`'s bounds
(1e-13 of max|y| at 8 slices, the truncation class 2^(-7S+4) at S = 6);
`_mult` against the native `_mult` at the JAX package's Ozaki bound,
1e-12, except the energy rate, whose L2 CG stops at its 300 cap far from
convergence at this order (ROADMAP C6) and amplifies round-off (see
`test_q8_ozaki_mult_matches_native`).  The JAX package's Ozaki `_mult`
is not built at Q8: its XLA compiles alone would take most of this file's
budget; the port's native `_mult` at Q8 is held to the JAX package's in
`test_torch_high_order.py`.

About 90 s in one process on an 8-core x86-64 CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu.fem import basis as jbasis
from laghos_tpu.ops import lattice_oz as jlzo
from laghos_tpu.ops import omm as jomm
from laghos_tpu.ops import tensor as jtensor
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.interop import ozaki_arrays, state_from_numpy
from laghos_tpu_torch.ops import lattice_oz as tlzo
from laghos_tpu_torch.ops import mass as tmass
from laghos_tpu_torch.ops import omm

torch.set_num_threads(1)

# -cgt 1e-14: the velocity solves converge below the 1e-12 bound (the
# Ozaki IR solve and the native CG stop at different iterates of a
# converged solve: 1.1e-14 apart in v at this tolerance)
Q8 = dict(problem=0, order_v=8, order_e=7, ode_solver=7, cg_tol=1e-14,
          precond="jacobi")
_HYDROS = {}


def _hydro(ozaki):
    """Port Q8 Taylor-Green Hydro on cube01_hex (NE 8), native or Ozaki,
    built once per module."""
    if ozaki not in _HYDROS:
        _HYDROS[ozaki] = THydro(tdata.get_mesh("cube01_hex"),
                                TOptions(ozaki=ozaki, **Q8), device="cpu")
    return _HYDROS[ozaki]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_tables(h):
    """The JAX package's 1D H1 tables and dense L2 table at the port
    Hydro's rule."""
    h1b = jbasis.h1_gl_basis(8, h.nq1)
    l2b = jbasis.l2_bernstein_basis(7, h.nq1)
    l2bd, _ = jtensor.dense_ops(l2b.B, np.zeros_like(l2b.B), 3)
    return h1b, l2b, l2bd


@pytest.fixture(scope="module")
def q8():
    """(port Ozaki Hydro, JAX lattice_oz build from the same tables)."""
    h = _hydro(True)
    assert h._lat_oz is not None and h._lat32 is not None
    h1b, _, l2bd = _jax_tables(h)
    jl = jlzo.build_lattice_oz(h1b.B, h1b.G, l2bd,
                               tuple(reversed(h._sm.dims)))
    return h, jl


# ------------------------------------------------------ static splits -----
def _split_equal(t, j):
    """A port split (as `interop` NumPy) against a JAX StaticSplit, bit
    for bit: levels, exponents, scales and every level's digits; the
    levels the JAX package drops are all zero in the port."""
    assert t["levels"] == tuple(j.levels) and t["e"] == tuple(j.e)
    assert t["n_slices"] == j.n_slices
    np.testing.assert_array_equal(t["scale"], np.asarray(j.scale))
    for a, b in zip(t["slices"], j.slices):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_q8_lattice_static_splits_bitwise_equal_jax(q8):
    """The banded tables at p = 8 of every lattice axis in both
    orientations (values and gradients) and the dense L2 tables (4096,
    512) and (512, 4096) equal the JAX package's splits bit for bit, the
    level-stacked operands included."""
    h, jl = q8
    a = ozaki_arrays(h)["lat_oz"]
    assert sorted(a) == sorted(jl)
    for k, v in jl.items():
        pairs = zip(a[k], v) if isinstance(v, tuple) else [(a[k], v)]
        for t, j in pairs:
            _split_equal(t, j)
            assert len(t["stacks"]) == len(j.stacks)
            for x, y in zip(t["stacks"], j.stacks):
                np.testing.assert_array_equal(x, np.asarray(y))
    assert a["fwdB"][0]["stacks"][0].shape == (17, 32)
    assert a["l2fwd"]["stacks"][0].shape == (512, 4096)


@pytest.mark.parametrize("key", ["h1", "l2", "force", "forceT", "qup"])
def test_q8_dense_static_splits_bitwise_equal_jax(key):
    """The dense element operators' splits of an Ozaki Q8 Hydro (H1
    (4096, 729), its gradients stacked (12288, 729), L2 (4096, 512), in
    the orientations `laghos_tpu.hydro.Hydro` splits them) equal the JAX
    package's bit for bit."""
    h = _hydro(True)
    h1b, l2b, l2bd = _jax_tables(h)
    h1bd, h1gd = jtensor.dense_ops(h1b.B, h1b.G, 3)
    gcat = np.concatenate(list(h1gd), axis=0)
    operands = {"h1": (h1bd.T, h1bd), "l2": (l2bd.T, l2bd),
                "force": (l2bd.T, gcat), "forceT": (gcat.T, l2bd),
                "qup": (gcat.T, l2bd.T)}[key]
    for st, B in zip(h.oz[key], operands):
        t = {"slices": tuple(d.numpy() for d in st.slices),
             "levels": st.levels, "scale": st.scale.numpy(), "e": st.e,
             "n_slices": st.n_slices}
        j = jomm.split_static(np.asarray(B))
        _split_equal(t, j)
        assert st.digits.shape == (8,) + B.shape
        del j


# -------------------------------------------------- lattice_oz chains -----
_CASES = ["mass", "mass_s6", "grad18", "force_one", "force_one_s6",
          "l2_eval", "l2_eval_s6", "l2_transpose", "l2_transpose_s6"]


@pytest.fixture(scope="module")
def inputs(q8):
    h, _ = q8
    rng = np.random.default_rng(11)
    dims = h._lat_dims
    qdims = tuple(h._lat["Dq"].shape)
    assert dims == (17, 17, 17) and qdims == (32, 32, 32)
    return {"u": rng.standard_normal((3,) + dims),
            "x": rng.standard_normal((3,) + dims),
            "sJ": rng.standard_normal((9,) + qdims),
            "e_b": rng.standard_normal((h.NE, h.ld)),
            "eq": rng.standard_normal((h.NE, h.NQ))}


def _case(name, h, jl, inp):
    """(port result, JAX result, dynamic slices) of one entry point."""
    t = {k: torch.tensor(v) for k, v in inp.items()}
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    loz, dims, Dq = h._lat_oz, h._lat_dims, h._lat["Dq"]
    base, _, s = name.partition("_s")
    S = int(s) if s else None
    if base == "mass":
        return (tlzo.mass_apply_lattice_oz(t["u"].reshape(3, -1), loz, Dq,
                                           dims, n_slices=S),
                jlzo.mass_apply_lattice_oz(j["u"].reshape(3, -1), jl,
                                           jnp.asarray(Dq.numpy()), dims,
                                           n_slices=S), S or 8)
    if base == "grad18":   # 6 slices by default in both packages
        J9, dV9 = tlzo.grad18_lattice_oz(t["x"], t["u"], loz)
        Jj, dVj = jlzo.grad18_lattice_oz(j["x"], j["u"], jl)
        return torch.cat([J9, dV9]), np.stack(Jj + dVj), 6
    if base == "force_one":
        return (tlzo.force_one_lattice_oz(t["sJ"], loz, n_slices=S),
                jlzo.force_one_lattice_oz(tuple(j["sJ"]), jl, n_slices=S),
                S or 8)
    if base == "l2_eval":
        return (tlzo.l2_eval_oz(t["e_b"], loz, S),
                jlzo.l2_eval_oz(j["e_b"], jl, S), S or 8)
    assert base == "l2_transpose"
    return (tlzo.l2_transpose_oz(t["eq"], loz, S),
            jlzo.l2_transpose_oz(j["eq"], jl, S), S or 8)


@pytest.mark.parametrize("name", _CASES)
def test_q8_lattice_oz_ops_match_jax(q8, inputs, name):
    """Each Ozaki chain at Q8 against `laghos_tpu.ops.lattice_oz` on
    seeded inputs: 1e-13 of max|y| at 8 slices (measured 1.7e-15 to
    3.0e-15 on an x86-64 CPU), the truncation class 2^(-7S+4) = 3.6e-12
    at 6 (measured 6.7e-13 to 1.3e-12), as the two packages pick the
    dynamic exponents by different rules."""
    h, jl = q8
    got, ref, S = _case(name, h, jl, inputs)
    ref = np.asarray(ref)
    assert tuple(got.shape) == ref.shape
    assert _rel(got.numpy(), ref) <= max(1e-13, 2.0 ** (-omm.Q * S + 4))


# ------------------------------------------------ the dynamic split -----
def _mixed_rows(rng, rows, k):
    """Rows of mixed magnitude (2^-30 to 2^30 within a row, and rows
    scaled from 2^-200 to 2^200), an all-zero row, a NaN row and an Inf
    row."""
    A = rng.standard_normal((rows, k)) * np.exp2(
        rng.integers(-30, 30, (rows, k)))
    A *= np.exp2(rng.integers(-200, 200, (rows, 1)))
    A[1] = 0.0
    A[4, 7] = np.nan
    A[-1, -1] = np.inf
    return A


def _reconstruct(cat, scale, k, S):
    """sum_t d_t 2^-7(t+1) times the row scale, from a DynSplit's cat."""
    d = cat.numpy().reshape(cat.shape[0], S, -1)[:, :, :k]
    w = np.exp2(-omm.Q * (np.arange(S) + 1.0))
    return np.einsum("rtk,t->rk", d.astype(np.float64), w) \
        * scale.numpy()[:, None]


@pytest.mark.parametrize("S", [8, 6, 4])
@pytest.mark.parametrize("k", [129, 256, 512, 4096])
def test_split_dyn_plain_at_q8_widths(k, S):
    """`split_dyn_plain`, the split kernel's twin, at the contraction
    widths of the Q8 production run (the rs3 lattice axes 129 and 256;
    the L2 pair's 512, the kernel's one-tile limit, and 4,096, its chunked
    branch): exact power-of-two scales with |row| * 2^-e <= 1/2, digits in
    [-64, 64], zero padding up to the multiple of 8, and a reconstruction
    within the truncation 2^(-7S-1) of the row's scale; zero digits and a
    NaN scale on the NaN and Inf rows.  The JAX package's split of the
    same rows reconstructs them within its own truncation: the two may
    pick exponents one apart (csrc/split.cu), so reconstructions are
    compared, not digits."""
    rng = np.random.default_rng(k + S)
    A = _mixed_rows(rng, 67, k)
    d = omm.split_dyn_plain(torch.tensor(A), S)
    kp = -(-k // 8) * 8
    assert tuple(d.cat.shape) == (67, S * kp) and d.k == k
    bad = ~np.isfinite(A).all(axis=1)
    scale = d.scale.numpy()
    assert np.isnan(scale[bad]).all() and np.isfinite(scale[~bad]).all()
    mant, _ = np.frexp(scale[~bad])
    assert (mant == 0.5).all()
    assert (np.abs(A[~bad]).max(axis=1) <= 0.5 * scale[~bad]).all()
    cat = d.cat.numpy().reshape(67, S, kp)
    assert (np.abs(cat) <= 64).all() and not cat[:, :, k:].any()
    assert not cat[bad].any()
    R = _reconstruct(d.cat, d.scale, k, S)[~bad]
    tol = 2.0 ** (-omm.Q * S - 1) * scale[~bad][:, None]
    assert (np.abs(R - A[~bad]) <= tol).all()
    # the JAX split cascades three f32 parts of each value, each leaving
    # at most half a last-level digit, and scales by exp2, which rounds
    # (an ulp of m and of 2^e: 2^-52 of its scale, the bound at S = 8)
    j = jomm.split_dyn(jnp.asarray(A[~bad]), S, impl="xla")
    jscale = np.asarray(j.scale)
    Rj = sum(np.asarray(sl, np.float64) * 2.0 ** (-omm.Q * (t + 1))
             for t, sl in enumerate(j.slices)) * jscale
    assert (jscale <= 2 * scale[~bad][:, None]).all()
    jtol = (3 * 2.0 ** (-omm.Q * S - 1) + 2.0 ** -52) * jscale
    assert (np.abs(Rj - A[~bad]) <= jtol).all()


# ------------------------------------------------------------ _mult -------
def _perturbed(h, seed=8):
    rng = np.random.default_rng(seed)
    S0 = {k: v.numpy() for k, v in h.S0.items()}
    return state_from_numpy({
        "x": S0["x"] + 0.002 * rng.normal(size=S0["x"].shape),
        "v": np.where(h.ess_mask, 0.0, 0.1 * rng.normal(size=S0["v"].shape)),
        "e": S0["e"] + 0.5}, device="cpu")


def test_q8_ozaki_mult_matches_native():
    """The port's Ozaki `_mult` at Q8 (the lattice path with the IR
    velocity solve) against its native `_mult` on a perturbed
    Taylor-Green state.

    The q-update (6-slice gradients: stress and dt within 1e-12, measured
    5.4e-14 and 3.3e-14), the force pair, the H1 mass apply and the L2
    mass apply on seeded vectors within 1e-13; then `_mult` on the same
    stress: x and v within 1e-12 (v 1.1e-14 measured).  The energy rate
    comes from the L2 CG, which stops at its 300 cap at this order in both
    modes (the degree-7 Bernstein element mass has condition ~2.7e11,
    ROADMAP C6): its iterate rides on round-off, so operators 1.5e-15
    apart give rates 3.6e-2 of max|de| apart (x86-64 CPU, torch 2.13).
    The bound 1e-1 is that gap's decade, as
    `test_torch_high_order.test_l2_cg_capped_at_q8_converges_at_q4` holds
    the two packages' capped solves; both stop at the cap."""
    h0, h1 = _hydro(False), _hydro(True)
    S = _perturbed(h0)
    sJ0, dt0 = h0._qupdate(S)
    sJ1, dt1 = h1._qupdate(S)
    assert _rel(sJ1, sJ0) <= 1e-12
    assert abs(float(dt1) - float(dt0)) <= 1e-12 * float(dt0)
    assert _rel(h1._force_rhs_raw(sJ0), h0._force_rhs_raw(sJ0)) <= 1e-13
    assert _rel(h1._force_transpose(sJ0, S["v"]),
                h0._force_transpose(sJ0, S["v"])) <= 1e-13
    rng = np.random.default_rng(9)
    u = torch.tensor(rng.normal(size=(3, h0.ndof)))
    assert _rel(h1._h1_apply_bc(u), h0._h1_apply_bc(u)) <= 1e-13
    ue = torch.tensor(rng.normal(size=(h0.NE, h0.ld)))
    assert _rel(tmass.mass_apply_e(ue, h1.massD, h1.tables["L2B"], 3,
                                   oz=h1.oz["l2"]),
                tmass.mass_apply_e(ue, h0.massD, h0.tables["L2B"], 3)) \
        <= 1e-13
    a, _, (h1a, l2a) = h0._mult(S, sJ0)
    b, _, (h1b, l2b) = h1._mult(S, sJ0)
    assert _rel(b["x"], a["x"]) <= 1e-12
    assert _rel(b["v"], a["v"]) <= 1e-12
    assert int(l2a) == int(l2b) == h0.opt.cg_max_iter
    assert _rel(b["e"], a["e"]) <= 1e-1
    st = h1.ir_stats()
    assert st["solves"] >= 1 and st["inner_sweeps"] > 0
