"""The lattice H1 PA mass apply of the PyTorch port against the JAX package,
on the CPU: `ops/lattice.mass_apply_lattice_plain` (the plain twin of the
CUDA kernel `csrc/lattice_mass.cu`) against
`laghos_tpu.ops.lattice.mass_apply_lattice` on the same seeded inputs, in
2D and 3D, H1 orders 1, 2, 4 and 8, on the raster lattices of the built-in
cubic and non-cubic meshes, with C = dim and C = 1; the twin against the
element route the kernel takes (element applies `mass_apply_e` on the
dofs read from the lattice, then the incidence assembly), on a Hydro's
lattice and on slab and pencil views' local lattices; how the kernel's wrapper
finds the 1D table in the banded tables, or takes the one recorded where
they were built; and the wrapper on CPU tensors: the twin, no launch,
refusals.  The kernel itself is held to the twin on the card
(tests/test_torch_kernels.py).

Tolerances: the twin and the JAX function run the same dense banded
contractions, which the two libraries order differently (a few ulps);
1e-13 x max leaves an order of magnitude of room.  The element route sums
in another order again (test_torch_lattice.py's bound, 1e-13)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laghos_tpu.ops import lattice as jlat
from laghos_tpu_torch import data as tdata
from laghos_tpu_torch.fem import basis as tbasis
from laghos_tpu_torch.fem import mesh as tmesh
from laghos_tpu_torch.fem import quadrature as tquad
from laghos_tpu_torch.hydro import Hydro as THydro
from laghos_tpu_torch.hydro import Options as TOptions
from laghos_tpu_torch.ops import lattice as tlat
from laghos_tpu_torch.ops import mass as tmass

torch.set_num_threads(1)

# raster element dims (n_x, n_y[, n_z]) of the built-in meshes at rs0
MESHES = {"cube01_hex": (2, 2, 2), "box01_hex": (4, 2, 2),
          "square01_quad": (2, 2), "rectangle01_quad": (7, 3)}


def _table(order):
    """The H1 1D table (nq1, order + 1) at the Gauss points of the default
    rule of (order, order - 1)."""
    nq1 = tquad.points_for_order(tquad.default_rule_order(order, order - 1))
    return np.asarray(tbasis.h1_gl_basis(order, nq1).B)


def _operands(dims, order, C, seed=0):
    """(u (C, ndof), Ts (z, y, x), Dq, lat_dims) as numpy f64 arrays on the
    raster lattice of element dims (n_x, n_y[, n_z])."""
    B = _table(order)
    nq1 = B.shape[0]
    n_zyx = tuple(reversed(dims))
    lat = tuple(n * order + 1 for n in n_zyx)
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((C, int(np.prod(lat))))
    Dq = rng.uniform(0.5, 1.5, tuple(n * nq1 for n in n_zyx))
    return u, [tlat.banded_eval_table(B, n) for n in n_zyx], Dq, lat


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


def test_mesh_dims_are_the_hydro_lattices():
    """MESHES holds the raster dims a default Hydro finds on each mesh."""
    for name, dims in MESHES.items():
        h = THydro(tdata.get_mesh(name), TOptions(problem=1), device="cpu")
        assert tuple(h._sm.dims) == dims, name
        assert h._lat_dims == tuple(n * 2 + 1 for n in reversed(dims))


@pytest.mark.parametrize("C", ["dim", 1])
@pytest.mark.parametrize("order", [1, 2, 4, 8])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_mass_apply_lattice_plain_matches_jax(mesh, order, C):
    """f64 within 1e-13 x max of the JAX package's apply; f32 within 1e-5 x
    max of it."""
    dims = MESHES[mesh]
    C = len(dims) if C == "dim" else C
    u, Ts, Dq, lat = _operands(dims, order, C, seed=order)
    y_j = np.asarray(jlat.mass_apply_lattice(
        jnp.asarray(u), [jnp.asarray(T) for T in Ts], jnp.asarray(Dq), lat))
    y_t = tlat.mass_apply_lattice_plain(_t(u), [_t(T) for T in Ts], _t(Dq),
                                        lat)
    assert y_t.dtype == torch.float64 and tuple(y_t.shape) == u.shape
    assert _rel(y_t.numpy(), y_j) <= 1e-13
    f32 = torch.float32
    y32 = tlat.mass_apply_lattice_plain(_t(u, f32), [_t(T, f32) for T in Ts],
                                        _t(Dq, f32), lat)
    assert y32.dtype == f32
    assert _rel(y32.numpy(), y_j) <= 1e-5


def _element_route(u, Ts, Dq, lat, dims):
    """The kernel's route on the CPU: each element's dofs read from the
    lattice at strides (dof (a, b, c) of element (ez, ey, ex) at node
    (ez p + a, ey p + b, ex p + c)), the element apply `mass_apply_e` with
    the 1D table the wrapper finds (`lattice_table`) and D rearranged per
    element, then the incidence assembly."""
    d = len(lat)
    tab = tlat.lattice_table(Ts)
    assert tab.elems == tuple(reversed(dims))
    p = tab.nd1 - 1
    nodes = np.arange(int(np.prod(lat))).reshape(lat)
    blocks = []
    for e in np.ndindex(*tab.elems):          # raster order, x fastest
        sl = tuple(slice(k * p, k * p + p + 1) for k in e)
        blocks.append(nodes[sl].reshape(-1))
    gather = np.stack(blocks)                 # (NE, nd1^d)
    ndof = nodes.size
    u_e = u[:, torch.as_tensor(gather, dtype=torch.long)]
    if d == 3:
        D_e = tlat.qlattice_to_eq(Dq, dims, tab.nq1)
    else:
        D_e = tlat.qlattice_to_eq_2d(Dq, dims, tab.nq1)
    y_e = tmass.mass_apply_e(u_e, D_e, tab.B, d)
    inc, msk = tmass.build_incidence(gather, ndof)
    return tmass.e_to_l_gather(y_e, torch.as_tensor(inc, dtype=torch.long),
                               torch.tensor(msk, dtype=u.dtype))


@pytest.mark.parametrize("mesh", ["cube01_hex", "box01_hex",
                                  "rectangle01_quad"])
def test_plain_matches_element_route_on_hydro_lattice(mesh):
    """On a Hydro's own lattice tables and weights (Q2-Q1 at rs1)."""
    h = THydro(tmesh.uniform_refine(tdata.get_mesh(mesh)),
               TOptions(problem=1), device="cpu")
    dims, lat = tuple(h._sm.dims), h._lat_dims
    rng = np.random.default_rng(7)
    u = _t(rng.standard_normal((h.dim, h.ndof)))
    Ts, Dq = h._lat["Ts"], h._lat["Dq"]
    y = tlat.mass_apply_lattice_plain(u, Ts, Dq, lat)
    assert _rel(y.numpy(), _element_route(u, Ts, Dq, lat, dims).numpy()) \
        <= 1e-13


@pytest.mark.parametrize("rank,mesh_shape", [(1, (2,)), (3, (2, 2))])
def test_plain_matches_element_route_on_slab_view(rank, mesh_shape):
    """A slab (or pencil) view's rank applies the mass on its block's own
    lattice (parallel/slab_hydro.py builds its tables and q-lattice):
    rank 1 of 2 slabs and rank 3 of 2 x 2 pencils of the box at rs1, built
    on a stand-in group (the view's setup sends nothing)."""
    import types

    from laghos_tpu_torch.parallel.slab_hydro import SlabHydro

    h = THydro(tmesh.uniform_refine(tdata.get_mesh("box01_hex")),
               TOptions(problem=1), device="cpu")
    comm = types.SimpleNamespace(rank=rank, size=int(np.prod(mesh_shape)),
                                 device=torch.device("cpu"))
    v = SlabHydro(h, comm, mesh_shape)
    dims, lat = tuple(v._sm.dims), v._lat_dims
    assert lat != h._lat_dims
    rng = np.random.default_rng(rank)
    u = _t(rng.standard_normal((3, int(np.prod(lat)))))
    Ts, Dq = v._lat["Ts"], v._lat["Dq"]
    y = tlat.mass_apply_lattice_plain(u, Ts, Dq, lat)
    assert _rel(y.numpy(), _element_route(u, Ts, Dq, lat, dims).numpy()) \
        <= 1e-13


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("dims", [(3,), (4, 2, 3), (7, 3)])
def test_banded_factors_finds_the_table(dims, order):
    """The elements an axis and the 1D table of build_lattice_ops's banded
    tables, recovered from their values, in f64 and f32 (the Ozaki f32
    shadow's tables), cached per tensor objects and version."""
    B = _table(order)
    Ts = [tlat.banded_eval_table(B, n) for n in reversed(dims)]
    ns, Bf = tlat.banded_factors(Ts)
    assert ns == tuple(reversed(dims))
    np.testing.assert_array_equal(Bf, B)
    for dt in (torch.float64, torch.float32):
        Tt = [_t(T, dt) for T in Ts]
        tab = tlat.lattice_table(Tt)
        assert (tab.elems, tab.nd1, tab.nq1) == (ns, order + 1, B.shape[0])
        assert tab.B.dtype == dt and tab.host.dtype == dt
        assert torch.equal(tab.B, _t(B, dt))
        assert tlat.lattice_table(Tt) is tab


def test_lattice_table_follows_in_place_changes_and_refuses_mixed_bases():
    """An in-place change of a table finds the table again; tables of two
    different 1D bases have no common banded form (ValueError); a table
    that dies leaves the cache."""
    B = _table(2)
    Ts = [_t(tlat.banded_eval_table(B, n)) for n in (2, 3)]
    tab = tlat.lattice_table(Ts)
    for T in Ts:
        T.mul_(2.0)
    again = tlat.lattice_table(Ts)
    assert again is not tab and torch.equal(again.B, 2.0 * tab.B)
    mixed = [tlat.banded_eval_table(_table(2), 4),
             tlat.banded_eval_table(_table(4), 2)]
    assert mixed[0].shape == mixed[1].shape
    with pytest.raises(ValueError, match="banded"):
        tlat.banded_factors(mixed)
    key = tuple(id(T) for T in Ts)
    del Ts, T
    assert key not in tlat._TABLES


@pytest.mark.parametrize("mesh", ["box01_hex", "rectangle01_quad"])
def test_built_tables_carry_their_lattice_table(mesh, monkeypatch):
    """build_lattice_ops records the LatticeTable of the tables it builds,
    and cast_tables that of its f32 copies (the Ozaki inner sweeps'): the
    wrapper finds both without reading the tables' values, and they are
    what the search over the values finds."""
    h = THydro(tdata.get_mesh(mesh), TOptions(problem=1), device="cpu")
    Ts = h._lat["Ts"]
    T32 = tlat.cast_tables(Ts, torch.float32)
    assert all(T.dtype == torch.float32 for T in T32)
    elems, B = tlat.banded_factors([T.numpy() for T in Ts])

    def refuse(_):
        raise AssertionError("the tables' values were searched")

    monkeypatch.setattr(tlat, "banded_factors", refuse)
    for tables, dt in ((Ts, torch.float64), (T32, torch.float32)):
        tab = tlat.lattice_table(tables)
        assert (tab.elems, tab.nd1, tab.nq1) == (elems, *B.shape[::-1])
        assert torch.equal(tab.B, _t(B, dt)) and tab.host.dtype == dt


@pytest.mark.parametrize("mesh", ["cube01_hex", "rectangle01_quad"])
def test_cpu_wrapper_runs_the_twin(mesh):
    """On CPU tensors the wrapper is the twin, bit for bit, and launches
    nothing."""
    dims = MESHES[mesh]
    u, Ts, Dq, lat = _operands(dims, 2, len(dims), seed=3)
    u, Ts, Dq = _t(u), [_t(T) for T in Ts], _t(Dq)
    before = tlat.mass_apply_lattice.launches
    y = tlat.mass_apply_lattice(u, Ts, Dq, lat)
    assert torch.equal(y, tlat.mass_apply_lattice_plain(u, Ts, Dq, lat))
    assert tlat.mass_apply_lattice.launches == before


def test_wrapper_refuses_bad_operands_without_a_card():
    """A wrong or mixed dtype, shapes that do not fit, a non-contiguous
    operand or a table count other than the lattice's axes: ValueError,
    before any device is touched; a device other than the CPU and CUDA
    raises."""
    u, Ts, Dq, lat = _operands((2, 3, 2), 2, 3)
    u, Ts, Dq = _t(u), [_t(T) for T in Ts], _t(Dq)
    f = tlat.mass_apply_lattice
    before = f.launches
    bad = [
        (u.half(), [T.half() for T in Ts], Dq.half(), lat),   # f16
        (u.float(), Ts, Dq, lat),                             # mixed
        (u, Ts, Dq.float(), lat),
        (u[:, :-1].contiguous(), Ts, Dq, lat),                # ndof
        (u.reshape(3, *lat), Ts, Dq, lat),                    # u's rank
        (u, Ts, Dq[:-1].contiguous(), lat),                   # Q_z
        (u, [Ts[0], Ts[1], Ts[2][:, :-1].contiguous()], Dq, lat),
        (u, Ts[:2], Dq, lat),                                 # 2 tables
        (u.t().contiguous().t(), Ts, Dq, lat),                # strides
        (u, [Ts[0].t().contiguous().t()] + Ts[1:], Dq, lat),
        (u, Ts, Dq.transpose(0, 1).contiguous().transpose(0, 1), lat),
    ]
    assert not bad[8][0].is_contiguous()
    for args in bad:
        with pytest.raises(ValueError, match="lattice mass apply"):
            f(*args)
    meta = [t.to("meta") for t in (u, Dq, *Ts)]
    with pytest.raises(NotImplementedError, match="meta"):
        f(meta[0], meta[2:], meta[1], lat)
    assert f.launches == before

