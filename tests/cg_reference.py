"""The JAX package's solutions of `Hydro`'s velocity and energy CG systems,
kept in tests/data/cg_jax_reference.npz for the card's tests, which import
no JAX: 3D Sedov (problem 1) on the (2, 2, 2) unit box refined `rs` times,
at both benchmark cells' orders (Q2-Q1 and Q4-Q3), Jacobi, the default
(whole-lattice) path, CG tolerance 1e-14, on the fixed right-hand sides of
`rhs`.  The velocity system is `laghos_tpu.solvers.cg` on `_h1_apply_bc`
with `_precond_velocity`, the energy system `Hydro._cg_energy`.

    JAX_PLATFORMS=cpu python tests/cg_reference.py

writes the file anew; tests/test_torch_ops.py::test_cg_reference_is_jax
holds the file to the JAX package on every CPU run.  This module imports
JAX only inside `solve_jax`."""

import os

import numpy as np

# (order_v, order_e), rs
CASES = (((2, 1), 0), ((2, 1), 1), ((4, 3), 0), ((4, 3), 1))
TOL = 1e-14
MAX_ITER = 300
PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "cg_jax_reference.npz")


def options(orders):
    return dict(problem=1, order_v=orders[0], order_e=orders[1],
                precond="jacobi", cg_tol=TOL, cg_max_iter=MAX_ITER)


def key(orders, rs, name):
    return f"q{orders[0]}q{orders[1]}_rs{rs}_{name}"


def rhs(shape, offset):
    """A fixed right-hand side in [-0.5, 0.5): the fractional parts of k
    times the golden ratio, k the flat index, each an exactly rounded
    product and an exact remainder, so every machine makes the same
    bits."""
    k = np.arange(int(np.prod(shape)), dtype=np.float64)
    return ((k * 0.6180339887498949 + offset) % 1.0 - 0.5).reshape(shape)


def velocity_rhs(ess_mask):
    """The velocity system's b (dim, ndof), zero at the essential dofs."""
    return np.where(ess_mask, 0.0, rhs(ess_mask.shape, 0.25))


def solve_jax(orders, rs):
    """{name: array} of the JAX package's solves at one case: the velocity
    x (dim, ndof) and iterations (dim,), the energy x (NE, ld) and its
    iteration count."""
    import jax
    import jax.numpy as jnp

    from laghos_tpu.fem import mesh as jmesh
    from laghos_tpu.hydro import Hydro, Options
    from laghos_tpu.solvers.cg import cg

    m = jmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(rs):
        m = jmesh.uniform_refine(m)
    h = Hydro(m, Options(**options(orders)))
    b = jnp.asarray(velocity_rhs(np.asarray(h.ess_mask)))
    v = jax.jit(lambda r: cg(h._h1_apply_bc, r, TOL, MAX_ITER,
                             precond=h._precond_velocity))(b)
    e_x, e_it = jax.jit(h._cg_energy)(jnp.asarray(rhs((h.NE, h.ld), 0.75)))
    return {"v_x": np.asarray(v.x), "v_iters": np.asarray(v.iters),
            "e_x": np.asarray(e_x), "e_iters": np.asarray(e_it)}


def load():
    with np.load(PATH) as f:
        return {k: f[k] for k in f.files}


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    out = {}
    for orders, rs in CASES:
        for name, a in solve_jax(orders, rs).items():
            out[key(orders, rs, name)] = a
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **out)
    print(PATH, {k: a.shape for k, a in out.items()})
