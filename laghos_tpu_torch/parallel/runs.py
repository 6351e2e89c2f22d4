"""Distributed runs as rank functions for `comm.launch`.

`run_view(comm, spec)`: every rank builds the spec's mesh (the CLI's mesh
flags, through `cli.make_mesh`) and global `Hydro` on the host, takes its
view as the CLI does (`sharding.rank_view`), runs `driver.run` on it and
returns the global summary, the same on every rank.  The spec:

    {"mesh": ["-dim", "3", "-rs", "1"],   # the CLI's mesh flags
     "opt": {...},                        # hydro.Options fields
     "halo": True,                        # slabs / chunks, or replicated
     "mesh_shape": None | (Dz,) | (Dz, Dy),
     "run": {...}}                        # driver.run keyword arguments

`sweep_ranks` runs the collective sweep, `batch.sweep(n_devices=...)`.
"""

from __future__ import annotations

from .. import driver
from ..hydro import Hydro, Options
from ..ops import omm, qphys
from .sharding import rank_view


def build_mesh(spec):
    """The mesh of the spec's CLI mesh flags, as `cli.make_mesh` builds it."""
    from .. import cli

    return cli.make_mesh(cli.build_parser().parse_args(spec["mesh"]))


def build_hydro(spec, device="cpu") -> Hydro:
    """The spec's global f64 Hydro on `device` (the host for the views)."""
    return Hydro(build_mesh(spec), Options(**spec.get("opt", {})),
                 device=device)


def spec_view(comm, spec):
    """(the global Hydro on the host, this rank's view of it)."""
    h = build_hydro(spec)
    return h, rank_view(h, comm, spec.get("halo", True),
                        spec.get("mesh_shape"))


def launches() -> dict:
    """The kernel wrappers' launch counts in this process."""
    return {"element": qphys.physics_3d.launches,
            "lattice": qphys.physics_3d_lattice.launches,
            "packed": qphys.physics_3d_packed.launches,
            "split": omm.split_dyn.launches}


def run_view(comm, spec) -> dict:
    """Rank function: the spec's run on this rank's view; the global
    summary (steps, t, dt, |e|, energies, CG totals, norms, the final
    global state as NumPy arrays, this rank's kernel launches)."""
    _, view = spec_view(comm, spec)
    r = driver.run(view, **spec.get("run", {}))
    G = view.to_global(r.S)
    return {"steps": r.steps, "t": r.t, "dt": r.dt, "e_norm": r.e_norm,
            "energy_init": r.energy_init, "energy_final": r.energy_final,
            "h1_iters": r.h1_iters, "l2_iters": r.l2_iters,
            "norms": r.norms,
            "S": {k: v.detach().cpu().numpy() for k, v in G.items()},
            "launches": launches(), "NE": view.NE}


def sweep_ranks(comm, spec, energies, t_final, max_steps) -> dict:
    """Rank function: `batch.sweep(n_devices=comm.size)` of the Sedov
    blast-energy batch `energies` on the spec's Hydro, built on the rank's
    device; the whole batch's results as NumPy arrays, with this rank's
    share."""
    from .. import batch

    h = build_hydro(spec, comm.device)
    out = batch.sweep(h, batch.blast_states(h, energies), t_final,
                      max_steps=max_steps, n_devices=comm.size, comm=comm)
    res = {k: v.cpu().numpy() for k, v in out.items() if k != "S"}
    res["S"] = {k: v.cpu().numpy() for k, v in out["S"].items()}
    B = len(energies)
    res["share"] = (comm.rank * B // comm.size,
                    (comm.rank + 1) * B // comm.size)
    return res
