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

`run_amr_view(comm, spec)`: every rank builds the spec's AMRHydro on the
host (from a forest or a checkpoint), distributes it (`sharding.shard_amr`)
and runs `amr.driver.run_amr`.  The spec:

    {"forest": {"dim": 2, "base_n": (2, 2), "sizes": (1.0, 1.0),
                "max_depth": 3, "leaves": [...]},  # Forest.from_leaves
     "h0": 0.25,
     "ckpt": None | path,                 # resume from this checkpoint
     "opt": {...},                        # hydro.Options fields
     "run": {...}}                        # run_amr keyword arguments
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


def run_amr_view(comm, spec) -> dict:
    """Rank function: the spec's AMR run over the ranks; the trace, the
    summary and the final global state (the same on every rank), with this
    rank's element count after its first placement and after each mesh
    change ("elements") and its kernel launches."""
    from ..amr import driver as adrv
    from ..amr.forest import Forest
    from ..amr.solver import AMRHydro
    from .sharding import shard_amr

    opt = Options(**spec["opt"])
    trace, kw = [], dict(spec.get("run", {}))
    if spec.get("ckpt"):
        ck = adrv.load_checkpoint(spec["ckpt"])
        h = adrv.resume_amr_hydro(ck, opt, device="cpu")
        trace, kw["resume"] = list(ck.get("trace", [])), ck
    else:
        h = AMRHydro(Forest.from_leaves(**spec["forest"]), opt,
                     h0=spec["h0"], device="cpu")
    shard_amr(h, comm)
    elements = [h.ctx["gather"].shape[0]]
    place = h._on_rebuild

    def on_rebuild(*build):
        place(*build)
        elements.append(h.ctx["gather"].shape[0])

    h._on_rebuild = on_rebuild
    res = adrv.run_amr(h, trace=trace, **kw)
    xT, vT, e = h.global_state()
    return {"trace": trace, "summary": res, "elements": elements,
            "state": {"x": xT, "v": vT, "e": e},
            "h1_iters": int(h.h1_iters), "launches": launches()}


def run_amr_views(comm, specs) -> list:
    """Rank function: `run_amr_view` of each spec in turn, in one launch."""
    return [run_amr_view(comm, sp) for sp in specs]
