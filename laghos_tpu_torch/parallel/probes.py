"""Rank functions of the distributed checks.

They live in the package, beside `runs`, so that the spawned ranks import
neither a test module nor JAX; nothing of the run path imports them.
`comm_probe` exercises `Comm` (its collectives, the checked exchange, a
rank's failure or stall), `halo_probe` the generic halo layout, and
`view_dt` and `view_roundtrip` a rank view of a `runs` spec without a run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .runs import build_hydro, launches, spec_view


def comm_probe(comm, mismatch=None, fail_rank=None, stall_rank=None) -> dict:
    """All-reduces of rank + 1, and two exchanges of (2, 3) planes filled
    with the rank with both neighbours of a chain (the second skips the
    header round: `checked` counts the headers swapped).  `mismatch`
    ("dtype" or "shape") makes rank 1's plane differ from what its peers
    expect; `fail_rank` raises on that rank; `stall_rank` sleeps for a
    minute first, leaving its peers waiting."""
    if comm.rank == fail_rank:
        raise RuntimeError(f"probe failure on rank {comm.rank}")
    if comm.rank == stall_rank:
        time.sleep(60.0)
    t = torch.tensor([comm.rank + 1.0], dtype=torch.float64,
                     device=comm.device)
    out = {"sum": float(comm.allreduce_sum(t)),
           "min": float(comm.allreduce_min(t)),
           "max": float(comm.allreduce_max(t))}
    shape, dtype = (2, 3), torch.float64
    if comm.rank == 1 and mismatch == "dtype":
        dtype = torch.float32
    if comm.rank == 1 and mismatch == "shape":
        shape = (3, 3)
    peers = [p for p in (comm.rank - 1, comm.rank + 1) if 0 <= p < comm.size]
    out["got"], out["checked"] = [], []
    for _ in range(2):
        got = comm.exchange({p: torch.full(shape, float(comm.rank),
                                           dtype=dtype, device=comm.device)
                             for p in peers})
        out["got"].append({p: v.cpu().numpy() for p, v in got.items()})
        out["checked"].append(len(comm._checked))
    return out


def halo_probe(comm, spec, seed=0) -> dict:
    """Each rank assembles the H1 mass apply of a random field over its
    slab's elements only (parallel/halo.py's layout), adds its
    neighbours' shares with `halo_exchange_add`, and returns its dofs'
    values, with the global assembly's."""
    from ..ops import mass as mop
    from . import halo

    h = build_hydro(spec)
    lay = halo.build_layout(h.h1, comm.size)
    k = comm.rank
    u = torch.as_tensor(np.random.default_rng(seed).normal(
        size=(h.dim, h.ndof)), dtype=h.dtype)
    full = mop.h1_mass_apply(u, h.gather, h.ndof, h.massD, h.tables["H1B"],
                             h.dim)
    els, dofs = lay.elems[k], lay.loc_of_glob[k]
    loc = mop.h1_mass_apply(u[:, dofs], torch.as_tensor(lay.gather[k],
                                                     dtype=torch.long),
                            dofs.size, h.massD[els], h.tables["H1B"], h.dim)
    y = halo.halo_exchange_add(loc.to(comm.device), lay, comm)
    return {"local": y.cpu().numpy(), "global": full[:, dofs].numpy()}


def view_dt(comm, spec) -> dict:
    """The all-reduced dt estimate of the view's initial state."""
    _, view = spec_view(comm, spec)
    dtm, _ = view.dt_estimate_full(view.S0)
    return {"dt": float(dtm), "launches": launches()}


def view_roundtrip(comm, spec) -> dict:
    """The global state of the view's initial state, and whether the view
    takes its block of it back unchanged."""
    _, view = spec_view(comm, spec)
    G = view.to_global(view.S0)
    back = view.from_global(G)
    return {"S": {k: v.numpy() for k, v in G.items()},
            "back_equal": all(torch.equal(back[k], view.S0[k])
                              for k in back)}
