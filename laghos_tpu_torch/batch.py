"""Parameter sweeps: B independent runs of one `Hydro` on one card.

The reference runs parameter studies (blast energy, CFL, resolution
ladders) as separate jobs.  `laghos_tpu.batch` vmaps its on-device
adaptive-dt loop over a leading member axis; PyTorch has no vmap over a
data-dependent loop, so here the members run one after another, each
through `hydro.segment_loop` (`Hydro.run_segment`) with its control
scalars on the card, and the results are stacked on a leading B axis.
Each member equals a separate `driver.run` of the port on the same
`Hydro`, bit for bit.  A batched member axis is later work (ROADMAP).

Over ranks (`n_devices` with a `comm` of that many ranks, parallel/
comm.py, where the JAX package shards the member axis over chips), every
rank runs its contiguous share of the members on its own Hydro (B need not
divide evenly: shares differ by at most one member, where JAX pads) and
the shares are all-gathered, so every rank returns the whole batch,
each member bit for bit its single-rank result.

`blast_states` builds the batch of initial states of the common Sedov
blast-energy study (p1's delta initial energy is linear in the blast
energy, laghos.cpp:600-624).
"""

from __future__ import annotations

import torch


def blast_states(hydro, energies) -> dict:
    """Batch of initial states for a blast-energy sweep, on the hydro's
    device.

    Valid for delta-IC problems whose background internal energy is zero
    (Sedov p1: rho0 = 1, e0 = the blast delta only): the L2 energy dofs
    are then linear in the blast energy, so members are exact rescalings
    of the base state.  hydro.opt.blast_energy is the base."""
    e0 = torch.as_tensor(energies, dtype=hydro.dtype).to(hydro.device) \
        / float(hydro.opt.blast_energy)
    B = e0.shape[0]

    def tile(a):
        return a[None].expand((B,) + tuple(a.shape)).contiguous()

    return {"x": tile(hydro.S0["x"]), "v": tile(hydro.S0["v"]),
            "e": hydro.S0["e"][None] * e0[:, None, None]}


def sweep(hydro, S_batch, t_final, *, max_steps=-1, n_devices=None,
          comm=None):
    """Run every member of `S_batch` (leading axis B) to `t_final`;
    returns {"S", "t", "dt", "steps", "crashed", "h1_iters", "l2_iters"}
    with a leading B axis, the keys of `laghos_tpu.batch.sweep` ("steps"
    counts step attempts, rejected ones included, as there; t and dt are
    f64, the control scalars' type).  A member that crashes stops there,
    flagged.

    With `n_devices` a collective call on a group of that many ranks: each
    rank of `comm` (its Comm, comm.size == n_devices) calls sweep with the
    same batch and its own `hydro`, runs its share of the members and
    returns the all-gathered batch.  Raises ValueError outside such a
    group."""
    B = S_batch["e"].shape[0]
    members = range(B)
    if n_devices is not None:
        if comm is None or comm.size != n_devices:
            raise ValueError(
                f"sweep(n_devices={n_devices}) is a collective call on a "
                f"group of {n_devices} ranks: call it on every rank of "
                f"comm.launch(fn, {n_devices}, ...) with comm= the rank's "
                f"Comm (given: {comm})")
        members = range(comm.rank * B // n_devices,
                        (comm.rank + 1) * B // n_devices)
    outs = []
    for b in members:
        S = {k: v[b] for k, v in S_batch.items()}
        sj, dt0 = hydro._qupdate(S)
        dt0 = hydro._guard_finite(S, dt0)
        # no vis pauses inside a sweep, no check pauses
        (S2, t2, dt2, _, steps2, _, _, _, crashed, h1a, l2a,
         _) = hydro.run_segment(S, 0.0, dt0, 1, 0, sj, False, t_final,
                                max_steps, 2**30, [-1])
        outs.append({"S": S2, "t": t2, "dt": dt2, "steps": steps2,
                     "crashed": crashed, "h1_iters": h1a, "l2_iters": l2a})
    if n_devices is not None:
        # every rank's members, in rank order (host copies: the members'
        # bits travel unchanged)
        shares = comm.all_gather([_to(o, "cpu") for o in outs])
        outs = [_to(o, hydro.device) for share in shares for o in share]
    out = {k: torch.stack([o[k] for o in outs])
           for k in ("t", "dt", "steps", "crashed", "h1_iters", "l2_iters")}
    out["S"] = {k: torch.stack([o["S"][k] for o in outs])
                for k in ("x", "v", "e")}
    return out


def _to(o, device):
    """A member's result with every tensor on `device`."""
    return {k: ({kk: vv.to(device) for kk, vv in v.items()}
                if isinstance(v, dict) else v.to(device))
            for k, v in o.items()}
