"""Parameter sweeps: B independent runs of one `Hydro` on one card.

The reference runs parameter studies (blast energy, CFL, resolution
ladders) as separate jobs.  `laghos_tpu.batch` vmaps its on-device
adaptive-dt loop over a leading member axis; PyTorch has no vmap over a
data-dependent loop, so here the members run one after another, each
through `hydro.segment_loop` (`Hydro.run_segment`) with its control
scalars on the card, and the results are stacked on a leading B axis.
Each member equals a separate `driver.run` of the port on the same
`Hydro`, bit for bit.  A batched member axis is later work (ROADMAP).

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


def sweep(hydro, S_batch, t_final, *, max_steps=-1, n_devices=None):
    """Run every member of `S_batch` (leading axis B) to `t_final`;
    returns {"S", "t", "dt", "steps", "crashed", "h1_iters", "l2_iters"}
    with a leading B axis, the keys of `laghos_tpu.batch.sweep` ("steps"
    counts step attempts, rejected ones included, as there; t and dt are
    f64, the control scalars' type).  A member that crashes stops there,
    flagged.

    `n_devices` (the JAX package's member axis sharded over chips) needs
    the distributed slice and raises NotImplementedError."""
    if n_devices is not None:
        raise NotImplementedError(
            "batch.sweep over several devices is not ported yet (ROADMAP "
            "A11)")
    outs = []
    for b in range(S_batch["e"].shape[0]):
        S = {k: v[b] for k, v in S_batch.items()}
        sj, dt0 = hydro._qupdate(S)
        dt0 = hydro._guard_finite(S, dt0)
        # no vis pauses inside a sweep, no check pauses
        (S2, t2, dt2, _, steps2, _, _, _, crashed, h1a, l2a,
         _) = hydro.run_segment(S, 0.0, dt0, 1, 0, sj, False, t_final,
                                max_steps, 2**30, [-1])
        outs.append({"S": S2, "t": t2, "dt": dt2, "steps": steps2,
                     "crashed": crashed, "h1_iters": h1a, "l2_iters": l2a})
    out = {k: torch.stack([o[k] for o in outs])
           for k in ("t", "dt", "steps", "crashed", "h1_iters", "l2_iters")}
    out["S"] = {k: torch.stack([o["S"][k] for o in outs])
                for k in ("x", "v", "e")}
    return out
