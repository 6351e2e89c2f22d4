"""The device loop across ranks: `hydro.segment_loop` over a rank view.

The port's counterpart of `laghos_tpu.parallel.segment`, which runs the
adaptive-dt control flow in one shard_map'd while_loop.  Here each rank
runs `Hydro.run_segment` on its view: the q-update's dt is all-reduced to
the minimum, the step's CG dots and the finite guard read all-reduced
sums (parallel/view.py), so every rank takes the same branch at every
attempt and reads its CG flags on the same schedule (`cg(reads=)`, the
previous stop of each solve being the same on every rank).  The
trajectory is the distributed host loop's, bit for bit.

At the end of each segment the ranks check that they agree on (t, dt,
step, attempts): a rank that diverged raises here, with the values,
instead of deadlocking in a later collective.
"""

from __future__ import annotations

import torch

from ..hydro import Hydro


def check_lockstep(comm, scalars, what="segment"):
    """Raise RuntimeError unless every rank holds the same `scalars` (0-d
    tensors or numbers); a collective."""
    v = torch.stack([torch.as_tensor(s, dtype=torch.float64).reshape(())
                     .to(comm.device) for s in scalars])
    lo, hi = comm.allreduce_min(v), comm.allreduce_max(v)
    if not torch.equal(lo, hi):
        raise RuntimeError(f"rank {comm.rank}: the ranks left lockstep at "
                           f"the end of a {what}: min {lo.tolist()}, max "
                           f"{hi.tolist()}")


def run_segment(view, S, t, dt, ti, steps, sj, count_stage1, t_final,
                max_steps, vis_steps, chk, on_reject=None):
    """`Hydro.run_segment` on the rank view `view`, then the lockstep
    check; returns the same carry."""
    out = Hydro.run_segment(view, S, t, dt, ti, steps, sj, count_stage1,
                            t_final, max_steps, vis_steps, chk,
                            on_reject=on_reject)
    check_lockstep(view.comm, out[1:5])
    return out
