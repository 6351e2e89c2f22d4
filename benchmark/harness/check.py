"""Whether the window's steps are right: the plain reference against what
the timed path produced.

The reference cannot run the hundreds of steps of a run in the time of a
window, so it follows the program from the program's own states: for each
sample, drawn from the seed, of three consecutive accepted states
S_(g-2), S_(g-1), S_g of the window, it takes step g-1 from S_(g-2) at the
dt the program took, then proposes the next dt from its own estimate and
takes step g from S_(g-1), rejecting and retrying as the driver does.  A
dt decision of the program that differs from the reference's changes
step g by 2 % or more.  The start, which this skips, is checked by itself:
the program's set-up state against the reference's.

The numbers compared, each the worst over the steps checked:
  start   max |S0 - S0_ref| / max |S0_ref| over x and e (v0 = 0 exactly);
  step_x, step_v, step_e
          max |S_g - S_g,ref| / max |S_g,ref - S_(g-1)|, the error of the
          step's increment against the increment, of x, v and e."""

from __future__ import annotations

NUMBERS = ("start", "step_x", "step_v", "step_e")
# the driver's growth factors of an accepted dt (laghos.cpp); any other
# ratio of two consecutive dts means a rejection between them
_GROWTH = (1.0, 1.02)


def _rel(prog, ref, base=None):
    diff = float((prog.double() - ref).abs().max())
    scale = ref if base is None else ref - base.double()
    den = float(scale.abs().max())
    return diff / den if den > 0 else diff


def after_reject(ts, g):
    """Whether step g followed a rejected attempt, from the times of the
    accepted steps (ts[k] = t after step k)."""
    ratio = (ts[g] - ts[g - 1]) / (ts[g - 1] - ts[g - 2])
    return not any(abs(ratio - f) < 1e-9 for f in _GROWTH)


def compare(ref, S0, samples, ts, limits, log=print):
    """Hold the program to the reference `ref` (a built reference
    problem).  S0: the program's set-up state; samples: {g: (S_(g-2),
    S_(g-1), S_g)} on the reference's device; ts: the t of every accepted
    step from step 0.  Returns (correct, checked, failed, checks)."""
    R0 = ref.initial_state()
    start = max(_rel(S0[k], R0[k]) for k in ("x", "e"))
    v0 = float(S0["v"].abs().max())
    start = max(start, v0)
    over = [start > limits["start"]]
    worst = {k: 0.0 for k in ("x", "v", "e")}
    for g in sorted(samples):
        Sa, Sb, Sc = ({k: s[k].double() for k in s} for s in samples[g])
        dt_b = ts[g - 1] - ts[g - 2]
        Rb, _, est, _ = ref.step(Sa, dt_b,
                                 after_reject=after_reject(ts, g - 1))
        Rc, dt_c, _, rej = ref.step(Sb, ref.next_dt(dt_b, est))
        for S, R, base, step in ((Sb, Rb, Sa, g - 1), (Sc, Rc, Sb, g)):
            err = {k: _rel(S[k], R[k], base[k]) for k in worst}
            log(f"step {step}: increment errors x {err['x']:.3e} v "
                f"{err['v']:.3e} e {err['e']:.3e}")
            over.append(any(err[k] > limits[f"step_{k}"] for k in err))
            for k in worst:
                worst[k] = max(worst[k], err[k])
        log(f"step {g}: the reference's dt {dt_c:.9e} after {rej} "
            f"rejections, the program's {ts[g] - ts[g - 1]:.9e}")
    values = {"start": start, "step_x": worst["x"], "step_v": worst["v"],
              "step_e": worst["e"]}
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    correct = bool(samples) and all(values[k] <= limits[k] for k in NUMBERS)
    return correct, len(over), sum(over), checks
