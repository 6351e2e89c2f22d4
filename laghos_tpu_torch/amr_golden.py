"""The reference AMR variant's golden table (amr/README.md:98-103, the AMR
table of BASELINE.md) through the port's AMR driver.

    python -m laghos_tpu_torch.amr_golden <row>|all [-d cpu|cuda]
        [--out DIR] [--row4-seconds S]

Rows 1-3 run from t = 0 to t_final, as `-p 1 -m <mesh> -rs <rs> -tf <tf>
-amr` (with -ok/-ot/-rt as the table sets them, -cgt 1e-8).  Row 4 resumes
the JAX package's committed checkpoint (runs/amr_ckpt_row4.pkl, step 1801,
t = 0.094) and runs on for at most --row4-seconds of wall time; it writes
its own checkpoint to DIR (never to runs/), from which a later call goes
on.  For each row the line gives steps, final dt, |e| and final NE beside
three references: the table, the JAX package's endpoint (docs/AMR_RUNS.md),
and, where runs/ holds the JAX package's step-indexed trace, the first step
where |e| leaves it by more than 1e-10 relative and the first refine or
derefine decision that differs (`scripts/amr_trace_diff.py`'s measures),
over the steps the run made itself (runs/amr_trace_row4.json ends at step
1764, before row 4's checkpoint, so row 4 has none in common).
Wall seconds are split into stepping (the device steps and the indicator
reads) and host rebuild (forest, transfers, space and operator rebuilds).
Each row's trace goes to DIR/amr_trace_row<N>.json.

A row that reaches t_final passes when its |e| is within relative 5e-3
of the table's (the JAX package's own worst is 4.0e-3, row 3: refinement
thresholds turn round-off into different meshes); exits non-zero if one
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# row: mesh, rs, tf, -ok, -ot, -rt; the table's (steps, dt, |e|); the JAX
# package's endpoint (steps, dt, |e|, NE) from docs/AMR_RUNS.md or None
ROWS = {
    1: dict(mesh="square01_quad", rs=4, tf=0.8, ok=2, ot=1, rt=2e-4,
            ref=(2374, 0.000308, 90.9397751791),
            jax=(2371, 0.000606, 90.9415397219, None)),
    2: dict(mesh="square01_quad", rs=4, tf=0.8, ok=3, ot=2, rt=2e-4,
            ref=(2727, 0.000458, 168.0063715464),
            jax=(2726, 0.000233, 167.7027894633, None)),
    3: dict(mesh="cube01_hex", rs=3, tf=0.6, ok=2, ot=1, rt=2e-4,
            ref=(998, 0.001262, 388.6322346715),
            jax=(999, 0.000570, 387.0903035404, 2507)),
    4: dict(mesh="cube01_hex", rs=4, tf=0.6, ok=2, ot=1, rt=1e-3,
            ref=(2463, 0.000113, 1703.2772575684), jax=None),
}
REL_TOL = 5e-3
ROW4_CKPT = os.path.join(ROOT, "runs", "amr_ckpt_row4.pkl")


def jax_trace(row):
    """The JAX package's trace of `row` in runs/ (None if there is none)."""
    path = os.path.join(ROOT, "runs", f"amr_trace_row{row}.json")
    if not os.path.exists(path):
        return None, path
    with open(path) as fp:
        return json.load(fp), path


def divergence(trace, ref, e_tol=1e-10, start=1):
    """First accepted step where |e| leaves `ref` by more than e_tol
    relative, and first where NE, n_ref or n_deref differ, over the steps
    from `start` on that both traces hold (`scripts/amr_trace_diff.py`'s
    measures).  Returns (first_e, first_flip, n_common)."""
    def steps(recs):
        return {r["ti"]: r for r in recs if "t" in r and r["ti"] >= start}

    A, B = steps(trace), steps(ref)
    common = sorted(set(A) & set(B))
    first_e = first_flip = None
    for ti in common:
        a, b = A[ti], B[ti]
        if first_e is None and (abs(a["e_norm"] - b["e_norm"])
                                > e_tol * abs(b["e_norm"])):
            first_e = ti
        if first_flip is None and any(a[k] != b[k] for k in
                                      ("NE", "n_ref", "n_deref")):
            first_flip = ti
    return first_e, first_flip, len(common)


def build(row, device):
    """(hydro, resume checkpoint or None, Options) of `row`."""
    from .amr.driver import load_checkpoint, resume_amr_hydro
    from .amr.forest import Forest
    from .amr.solver import AMRHydro
    from .hydro import Options

    cfg = ROWS[row]
    opt = Options(problem=1, blast_energy=0.25, order_v=cfg["ok"],
                  order_e=cfg["ot"], cg_tol=1e-8)
    if row == 4:
        ck = load_checkpoint(ROW4_CKPT)
        return resume_amr_hydro(ck, opt, device=device), ck
    dim = 2 if cfg["mesh"] == "square01_quad" else 3
    f = Forest(dim, (2,) * dim, (1.0,) * dim, max_depth=cfg["rs"])
    # RefineAtVertex at the blast corner, rs times, without 2:1 balancing
    # (amr/laghos.cpp:199-209)
    for _ in range(cfg["rs"]):
        corner = [k for k in f.leaf_list() if all(v == 0 for v in k[1])]
        f.refine(corner, balance=False)
    return AMRHydro(f, opt, h0=0.5 / cfg["ok"], device=device), None


def run_row(row, device="cuda", out="chiprun_out", row4_seconds=900.0):
    """Run `row`; returns (passed or None when it did not reach t_final,
    its report line, the result dict)."""
    from .amr.driver import run_amr

    cfg = ROWS[row]
    os.makedirs(out, exist_ok=True)
    t0 = time.perf_counter()
    h, ck = build(row, device)
    setup = time.perf_counter() - t0
    trace = list(ck.get("trace") or []) if ck else []
    kw = {}
    if ck is not None:
        kw = dict(resume=ck, wall_limit=row4_seconds,
                  ckpt_path=os.path.join(out, f"amr_ckpt_row{row}.pkl"),
                  ckpt_every=100)
    res = run_amr(h, t_final=cfg["tf"], ref_threshold=cfg["rt"],
                  vis_steps=10**9, trace=trace, **kw)
    with open(os.path.join(out, f"amr_trace_row{row}.json"), "w") as fp:
        json.dump(trace, fp)
    done = res["t"] >= cfg["tf"] - 1e-14
    steps, dt_ref, e_ref = cfg["ref"]
    rel = abs(res["e_norm"] - e_ref) / e_ref
    line = (f"AMR row {row} ({cfg['mesh']} rs{cfg['rs']} Q{cfg['ok']}-"
            f"Q{cfg['ot']} rt {cfg['rt']:g}): ")
    if ck is not None:
        line += (f"resumed at step {ck['ti'] - 1} (t {ck['t']:.4f}, NE "
                 f"{len(ck['forest']['leaves'])}), ")
    line += (f"steps {res['steps']}, t {res['t']:.6f}, dt {res['dt']:.6f}, "
             f"|e| {res['e_norm']:.10f}, NE {res['NE']}; table "
             f"{steps} / {dt_ref} / {e_ref} (|e| rel {rel:.2e})")
    if cfg["jax"]:
        js, jdt, je, jne = cfg["jax"]
        line += (f"; JAX {js} / {jdt} / {je} (|e| rel "
                 f"{abs(res['e_norm'] - je) / je:.2e}"
                 + (f", NE {jne})" if jne else ")"))
    ref, path = jax_trace(row)
    if ref is None:
        line += "; no JAX trace in runs/"
    else:
        fe, ff, n = divergence(trace, ref, start=ck["ti"] if ck else 1)
        line += (f"; against {os.path.relpath(path, ROOT)} over {n} common "
                 f"steps: first |e| divergence > 1e-10 at step {fe}, first "
                 f"decision difference at step {ff}")
    sec = res["seconds"]
    line += (f"; seconds: setup {setup:.1f}, stepping {sec['stepping']:.1f},"
             f" host rebuild {sec['rebuild']:.1f} ({res['mesh_changes']} "
             f"mesh changes)")
    passed = (rel <= REL_TOL) if done else None
    line += {True: "  PASS", False: "  FAIL", None: "  (not at t_final)"}[
        passed]
    return passed, line, res


def main(argv=None):
    p = argparse.ArgumentParser(prog="laghos_tpu_torch.amr_golden")
    p.add_argument("row", help="1-4 or all")
    p.add_argument("-d", "--device", default="cuda", choices=["cpu", "cuda"])
    p.add_argument("--out", default="chiprun_out",
                   help="directory of the traces and row 4's checkpoint")
    p.add_argument("--row4-seconds", type=float, default=900.0,
                   help="wall-time budget of row 4's resumed run")
    args = p.parse_args(argv)
    rows = sorted(ROWS) if args.row == "all" else [int(args.row)]
    failed = []
    for row in rows:
        passed, line, _ = run_row(row, args.device, args.out,
                                  args.row4_seconds)
        print(line, flush=True)
        if passed is False:
            failed.append(row)
    if failed:
        print(f"FAILED rows: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
