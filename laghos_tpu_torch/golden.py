"""The reference's nine "Verification of Results" runs through the port's
CLI (reference README.md:225-235, the main table of BASELINE.md).

    python -m laghos_tpu_torch.golden <row>|all [-d cpu|cuda]

Each row runs its reference command line as written (`-m` names the
built-in geometry of the reference's data file) through `cli.main` to
t_final.  A row passes when its step count is exact, its printed dt (6
decimals) equals the table's and its final |e| is within relative 1e-9 of
the table's, the gate of the JAX package's scripts/golden_run.py.  Prints
one line per row with its seconds; exits non-zero if a row fails.

The built-in `box01_hex` of row 7 is a uniform 4x2x2 box, a stand-in for
the reference's non-uniform box file, so the table's figures do not apply
to it: row 7 runs and is reported as having no reference mesh, neither
passed nor failed.  tests/test_torch_fa.py holds it to the JAX package's
run of the same command on the same mesh.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time

# row: (reference command line, step, dt, |e|)
GOLDEN = {
    1: ("-p 0 -m square01_quad -rs 3 -tf 0.75 -pa",
        339, 0.000702, 4.9695537349e+01),
    2: ("-p 0 -m cube01_hex -rs 1 -tf 0.75 -pa",
        1041, 0.000121, 3.3909635545e+03),
    3: ("-p 1 -m square01_quad -rs 3 -tf 0.8 -pa",
        1154, 0.001655, 4.6303396053e+01),
    4: ("-p 1 -m cube01_hex -E0 2 -rs 2 -tf 0.6 -pa",
        560, 0.002449, 1.3408616722e+02),
    5: ("-p 2 -m segment01 -rs 5 -tf 0.2 -fa",
        413, 0.000470, 3.2012077410e+01),
    6: ("-p 3 -m rectangle01_quad -rs 2 -tf 3.0 -pa",
        2872, 0.000064, 5.6547039096e+01),
    7: ("-p 3 -m box01_hex -rs 1 -tf 5.0 -pa",
        858, 0.000474, 5.6691500623e+01),
    8: ("-p 4 -m square_gresho -rs 3 -ok 3 -ot 2 -tf 0.62831853 -s 7 -pa",
        776, 0.000045, 4.0982431726e+02),
    9: ("-p 7 -m rt2D -tf 4 -rs 1 -ok 4 -ot 3 -pa",
        2462, 0.000050, 1.1792848680e+02),
}
# rows whose built-in mesh is a stand-in for the reference's mesh file
NO_REF_MESH = {7}
REL_TOL = 1e-9


def run_row(row: int, device: str = "cuda", verbose: bool = False) -> dict:
    """Run one row through the CLI; returns its figures and `ok` (None for
    a row without its reference mesh), and the CLI's result as `run`."""
    from . import cli

    cmd, ref_step, ref_dt, ref_e = GOLDEN[row]
    argv = cmd.split() + ["-d", device, "-vs", "100"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with (contextlib.nullcontext() if verbose
          else contextlib.redirect_stdout(out)):
        run = cli.main(argv)
    seconds = time.perf_counter() - t0
    res = run.result
    rel = abs(res.e_norm - ref_e) / ref_e
    dt_ok = f"{res.dt:.6f}" == f"{ref_dt:.6f}"
    ok = (None if row in NO_REF_MESH
          else res.steps == ref_step and dt_ok and rel < REL_TOL)
    return dict(row=row, cmd=cmd, steps=res.steps,
                ref_step=ref_step, dt=res.dt, ref_dt=ref_dt,
                e_norm=res.e_norm, ref_e=ref_e, rel=rel,
                seconds=seconds, ok=ok, run=run, output=out.getvalue())


def line(r: dict) -> str:
    verdict = {True: "OK", False: "FAIL",
               None: "NO-REFERENCE-MESH (built-in stand-in)"}[r["ok"]]
    return (f"row {r['row']} ({r['cmd']}): steps {r['steps']} (ref "
            f"{r['ref_step']}), dt {r['dt']:.6f} (ref {r['ref_dt']:.6f}), "
            f"|e| {r['e_norm']:.10e} (ref {r['ref_e']:.10e}, rel "
            f"{r['rel']:.2e}), {r['seconds']:.1f} s {verdict}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="laghos_tpu_torch.golden")
    ap.add_argument("row", help="a row of the table (1-9) or 'all'")
    ap.add_argument("-d", "--device", default="cuda",
                    choices=["cpu", "cuda"])
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show the CLI's output")
    args = ap.parse_args(argv)
    rows = sorted(GOLDEN) if args.row == "all" else [int(args.row)]
    ok, no_ref = True, []
    for row in rows:
        r = run_row(row, args.device, args.verbose)
        print(line(r), flush=True)
        ok &= r["ok"] is not False
        if r["ok"] is None:
            no_ref.append(str(row))
    if len(rows) > 1:
        print(("ALL-OK" if ok else "SOME-FAILED")
              + (f" (not held, no reference mesh: row {', '.join(no_ref)})"
                 if no_ref else ""))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
