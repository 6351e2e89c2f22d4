"""Time the lattice H1 mass kernel of two or more source trees, in turns.

    python3 lattice_mass_turns.py TREE [TREE ...] [--out FILE]

Each TREE (a checkout holding `chip_smoke.py` and `laghos_tpu_torch/`)
runs in a process of its own, in the order given, so `OLD NEW NEW OLD`
compares two versions of `csrc/lattice_mass.cu` on one card in one call.
A tree builds its own kernels and is measured by its own
`chip_smoke.lattice_mass_check` (the twin at MASS_TOL, two launches
bitwise, the runtime-size body, warm and cold-L2 ms, the bound) on the
cells' lattices: the flagship, Q2-Q1 on 32^3 elements; ns4, Q4-Q3 on 16^3;
q8, Q8-Q7 on 16^3; C = 3, seeded u and q-lattice weights, f64 and f32.
Added here: a SHA-256 of the output's bytes (equal digests across trees:
equal bits), whether the runtime-size body gives the kernel's bits, and
the static SASS counts of the tree's lattice mass kernels.  One JSON line
a tree on stdout, appended to FILE with `--out`.  Needs a CUDA card.
"""

import argparse
import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

# name -> (H1 order, elements (n_z, n_y, n_x))
CELLS = {"flagship": (2, (32, 32, 32)), "ns4": (4, (16, 16, 16)),
         "q8": (8, (16, 16, 16))}
SASS_OPS = ("LDS", "STS", "DFMA", "FFMA", "BAR", "LDGSTS", "ULDC", "LDG",
            "STG")


def _digest(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def measure():
    """The numbers of the tree in the working directory."""
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke
    from laghos_tpu_torch.fem import basis, quadrature
    from laghos_tpu_torch.ops import kernels, lattice

    b = kernels.build()
    out = dict(tree=os.getcwd(), card=chip_smoke.card_line(), cells={})
    for name, (order, elems) in CELLS.items():
        nq1 = quadrature.points_for_order(
            quadrature.default_rule_order(order, order - 1))
        B = np.asarray(basis.h1_gl_basis(order, nq1).B)
        lat = tuple(n * order + 1 for n in elems)
        for dt in (torch.float64, torch.float32):
            rng = np.random.default_rng(0)

            def t(a):
                return torch.tensor(a, dtype=dt, device="cuda")

            u = t(rng.standard_normal((len(elems), math.prod(lat))))
            Ts = [t(lattice.banded_eval_table(B, n)) for n in elems]
            Dq = t(rng.uniform(0.5, 1.5, tuple(n * nq1 for n in elems)))
            cell = chip_smoke.lattice_mass_check(u, Ts, Dq, lat, name,
                                                 "turns")
            y = lattice.mass_apply_lattice(u, Ts, Dq, lat)
            tab = lattice.lattice_table(Ts)
            yr = torch.empty_like(y)
            ye = torch.empty(
                (len(elems), math.prod(elems), tab.nd1 ** len(elems)),
                dtype=dt, device="cuda")
            kernels.launch_lattice_mass(u, Dq, tab.B, tab.host, ye, yr,
                                        C=len(elems), elems=tab.elems,
                                        nd1=tab.nd1, nq1=tab.nq1, rt=True)
            cell.update(digest=_digest(y), rt_bitwise=torch.equal(y, yr))
            out["cells"][f"{name} {str(dt)[6:]}"] = cell
            del u, Ts, Dq, y, yr, ye
            torch.cuda.empty_cache()
    mix = kernels.sass_instructions(b.path, SASS_OPS, per_opcode=True)
    out["sass"] = {k: v for k, v in mix.items() if "lattice_mass" in k}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one:                       # a child: the tree it runs in
        print(json.dumps(measure()), flush=True)
        return 0
    rc = 0
    for tree in a.trees:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one"],
            cwd=str(Path(tree).resolve()), capture_output=True, text=True)
        sys.stderr.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            rc = proc.returncode
            continue
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
