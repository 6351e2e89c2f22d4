"""Standalone Sedov exact-solution sampler (the reference's sedov/ tool).

The counterpart of `laghos_tpu.sedov_tool` and of sedov/sedov.cpp:
evaluate the analytic (rho, v, p) blast profile at time t on a lattice of
points in [0, 1.2]^dim and save it as NPZ.

    python -m laghos_tpu_torch.sedov_tool -dim 3 -tf 0.6 -E0 2.0 \
        -o sedov_exact
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sedov_tool")
    ap.add_argument("-dim", type=int, default=3)
    ap.add_argument("-tf", type=float, default=0.6)
    ap.add_argument("-E0", type=float, default=1.0)
    ap.add_argument("-gamma", type=float, default=1.4)
    ap.add_argument("-rho0", type=float, default=1.0)
    ap.add_argument("-omega", type=float, default=0.0)
    ap.add_argument("-rs", type=int, default=2)
    ap.add_argument("-n", type=int, default=32,
                    help="sample lattice per dimension")
    ap.add_argument("-o", "--out", default="sedov_exact")
    args = ap.parse_args(argv)

    from .sedov import SedovSolution

    sol = SedovSolution(args.dim, args.gamma, args.rho0, args.E0,
                        args.omega)
    sol.set_time(args.tf)
    axes = [np.linspace(0, 1.2, args.n) for _ in range(args.dim)]
    grid = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grid], axis=1)
    r = np.linalg.norm(pts, axis=1)
    rho, v, p = sol.eval(r)
    np.savez(args.out + ".npz", points=pts, r=r, rho=rho, v=v, p=p,
             r2=sol.r2, alpha=sol.alpha, t=args.tf)
    print(f"alpha = {sol.alpha:.12f}, shock radius r2 = {sol.r2:.12f}")
    print(f"wrote {args.out}.npz ({pts.shape[0]} points)")


if __name__ == "__main__":
    main()
