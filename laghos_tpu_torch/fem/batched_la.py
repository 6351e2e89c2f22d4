"""Determinants and inverses of many small matrices, split over worker
processes.

`Hydro` inverts the t=0 Jacobian at every quadrature point on the host
(`np.linalg.det` and `np.linalg.inv`, as the JAX package does): 2.1M 3x3
matrices at the flagship size and 16.8M at Q8-Q7 rs3, where the two calls
took most of a 30-40 s setup.  numpy runs them one matrix at a time
holding the GIL (threads do not help), so a large batch goes to worker
processes, each running the same two calls on a contiguous slice: every
matrix's result comes from the same LAPACK routine on the same values, so
the bits are those of one call.  The workers import numpy only and share
the values through files mapped into memory in a temporary directory.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# below this many matrices one in-process call is quicker than starting
# workers (~0.3 s each, in parallel)
MIN_WORKER_BATCH = 1 << 20
MAX_WORKERS = 8

# argv: directory, dtype, d, n, first, last
_WORKER = """
import sys
import numpy as np
path, dt, d, n, lo, hi = sys.argv[1], sys.argv[2], *map(int, sys.argv[3:])
J = np.memmap(path + "/J", dt, "r", shape=(n, d, d))
det = np.memmap(path + "/det", dt, "r+", shape=(n,))
inv = np.memmap(path + "/inv", dt, "r+", shape=(n, d, d))
det[lo:hi] = np.linalg.det(J[lo:hi])
try:
    inv[lo:hi] = np.linalg.inv(J[lo:hi])
except np.linalg.LinAlgError:
    sys.exit(3)
det.flush()
inv.flush()
"""


def det_inv(J: np.ndarray):
    """(np.linalg.det(J), np.linalg.inv(J)) of a stack J (..., d, d), bit
    for bit and in J's precision, in worker processes when the stack is
    large (f32 or f64).  Raises numpy's LinAlgError where np.linalg.inv
    does (a singular matrix), and RuntimeError if a worker fails
    otherwise."""
    J = np.asarray(J)
    d = J.shape[-1]
    lead = J.shape[:-2]
    n = int(np.prod(lead, dtype=np.int64))
    k = min(MAX_WORKERS, os.cpu_count() or 1) if n >= MIN_WORKER_BATCH else 1
    if k < 2 or J.dtype not in (np.float32, np.float64):
        return np.linalg.det(J), np.linalg.inv(J)
    dt = J.dtype
    cuts = np.linspace(0, n, k + 1).astype(np.int64)
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    with tempfile.TemporaryDirectory(prefix="laghos_la_") as tmp:
        src = np.memmap(f"{tmp}/J", dt, "w+", shape=(n, d, d))
        src[:] = J.reshape(n, d, d)
        src.flush()
        del src
        np.memmap(f"{tmp}/det", dt, "w+", shape=(n,)).flush()
        np.memmap(f"{tmp}/inv", dt, "w+", shape=(n, d, d)).flush()

        def run(i):
            out = subprocess.run(
                [sys.executable, "-c", _WORKER, tmp, dt.name, str(d),
                 str(n), str(cuts[i]), str(cuts[i + 1])],
                capture_output=True, env=env, check=False)
            if out.returncode == 3:
                raise np.linalg.LinAlgError("Singular matrix")
            if out.returncode != 0:
                raise RuntimeError(
                    f"batched det/inv worker failed ({out.returncode}):\n"
                    f"{out.stderr.decode(errors='replace')}")

        with ThreadPoolExecutor(k) as ex:
            list(ex.map(run, range(k)))
        det = np.array(np.memmap(f"{tmp}/det", dt, "r", shape=(n,)))
        inv = np.array(np.memmap(f"{tmp}/inv", dt, "r", shape=(n, d, d)))
    return det.reshape(lead), inv.reshape(*lead, d, d)
