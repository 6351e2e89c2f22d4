"""Controlled-scaling meshes (the reference's -epm mode).

Reference semantics (README.md:271-278): instead of a mesh file, generate a
[0,1]^dim quad/hex mesh of (ranks x elements per rank) elements; weak
scaling varies the rank count at fixed -epm, strong scaling fixes the
product.  The port's copy of `laghos_tpu.parallel.scaling`.
"""

from __future__ import annotations

import numpy as np

from ..fem import mesh as fmesh


def _factor(n: int, d: int):
    """Factor n into d near-equal integer factors (descending)."""
    facs = [1] * d
    rem = n
    p = 2
    primes = []
    while p * p <= rem:
        while rem % p == 0:
            primes.append(p)
            rem //= p
        p += 1
    if rem > 1:
        primes.append(rem)
    for q in sorted(primes, reverse=True):
        facs[int(np.argmin(facs))] *= q
    return sorted(facs, reverse=True)


def epm_mesh(dim: int, n_devices: int, elems_per_device: int,
             sizes=(1.0, 1.0, 1.0)):
    """[0,Sx]x[0,Sy]x[0,Sz] Cartesian mesh of n_devices * epm elements:
    (mesh, element counts per axis, (n_devices,)).

    The rank factor goes into the LAST (slowest-varying) mesh axis, so that
    a contiguous block partition of the element order gives slabs with
    planar interfaces."""
    per = _factor(elems_per_device, dim)
    n = list(sorted(per))
    n[-1] = n[-1] * n_devices
    return fmesh.cartesian(dim, tuple(n), tuple(sizes)), tuple(n), \
        (n_devices,)
