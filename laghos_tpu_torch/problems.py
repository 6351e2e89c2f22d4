"""The 8 canonical test problems (initial conditions and material laws).

Pointwise NumPy re-implementations of the reference's problem definitions
(laghos.cpp:1094-1275): 0 Taylor-Green, 1 Sedov blast, 2 Sod shock tube,
3 triple point, 4 Gresho vortex, 5/6 2D Riemann configs 12/6,
7 Rayleigh-Taylor.  All functions are vectorized over points with
x of shape (..., dim).
"""

from __future__ import annotations

import numpy as np

# Per-problem run configuration (laghos.cpp:634-648):
# (source_type, use_viscosity, use_vorticity); source 1 = Taylor-Green
# forcing (2D only), source 2 = Rayleigh-Taylor gravity.
def problem_flags(problem: int, dim: int):
    source, visc, vort = 0, True, False
    if problem == 0:
        visc = False
        if dim == 2:
            source = 1
    elif problem in (1, 2, 3, 5, 6):
        visc = True
    elif problem == 4:
        visc = False
    elif problem == 7:
        source, visc, vort = 2, True, True
    else:
        raise ValueError(f"bad problem {problem}")
    return source, visc, vort


def rho0(problem: int, x: np.ndarray, dim: int) -> np.ndarray:
    x0 = x[..., 0]
    one = np.ones_like(x0)
    if problem in (0, 1, 4):
        return one
    if problem == 2:
        return np.where(x0 < 0.5, 1.0, 0.1)
    if problem == 3:
        if dim == 2:
            return np.where((x0 > 1.0) & (x[..., 1] > 1.5), 0.125, 1.0)
        y, z = x[..., 1], x[..., 2]
        cond = (x0 > 1.0) & (((y < 1.5) & (z < 1.5)) | ((y > 1.5) & (z > 1.5)))
        return np.where(cond, 0.125, 1.0)
    if problem == 5:
        y = x[..., 1]
        out = np.where((x0 >= 0.5) & (y >= 0.5), 0.5313, 1.0)
        return np.where((x0 < 0.5) & (y < 0.5), 0.8, out)
    if problem == 6:
        y = x[..., 1]
        out = np.where((x0 < 0.5) & (y >= 0.5), 2.0, 1.0)
        return np.where((x0 >= 0.5) & (y < 0.5), 3.0, out)
    if problem == 7:
        return np.where(x[..., 1] >= 0.0, 2.0, 1.0)
    raise ValueError(problem)


def gamma(problem: int, x: np.ndarray, dim: int) -> np.ndarray:
    x0 = x[..., 0]
    if problem in (0, 4, 7):
        return np.full_like(x0, 5.0 / 3.0)
    if problem in (1, 2, 5, 6):
        return np.full_like(x0, 1.4)
    if problem == 3:
        if dim == 1:
            return np.where(x0 > 0.5, 1.4, 1.5)
        return np.where((x0 > 1.0) & (x[..., 1] <= 1.5), 1.4, 1.5)
    raise ValueError(problem)


def v0(problem: int, x: np.ndarray, dim: int) -> np.ndarray:
    v = np.zeros_like(x)
    if problem == 0:
        vx = np.sin(np.pi * x[..., 0]) * np.cos(np.pi * x[..., 1])
        vy = -np.cos(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1])
        if dim == 3:
            vx = vx * np.cos(np.pi * x[..., 2])
            vy = vy * np.cos(np.pi * x[..., 2])
        v[..., 0] = vx
        v[..., 1] = vy
        return v
    if problem in (1, 2, 3):
        return v
    if problem == 4:
        r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        rs = np.maximum(r, 1e-300)
        inner = r < 0.2
        mid = (r >= 0.2) & (r < 0.4)
        v[..., 0] = np.where(inner, 5.0 * x[..., 1], 0.0) + np.where(
            mid, 2.0 * x[..., 1] / rs - 5.0 * x[..., 1], 0.0)
        v[..., 1] = np.where(inner, -5.0 * x[..., 0], 0.0) + np.where(
            mid, -2.0 * x[..., 0] / rs + 5.0 * x[..., 0], 0.0)
        return v
    if problem in (5, 6):
        atn = _atn(x) if dim != 1 else np.zeros_like(x[..., 0])
        x0, y = x[..., 0], x[..., 1]
        if problem == 5:
            v[..., 0] = np.where((x0 < 0.5) & (y >= 0.5), 0.7276 * atn, 0.0)
            v[..., 1] = np.where((x0 >= 0.5) & (y < 0.5), 0.7276 * atn, 0.0)
        else:
            sx = np.where(y >= 0.5, 0.75, -0.75)
            sy = np.where(x0 < 0.5, 0.5, -0.5)
            v[..., 0] = sx * atn
            v[..., 1] = sy * atn
        return v
    if problem == 7:
        v[..., 1] = (0.02 * np.exp(-2.0 * np.pi * x[..., 1] ** 2)
                     * np.cos(2.0 * np.pi * x[..., 0]))
        return v
    raise ValueError(problem)


def _atn(x):
    """Boundary-vanishing envelope for the Riemann problems
    (laghos.cpp:1144-1145)."""
    g = (x[..., 0] * (1.0 - x[..., 0]) * 4.0
         * x[..., 1] * (1.0 - x[..., 1]) * 4.0)
    return np.power(np.maximum(g, 0.0), 0.4)


def e0(problem: int, x: np.ndarray, dim: int) -> np.ndarray:
    x0 = x[..., 0]
    if problem == 0:
        denom = 2.0 / 3.0
        if dim == 2:
            val = 1.0 + (np.cos(2 * np.pi * x[..., 0])
                         + np.cos(2 * np.pi * x[..., 1])) / 4.0
        else:
            val = 100.0 + ((np.cos(2 * np.pi * x[..., 2]) + 2.0)
                           * (np.cos(2 * np.pi * x[..., 0])
                              + np.cos(2 * np.pi * x[..., 1])) - 2.0) / 16.0
        return val / denom
    if problem == 1:
        return np.zeros_like(x0)  # delta-projected in the driver
    if problem == 2:
        p = np.where(x0 < 0.5, 1.0, 0.1)
        return p / rho0(2, x, dim) / (gamma(2, x, dim) - 1.0)
    if problem == 3:
        p = np.where(x0 > 1.0, 0.1, 1.0)
        return p / rho0(3, x, dim) / (gamma(3, x, dim) - 1.0)
    if problem == 4:
        r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        rsq = x[..., 0] ** 2 + x[..., 1] ** 2
        gm = 5.0 / 3.0
        rs = np.maximum(r, 1e-300)
        inner = (5.0 + 25.0 / 2.0 * rsq) / (gm - 1.0)
        t1 = 9.0 - 4.0 * np.log(0.2) + 25.0 / 2.0 * rsq
        t2 = 20.0 * r - 4.0 * np.log(rs)
        mid = (t1 - t2) / (gm - 1.0)
        outer = (3.0 + 4.0 * np.log(2.0)) / (gm - 1.0)
        return np.where(r < 0.2, inner, np.where(r < 0.4, mid, outer))
    if problem == 5:
        y = x[..., 1]
        p = np.where((x0 >= 0.5) & (y >= 0.5), 0.4, 1.0)
        return p / rho0(5, x, dim) / (gamma(5, x, dim) - 1.0)
    if problem == 6:
        return 1.0 / rho0(6, x, dim) / (gamma(6, x, dim) - 1.0)
    if problem == 7:
        rho = rho0(7, x, dim)
        gm = gamma(7, x, dim)
        return (6.0 - rho * x[..., 1]) / (gm - 1.0) / rho
    raise ValueError(problem)
