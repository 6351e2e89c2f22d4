"""Command-line driver mirroring the reference Laghos CLI.

Flag names follow laghos.cpp:181-278 and `laghos_tpu.cli`, e.g.:
    python -m laghos_tpu_torch -p 1 -dim 3 -rs 4 -s 7 -cgt 1e-11 -ms 20 -f
The flags of the ported slice (conforming partial assembly on quad/hex
meshes) run; every other flag of `laghos_tpu.cli` is accepted by the parser
and then refused with NotImplementedError naming the ROADMAP item that
ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from . import data, driver
from .device import setup
from .fem import mesh as fmesh
from .hydro import Hydro, Options
from .timing import print_timing
from .verify import CHECKS_TABLE, run_checks

# flags of laghos_tpu.cli outside this slice: (flags, dest, takes a value,
# the ROADMAP item that ports it)
_NOT_PORTED = [
    (("-nx", "--xelems"), "nx", True, "A7"),
    (("-ny", "--yelems"), "ny", True, "A7"),
    (("-nz", "--zelems"), "nz", True, "A7"),
    (("-Sx", "--xwidth"), "xwidth", True, "A7"),
    (("-Sy", "--ywidth"), "ywidth", True, "A7"),
    (("-Sz", "--zwidth"), "zwidth", True, "A7"),
    (("-rp", "--refine-parallel"), "rp", True, "A11"),
    (("-epm", "--elem-per-mpi"), "epm", True, "A11"),
    (("-ftz", "--ftz-tol"), "ftz_tol", True, "A7"),
    (("-dtol", "--delta-tol"), "delta_tol", True, "A7"),
    (("-fa", "--full-assembly"), "fa", False, "A6"),
    (("-iv", "--impose-viscosity"), "impose_visc", False, "A7"),
    (("-print", "--print"), "gfprint", False, "A7"),
    (("-visit", "--visit"), "visit", False, "A7"),
    (("-vis", "--visualization"), "visualization", False, "A7"),
    (("--glvis",), "glvis", True, "A7"),
    (("-mb", "--mem"), "mem_usage", False, "A7"),
    (("-k", "--outputfilename"), "basename", True, "A7"),
    (("-err", "--exact-error"), "check_exact_sedov", False, "A7"),
    (("-nd", "--n-devices"), "n_devices", True, "A11"),
    (("-sfc", "--sfc-partition"), "sfc", False, "A11"),
    (("--halo",), "halo", False, "A11"),
    (("--pencil",), "pencil", True, "A11"),
    (("-amr", "--enable-amr"), "amr", False, "A13"),
    (("-rt", "--ref-threshold"), "ref_threshold", True, "A13"),
    (("-dt", "--deref-threshold"), "deref_threshold", True, "A13"),
    (("--device-loop",), "device_loop", False, "A8"),
    (("--mxu",), "mxu", True, "'Not to port' (a TPU MXU knob)"),
    (("--ozaki",), "ozaki", False, "A10"),
    (("--precond",), "precond", True, "A8"),
    (("--checkpoint",), "checkpoint", True, "A7"),
    (("--restore",), "restore", True, "A7"),
    (("--debug-nans",), "debug_nans", False, "A7"),
    (("--profile",), "profile", True, "A7"),
]


def build_parser():
    p = argparse.ArgumentParser(
        prog="laghos_tpu_torch",
        description="Lagrangian hydrodynamics on PyTorch and CUDA")
    p.add_argument("-dim", "--dimension", type=int, default=3, dest="dim")
    p.add_argument("-m", "--mesh", default="default", dest="mesh",
                   help="a built-in geometry (square01_quad, cube01_hex, "
                        "...); default: the 2^dim unit Cartesian mesh")
    p.add_argument("-E0", "--blast-energy", type=float, default=1.0,
                   dest="blast_energy")
    p.add_argument("-rs", "--refine-serial", type=int, default=2,
                   dest="rs")
    p.add_argument("-p", "--problem", type=int, default=1, dest="problem")
    p.add_argument("-ok", "--order-kinematic", type=int, default=2,
                   dest="order_v")
    p.add_argument("-ot", "--order-thermo", type=int, default=1,
                   dest="order_e")
    p.add_argument("-oq", "--order-intrule", type=int, default=-1,
                   dest="order_q")
    p.add_argument("-s", "--ode-solver", type=int, default=4,
                   dest="ode_solver")
    p.add_argument("-tf", "--t-final", type=float, default=0.6,
                   dest="t_final")
    p.add_argument("-cfl", "--cfl", type=float, default=0.5)
    p.add_argument("-cgt", "--cg-tol", type=float, default=1e-8,
                   dest="cg_tol")
    p.add_argument("-cgm", "--cg-max-steps", type=int, default=300,
                   dest="cg_max_iter")
    p.add_argument("-ms", "--max-steps", type=int, default=-1,
                   dest="max_steps")
    p.add_argument("-pa", "--partial-assembly", action="store_true",
                   default=True, dest="pa",
                   help="partial assembly (the only mode ported)")
    p.add_argument("-vs", "--visualization-steps", type=int, default=5,
                   dest="vis_steps")
    p.add_argument("-d", "--device", default="cuda",
                   choices=["cpu", "cuda"])
    p.add_argument("-chk", "--checks", action="store_true", dest="check")
    p.add_argument("-f", "--fom", action="store_true", dest="fom")
    p.add_argument("--dtype", default="f64", choices=["f64", "f32"])
    for flags, dest, takes_value, _ in _NOT_PORTED:
        if takes_value:
            p.add_argument(*flags, dest=dest, default=None,
                           help=argparse.SUPPRESS)
        else:
            p.add_argument(*flags, dest=dest, action="store_const",
                           const=True, default=None, help=argparse.SUPPRESS)
    return p


def _refuse_unported(args):
    for flags, dest, _, item in _NOT_PORTED:
        if getattr(args, dest) is not None:
            raise NotImplementedError(
                f"{flags[0]} is not ported yet (ROADMAP {item})")


def make_mesh(args) -> fmesh.Mesh:
    if args.mesh == "default":
        dim = args.dim
        m = fmesh.cartesian(dim, (2, 2, 2)[:dim], (1.0, 1.0, 1.0)[:dim])
    else:
        m = data.get_mesh(args.mesh)
    for _ in range(args.rs):
        m = fmesh.uniform_refine(m)
    return m


@dataclasses.dataclass
class CliRun:
    result: driver.RunResult
    hydro: Hydro
    setup_seconds: float      # mesh + Hydro construction, host clock
    fom: Optional[dict]       # print_timing's figures with -f


def main(argv=None) -> CliRun:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = setup(args.device)

    t_setup = time.perf_counter()
    m = make_mesh(args)
    print(f"Number of zones in the serial mesh: {m.num_elems}")
    opt = Options(
        problem=args.problem, order_v=args.order_v, order_e=args.order_e,
        order_q=args.order_q, cfl=args.cfl, cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter, blast_energy=args.blast_energy,
        ode_solver=args.ode_solver)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    h = Hydro(m, opt, dtype=dtype, device=device)
    setup_seconds = time.perf_counter() - t_setup
    print(f"Number of kinematic (position, velocity) dofs: "
          f"{h.ndof * m.dim}")
    print(f"Number of specific internal energy dofs: {h.NE * h.ld}")

    check_steps = ()
    if args.check:
        if args.rs != 0:
            raise ValueError("--checks needs -rs 0")
        if (args.order_v, args.order_e) != (2, 1):
            raise ValueError("--checks needs -ok 2 -ot 1")
        if args.ode_solver != 4 or args.t_final != 0.6 or args.cfl != 0.5:
            raise ValueError("--checks needs -s 4 -tf 0.6 -cfl 0.5")
        check_steps = tuple(s for s, _ in CHECKS_TABLE[m.dim][args.problem])
    res = driver.run(h, t_final=args.t_final, max_steps=args.max_steps,
                     vis_steps=args.vis_steps, verbose=True,
                     timing=args.fom, check_steps=check_steps)
    if args.check:
        run_checks(args.problem, m.dim, res.norms)
        print("Checks passed.")

    rk_stages = {1: 1, 2: 2, 3: 3, 4: 4, 6: 8, 7: 2}[args.ode_solver]
    fom = None
    if res.timing_data is not None:
        fom = print_timing(
            res.timing_data, steps=res.steps * rk_stages,
            H1_dofs=h.ndof * m.dim, L2_dofs=h.NE * h.ld, NQ=h.NQ, NE=h.NE,
            p_assembly=True, dim=m.dim, fom_table=args.fom)
    print("")
    print(f"Energy  diff: {abs(res.energy_init - res.energy_final):.2e}")
    return CliRun(res, h, setup_seconds, fom)
