"""Command-line driver mirroring the reference Laghos CLI.

Flag names follow laghos.cpp:181-278 and `laghos_tpu.cli`, so reference
command lines run as written, e.g.:
    python -m laghos_tpu_torch -p 1 -dim 3 -rs 4 -s 7 -cgt 1e-11 -ms 20 -f
    python -m laghos_tpu_torch -p 2 -m segment01 -rs 5 -tf 0.2 -fa
Every single-device flag of `laghos_tpu.cli` runs: partial (-pa) and full
(-fa) assembly in 1D, 2D and 3D, the Cartesian mesh of -nx/-ny/-nz and
-Sx/-Sy/-Sz or a mesh file or built-in geometry (-m; triangle and
tetrahedron meshes such as cube01_tet run the simplex solver), the
whole-lattice operators on Cartesian meshes, --precond
jacobi|auto|kron|schwarz, the on-device adaptive-dt loop (--device-loop),
the Ozaki f64 mode (--ozaki), the output flags (-visit, -print, -vis, -k),
-mb, -err, --checkpoint/--restore, --debug-nans and --profile.  The flags
of the modules not ported yet (distribution, AMR) and the TPU knob --mxu
are accepted by the parser and then refused with NotImplementedError
naming the ROADMAP item that ports them.

Where the JAX package turns on `jax_debug_nans`, --debug-nans here checks
the outputs of every phase of the step for non-finite values and raises
FloatingPointError naming the phase and the step; --profile writes a
torch.profiler trace (trace.json) to its directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from . import data, driver
from .device import setup
from .fem import mesh as fmesh
from .fem import simplex_mesh as fsm
from .hydro import Hydro, Options
from .timing import print_timing, run_metadata
from .verify import (CHECKS_TABLE, OZAKI_CHECKS_EPS, run_checks,
                     velocity_error_norms)

# flags of laghos_tpu.cli outside the port so far: (flags, dest, takes a
# value, the ROADMAP item that ports it)
_NOT_PORTED = [
    (("-rp", "--refine-parallel"), "rp", True, "A11"),
    (("-epm", "--elem-per-mpi"), "epm", True, "A11"),
    (("-nd", "--n-devices"), "n_devices", True, "A11"),
    (("-sfc", "--sfc-partition"), "sfc", False, "A11"),
    (("--halo",), "halo", False, "A11"),
    (("--pencil",), "pencil", True, "A11"),
    (("-amr", "--enable-amr"), "amr", False, "A13"),
    (("-rt", "--ref-threshold"), "ref_threshold", True, "A13"),
    (("-dt", "--deref-threshold"), "deref_threshold", True, "A13"),
    (("--mxu",), "mxu", True, "'Not to port' (a TPU MXU knob)"),
]


def build_parser():
    p = argparse.ArgumentParser(
        prog="laghos_tpu_torch",
        description="Lagrangian hydrodynamics on PyTorch and CUDA")
    p.add_argument("-dim", "--dimension", type=int, default=3, dest="dim")
    p.add_argument("-m", "--mesh", default="default", dest="mesh",
                   help="an MFEM v1.0 or NetGen mesh file, or a built-in "
                        "geometry (segment01, square01_quad, cube01_hex, "
                        "...); default: the Cartesian mesh of -nx/-ny/-nz "
                        "and -Sx/-Sy/-Sz")
    p.add_argument("-nx", "--xelems", type=int, default=2, dest="nx")
    p.add_argument("-ny", "--yelems", type=int, default=2, dest="ny")
    p.add_argument("-nz", "--zelems", type=int, default=2, dest="nz")
    p.add_argument("-E0", "--blast-energy", type=float, default=1.0,
                   dest="blast_energy")
    p.add_argument("-Sx", "--xwidth", type=float, default=1.0, dest="xwidth")
    p.add_argument("-Sy", "--ywidth", type=float, default=1.0)
    p.add_argument("-Sz", "--zwidth", type=float, default=1.0)
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
    p.add_argument("-ftz", "--ftz-tol", type=float, default=0.0,
                   dest="ftz_tol",
                   help="accepted and recorded in the run metadata; "
                        "numerically dead as in the reference (laghos.cpp:233 "
                        "parses it and never uses it; the force flush is the "
                        "hardcoded eps^2)")
    p.add_argument("-dtol", "--delta-tol", type=float, default=1e-12,
                   dest="delta_tol")
    p.add_argument("-cgm", "--cg-max-steps", type=int, default=300,
                   dest="cg_max_iter")
    p.add_argument("-ms", "--max-steps", type=int, default=-1,
                   dest="max_steps")
    p.add_argument("-pa", "--partial-assembly", action="store_true",
                   default=True, dest="pa")
    p.add_argument("-fa", "--full-assembly", action="store_false",
                   dest="pa")
    p.add_argument("-iv", "--impose-viscosity", action="store_true",
                   dest="impose_visc")
    p.add_argument("-vs", "--visualization-steps", type=int, default=5,
                   dest="vis_steps")
    p.add_argument("-print", "--print", action="store_true", dest="gfprint")
    p.add_argument("-visit", "--visit", action="store_true", dest="visit")
    p.add_argument("-vis", "--visualization", action="store_true",
                   dest="visualization",
                   help="stream rho/e/v to a live GLVis server every vis "
                        "step (laghos.cpp:691-738)")
    p.add_argument("--glvis", default="localhost:19916",
                   help="GLVis server host:port for -vis")
    p.add_argument("-mb", "--mem", action="store_true", dest="mem_usage")
    p.add_argument("-k", "--outputfilename", default="results/Laghos",
                   dest="basename")
    p.add_argument("-d", "--device", default="cuda",
                   choices=["cpu", "cuda"])
    p.add_argument("-chk", "--checks", action="store_true", dest="check")
    p.add_argument("-err", "--exact-error", action="store_true",
                   dest="check_exact_sedov")
    p.add_argument("-f", "--fom", action="store_true", dest="fom")
    p.add_argument("--dtype", default="f64", choices=["f64", "f32"])
    p.add_argument("--ozaki", action="store_true",
                   help="3D f64 only: run the hot contractions as Ozaki "
                        "int8 products (f64-accurate), with the "
                        "mixed-precision IR velocity solve on Cartesian "
                        "meshes")
    p.add_argument("--precond", default="jacobi",
                   choices=["jacobi", "auto", "kron", "schwarz"],
                   help="velocity CG preconditioner: jacobi (reference "
                        "parity, the default), kron (per-axis Kronecker "
                        "inverse on Cartesian meshes), auto (kron where "
                        "available, else jacobi), schwarz (element-block "
                        "additive Schwarz)")
    p.add_argument("--device-loop", action="store_true", dest="device_loop",
                   help="keep the adaptive-dt control flow on the device "
                        "(t, dt and the step counters as device scalars, "
                        "the CGs reading their convergence flag around the "
                        "previous solve's stop): the host loop's trajectory and "
                        "lines bit for bit, with fewer host syncs; ignored "
                        "with -f")
    p.add_argument("--checkpoint", default=None,
                   help="write an NPZ checkpoint of (S, t, dt, step) here "
                        "every vis step")
    p.add_argument("--restore", default=None,
                   help="resume from an NPZ checkpoint (of either package)")
    p.add_argument("--debug-nans", action="store_true", dest="debug_nans",
                   help="check every phase's outputs for non-finite values "
                        "and raise naming the phase and the step")
    p.add_argument("--profile", default=None,
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
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


def _refine(m):
    """Uniform refinement of the mesh's own family: tensor meshes, or
    triangles (1:4) and tetrahedra (1:8)."""
    if isinstance(m, fsm.TriMesh):
        return fsm.uniform_refine_tri(m)
    if isinstance(m, fsm.TetMesh):
        return fsm.uniform_refine_tet(m)
    return fmesh.uniform_refine(m)


def make_mesh(args):
    """The run's mesh: a tensor `Mesh`, or a `TriMesh` / `TetMesh`."""
    if args.mesh == "default":
        dim = args.dim
        m = fmesh.cartesian(dim, (args.nx, args.ny, args.nz),
                            (args.xwidth, args.ywidth, args.zwidth))
    else:
        m = data.get_mesh(args.mesh)
    for _ in range(args.rs):
        m = _refine(m)
    return m


def _main_simplex(args, m, device, t_setup) -> CliRun:
    """A triangle or tetrahedron mesh runs `SimplexHydro` with the options
    of the JAX package's simplex route (its RK4 or RK2Avg default, f64)
    and prints its last line; the other output flags do not apply."""
    from .simplex_hydro import SimplexHydro

    th = SimplexHydro(m, Options(
        problem=args.problem, order_v=args.order_v, order_e=args.order_e,
        order_q=args.order_q, cfl=args.cfl, cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter), device=device)
    setup_seconds = time.perf_counter() - t_setup
    ie, ke = th.energies(th.S0)
    t0 = time.perf_counter()
    S, t, steps = th.run(args.t_final, max_steps=args.max_steps,
                         verbose=True)
    en = float(torch.sqrt(torch.sum(S["e"] * S["e"])))
    wall = time.perf_counter() - t0
    print(f"step {steps:5d},\tt = {t:.4f},\t|e| = {en:.10e}")
    ie1, ke1 = th.energies(S)
    res = driver.RunResult(
        steps=steps, t=t, dt=th.dt, e_norm=en,
        energy_init=float(ie) + float(ke),
        energy_final=float(ie1) + float(ke1), h1_iters=th.h1_iters,
        l2_iters=0, quad_steps=steps * th.NE, norms={steps: en},
        timings={"total": wall}, S=S)
    return CliRun(res, th, setup_seconds, None)


@dataclasses.dataclass
class CliRun:
    result: driver.RunResult
    hydro: Hydro
    setup_seconds: float      # mesh + Hydro construction, host clock
    fom: Optional[dict]       # print_timing's figures with -f


def _on_vis(args, h):
    """The vis-step callback of -visit/-print and -vis (None without
    them), after writing or streaming the initial state."""
    calls = []
    if args.visit or args.gfprint:
        from .io import DataCollection

        dc = DataCollection(args.basename, h)
        dc.save(0, 0.0, h.S0)
        calls.append(dc.save)
    if args.visualization:
        from .vis import GLVisSession

        host, _, port = args.glvis.partition(":")
        gl = GLVisSession(h, host or "localhost", int(port or 19916))
        gl.step(h.S0)
        calls.append(lambda ti, t, S: gl.step(S))
    if not calls:
        return None

    def on_vis(ti, t, S):
        for call in calls:
            call(ti, t, S)
    return on_vis


def _profiler(args, device):
    if not args.profile:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, "trace.json")
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=lambda prof: prof.export_chrome_trace(path))


def main(argv=None) -> CliRun:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = setup(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    t_setup = time.perf_counter()
    m = make_mesh(args)
    print(f"Number of zones in the serial mesh: {m.num_elems}")
    if isinstance(m, (fsm.TriMesh, fsm.TetMesh)):
        return _main_simplex(args, m, device, t_setup)
    opt = Options(
        problem=args.problem, order_v=args.order_v, order_e=args.order_e,
        order_q=args.order_q, cfl=args.cfl, cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter, p_assembly=args.pa,
        impose_visc=args.impose_visc, blast_energy=args.blast_energy, delta_tol=args.delta_tol,
        ode_solver=args.ode_solver, precond=args.precond, ozaki=args.ozaki)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    h = Hydro(m, opt, dtype=dtype, device=device)
    h.debug_nans = args.debug_nans
    setup_seconds = time.perf_counter() - t_setup
    print(f"Number of kinematic (position, velocity) dofs: "
          f"{h.ndof * m.dim}")
    print(f"Number of specific internal energy dofs: {h.NE * h.ld}")

    S_init, t0, dt0, st0 = None, 0.0, None, 1
    if args.restore:
        from . import checkpoint

        S_init, t0, dt0, st0 = checkpoint.load(args.restore, device=device,
                                               dtype=dtype)
        # the checkpoint holds the last completed step: resume at the next
        # one, so the |e| lines, the vis cadence and the --checks steps
        # line up with an uninterrupted run
        st0 += 1
    check_steps = ()
    if args.check:
        if args.rs != 0:
            raise ValueError("--checks needs -rs 0")
        if (args.order_v, args.order_e) != (2, 1):
            raise ValueError("--checks needs -ok 2 -ot 1")
        if args.ode_solver != 4 or args.t_final != 0.6 or args.cfl != 0.5:
            raise ValueError("--checks needs -s 4 -tf 0.6 -cfl 0.5")
        check_steps = tuple(s for s, _ in CHECKS_TABLE[m.dim][args.problem])
    on_vis = _on_vis(args, h)
    with _profiler(args, device):
        res = driver.run(h, t_final=args.t_final, max_steps=args.max_steps,
                         vis_steps=args.vis_steps, verbose=True,
                         timing=args.fom, check_steps=check_steps,
                         on_vis=on_vis, S_init=S_init, t_init=t0,
                         dt_init=dt0, step_init=st0,
                         checkpoint_path=args.checkpoint,
                         device_loop=args.device_loop and not args.fom)
    if args.profile:
        print(f"Profiler trace written to "
              f"{os.path.join(args.profile, 'trace.json')}")
    if args.check:
        run_checks(args.problem, m.dim, res.norms,
                   eps=OZAKI_CHECKS_EPS if args.ozaki else 1e-13)
        print("Checks passed.")

    rk_stages = {1: 1, 2: 2, 3: 3, 4: 4, 6: 8, 7: 2}[args.ode_solver]
    fom = None
    if res.timing_data is not None:
        fom = print_timing(
            res.timing_data, steps=res.steps * rk_stages,
            H1_dofs=h.ndof * m.dim, L2_dofs=h.NE * h.ld, NQ=h.NQ, NE=h.NE,
            p_assembly=h.p_assembly, dim=m.dim, fom_table=args.fom)
        # Adiak-style provenance record (laghos.cpp:1288-1346)
        meta = run_metadata(args=args, opt=opt, result=fom, device=device,
                            extra={"NE": h.NE, "steps": res.steps,
                                   "t_final": res.t, "e_norm": res.e_norm})
        with open("laghos_run_metadata.json", "w") as fp:
            json.dump(meta, fp, indent=1, default=str)
        print("Run metadata written to laghos_run_metadata.json")
    print("")
    print(f"Energy  diff: {abs(res.energy_init - res.energy_final):.2e}")
    if args.mem_usage:
        from .io import device_memory_stats, max_rss_mb

        print(f"Maximum memory resident set size: {max_rss_mb()} MB")
        stats = device_memory_stats(device)
        if stats:
            print(f"  {device}: {stats['bytes_in_use'] // 2**20} MB in use, "
                  f"peak {stats['peak_bytes_in_use'] // 2**20} MB allocated")

    if args.problem in (0, 4):
        linf, l1, l2 = velocity_error_norms(h, res.S)
        print(f"L_inf  error: {linf}")
        print(f"L_1    error: {l1}")
        print(f"L_2    error: {l2}")

    if args.check_exact_sedov:
        from .sedov import sedov_density_l2_error

        err = sedov_density_l2_error(h, res.S, res.t, args.blast_energy)
        print(f"Density L2 error: {err}")
    return CliRun(res, h, setup_seconds, fom)
