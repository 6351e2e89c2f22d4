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
-mb, -err, --checkpoint/--restore, --debug-nans and --profile, and the
AMR variant (-amr with -rt/-dt, e.g. `-p 1 -m square01_quad -rs 4 -tf 0.8
-amr`), and the distributed runs: `-nd N` starts N ranks (one process
each, parallel/comm.py) over the replicated-vector layout, or with --halo
over slabs (--pencil DZxDY: pencils) of a raster mesh and element chunks
of any other mesh (-sfc orders them along a Morton curve first); with
-amr over the element chunks of the forest's leaf order, placed again at
every mesh change (`parallel.sharding.shard_amr`); -rp refines after -rs
on every route, -epm builds the controlled-scaling mesh.  --dist-backend
picks the ranks' backend (nccl for card ranks, the default on cuda, one
card per rank; gloo for CPU ranks, the default on cpu, and for card ranks
sharing a card).  Refused with NotImplementedError naming the ROADMAP
item: the TPU knob --mxu.

A distributed run keeps the JAX CLI's conditions: --restore with --halo is
refused, --device-loop runs with --halo unless -f or --checkpoint is
given, and rank 0 prints the step lines; the outputs (-visit, -print,
-vis, --checkpoint, the error norms) see the global state.

Where the JAX package turns on `jax_debug_nans`, --debug-nans here checks
the outputs of every phase of the step for non-finite values and raises
FloatingPointError naming the phase and the step; --profile writes a
torch.profiler trace (trace.json) to its directory.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import data, driver
from .device import setup
from .fem import mesh as fmesh
from .fem import simplex_mesh as fsm
from .hydro import Hydro, Options
from .parallel import comm as pcomm
from .parallel.partition import sfc_partition
from .parallel.runs import launches
from .parallel.scaling import epm_mesh
from .parallel.sharding import rank_view
from .parallel.slab_hydro import check_partition, element_grid
from .timing import print_timing, run_metadata
from .verify import (CHECKS_TABLE, OZAKI_CHECKS_EPS, run_checks,
                     velocity_error_norms)

# flags of laghos_tpu.cli outside the port: (flags, dest, takes a value,
# the ROADMAP item)
_NOT_PORTED = [
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
    p.add_argument("-rp", "--refine-parallel", type=int, default=0,
                   dest="rp", help="uniform refinements after -rs")
    p.add_argument("-epm", "--elem-per-mpi", type=int, default=0, dest="epm",
                   help="controlled-scaling mesh of (-nd) x EPM elements "
                        "(README.md:271-278 of the reference)")
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
    p.add_argument("-amr", "--enable-amr", action="store_true", dest="amr",
                   help="adaptive mesh refinement (problem 1 only; "
                        "amr/laghos.cpp:106-113)")
    p.add_argument("-rt", "--ref-threshold", type=float, default=2e-4,
                   dest="ref_threshold", help="AMR refinement threshold")
    p.add_argument("-dt", "--deref-threshold", type=float, default=0.75,
                   dest="deref_threshold",
                   help="AMR derefinement threshold (0 = no derefinement)")
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
                        "DIR/trace.json (DIR/trace_rank<r>.json per rank "
                        "with -nd)")
    p.add_argument("-nd", "--n-devices", type=int, default=1,
                   dest="n_devices",
                   help="run on this many ranks, one process each")
    p.add_argument("-sfc", "--sfc-partition", action="store_true",
                   dest="sfc",
                   help="order the elements along a Morton curve, so that "
                        "equal contiguous chunks are the ranks' parts")
    p.add_argument("--halo", action="store_true", dest="halo",
                   help="with -nd: slabs of a raster mesh with plane "
                        "halos (pencils with --pencil), element chunks "
                        "with a boundary buffer elsewhere; without it the "
                        "replicated-vector layout")
    p.add_argument("--pencil", type=str, default=None, metavar="DZxDY",
                   help="with --halo: split the two slowest element axes "
                        "over a DZxDY rank grid (e.g. 2x2)")
    p.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                   dest="dist_backend",
                   help="the ranks' torch.distributed backend: nccl for "
                        "card ranks with a card each (the default with -d "
                        "cuda), gloo for CPU ranks (the default with -d "
                        "cpu) and for card ranks sharing a card")
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
    """The run's mesh: a tensor `Mesh`, or a `TriMesh` / `TetMesh`.
    -epm builds the controlled-scaling mesh instead of -m/-nx..; -rs then
    -rp refine it; -sfc orders its elements along a Morton curve."""
    sizes = (args.xwidth, args.ywidth, args.zwidth)
    if args.epm:
        m, _, _ = epm_mesh(args.dim, max(1, args.n_devices), args.epm, sizes)
        return m
    if args.mesh == "default":
        m = fmesh.cartesian(args.dim, (args.nx, args.ny, args.nz), sizes)
    else:
        m = data.get_mesh(args.mesh)
    for _ in range(args.rs + args.rp):
        m = _refine(m)
    return sfc_partition(m) if args.sfc else m


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


def _amr_forest(args):
    """The initial AMR forest of the mesh flags."""
    from .amr.forest import Forest

    if args.problem != 1:
        raise SystemExit("AMR only supported for problem 1.")
    base = {"square01_quad": (2, (2, 2), (1.0, 1.0)),
            "cube01_hex": (3, (2, 2, 2), (1.0, 1.0, 1.0))}
    name = args.mesh.rsplit("/", 1)[-1].removesuffix(".mesh")
    if name in base:
        dim, base_n, sizes = base[name]
    else:
        dim = args.dim
        base_n = (args.nx, args.ny, args.nz)[:dim]
        sizes = (args.xwidth, args.ywidth, args.zwidth)[:dim]
    levels = args.rs + args.rp
    f = Forest(dim, base_n, sizes, max_depth=levels)
    # initial mesh: RefineAtVertex at the blast corner, rs + rp times,
    # WITHOUT 2:1 balancing (amr/laghos.cpp:199-209)
    for _ in range(levels):
        corner = [k for k in f.leaf_list() if all(v == 0 for v in k[1])]
        f.refine(corner, balance=False)
    return f


def _main_amr(args, device, comm=None):
    """AMR run (amr/laghos.cpp): RefineAtVertex initial mesh, viscosity-
    estimator refinement, density-based derefinement, as
    `laghos_tpu.cli._main_amr`.  Problem 1 only, f64; blast energy is the
    variant's fixed 0.25 and h0 its fixed 0.5/order_v (SetH0).  With `comm`
    this rank's part of a run over ranks: the AMRHydro is built on the host
    and distributed (`shard_amr`).  Returns run_amr's summary."""
    from .amr.driver import run_amr
    from .amr.solver import AMRHydro
    from .parallel.sharding import shard_amr

    f = _amr_forest(args)
    opt = Options(problem=1, blast_energy=0.25, order_v=args.order_v,
                  order_e=args.order_e, order_q=args.order_q,
                  cfl=args.cfl, cg_tol=args.cg_tol,
                  cg_max_iter=args.cg_max_iter,
                  ode_solver=args.ode_solver)
    h = AMRHydro(f, opt, h0=0.5 / args.order_v,
                 device="cpu" if comm is not None else device)
    if comm is not None:
        shard_amr(h, comm)
    print(f"Number of zones in the initial AMR mesh: {h.NE}")
    res = run_amr(h, t_final=args.t_final,
                  ref_threshold=args.ref_threshold,
                  deref_threshold=args.deref_threshold,
                  max_steps=args.max_steps, vis_steps=args.vis_steps,
                  verbose=True)
    print(f"step {res['steps']:5d},\tt = {res['t']:.4f},"
          f"\tdt = {res['dt']:.6f},\t|e| = {res['e_norm']:.10e}"
          f"  NE={res['NE']}")
    if comm is not None:
        res["ranks"] = _report_ranks(comm, h.ctx["gather"].shape[0])
    return res


@dataclasses.dataclass
class CliRun:
    result: driver.RunResult
    hydro: Optional[Hydro]    # None for a run over ranks
    setup_seconds: float      # mesh + Hydro construction, host clock
    fom: Optional[dict]       # print_timing's figures with -f
    # over ranks (-nd > 1): each rank's {"rank", "device", "NE",
    # "launches"} (its kernel launches, parallel/runs.launches) and rank
    # 0's printed lines
    ranks: Optional[list] = None
    log: Optional[str] = None


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


def _profiler(args, device, name="trace.json"):
    if not args.profile:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, name)
    return torch.profiler.profile(
        activities=acts,
        on_trace_ready=lambda prof: prof.export_chrome_trace(path))


def main(argv=None):
    """Run the command line `argv`: returns a CliRun, or with -amr the
    AMR driver's summary dict."""
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.n_devices > 1:
        return _main_distributed(args)
    device = setup(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.amr:
        return _main_amr(args, device)

    t_setup = time.perf_counter()
    m = make_mesh(args)
    print(f"Number of zones in the serial mesh: {m.num_elems}")
    if isinstance(m, (fsm.TriMesh, fsm.TetMesh)):
        return _main_simplex(args, m, device, t_setup)
    return _main_tensor(args, m, device, t_setup)


def mesh_shape(args):
    """The rank grid of --pencil, else -nd slabs."""
    return (tuple(int(x) for x in args.pencil.lower().split("x"))
            if args.pencil else (args.n_devices,))


def _check_distributed(args, m):
    """Refuse, before any rank starts, what a run over -nd ranks cannot
    do on the mesh `m`; the partition checks of the views."""
    if isinstance(m, (fsm.TriMesh, fsm.TetMesh)):
        raise ValueError("-nd covers tensor-element meshes; triangle and "
                         "tetrahedron meshes run the simplex solver on one "
                         "device")
    if not args.pa or m.dim == 1:
        raise ValueError("-nd covers the partial-assembly path (2D and 3D, "
                         "without -fa)")
    if args.pencil and not args.halo:
        raise ValueError("--pencil needs --halo")
    if args.restore and args.halo:
        raise SystemExit("--restore is not supported with --halo yet")
    grid = element_grid(m) if args.halo else None
    if grid is not None:
        shape = mesh_shape(args)
        if int(np.prod(shape)) != args.n_devices:
            raise ValueError(f"--pencil {args.pencil} needs "
                             f"{int(np.prod(shape))} ranks, -nd is "
                             f"{args.n_devices}")
        check_partition(grid, shape)
    elif m.num_elems < args.n_devices:
        raise ValueError(f"{m.num_elems} elements cannot be split over "
                         f"{args.n_devices} ranks")


def _main_distributed(args):
    """-nd N: check the run, build the CUDA kernels once here (the ranks
    load the cached library instead of running N nvcc builds), start N
    ranks and return rank 0's CliRun (with -amr its summary, holding its
    printed lines under "log")."""
    device = setup(args.device)
    backend = args.dist_backend or pcomm.default_backend(device.type)
    pcomm.check_backend(backend, device.type, args.n_devices)
    if args.amr:
        # the AMR path launches no hand-written kernel
        NE = _amr_forest(args).num_leaves
        if NE < args.n_devices:
            raise ValueError(f"{NE} elements cannot be split over "
                             f"{args.n_devices} ranks")
        return pcomm.launch(_cli_rank, args.n_devices, backend, device.type,
                            args)[0]
    _check_distributed(args, make_mesh(args))
    if device.type == "cuda":
        from .ops import kernels

        kernels.build()
    return pcomm.launch(_cli_rank, args.n_devices, backend, device.type,
                        args)[0]


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def _cli_rank(comm, args):
    """One rank of a -nd run: rank 0 prints (and records) the run's lines,
    the others print nothing.  Rank 0 returns the CliRun."""
    log = io.StringIO()
    out = _Tee(sys.stdout, log) if comm.rank == 0 else io.StringIO()
    with contextlib.redirect_stdout(out):
        if comm.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(comm.device)
        if args.amr:
            res = _main_amr(args, comm.device, comm)
            return dict(res, log=log.getvalue()) if comm.rank == 0 else None
        t_setup = time.perf_counter()
        m = make_mesh(args)
        print(f"Number of zones in the serial mesh: {m.num_elems}")
        run = _main_tensor(args, m, comm.device, t_setup, comm)
    return (dataclasses.replace(run, log=log.getvalue()) if comm.rank == 0
            else None)


def _report_ranks(comm, NE):
    """Every rank's {"rank", "device", "NE", "launches"} (its zones and its
    kernel launches, parallel/runs.launches), printed; a collective."""
    ranks = comm.all_gather({"rank": comm.rank, "device": str(comm.device),
                             "NE": NE, "launches": launches()})
    print(f"Ranks: {comm.size} ({comm.backend})")
    for rk in ranks:
        print(f"  rank {rk['rank']}: {rk['device']}, {rk['NE']} zones, "
              f"kernel launches {rk['launches']}")
    return ranks


def _main_tensor(args, m, device, t_setup, comm=None):
    """A tensor-element run on one device, or with `comm` this rank's part
    of a run over ranks (every rank builds the global Hydro on the host and
    runs its view)."""
    opt = Options(
        problem=args.problem, order_v=args.order_v, order_e=args.order_e,
        order_q=args.order_q, cfl=args.cfl, cg_tol=args.cg_tol,
        cg_max_iter=args.cg_max_iter, p_assembly=args.pa,
        impose_visc=args.impose_visc, blast_energy=args.blast_energy, delta_tol=args.delta_tol,
        ode_solver=args.ode_solver, precond=args.precond, ozaki=args.ozaki)
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    if comm is None:
        h = run_h = Hydro(m, opt, dtype=dtype, device=device)
    else:
        h = Hydro(m, opt, dtype=dtype, device="cpu")
        run_h = rank_view(h, comm, args.halo, mesh_shape(args))
    run_h.debug_nans = args.debug_nans
    setup_seconds = time.perf_counter() - t_setup
    print(f"Number of kinematic (position, velocity) dofs: "
          f"{h.ndof * m.dim}")
    print(f"Number of specific internal energy dofs: {h.NE * h.ld}")

    S_init, t0, dt0, st0 = None, 0.0, None, 1
    if args.restore:
        from . import checkpoint

        S_init, t0, dt0, st0 = checkpoint.load(args.restore, device=device,
                                               dtype=dtype)
        if comm is not None:
            S_init = run_h.from_global(S_init)
        # the checkpoint holds the last completed step: resume at the next
        # one, so the |e| lines, the vis cadence and the --checks steps
        # line up with an uninterrupted run
        st0 += 1
    check_steps = ()
    if args.check:
        if args.rs != 0 or args.rp != 0:
            raise ValueError("--checks needs -rs 0 -rp 0")
        if (args.order_v, args.order_e) != (2, 1):
            raise ValueError("--checks needs -ok 2 -ot 1")
        if args.ode_solver != 4 or args.t_final != 0.6 or args.cfl != 0.5:
            raise ValueError("--checks needs -s 4 -tf 0.6 -cfl 0.5")
        check_steps = tuple(s for s, _ in CHECKS_TABLE[m.dim][args.problem])
    on_vis = _on_vis(args, h) if comm is None or comm.rank == 0 else None
    if comm is not None and (args.visit or args.gfprint
                             or args.visualization):
        # every rank joins the gather; rank 0 writes
        def on_vis(ti, t, S, rank0=on_vis):
            G = run_h.to_global(S)
            if rank0 is not None:
                rank0(ti, t, G)
    trace = "trace.json" if comm is None else f"trace_rank{comm.rank}.json"
    with _profiler(args, device, trace):
        res = driver.run(run_h, t_final=args.t_final,
                         max_steps=args.max_steps, vis_steps=args.vis_steps,
                         verbose=True, timing=args.fom,
                         check_steps=check_steps, on_vis=on_vis,
                         S_init=S_init, t_init=t0, dt_init=dt0,
                         step_init=st0, checkpoint_path=args.checkpoint,
                         device_loop=(args.device_loop and not args.fom
                                      and (comm is None or (
                                          args.halo
                                          and not args.checkpoint))))
    if comm is not None:
        # the global state; element and q-point counts summed over ranks,
        # as the reference reduces them (laghos_solver.cpp:699-778)
        quads = [res.quad_steps] + ([res.timing_data.quad_tstep]
                                    if res.timing_data is not None else [])
        quads = comm.allreduce_sum(torch.tensor(quads)).tolist()
        res = dataclasses.replace(res, S=run_h.to_global(res.S),
                                  quad_steps=quads[0])
        if res.timing_data is not None:
            res.timing_data.quad_tstep = quads[1]
    if args.profile:
        print(f"Profiler trace written to "
              f"{os.path.join(args.profile, trace)}")
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
            p_assembly=h.p_assembly, dim=m.dim, fom_table=args.fom,
            ranks=1 if comm is None else comm.size)
        if comm is None or comm.rank == 0:
            # Adiak-style provenance record (laghos.cpp:1288-1346)
            meta = run_metadata(args=args, opt=opt, result=fom,
                                device=device,
                                extra={"NE": h.NE, "steps": res.steps,
                                       "t_final": res.t,
                                       "e_norm": res.e_norm})
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
    if comm is None:
        return CliRun(res, h, setup_seconds, fom)
    return CliRun(res, None, setup_seconds, fom,
                  ranks=_report_ranks(comm, run_h.NE))
