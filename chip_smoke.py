"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths (`laghos_tpu_torch`) through the entry points a
user calls, at the reference's 3D Sedov benchmark size, and checks them:

1. device: the card, its power limit, and the torch/CUDA/nvcc versions;
2. build of the hand-written CUDA kernels (csrc/qphys.cu, csrc/split.cu,
   csrc/mass.cu, csrc/lattice_mass.cu, csrc/cg.cu) from this checkout, one
   nvcc per source in parallel, on the host's cores while phase 15 (which
   launches none) runs on the card, with ptxas's registers and spills and,
   for the mass kernel's and the lattice mass kernel's Q8-Q7 instances, their
   static SASS counts of shared-memory loads and stores, FMAs, barriers,
   cp.async copies and uniform constant loads;
3. each kernel instance against its plain PyTorch version on the card, f64
   and f32, with inverted and NaN points mixed in, with launch times (warm,
   and with a cold L2: a 128 MiB buffer written before each launch): the
   CG chain (csrc/cg.cu) at the benchmark cells' velocity and energy CG
   shapes against its plain twins, f64 and f32, bit for bit across two
   launches, each timed launch from the same active state; the
   element layout on the flagship mesh's gather-path q-data, the q-lattice
   and packed layouts on its q-lattice (2,097,152 points); the Ozaki split
   bit for bit at the six stage operands of an Ozaki mass apply of the
   flagship state (8 and 6 slices), at the flat operands of the flagship's
   L2 energy (NE, 8) and gather-path force (3 NE, 192) products, and on a
   mixed-magnitude operand with zero, NaN and Inf rows; the mass kernel
   against its plain twin, f64 and f32, bit for bit across two launches,
   on the flagship's tables and D: the energy CG's L2 apply (NE, 8), the
   gather path's H1 apply (3, NE, 27), and both in 2D on seeded D, each
   also against one torch.bmm of its dense element matrices
   (`mass.l2_mass_matrices`), timed beside the kernel, and in 3D the
   runtime-size kernel forced at the same sizes, held to the twin and timed
   beside the compiled instances; the lattice mass kernel (the velocity
   CG's operator on the lattice path) against its plain twin (the banded
   tensordot chain), f64 and f32, bit for bit across two launches, on the
   flagship lattice's tables and weights (65^3 nodes, 128^3 q-points),
   timed beside the twin and its runtime-size body forced at that size;
4. the reference's --checks goldens (3D and 2D Sedov) through the port's
   driver on the card, on the whole-lattice and on the gather path, and 3D
   Sedov through the Ozaki lattice path (at its gate, 3e-13);
5. the flagship runs: 3D Sedov, rs4, Q2-Q1, RK2Avg, f64 through the CLI on
   the lattice path (Jacobi, then --precond kron), with FOM, CG
   iterations, energy drift and peak memory; the gather path at the same
   size through `driver.run` for fewer steps, whose |e| must agree with
   the lattice run's; the ns4 shape (Q4-Q3, rs3) on the lattice path;
   short f32 runs of both paths, and the lattice mass kernel held and
   timed as in phase 3 on the ns4 run's lattice, and against one SpMM of
   its mass assembled on the card (the library call); then the Ozaki mode
   (--ozaki) on the same shapes: flagship Jacobi and kron, ns4, and the
   gather path, each
   gated on drift and on |e| against the native lattice Jacobi run of this
   call.  The packed layout is on no time-stepping path (its `launches` is
   0 and its entry `on_path` false): its entry point is held, outside the
   counted runs, against the q-update of the final state of the f64 and
   the f32 lattice runs;
6. bitwise repeatability of two runs on the lattice path, two on the
   gather path and two on the Ozaki lattice path, and of the -fa flagship
   (run again after phase 8);
7. BASELINE rows 5 (1D, -fa), 1 (p0, with its velocity error norms) and 8
   (p4, RK2Avg) in full through the CLI (`laghos_tpu_torch/golden.py`), to
   the golden gates, with their seconds;
8. the flagship under -fa (full assembly: the coupled CG through the
   assembled sparse H1 mass, the element-layout q-point kernel) against
   the gather path under -pa in the same call, with the CSR's size, build
   time and memory, and its product (one CSR SpMV per component) checked
   for bitwise repeatability beside the single SpMM with the (ndof, 3)
   block, which is timed and checked too (and timed in f32: the lattice
   mass kernel's library yardstick);
9. checkpoint and restore: 3D Sedov rs3, 5 steps with --checkpoint, then
   --restore and 5 more, bit for bit the uninterrupted 10 steps;
10. the I/O flags on a small card run: -visit -print -k (VTU, PVD, NPZ
   parsed and counted), -mb (the card's peak), -err (a finite density
   error), --profile (a trace with device kernels);
11. the device loop: the flagship without -f through the CLI with the
   host loop and with --device-loop, bit for bit (states, steps, t, dt,
   norms, CG totals, step lines), then step_ms of each twice, alternating
   on one Hydro, and the host syncs per accepted step of each
   (`timing.count_syncs`, in a further run); the
   gather path at the flagship size (5 steps) and the Ozaki lattice path
   at rs3 (5 steps) likewise bit for bit;
12. solver options on the flagship: --precond schwarz for 5 steps (|e|
   within 1e-10 of the Jacobi run's at step 5, its iterations and setup
   printed), then `cg_warm_start` for the 21 steps (the same steps, |e|
   within 1e-6 of the cold run, no more H1 iterations: at -cgt 1e-11 the
   force changes between the stages too much for the previous stage's
   acceleration to save one), and the JAX package's own warm-start gate
   (3D Sedov rs1, RK4, 12 steps: fewer iterations);
13. `batch.sweep` of four blast energies on the flagship mesh, 6 step
   attempts each, every member bit for bit its separate card run;
14. the simplex solver: 3D Sedov on cube01_tet refined three times
   (24,576 tets, Q2-Q1, 120 q-points a tet), RK2Avg, 5 steps twice
   (drift <= 1e-11, bitwise equal), its assembly's repeatability beside
   an index_add_ version (printed), then once through the CLI's simplex
   route.  The simplex path runs no hand-written kernel, as the JAX
   package's runs no Pallas kernel;
15. the AMR variant (`laghos_tpu_torch/amr/`): BASELINE AMR row 1's
   60-attempt prefix (2D, rs4, Q2-Q1) twice, bitwise equal and at the JAX
   package's pinned 51 steps / NE 70 / |e| 390.4794540789; row 3's first
   50 accepted steps (3D, rs3) against the JAX package's trace in
   runs/ (every refine/derefine decision equal, |e| to AMR_E_TOL); row 4
   resumed from the JAX package's checkpoint in runs/ (NE 2,745, 21,041
   true nodes a component) for 4 attempts twice, bitwise equal, against
   the JAX package's continuation, with the host syncs per accepted step;
   one CLI run with -amr.  No hand-written kernel may launch there: the
   AMR q-update is plain torch, as it is plain JAX.  It runs second, beside
   the build of phase 2;
16. distributed runs (`laghos_tpu_torch/parallel/`): (a) the flagship
   over slabs at world size 1 on NCCL, against phase 11's single-device
   run (bitwise printed); (b) the flagship through the CLI on 4 ranks
   sharing the card (`-nd 4 --halo --dist-backend gloo`: NCCL refuses two
   ranks on one card, so the planes and all-reduces go through the host),
   21 steps against (a) at the JAX package's distributed bounds (steps, t
   at 1e-13, |e| and energy at 1e-11, CG-H1 within 1 %), drift <= 1e-12,
   then its first 5 steps again, bitwise equal in its lines and norms to
   the 21-step run and in its global state, norms, t, dt and CG totals to
   (f)'s host-loop slabs run through the library (cut from a second CLI
   run, for time), every rank's q-lattice and mass kernel launches
   reported to rank 0; on 4 ranks, 5 steps each: (c) pencils 2x2 against
   (b) at step 5, (d) element chunks (the element kernel) against phase
   11's gather run, (f) the device loop bit for bit the host loop, whose
   |e| at step 5 is (b)'s bit for bit, (g) the replicated layout at rs3
   against phase 9's run, and in f32 (the f32 element kernel) against the
   f64 one at 1e-4; on 2 ranks: (e) Ozaki slabs at rs3 (the split
   kernel on both) against phase 11's Ozaki run, (h)
   `batch.sweep(n_devices=2)` of phase 13's members, each bit for bit its
   phase 13 result.  Any rank's failure fails the phase.  Its times say
   nothing about scaling: four processes share one card;
17. the AMR variant across ranks (`parallel.sharding.shard_amr`): (a)
   row 1's 60-attempt prefix at world size 1 on NCCL, bit for bit phase 15
   (a); (b) the converged 2D trajectory TRAJ on 2 gloo ranks sharing the
   card, record for record a single-card run (t and dt at 1e-12, |e| at
   1e-10), refining and derefining, each rank's element count printed
   after every placement, and a second run of its first 5 attempts
   bitwise equal to the first's records (cut: ranks sharing the card
   take 4-7 ms a CG iteration, so 2 ranks, not 4, and the repeat short);
   (c) row 4 resumed from the JAX checkpoint (NE 2,745) on the same 2
   ranks (one launch with (b)) for 2 attempts (cut from phase 15's 4),
   NE per attempt equal to phase 15 (c), |e| within AMR_E_TOL, with
   step_ms split and the collectives a step; (d) the
   CLI's -amr -nd 2 on phase 15 (d)'s arguments, its step lines equal in
   step, t, dt and NE.  No hand-written kernel launches on any rank; the
   gloo cells' times say nothing about scaling;
18. high order, Q8-Q7 (the JAX package's `q8` row): 3D Sedov at rs3 (NE
   4,096, 16,777,216 q-points, 6,440,067 H1 dofs) through the CLI on the
   lattice path in f64 and in the JAX row's f32 form (|e| within
   Q8_F32_E_TOL of f64), 3D Taylor-Green at rs3, each with setup seconds,
   step_ms and its phase split, L2 iterations a solve and peak memory;
   the mass kernel (L2 (NE, 512), H1 (3, NE, 729), f64 and f32, the
   runtime-size kernel timed beside it), the lattice mass kernel (129^3
   nodes, 256^3 q-points, f64 and f32) and the lattice-, element- and
   packed-layout q-point kernels at those shapes against their plain
   twins; at rs2 Taylor-Green on the lattice path twice (bitwise)
   against the gather path (|e| at 1e-11, drift <= 1e-12) and Sedov with
   kron against the gather path (|e| within Q8_SEDOV_E_TOL); at rs0 the
   card against the CPU (Taylor-Green at 1e-11, Sedov at Q8_SEDOV_E_TOL:
   its L2 CG stops at its cap, far from convergence);
19. the Ozaki mode at Q8-Q7: phase 18's Taylor-Green at rs3 through the
   CLI with --ozaki (every contraction an Ozaki product, the IR velocity
   solve), against phase 18's native run: the same printed step lines, t
   and dt at the end within 1e-12, |e| at every step within OZ_E_TOL, the
   final velocity within OZ_V_TOL, drift <= 1e-12, with setup seconds,
   step_ms and its phase split, the H1 inner sweeps and outers, the L2
   iterations a solve, peak memory and the split launches; then the split
   kernel bit for bit against its plain twin at the q8 shapes: the six
   stage operands of one Ozaki mass apply (k = 129 and 256, 8 and 6
   slices), the L2 pair's flat operands (NE, 512) and (NE, 4096) (the
   chunked branch; 8, 6 and 4 slices) and mixed-magnitude operands of
   those widths with zero, NaN and Inf rows, timed warm and with a cold
   L2;
20. the triple point (-p 3) under RK2Avg, BASELINE configs[3], on a 7 x
   3 x 3 box whose element faces lie on the material interfaces, written
   as an MFEM file and read by -m, at rs2 (1,792 zones, Q2-Q1, 51 step
   attempts): through the CLI on the lattice path (drift <= 1e-12), the
   gather path (|e| at every step within 1e-11 of the lattice run's,
   drift <= 1e-12), and the lattice run's command on this machine's CPU,
   in a child process run beside phase 19 (the same printed step lines,
   |e| at every step within 1e-11).

Each kernel's `bound_ms` is the larger of its bytes (every input read once,
every output written once) over 3.35 TB/s and its operations over the
card's peak for their type (for the q-point kernel, the longer of the
algorithm's operations and the FP64-pipe instructions counted in the built
library, at half the FP64 peak; for the lattice mass kernel the least
operations of the function, those of the banded sum factorization, not
of the kernel's element route: `lattice_mass_ops`); `cold_ms` is its time
with a cold L2, the one its share of the bound is read against;
`library_ms` is null for the q-point and split kernels, as no single
PyTorch call computes them, and for the mass kernel one torch.bmm of
dense element mass matrices by u (at Q8-Q7 on seeded matrices of that
shape), for the lattice mass kernel one SpMM of the assembled H1 mass by
the (ndof, 3) block: phase 8's CSR at the flagship size, one assembled on
the card at ns4 (`assembled_h1_csr`, 57.1M nonzeros), null at Q8-Q7
(its CSR would hold 2.10e9 nonzeros, 25 GB in f64 with int32 columns,
and its build on the card 2.18e9 entries with int64 indices before
coalescing: more than the card holds).  The q-point kernel's
entries carry the same numbers at phase 18's Q8-Q7 shapes under "q8",
the split kernel's at phase 19's (the six stages of one Ozaki mass
apply), the mass kernel's and the lattice mass kernel's at phase 18's
(the lattice mass kernel's also at phase 5's ns4 lattice under "ns4");
the mass kernel's top-level numbers are the flagship's energy CG apply,
"h1" the gather path's velocity apply.  The mass kernel's launches are
those of every main-path run of its dtype (none in the Ozaki mode, -fa,
AMR or simplex runs, whose mass applies are other products, as in the
JAX package); the lattice mass kernel's those of every lattice-path run,
counted as f32 in the Ozaki mode (the IR solve's f32 inner sweeps).

Every phase raises on failure.  The last two lines are a JSON record of the
kernels and the JSON status line; neither is printed unless every phase
passed.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FLAGSHIP = ["-p", "1", "-dim", "3", "-rs", "4", "-ok", "2", "-ot", "1",
            "-s", "7", "-cgt", "1e-11", "-ms", "20", "-f", "-vs", "5",
            "-d", "cuda"]
FLAGSHIP_KRON = FLAGSHIP + ["--precond", "kron"]
# the JAX package's ns4 shape (Q4-Q3 at rs3), a few steps
NS4 = ["-p", "1", "-dim", "3", "-rs", "3", "-ok", "4", "-ot", "3", "-s", "7",
       "-cgt", "1e-11", "-ms", "4", "-f", "-vs", "5", "-d", "cuda"]
FLAGSHIP_OZ = FLAGSHIP + ["--ozaki"]
FLAGSHIP_OZ_KRON = FLAGSHIP_KRON + ["--ozaki"]
NS4_OZ = NS4 + ["--ozaki"]
FLAGSHIP_F32 = ["-p", "1", "-dim", "3", "-rs", "4", "-ok", "2", "-ot", "1",
                "-s", "7", "-cgt", "2e-7", "-ms", "3", "--dtype", "f32",
                "-vs", "5", "-d", "cuda"]
# the flagship under full assembly (-fa): the gather-path q-update and
# force, the coupled CG through the assembled sparse H1 mass
FLAGSHIP_FA = FLAGSHIP + ["-fa"]
FLAGSHIP_STEPS = 21        # accepted steps of the flagship runs (-ms 20)
# BASELINE rows run in full on the card (laghos_tpu_torch/golden.py)
GOLDEN_ROWS = (5, 1, 8)
# 3D Sedov at rs3 for the checkpoint phase: 10 steps, saved at step 5
CKPT = ["-p", "1", "-dim", "3", "-rs", "3", "-s", "7", "-cgt", "1e-11",
        "-vs", "5", "-d", "cuda"]
# a small card run for the I/O flags of phase 10
IO_RUN = ["-p", "1", "-dim", "3", "-rs", "1", "-ms", "4", "-vs", "5", "-mb",
          "-err", "-d", "cuda"]
# the flagship without -f (the device loop takes no phase timing), and
# the same with --precond schwarz for 5 steps; the Ozaki lattice path at
# rs3 for 5 steps, for the device-loop phase
FLAGSHIP_RUN = [a for a in FLAGSHIP if a != "-f"]
SCHWARZ_RUN = [a for a in FLAGSHIP_RUN] + ["--precond", "schwarz"]
SCHWARZ_RUN[SCHWARZ_RUN.index("-ms") + 1] = "4"
OZAKI_RUN = CKPT + ["-ms", "4", "--ozaki"]
# 3D Sedov on cube01_tet refined 3 times (24,576 tets): 10 steps in
# SimplexHydro, a few through the CLI's simplex route (RK4, the JAX CLI's)
SIMPLEX_RS = 3
SIMPLEX_STEPS = 5          # cut from 10 for the script's time
SIMPLEX_CLI = ["-p", "1", "-m", "cube01_tet", "-rs", str(SIMPLEX_RS),
               "-cgt", "1e-11", "-ms", "2", "-d", "cuda"]
# Options of the gather path (the default Options run the lattice path on
# these Cartesian meshes)
GATHER = dict(structured_el=False, lattice_ops=False, precond="jacobi")
GATHER_STEPS = 5           # accepted steps of the rs4 gather-path run
SOURCE = "laghos_tpu_torch/csrc/qphys.cu"
SPLIT_SOURCE = "laghos_tpu_torch/csrc/split.cu"
SPLIT_REPLACES = "laghos_tpu/ops/pallas_split.py:129"
MASS_SOURCE = "laghos_tpu_torch/csrc/mass.cu"
# the JAX package's mass apply, which XLA runs (no Pallas kernel)
MASS_REPLACES = "laghos_tpu/ops/mass.py:68"
# the mangled names of the mass kernel's Q8-Q7 instances (3D, L2 and H1
# tables, f64 and f32), whose ptxas lines phase 2 prints in full
MASS_Q8 = ("Li3ELi8ELi16E", "Li3ELi9ELi16E")
# the SASS opcodes phase 2 counts in those instances: shared-memory loads
# and stores, the FMAs of the contractions, barriers, cp.async copies and
# the uniform constant loads of the table operands
MASS_SASS_OPS = ("LDS", "STS", "DFMA", "FFMA", "BAR", "LDGSTS", "ULDC")
LATTICE_MASS_SOURCE = "laghos_tpu_torch/csrc/lattice_mass.cu"
# the JAX package's lattice H1 mass apply, which XLA runs (no Pallas kernel)
LATTICE_MASS_REPLACES = "laghos_tpu/ops/lattice.py:65"
F64, F32 = torch.float64, torch.float32
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, FP64 and FP32 rates outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {F64: 34e12, F32: 67e12}
# the mass kernel's products are batched small matrix products, which the
# card also runs in IEEE FP64 on its tensor cores (67 TFLOP/s, cuBLAS's
# DGEMM path): its f64 work is bound at that rate.  Its f32 work keeps
# 67 TFLOP/s outside the tensor cores (TF32 is not f32 precision)
MASS_PEAK_FLOPS = {F64: 67e12, F32: 67e12}
# FP operations per q-point of the physics chain, counted from
# csrc/qphys.cu (det and adjugate, EOS, two 3x3 eigen-solves with their
# Jacobi sweeps, dt, stress): an estimate, not a measurement
QPHYS_OPS_PER_POINT = 1000
# beside it, what the card executes: static SASS instructions of the
# q-lattice viscous instance (f64, f32), the IEEE division and square-root
# sequences and their slow paths included, as phase 2 counts them in the
# built library (`kernels.sass_instructions`; H100 80GB HBM3, 700 W)
QPHYS_SASS_PER_POINT = {F64: 4038, F32: 3566}
# the opcodes of the FP64 pipe: each takes one of its issue slots, at half
# the FP64 peak a second (an FMA counts two operations in the peak); the
# chain's FP64 instructions (static, one pass through every loop and slow
# path) bound it beside its bytes
FP64_OPCODES = {"DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"}
# {(layout, dtype): FP64-pipe instructions a point of its viscous
# instance}, filled by phase 2 from the built library
FP64_PER_POINT = {}
# an estimate logged beside the bound, not a bound: every SASS instruction
# of the chain at one issue a clock for each of an SM's 4 schedulers (32
# threads each), on the data sheet's 132 SMs at their 1.98 GHz boost clock
ISSUE_PER_S = 132 * 4 * 32 * 1.98e9
# layout -> (wrapper in ops/qphys, {dtype: the TPU kernel it replaces}), in
# the order of csrc/qphys.cu's Layout enum
LAYOUTS = {
    "element": ("physics_3d", {F64: "laghos_tpu/ops/pallas_df64.py:132",
                               F32: "laghos_tpu/ops/pallas_qphys.py:211"}),
    "lattice": ("physics_3d_lattice",
                {F64: "laghos_tpu/ops/pallas_qphys.py:149",
                 F32: "laghos_tpu/ops/pallas_qphys.py:149"}),
    "packed": ("physics_3d_packed",
               {F64: "laghos_tpu/ops/pallas_qphys.py:97",
                F32: "laghos_tpu/ops/pallas_qphys.py:97"}),
}
# kernel vs plain version on the card, relative to max|sJit| (and max|visc|
# for the packed layout).  Both run the same operations; they differ only
# where nvcc contracts a*b+c into FMA and the plain version rounds twice.
# f64: ~1e-16 observed, 1e-12 asked.  f32: ~1e-9 observed on an H100 (the
# f32 eigen-solve of the strain rate can amplify an ulp of difference);
# 1e-5 is about 80 f32 ulps of max|sJit|.
TOL = {F64: 1e-12, F32: 1e-5}
# the mass kernel against its plain twin, relative to max|twin|: both sum
# the same products in another order (the twin's tensordots through
# cuBLAS), ~1e-16 of max|twin| expected in f64; 1e-5 is ~80 f32 ulps
MASS_TOL = {F64: 1e-13, F32: 1e-5}
# calls of the q-point kernel's plain twin timed (the kernels' own: 20)
PLAIN_CALLS = 5


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_device():
    from laghos_tpu_torch.device import setup

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    dev = setup("cuda")
    from laghos_tpu_torch.ops import kernels

    nvcc = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60)
    log(f"[1 device] nvidia-smi: {card_line()}")
    log(f"[1 device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"[1 device] {torch.cuda.get_device_name(dev)} "
        f"(count {torch.cuda.device_count()})")
    return dev


def phase_build(b):
    """Phase 2 on `b`, the `kernels.build()` of this checkout (run beside
    phase 15)."""
    from laghos_tpu_torch.ops import kernels

    kernels.library()
    log(f"[2 build] {b.path.name}: nvcc and link {b.seconds:.2f} s (beside "
        "phase 15)")
    mass = {}           # kernel -> [registers, spill store bytes]
    cur = ""
    for line in b.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        if (("mass_kernel" in cur or "lattice_mass" in cur)
                and not any(q in cur for q in MASS_Q8)):
            k = mass.setdefault(cur, [0, 0])
            m = re.search(r"Used (\d+) registers", line)
            k[0] = int(m.group(1)) if m else k[0]
            m = re.search(r"(\d+) bytes spill stores", line)
            k[1] = int(m.group(1)) if m else k[1]
            continue
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[2 build] ptxas: {line.strip()}")
    if mass:
        regs = [r for r, _ in mass.values()]
        log(f"[2 build] ptxas: {len(mass)} other mass and lattice mass "
            f"kernel instances: "
            f"{min(regs)}-{max(regs)} registers; spill stores in "
            f"{[k for k, (_, sp) in mass.items() if sp]}")
    mix = kernels.sass_instructions(b.path, MASS_SASS_OPS, per_opcode=True)
    for name in sorted(k for k in mix
                       if ("mass_kernelI" in k or "lattice_mass_stagesI" in k)
                       and any(q in k for q in MASS_Q8)):
        n = mix[name]
        fma = max(1, n['DFMA'] + n['FFMA'])
        log(f"[2 build] SASS {name}: "
            + ", ".join(f"{op} {n[op]}" for op in MASS_SASS_OPS)
            + f"; LDS/FMA {n['LDS'] / fma:.3f}, (ULDC + LDS)/FMA "
            f"{(n['ULDC'] + n['LDS']) / fma:.3f}")
    sass = kernels.sass_instructions(b.path)
    fp64 = kernels.sass_instructions(b.path, FP64_OPCODES)
    for code, dt in (("d", F64), ("f", F32)):
        for lay, layout in enumerate(LAYOUTS):
            # the viscous, vorticity-free qphys_kernel<T, layout, true, false>
            name = f"qphys_kernelI{code}Li{lay}ELb1ELb0E"
            n = [k for k in sass if name in k]
            if len(n) != 1:
                raise AssertionError(f"no {layout} viscous {dt} instance in "
                                     f"the SASS of {b.path.name}")
            FP64_PER_POINT[layout, dt] = fp64[n[0]]
            if layout == "lattice":
                total = sass[n[0]]
        log(f"[2 build] q-lattice viscous {str(dt)[6:]} instance: {total} "
            f"SASS instructions a point (QPHYS_SASS_PER_POINT "
            f"{QPHYS_SASS_PER_POINT[dt]}) against {QPHYS_OPS_PER_POINT} "
            "operations of the algorithm; FP64-pipe instructions a point: "
            + ", ".join(f"{lay} {FP64_PER_POINT[lay, dt]}"
                        for lay in LAYOUTS))
    if not FP64_PER_POINT["lattice", F64]:
        raise AssertionError("no FP64 instructions in the f64 instance")


# ------------------------------------------------------- launch counts --
def _wrapper(layout):
    from laghos_tpu_torch.ops import qphys

    return getattr(qphys, LAYOUTS[layout][0])


def reset_counts():
    from laghos_tpu_torch.ops import lattice, mass, omm
    from laghos_tpu_torch.solvers import cg as cgm

    for layout in LAYOUTS:
        _wrapper(layout).launches = 0
    omm.split_dyn.launches = 0
    mass.mass_apply_e.launches = 0
    lattice.mass_apply_lattice.launches = 0
    cgm.chain_step.launches = 0
    cgm.chain_ess_dot.launches = 0


def read_counts():
    """The launch counts since the last reset."""
    from laghos_tpu_torch.ops import lattice, mass, omm
    from laghos_tpu_torch.solvers import cg as cgm

    out = {layout: _wrapper(layout).launches for layout in LAYOUTS}
    out["split"] = omm.split_dyn.launches
    out["mass"] = mass.mass_apply_e.launches
    out["lattice_mass"] = lattice.mass_apply_lattice.launches
    out["cg_step"] = cgm.chain_step.launches
    out["cg_ess_dot"] = cgm.chain_ess_dot.launches
    return out


def tally(launches, counts, layout, dtype=F64):
    """Adds the counts of a main-path run in `dtype` to the ledger
    `launches`: the `layout` q-point kernel's at (layout, dtype), the split
    kernel's at "split", the mass kernel's at ("mass", dtype), the lattice
    mass kernel's at ("lattice_mass", dtype), or at ("lattice_mass", F32)
    in the Ozaki mode (the runs that split), where only the f32 inner
    sweeps of the IR velocity solve launch it; the CG chain's steps and
    mask-and-dot launches at ("cg_step", dtype) and ("cg_ess_dot", dtype)
    (the CGs of a run solve in its dtype; the IR solve's f32 inner CG takes
    the eager iteration)."""
    lat_dt = F32 if counts["split"] else dtype
    for key, n in (((layout, dtype), counts[layout]),
                   ("split", counts["split"]),
                   (("mass", dtype), counts["mass"]),
                   (("lattice_mass", lat_dt), counts["lattice_mass"]),
                   (("cg_step", dtype), counts["cg_step"]),
                   (("cg_ess_dot", dtype), counts["cg_ess_dot"])):
        launches[key] = launches.get(key, 0) + n


def merge(launches, more):
    """Adds the ledger `more` to `launches`."""
    for key, n in more.items():
        launches[key] = launches.get(key, 0) + n


def named(launches):
    """The ledger with readable keys, for the log."""
    return {(f"{k[0]} {str(k[1])[6:]}" if isinstance(k, tuple) else k): n
            for k, n in launches.items()}


def bound(nbytes, ops, dtype, fp64=0, peak=None):
    """(bound_ms, bound_by): the larger of the byte time at HBM bandwidth
    and the operation time, the longer of `ops` at `peak` (default the
    card's peak for `dtype`) and `fp64` FP64-pipe instructions at half the
    FP64 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / (peak or PEAK_FLOPS[dtype]),
                fp64 / (PEAK_FLOPS[F64] / 2)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ------------------------------------------------------------ phase 3 --
def flagship_hydro(device, dtype=F64, rs=4, **opt):
    """3D Sedov (RK2Avg, -cgt 1e-11 unless `opt` says otherwise) on
    cube01_hex refined `rs` times: the flagship at rs 4."""
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
    for _ in range(rs):
        m = fmesh.uniform_refine(m)
    opt = {"problem": 1, "ode_solver": 7, "cg_tol": 1e-11, **opt}
    return Hydro(m, Options(**opt), dtype=dtype, device=device)


def _perturbed_velocity(h, rng):
    dv = torch.tensor(rng.normal(size=tuple(h.S0["v"].shape)) * 0.1,
                      dtype=h.dtype, device=h.device)
    return h.S0["v"] + dv


def element_inputs(h, seed=0):
    """Element-layout q-data of the gather-path `h` at t=0 with the
    velocity perturbed by a seeded field (so the viscous branch is
    active), and a few inverted and NaN points."""
    from laghos_tpu_torch.ops import qupdate as qop
    from laghos_tpu_torch.ops import tensor as top

    rng = np.random.default_rng(seed)
    S = h.S0
    v = _perturbed_velocity(h, rng)
    x_e, v_e = h._gather_e(S["x"]), h._gather_e(v)
    J9 = qop._grad9(x_e, h.tables["H1B"], h.tables["H1G"], h.nd1, h.NQ)
    dV9 = qop._grad9(v_e, h.tables["H1B"], h.tables["H1G"], h.nd1, h.NQ)
    et = S["e"].reshape((h.NE,) + (h.l1d,) * 3)
    e_q = top.eval_values(et, h.tables["L2B"], 3).reshape(h.NE, h.NQ)
    e_q = e_q + 0.5             # nonzero pressure everywhere
    _inject(rng, J9.reshape(9, -1), e_q.reshape(-1))
    args = [J9.contiguous(), dV9.contiguous(), h.Jac0inv_t, e_q.contiguous(),
            h.rho0DetJ0w_t, h.gamma_t, h.tables["Winv"]]
    return args, dict(h0_e=h.h0)


def _inject(rng, J9flat, e_flat):
    """4 inverted, 2 NaN-geometry and 2 NaN-energy points."""
    pts = torch.as_tensor(rng.choice(e_flat.numel(), size=8, replace=False),
                          device=e_flat.device)
    J9flat[:, pts[:4]] *= -1.0                    # detJ < 0
    J9flat[4, pts[4:6]] = float("nan")            # NaN geometry
    e_flat[pts[6:]] = float("nan")                # NaN energy


def _qlattice_args(h, x, v, e):
    """The lattice-layout arguments of the q-update of the lattice-path
    `h` at the state (x, v, e)."""
    from laghos_tpu_torch.ops import lattice as lop

    lat, dims = h._lat, h._lat_dims
    J9 = torch.stack(lop.grad9_lattice(x.reshape((3,) + dims), lat["Ts"],
                                       lat["Tg"]))
    dV9 = torch.stack(lop.grad9_lattice(v.reshape((3,) + dims), lat["Ts"],
                                        lat["Tg"]))
    e_q = lop.energy_qlattice(e, h._edims, h.tables, 3)
    return [J9, dV9, lat["J0i9"], e_q, lat["rw"], lat["gam"], lat["winv"]]


def lattice_inputs(h, seed=0):
    """q-lattice-layout q-data of the lattice-path `h`, perturbed and
    injected as `element_inputs`."""
    rng = np.random.default_rng(seed)
    S = h.S0
    args = _qlattice_args(h, S["x"], _perturbed_velocity(h, rng), S["e"])
    args[3] = args[3] + 0.5
    _inject(rng, args[0].reshape(9, -1), args[3].reshape(-1))
    return args, dict(h0=h.h0)


def eq_inputs(h, lattice_args, layout):
    """The q-lattice q-data `lattice_args` of the lattice-path `h` per zone
    (raster element order) in `layout`: "element", (9, NE, NQ) a field, or
    "packed", (NE, NQ, 3, 3) a field."""
    from laghos_tpu_torch.ops import lattice as lop

    J9, dV9, J0i9, e_q, rw = lattice_args[:5]
    element = layout == "element"

    def eq(a):
        return lop.qlattice_to_eq(a, h._edims, h.nq1)

    def field(A9):
        if element:
            return torch.stack([eq(a) for a in A9]).contiguous()
        return torch.stack([eq(a) for a in A9], dim=-1).reshape(
            h.NE, h.NQ, 3, 3).contiguous()

    args = [field(J9), field(dV9), field(J0i9), eq(e_q).contiguous(),
            eq(rw).contiguous(), h.gamma_t,
            h.tables["Winv" if element else "W"]]
    return args, (dict(h0_e=h.h0) if element else dict(h0=h.h0))


def _max_err(k, p, what, dtype):
    nan_k, nan_p = torch.isnan(k), torch.isnan(p)
    if not torch.equal(nan_k, nan_p):
        raise AssertionError(f"{dtype}: NaN patterns of {what} differ")
    fin = ~nan_p
    return float((k[fin] - p[fin]).abs().max()), float(p[fin].abs().max())


def compare(layout, inputs, dtype, tag="3 kernel", h1order=2.0):
    """Kernel against plain version on the card for one layout and dtype;
    returns the kernels-line numbers."""
    from laghos_tpu_torch.ops import qphys
    from laghos_tpu_torch.timing import device_ms

    wrapper = _wrapper(layout)
    plain = getattr(qphys, LAYOUTS[layout][0] + "_plain")
    base, extra = inputs
    args = [a.to(dtype) for a in base]
    kw = dict(extra, h1order=h1order, cfl=0.5, use_viscosity=True,
              use_vorticity=False)
    out_k, out_p = wrapper(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    err, scale = _max_err(out_k[0], out_p[0], "sJit", dtype)
    dk, dp = out_k[1], out_p[1]
    zk, zp = dk == 0, dp == 0
    if not torch.equal(zk, zp):
        raise AssertionError(f"{layout} {dtype}: dtq == 0 masks differ "
                             f"({int(zk.sum())} vs {int(zp.sum())})")
    good = dp > 0
    dmin_k, dmin_p = float(dk[good].min()), float(dp[good].min())
    drel = abs(dmin_k - dmin_p) / dmin_p
    tol = TOL[dtype]
    name = f"{layout} {str(dtype)[6:]}"
    msg = (f"[{tag}] {name}: max|dsJit| {err:.3e} = {err / scale:.3e} x "
           f"max|sJit| (tol {tol:g}); dtq.min rel diff {drel:.3e}; "
           f"zero-dt points {int(zp.sum())}")
    ok = err <= tol * scale and drel <= tol
    if layout == "packed":
        verr, vscale = _max_err(out_k[2], out_p[2], "visc", dtype)
        msg += f"; max|dvisc| {verr / vscale:.3e} x max|visc|"
        ok = ok and verr <= tol * vscale
        err = max(err, verr)
    log(msg)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             "version")
    if int(zp.sum()) < 8:
        raise AssertionError("injected inverted/NaN points did not reach "
                             "dt = 0")
    ms = device_ms(lambda: wrapper(*args, **kw))
    cold_ms = device_ms(lambda: wrapper(*args, **kw), cold=True)
    # the plain twin (50-60x the kernel: 167 ms a call at q8) as a
    # yardstick, over fewer calls than the kernel
    plain_ms = device_ms(lambda: plain(*args, **kw), n=PLAIN_CALLS)
    N = args[3].numel()
    nbytes = _nbytes(args) + _nbytes(out_k)
    fp64 = FP64_PER_POINT[layout, dtype]
    b_ms, b_by = bound(nbytes, QPHYS_OPS_PER_POINT * N, dtype, fp64 * N)
    sass_ms = QPHYS_SASS_PER_POINT[dtype] * N / ISSUE_PER_S * 1e3
    log(f"[{tag}] {name}: kernel {ms:.4f} ms warm, {cold_ms:.4f} ms cold "
        f"L2, plain {plain_ms:.4f} ms (median of {PLAIN_CALLS}, N = {N}); "
        f"bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / cold_ms:.1f} % of it cold: "
        f"bytes {bound(nbytes, 0, dtype)[0]:.4f} ms, "
        f"{QPHYS_OPS_PER_POINT} operations a point "
        f"{bound(0, QPHYS_OPS_PER_POINT * N, dtype)[0]:.4f} ms, FP64 pipe "
        f"{bound(0, 0, dtype, fp64 * N)[0]:.4f} ms ({fp64} a point); "
        f"estimate, not a bound: ~{QPHYS_SASS_PER_POINT[dtype]} SASS "
        f"instructions a point at 4 issues a clock an SM {sass_ms:.4f} ms "
        f"({100 * sass_ms / cold_ms:.1f} % of the cold time)")
    return dict(max_abs_err=err, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def mass_stage_operands(h, u):
    """The six operands the Ozaki mass apply of `h` splits (over axis 1)
    when it applies to the (3, ndof) field u: (3, 65, 65, 65) ... (3, 128,
    128, 128) ... at the flagship size."""
    from laghos_tpu_torch.ops import omm

    loz = h._lat_oz
    q = u.reshape((3,) + h._lat_dims)
    out = []
    for k in range(3):
        out.append(q)
        q = omm.tensordot(q, loz["fwdB"][k], 1)
    q = q * h._lat["Dq"][None]
    for k in range(3):
        out.append(q)
        q = omm.tensordot(q, loz["bwdB"][k], 1)
    return out


def _split_bitwise(A, S, what, axis=1):
    from laghos_tpu_torch.ops import omm

    k = omm.split_dyn(A, S, axis=axis)
    p = omm.split_dyn_plain(A, S, axis=axis)
    torch.cuda.synchronize()
    same = (torch.equal(k.cat, p.cat)
            and torch.equal(k.scale.view(torch.int64),
                            p.scale.view(torch.int64)))
    if not same:
        raise AssertionError(f"split kernel and plain twin differ: {what} "
                             f"S={S}")
    return k


def _time_split(A, what, tag="3 split"):
    """Kernel (warm and cold L2) and plain times of the 8-slice split of A
    over axis 1 (axis -1 for a 2D A), with its bound; logged."""
    from laghos_tpu_torch.ops import omm
    from laghos_tpu_torch.timing import device_ms

    axis = 1 if A.dim() > 2 else -1
    ms = device_ms(lambda: omm.split_dyn(A, 8, axis=axis))
    cold_ms = device_ms(lambda: omm.split_dyn(A, 8, axis=axis), cold=True)
    plain_ms = device_ms(lambda: omm.split_dyn_plain(A, 8, axis=axis))
    d = omm.split_dyn(A, 8, axis=axis)
    nbytes = _nbytes((A, d.cat, d.scale))
    nops = (4 + 8 + 2) * A.numel()  # csrc/split.cu: max, scaling, digits
    b_ms, b_by = bound(nbytes, nops, F64)
    k = A.shape[axis]
    log(f"[{tag}] {what} {tuple(A.shape)} (k = {k}, {d.cat.shape[0]} "
        f"rows): bitwise equal at S = 8 and 6; S = 8 kernel {ms:.4f} ms "
        f"warm, {cold_ms:.4f} ms cold L2, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, {nbytes} B), {100 * b_ms / cold_ms:.1f} % "
        "of it cold")
    return dict(ms=ms, cold_ms=cold_ms, plain_ms=plain_ms), nbytes, nops


def stage_splits(h, rng, tag):
    """The split kernel against its plain twin, bit for bit at 8 and 6
    slices, at the six stage operands of one Ozaki mass apply of `h` on a
    seeded perturbed velocity, each timed at 8 slices (warm and with a
    cold L2); returns the sums over the six, the splits of one 8-slice
    mass apply, as kernels-line numbers."""
    ops = mass_stage_operands(h, _perturbed_velocity(h, rng))
    tot = dict(ms=0.0, cold_ms=0.0, plain_ms=0.0)
    nbytes = nops = 0
    for i, A in enumerate(ops):
        for S in (8, 6):
            d = _split_bitwise(A, S, f"stage {i}")
        mant, _ = torch.frexp(d.scale)
        if not bool((mant == 0.5).all()):
            raise AssertionError("split scales are not powers of two")
        t, nb, no = _time_split(A, f"stage {i}", tag)
        for key in tot:
            tot[key] += t[key]
        nbytes += nb
        nops += no
    b_ms, b_by = bound(nbytes, nops, F64)
    log(f"[{tag}] one 8-slice mass apply's six splits: kernel "
        f"{tot['ms']:.4f} ms warm, {tot['cold_ms']:.4f} ms cold L2, plain "
        f"{tot['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}, {nbytes} "
        f"B), {100 * b_ms / tot['cold_ms']:.1f} % of it cold")
    return dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, **tot)


def phase_split(h):
    """The split kernel against its plain twin, bit for bit, at the six
    stage operands of an Ozaki mass apply of the flagship state (8 and 6
    slices), at the two flat (R2 = 1) operands of the flagship's
    `omm.matmul` calls (the L2 energy's (NE, 8) and the gather-path
    force's (3 NE, 192)), and on a mixed-magnitude operand with zero, NaN
    and Inf rows; times at 8 slices, warm and with a cold L2.  The
    kernels-line numbers are the sums over the six stages: the splits of
    one 8-slice mass apply."""
    rng = np.random.default_rng(1)
    out = stage_splits(h, rng, "3 split")
    NE = h.NE
    for shape, what in (((NE, 8), "L2 energy operand"),
                        ((3 * NE, 192), "gather-path force operand")):
        A = torch.tensor(rng.standard_normal(shape), device=h.device)
        for S in (8, 6):
            _split_bitwise(A, S, what, axis=-1)
        _time_split(A, what)
    A = torch.tensor(rng.standard_normal((3, 17, 33)) * np.exp2(
        rng.integers(-30, 30, (3, 17, 33))), device=h.device)
    A[1, :, 5] = 0.0
    A[2, 4, 7] = float("nan")
    A[0, 9, 30] = float("inf")
    for S in (8, 6, 4):
        d = _split_bitwise(A, S, "mixed operand")
    nan_rows = int(torch.isnan(d.scale).sum())
    if nan_rows != 2:
        raise AssertionError(f"expected 2 NaN-scale rows, got {nan_rows}")
    log(f"[3 split] mixed-magnitude operand with zero, NaN and Inf rows: "
        f"bitwise equal at S = 8, 6, 4; NaN-scale rows {nan_rows}")
    return out


def mass_ops(dim, nd1, nq1, NE, C):
    """Operations of the sum-factorized mass apply of C components on NE
    elements (csrc/mass.cu): two (a multiply-add) for each contracted
    value of each output of the 2 dim 1D contractions, one multiply by D
    a q-point."""
    macs = sum(nq1 ** (s + 1) * nd1 ** (dim - s)
               + nd1 ** (s + 1) * nq1 ** (dim - s) for s in range(dim))
    return C * NE * (2 * macs + nq1 ** dim)


def mass_check(u, D, B, dim, what, tag="3 mass", dense=True, seed=0,
               rt=False):
    """The mass kernel (ops/mass.mass_apply_e on CUDA tensors) against its
    plain twin on the same operands: max|kernel - twin| within MASS_TOL of
    max|twin|, and two launches bit for bit.  Times (median of 20, warm and
    with a cold L2) of the kernel, the twin and the library call: one
    torch.bmm of dense (NE, nd, nd) element mass matrices by u, built by
    `mass.l2_mass_matrices` and held to the kernel too (dense True), or
    seeded of that shape and dtype (dense False, where building them costs
    too much).  With `rt`, the runtime-size kernel forced at this compiled
    size, held to the twin at MASS_TOL and timed beside it (rt_ms,
    rt_cold_ms).  Logged; returns the kernels-line numbers."""
    from laghos_tpu_torch.ops import kernels, mass
    from laghos_tpu_torch.timing import device_ms

    dt = u.dtype
    NE, nd = u.shape[-2:]
    C = math.prod(u.shape[:-2])
    nq1, nd1 = B.shape
    y = mass.mass_apply_e(u, D, B, dim)
    y2 = mass.mass_apply_e(u, D, B, dim)
    p = mass.mass_apply_e_plain(u, D, B, dim)
    torch.cuda.synchronize()
    err, scale = float((y - p).abs().max()), float(p.abs().max())
    tol = MASS_TOL[dt]
    same = torch.equal(y, y2)
    name = f"{what} {str(dt)[6:]}"
    if dense:
        M = mass.l2_mass_matrices(D, B, dim)
    else:
        g = torch.Generator(device=u.device).manual_seed(seed)
        M = torch.rand((NE, nd, nd), generator=g, dtype=dt, device=u.device)
    x = u.reshape(C, NE, nd).permute(1, 2, 0).contiguous()     # (NE, nd, C)
    lib_err = float("nan")
    if dense:
        yl = torch.bmm(M, x).permute(2, 0, 1).reshape(u.shape)
        torch.cuda.synchronize()
        lib_err = float((yl - y).abs().max()) / scale
        del yl
    log(f"[{tag}] {name} (dim {dim}, nd1 {nd1}, nq1 {nq1}, C {C}, NE {NE}):"
        f" max|kernel - twin| {err:.3e} = {err / scale:.3e} x max|twin| "
        f"(tol {tol:g}); two launches bitwise equal {same}"
        + (f"; dense element matrices (torch.bmm) {lib_err:.3e} x max|twin|"
           if dense else ""))
    if not (err <= tol * scale and same and (not dense or lib_err <= tol)):
        raise AssertionError(f"{name}: mass kernel disagrees with its twin, "
                             "its dense matrices or itself")
    ms = device_ms(lambda: mass.mass_apply_e(u, D, B, dim))
    cold_ms = device_ms(lambda: mass.mass_apply_e(u, D, B, dim), cold=True)
    plain_ms = device_ms(lambda: mass.mass_apply_e_plain(u, D, B, dim))
    library_ms = device_ms(lambda: torch.bmm(M, x))
    del M, x
    nbytes = _nbytes((u, D, B, y))
    nops = mass_ops(dim, nd1, nq1, NE, C)
    b_ms, b_by = bound(nbytes, nops, dt, peak=MASS_PEAK_FLOPS[dt])
    grid = kernels.mass_grid(dt, u.device.index or 0, dim=dim, nd1=nd1,
                             nq1=nq1)
    log(f"[{tag}] {name}: kernel {ms:.4f} ms warm, {cold_ms:.4f} ms cold L2 "
        f"({grid} persistent blocks), "
        f"plain {plain_ms:.4f} ms, torch.bmm of "
        f"{'its' if dense else 'seeded'} ({NE}, {nd}, {nd}) matrices "
        f"{library_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}: {nbytes} B, "
        f"{nops} operations), {100 * b_ms / cold_ms:.1f} % of it cold")
    out = dict(max_abs_err=err, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    if rt:
        uc, Dc, Bc = u.contiguous(), D.contiguous(), B.contiguous()
        yr = torch.empty_like(y)

        def launch_rt():
            kernels.launch_mass(uc, Dc, Bc, yr, C=C, NE=NE, dim=dim,
                                nd1=nd1, nq1=nq1, rt=True)

        launch_rt()
        torch.cuda.synchronize()
        rt_err = float((yr - p).abs().max())
        out["rt_ms"] = device_ms(launch_rt)
        out["rt_cold_ms"] = device_ms(launch_rt, cold=True)
        log(f"[{tag}] {name}: the runtime-size kernel at this size "
            f"{out['rt_ms']:.4f} ms warm, {out['rt_cold_ms']:.4f} ms cold L2 "
            f"({out['rt_cold_ms'] / cold_ms:.2f} x the compiled instance's "
            f"cold time); max|rt - twin| {rt_err / scale:.3e} x max|twin|, "
            f"bitwise the compiled instance's {torch.equal(yr, y)}")
        if not rt_err <= tol * scale:
            raise AssertionError(f"{name}: the runtime-size mass kernel "
                                 "disagrees with its twin")
        del yr
    return out


def mass_checks(h, tag, dense, dims=(3,), seed=0):
    """mass_check in f64 and f32 of the energy CG's L2 apply ((NE, ld), one
    component) and the gather path's H1 apply ((dim, NE, nd)) with the
    tables and D of `h`; for a dim other than h's, seeded positive D of
    that size on h's elements.  Returns {dtype: L2 numbers with the H1's
    under "h1"} of h's own dim."""
    rng = np.random.default_rng(seed)
    out = {}
    for dim in dims:
        if dim == h.dim:
            D = h.massD
        else:
            D = torch.tensor(rng.uniform(0.5, 1.5, (h.NE, h.nq1**dim)),
                             dtype=h.dtype, device=h.device)
        for dt in (F64, F32):
            got = {}
            for name, C in (("L2B", None), ("H1B", dim)):
                B = h.tables[name].to(dt)
                nd = B.shape[1] ** dim
                shape = (h.NE, nd) if C is None else (C, h.NE, nd)
                u = torch.tensor(rng.standard_normal(shape), dtype=dt,
                                 device=h.device)
                got[name] = mass_check(
                    u, D.to(dt), B, dim, f"{dim}D {name[:2]}", tag, dense,
                    seed=seed, rt=dim == 3)
            if dim == h.dim:
                out[dt] = dict(got["L2B"], h1=got["H1B"])
    return out


def lattice_mass_ops(lat, qlat, nd1, C):
    """The least operations of the lattice mass apply of C components from
    the lattice `lat` (nodes an axis) to the q-lattice `qlat` (q-points an
    axis), whatever the route: the banded sum factorization y = T' D T u
    contracts one axis at a time, nd1 multiply-adds (two operations) for
    each q-point of each contraction (T has nd1 nonzeros a column), in the
    axis order with the fewest, forward and transposed (the same sizes),
    then one multiply by D a q-point; it needs no assembly.  (The element
    route of csrc/lattice_mass.cu does more: mass_ops on every element,
    which contracts the shared nodes once for each element, and the adds
    that assemble them.)"""
    def contracted(order):
        shape, n = list(lat), 0
        for k in order:
            shape[k] = qlat[k]
            n += math.prod(shape)
        return n

    least = min(contracted(o)
                for o in itertools.permutations(range(len(lat))))
    return C * (2 * 2 * nd1 * least + math.prod(qlat))


def assembled_h1_csr(h):
    """The scalar H1 mass of the lattice Hydro `h` assembled on the card: its
    dense element matrices (ops/assemble.h1_mass_element_matrices) summed
    over its raster gather map into a (ndof, ndof) CSR matrix, coalesced
    by torch on the card.  The lattice mass kernel's library operand at
    ns4 (phase 8's CSR, built on the host, is the flagship's)."""
    from laghos_tpu_torch.ops import assemble as aop

    M = aop.h1_mass_element_matrices(h.massD, h.tables["H1B"], h.dim)
    g = torch.as_tensor(h.h1.gather, dtype=torch.long, device=h.device)
    nd = g.shape[1]
    idx = torch.stack([g[:, :, None].expand(-1, -1, nd).reshape(-1),
                       g[:, None, :].expand(-1, nd, -1).reshape(-1)])
    A = torch.sparse_coo_tensor(idx, M.reshape(-1), (h.ndof, h.ndof),
                                check_invariants=False)
    del M, idx
    return A.coalesce().to_sparse_csr()


def lattice_mass_check(u, Ts, Dq, lat, what, tag, library_ms=None,
                       csr=None):
    """The lattice mass kernel (ops/lattice.mass_apply_lattice on CUDA
    tensors) against its plain twin (the banded tensordot chain) on the
    same operands: max|kernel - twin| within MASS_TOL of max|twin|, and two
    launches bit for bit; then the runtime-size body forced at this size,
    held to the twin too.  Times (median of 20, warm and with a cold L2) of
    the kernel (2 device launches: the element stages, the assembly), the
    twin and the runtime-size body.  The library call: one SpMM of the
    assembled scalar mass `csr` (ndof, ndof) by the (ndof, C) block, held
    to the twin at MASS_TOL and timed here, or, without `csr`,
    `library_ms` (timed elsewhere, or None).  Logged; returns the
    kernels-line numbers."""
    from laghos_tpu_torch.ops import kernels, lattice
    from laghos_tpu_torch.timing import device_ms

    dt = u.dtype
    C = u.shape[0]
    y = lattice.mass_apply_lattice(u, Ts, Dq, lat)
    y2 = lattice.mass_apply_lattice(u, Ts, Dq, lat)
    p = lattice.mass_apply_lattice_plain(u, Ts, Dq, lat)
    torch.cuda.synchronize()
    err, scale = float((y - p).abs().max()), float(p.abs().max())
    tol = MASS_TOL[dt]
    same = torch.equal(y, y2)
    tab = lattice.lattice_table(Ts)
    name = f"{what} {str(dt)[6:]}"
    log(f"[{tag}] {name} (lattice {tuple(lat)}, elements {tab.elems}, nd1 "
        f"{tab.nd1}, nq1 {tab.nq1}, C {C}): max|kernel - twin| {err:.3e} = "
        f"{err / scale:.3e} x max|twin| (tol {tol:g}); two launches bitwise "
        f"equal {same}")
    if not (err <= tol * scale and same):
        raise AssertionError(f"{name}: lattice mass kernel disagrees with "
                             "its twin or itself")
    yr = torch.empty_like(y)
    ye = torch.empty((C, math.prod(tab.elems), tab.nd1 ** len(lat)),
                     dtype=dt, device=u.device)

    def launch_rt():
        kernels.launch_lattice_mass(u, Dq, tab.B, tab.host, ye, yr, C=C,
                                    elems=tab.elems, nd1=tab.nd1,
                                    nq1=tab.nq1, rt=True)

    launch_rt()
    torch.cuda.synchronize()
    rt_err = float((yr - p).abs().max())
    if not rt_err <= tol * scale:
        raise AssertionError(f"{name}: the runtime-size lattice mass body "
                             "disagrees with its twin")
    if csr is not None:
        lib_err = float(((csr @ u.T).T - p).abs().max()) / scale
        log(f"[{tag}] {name}: SpMM of the assembled mass ({csr._nnz()} "
            f"nonzeros) {lib_err:.3e} x max|twin|")
        if not lib_err <= tol:
            raise AssertionError(f"{name}: the assembled mass disagrees "
                                 "with the twin")
        library_ms = device_ms(lambda: (csr @ u.T).T)
    ms = device_ms(lambda: lattice.mass_apply_lattice(u, Ts, Dq, lat))
    cold_ms = device_ms(lambda: lattice.mass_apply_lattice(u, Ts, Dq, lat),
                        cold=True)
    plain_ms = device_ms(
        lambda: lattice.mass_apply_lattice_plain(u, Ts, Dq, lat))
    plain_cold_ms = device_ms(
        lambda: lattice.mass_apply_lattice_plain(u, Ts, Dq, lat), cold=True)
    rt_ms = device_ms(launch_rt)
    rt_cold_ms = device_ms(launch_rt, cold=True)
    del ye, yr
    nbytes = _nbytes((u, Dq, y))
    nops = lattice_mass_ops(lat, tuple(Dq.shape), tab.nd1, C)
    b_ms, b_by = bound(nbytes, nops, dt, peak=MASS_PEAK_FLOPS[dt])
    log(f"[{tag}] {name}: kernel {ms:.4f} ms warm, {cold_ms:.4f} ms cold L2 "
        f"(2 device launches), plain {plain_ms:.4f} / {plain_cold_ms:.4f} "
        f"ms, the runtime-size body {rt_ms:.4f} / {rt_cold_ms:.4f} ms "
        f"(max|rt - twin| {rt_err / scale:.3e} x max|twin|), library "
        + (f"{library_ms:.4f} ms" if library_ms is not None else "none")
        + f"; bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {nops} operations), "
        f"{100 * b_ms / cold_ms:.1f} % of it cold")
    return dict(max_abs_err=err, ms=ms, cold_ms=cold_ms, plain_ms=plain_ms,
                plain_cold_ms=plain_cold_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms, rt_ms=rt_ms, rt_cold_ms=rt_cold_ms)


def lattice_mass_checks(h, tag, seed=0, csr=False):
    """lattice_mass_check in f64 and f32 of the velocity CG's operator of
    the lattice Hydro `h` (its banded tables and q-lattice weights, f32
    copies for f32) on a seeded (dim, ndof) field; with `csr`, against
    its assembled mass (`assembled_h1_csr`, the values' f32 copy for f32)
    as the library call.  Returns {dtype: numbers}."""
    rng = np.random.default_rng(seed)
    lat = h._lat_dims
    u = rng.standard_normal((h.dim, math.prod(lat)))
    A = assembled_h1_csr(h) if csr else None
    out = {}
    for dt in (F64, F32):
        Ts = tuple(T.to(dt) for T in h._lat["Ts"])
        Dq = h._lat["Dq"].to(dt)
        A_dt = A
        if A is not None and dt != A.dtype:
            A_dt = torch.sparse_csr_tensor(
                A.crow_indices(), A.col_indices(), A.values().to(dt), A.shape)
        out[dt] = lattice_mass_check(
            torch.tensor(u, dtype=dt, device=h.device), Ts, Dq, lat,
            f"{h.dim}D H1 lattice", tag, csr=A_dt)
        del A_dt
    del A
    torch.cuda.empty_cache()
    return out


# the CG shapes of the benchmark cells: the Q2-Q1 velocity solve (3 rows of
# 2,146,689 = 129^3 H1 dofs, the Jacobi diagonal shared, the essential-dof
# mask, whose pattern the timing needs: a scattered mask makes the
# mask-and-dot kernel's stores partial) and the energy solve (one row of
# 2,097,152 L2 dofs, neither)
CG_SHAPES = (("velocity", 3, 2146689, True), ("energy", 1, 2097152, False))


def cg_chain_bytes(C, n, diag, item=8):
    """The bytes one iteration of csrc/cg.cu's chain must move, each input
    read once and each output written once: x, r, d read and written, Ad
    and the apply's output read, the diagonal (n,) and the bool mask (C,
    n) read."""
    return item * C * n * 8 + (item * n + C * n if diag else 0)


# the chain's agreement with its twins, as a share of each field's size: in
# f64 round-off of the dots' order; in f32 about a hundred of its epsilons
CG_CHAIN_TOL = {F64: 1e-12, F32: 1e-5}
_CG_FIELDS = ("x", "r", "d", "Ad", "nom", "den", "beta", "active", "iters",
              "flag")


def _lattice_faces(n, dev):
    """The velocity CG's essential-dof mask of 3D Sedov on an m^3 node
    lattice (n = m^3, x fastest; `Hydro.ess_mask` on the lattice path):
    row c true on the two faces normal to axis c (3, n)."""
    m = round(n ** (1 / 3))
    if m ** 3 != n:
        raise ValueError(f"{n} nodes are no cube")
    i = torch.arange(m, device=dev)
    edge = (i == 0) | (i == m - 1)
    return torch.stack([edge[None, None, :].expand(m, m, m),
                        edge[None, :, None].expand(m, m, m),
                        edge[:, None, None].expand(m, m, m)]).reshape(3, n)


def cg_chain_check(dev, shapes=CG_SHAPES, dtypes=(F64, F32)):
    """csrc/cg.cu's chain (`solvers/cg.chain_step` and `chain_ess_dot`) at
    the benchmark cells' CG shapes, f64 and f32, on a seeded state with a
    positive den and r0 = -1, so no row breaks down or converges and every
    launch does the whole work: one iteration against the plain twins (x,
    r, d, Ad, nom, den to CG_CHAIN_TOL of their size, the flags and counts
    equal), two launches bit for bit, and the times (warm and cold) of the
    chain and of the twins beside the chain's bound.  Each timed call
    starts from that state, restored outside its events, and the rows are
    checked still active after the timing.  Returns {dtype: {shape name:
    numbers}}."""
    from laghos_tpu_torch.solvers import cg as cgm
    from laghos_tpu_torch.timing import device_ms

    out = {}
    for dt in dtypes:
        out[dt] = {}
        for name, C, n, diag in shapes:
            out[dt][name] = _cg_chain_shape(dev, cgm, device_ms, dt, name,
                                            C, n, diag)
    return out


def _cg_chain_shape(dev, cgm, device_ms, dt, name, C, n, diag):
    gen = torch.Generator(device=dev).manual_seed(19)

    def rnd(*shape):
        return torch.randn(shape, dtype=dt, device=dev, generator=gen)

    def chain():
        x, r, d = rnd(C, n), rnd(C, n), rnd(C, n)
        Ad = d * 2.0
        nom = torch.sum(r * r, dim=-1)
        den = torch.sum(d * Ad, dim=-1)
        r0 = torch.full((C,), -1.0, dtype=dt, device=dev)
        act = torch.ones(C, dtype=torch.bool, device=dev)
        iters = torch.full((C,), 300, dtype=torch.int64, device=dev)
        dinv = rnd(n).abs() + 0.5 if diag else None
        return cgm._Chain(None, x, r, d, Ad, nom, den, r0, act, iters,
                          dinv, _lattice_faces(n, dev) if diag else None)

    y0 = rnd(C, n)
    runs = []
    for plain in (False, True, False):
        gen.manual_seed(19)
        ch = chain()
        y = y0.clone()
        if plain:
            cgm._step_plain(ch, 1)
            cgm._ess_dot_plain(ch, y)
        else:
            cgm.chain_step(ch, 1)
            cgm.chain_ess_dot(ch, y)
        torch.cuda.synchronize()
        runs.append(ch)
    k, p, k2 = runs
    err = max(float((getattr(k, f) - getattr(p, f)).abs().max())
              / float(getattr(p, f).abs().max())
              for f in ("x", "r", "d", "Ad", "nom", "den"))
    same = all(torch.equal(getattr(k, f), getattr(k2, f))
               for f in ("x", "r", "d", "Ad", "nom", "den", "beta"))
    flags = (torch.equal(k.active, p.active)
             and torch.equal(k.iters, p.iters)
             and int(k.flag) == int(p.flag) == 1)
    tag = f"{name} ({C}, {n}) {str(dt)[6:]}"
    if err > CG_CHAIN_TOL[dt] or not same or not flags:
        raise AssertionError(f"cg chain {tag}: {err:.3e} x max|twin|, "
                             f"bitwise {same}, flags {flags}")
    del runs, p, k2
    # the timed state: the seeded one, restored before every call
    gen.manual_seed(19)
    ch = chain()
    y = y0.clone()
    Ad = ch.Ad
    start = {f: getattr(ch, f).clone() for f in _CG_FIELDS}
    if not bool((start["den"] > 0).all()):
        raise AssertionError(f"cg chain {tag}: the timed state has den <= 0")

    def restore():
        ch.Ad = Ad
        for f in _CG_FIELDS:
            getattr(ch, f).copy_(start[f])
        y.copy_(y0)

    def run_chain():
        ch.launch.step(1, ch.Ad)
        ch.launch.ess_dot(y)

    def run_plain():
        cgm._step_plain(ch, 1)
        cgm._ess_dot_plain(ch, y)

    ms = []
    for fn in (run_chain, run_plain):
        for cold in (False, True):
            ms.append(device_ms(fn, cold=cold, before=restore))
            # the last timed call began at the restored state: every row
            # did its whole work and is still active
            if not bool(ch.active.all()):
                raise AssertionError(f"cg chain {tag}: a row left the "
                                     f"timed state")
    item = torch.finfo(dt).bits // 8
    bound = cg_chain_bytes(C, n, diag, item) / 3.35e12 * 1e3
    log(f"[3 cg chain] {tag}: {err:.3e} x max|twin|, two launches bitwise "
        f"equal; chain {ms[0]:.4f} / {ms[1]:.4f} ms warm / cold (5 "
        f"launches), bound {bound:.4f} ms (bytes), "
        f"{100 * bound / ms[1]:.1f} %; plain twins {ms[2]:.4f} / "
        f"{ms[3]:.4f} ms")
    del ch, y, y0, start
    torch.cuda.empty_cache()
    return dict(ms=ms, bound_ms=bound, err=err)


def phase_kernel(dev):
    out = {}
    out["cg"] = cg_chain_check(dev)
    h = flagship_hydro(dev, **GATHER)
    inp = element_inputs(h)
    for dt in (F64, F32):
        out["element", dt] = compare("element", inp, dt)
    del inp
    for dt, got in mass_checks(h, "3 mass", True, dims=(3, 2)).items():
        out["mass", dt] = got
    del h
    h = flagship_hydro(dev, ozaki=True)
    if h._lat is None or h._lat_oz is None:
        raise AssertionError("the flagship mesh did not build the lattice")
    lat = lattice_inputs(h)
    pk = eq_inputs(h, lat[0], "packed")
    for dt in (F64, F32):
        out["lattice", dt] = compare("lattice", lat, dt)
    del lat
    for dt in (F64, F32):
        out["packed", dt] = compare("packed", pk, dt)
    del pk
    for dt, got in lattice_mass_checks(h, "3 lattice mass").items():
        out["lattice_mass", dt] = got
    out["split"] = phase_split(h)
    del h
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ phase 4 --
def phase_goldens(dev):
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options
    from laghos_tpu_torch.verify import (CHECKS_TABLE, OZAKI_CHECKS_EPS,
                                         run_checks)

    for path, opt, layout in (("lattice", {}, "lattice"),
                              ("gather", GATHER, "element")):
        for dim in (3, 2):
            steps = tuple(s for s, _ in CHECKS_TABLE[dim][1])
            m = fmesh.cartesian(dim, (2,) * dim, (1.0,) * dim)
            h = Hydro(m, Options(problem=1, cg_tol=1e-14, **opt), device=dev)
            if (h._lat is not None) != (path == "lattice"):
                raise AssertionError(f"{path} goldens built the wrong path")
            reset_counts()
            res = driver.run(h, t_final=0.6, vis_steps=10**6,
                             check_steps=steps)
            got = read_counts()
            run_checks(1, dim, res.norms)
            if dim == 3 and got[layout] != h.qupdate_calls:
                raise AssertionError(f"3D {path} goldens: {layout} kernel "
                                     f"launches {got}")
            log(f"[4 goldens] {path} {dim}D Sedov |e| at steps {steps}: "
                f"{[res.norms[s] for s in steps]} match CHECKS_TABLE at "
                f"1e-13 (kernel launches {got}, H1 CG {res.h1_iters})")
    # the Ozaki lattice path: 3D only, at its own gate
    steps = tuple(s for s, _ in CHECKS_TABLE[3][1])
    m = fmesh.cartesian(3, (2,) * 3, (1.0,) * 3)
    h = Hydro(m, Options(problem=1, cg_tol=1e-14, ozaki=True), device=dev)
    reset_counts()
    res = driver.run(h, t_final=0.6, vis_steps=10**6, check_steps=steps)
    got = read_counts()
    run_checks(1, 3, res.norms, eps=OZAKI_CHECKS_EPS)
    if got["lattice"] != h.qupdate_calls or got["split"] == 0:
        raise AssertionError(f"3D Ozaki goldens: kernel launches {got}")
    log(f"[4 goldens] ozaki lattice 3D Sedov |e| at steps {steps}: "
        f"{[res.norms[s] for s in steps]} match CHECKS_TABLE at "
        f"{OZAKI_CHECKS_EPS:g} (kernel launches {got}, H1 CG "
        f"{res.h1_iters}, IR {h.ir_stats()})")


# ------------------------------------------------------------ phase 5 --
def drive(argv):
    """One drive through the CLI with the launch counts reset just before
    and read just after (in the dtype of its --dtype)."""
    import contextlib
    import io

    from laghos_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return run, read_counts(), wall, buf.getvalue()


def _only(counts, layout, calls, what, ozaki=False, pa=True):
    """The main-path run `what` launched the `layout` q-point kernel once
    per q-update and no other layout; the split kernel iff Ozaki; the mass
    kernel iff partial assembly outside the Ozaki mode (whose mass applies
    are Ozaki products; -fa's are the CSR and the inverted element
    matrices); the lattice mass kernel iff the lattice path (its velocity
    CG's operator, in the Ozaki mode the IR solve's f32 inner sweeps)."""
    got = {k: v for k, v in counts.items()
           if k not in ("split", "mass", "lattice_mass", "cg_step",
                        "cg_ess_dot")}
    want = {k: (calls if k == layout else 0) for k in got}
    split_ok = counts["split"] > 0 if ozaki else counts["split"] == 0
    mass = pa and not ozaki
    mass_ok = counts["mass"] > 0 if mass else counts["mass"] == 0
    lat = layout == "lattice"
    lat_ok = (counts["lattice_mass"] > 0 if lat
              else counts["lattice_mass"] == 0)
    if (got != want or calls == 0 or not split_ok or not mass_ok
            or not lat_ok):
        raise AssertionError(f"{what}: kernel launches {counts}, expected "
                             f"{want}, split launches "
                             f"{'> 0' if ozaki else '0'}, mass launches "
                             f"{'> 0' if mass else '0'} and lattice mass "
                             f"launches {'> 0' if lat else '0'}")


def _ir_line(h):
    """CG-H1 inner sweeps and outers of an Ozaki lattice run."""
    st = h.ir_stats()
    return (f"CG-H1 IR: {st['solves']} solves, {st['outers']} outers "
            f"({st['outers'] / max(st['solves'], 1):.2f} per solve), "
            f"{st['outer_applies']} Ozaki residual applies, "
            f"{st['inner_sweeps']} f32 inner sweeps "
            f"({st['inner_sweeps'] / max(3 * st['solves'], 1):.2f} per "
            f"component solve)")


def flagship_run(argv, tag, phase="5", drift_max=1e-12):
    """One -f drive of the CLI on the lattice path; logs its figures and
    gates it on finite state, the kernel launches and (unless `drift_max`
    is None) the RK2Avg energy drift.  Returns (run, counts), the CLI's
    printed lines in run.log."""
    run, counts, wall, out = drive(argv)
    res, h, fom = run.result, run.hydro, run.fom
    ozaki = h.oz is not None
    if h._lat is None:
        raise AssertionError(f"{tag}: the CLI did not take the lattice path")
    step_ms = 1e3 * res.timings["total"] / res.steps
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    peak = torch.cuda.max_memory_allocated()
    p = f"[{phase} {tag}]"
    for line in out.splitlines():
        if line.startswith("|") or "step" in line or "Energy" in line:
            log(f"{p} {line}")
    run.log = out
    log(f"{p} NE {h.NE}, NQ {h.NQ}, quadrature points {h.NE * h.NQ}, H1 "
        f"dofs {h.ndof * 3}, L2 dofs {h.NE * h.ld}, lattice "
        f"{h._lat_dims}, kron {'kron' in h._lat}, ozaki {ozaki}")
    log(f"{p} setup {run.setup_seconds:.3f} s, {res.steps} steps, "
        f"step_ms {step_ms:.3f} (timed run, fences per phase), "
        f"wall {wall:.3f} s")
    log(f"{p} FOM {fom['FOM']:.6g}, FOM1 {fom['FOM1']:.6g}, "
        f"FOM2 {fom['FOM2']:.6g}, FOM3 {fom['FOM3']:.6g}, T1 {fom['T1']:.4f} "
        f"T2 {fom['T2']:.4f} T3 {fom['T3']:.4f} s")
    t = res.timing_data.t
    log(f"{p} phase seconds over {res.steps} steps: "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))
    log(f"{p} CG iterations H1 {res.h1_iters} "
        f"({res.h1_iters / (2 * 3 * res.steps):.2f} per component solve), "
        f"L2 {res.l2_iters} ({res.l2_iters / (2 * res.steps):.2f} per "
        f"solve)")
    if ozaki:
        log(f"{p} {_ir_line(h)}; split launches {counts['split']}")
    log(f"{p} final |e| {res.e_norm:.13e}, energy drift {drift:.3e} "
        f"(relative), peak device memory {peak / 2**30:.3f} GiB")
    S = res.S
    finite = all(bool(torch.isfinite(S[k]).all()) for k in S)
    if not finite or not math.isfinite(res.e_norm):
        raise AssertionError(f"{tag}: state is not finite")
    if drift_max is not None and not drift <= drift_max:
        raise AssertionError(f"{tag}: RK2Avg energy drift {drift:.3e} > "
                             f"{drift_max:g}")
    _only(counts, "lattice", h.qupdate_calls, tag, ozaki)
    log(f"{p} lattice kernel launches {counts['lattice']} == q-updates "
        f"{h.qupdate_calls}")
    return run, counts


def packed_check(h, S, tag):
    """The packed layout runs on no time-stepping path (the JAX package
    calls its kernel only from its tests).  Hold its entry point,
    `ops/qphys.physics_3d_packed`, against the lattice q-update of the
    final state S of a lattice-path run.  A comparison, not a main-path
    run: its launches are not counted."""
    from laghos_tpu_torch.ops import lattice as lop
    from laghos_tpu_torch.ops import qphys

    sJ_lat, dt_lat = h._qupdate(S)
    args, extra = eq_inputs(h, _qlattice_args(h, S["x"], S["v"], S["e"]),
                            "packed")
    sJ, dtq, visc = qphys.physics_3d_packed(
        *args, **extra, h1order=float(h.opt.order_v), cfl=h.opt.cfl,
        use_viscosity=h.use_visc, use_vorticity=h.use_vort)
    sJ9 = torch.stack([lop.eq_to_qlattice(a, h._edims, h.nq1)
                       for a in sJ.reshape(h.NE, h.NQ, 9).unbind(-1)])
    tol = TOL[h.dtype]
    err = float((sJ9 - sJ_lat).abs().max() / sJ_lat.abs().max())
    drel = abs(float(dtq.min()) - float(dt_lat)) / float(dt_lat)
    log(f"[5 {tag}] packed entry point on the final state: sJit vs the "
        f"lattice q-update {err:.3e} x max|sJit|, dt rel diff {drel:.3e} "
        f"(tol {tol:g}); max visc {float(visc.max()):.6e}")
    if not (err <= tol and drel <= tol and bool(torch.isfinite(visc).all())):
        raise AssertionError(f"{tag}: the packed layout disagrees with the "
                             "lattice q-update")


def gather_run(dev, dtype, steps, cg_tol, **opt):
    """The gather path at the flagship size through driver.run."""
    from laghos_tpu_torch import driver

    t0 = time.perf_counter()
    h = flagship_hydro(dev, dtype, cg_tol=cg_tol, **GATHER, **opt)
    setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = driver.run(h, t_final=0.6, max_steps=steps - 1, vis_steps=5,
                     timing=True)
    torch.cuda.synchronize()
    counts = read_counts()
    what = f"gather {dtype}" + (" ozaki" if opt.get("ozaki") else "")
    _only(counts, "element", h.qupdate_calls, what, opt.get("ozaki", False))
    if res.steps != steps or not math.isfinite(res.e_norm):
        raise AssertionError(f"{what}: {res.steps} steps, |e| {res.e_norm}")
    return h, res, setup, counts


def gather_report(h, res, setup, counts, res_j, tag):
    """Log a gather-path run and hold its |e| at step GATHER_STEPS to the
    lattice Jacobi run's (`limit`: 1e-11 native, 1e-9 Ozaki)."""
    from laghos_tpu_torch.timing import print_timing

    t = res.timing_data.t
    step_ms = 1e3 * res.timings["total"] / res.steps
    peak = torch.cuda.max_memory_allocated()
    fom = print_timing(res.timing_data, steps=2 * res.steps,
                       H1_dofs=3 * h.ndof, L2_dofs=h.NE * h.ld, NQ=h.NQ,
                       NE=h.NE, p_assembly=True, dim=3, fom_table=False,
                       out=lambda *a: None)
    rel = abs(res.norms[GATHER_STEPS] - res_j.norms[GATHER_STEPS]) \
        / res_j.norms[GATHER_STEPS]
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    limit = 1e-9 if h.oz is not None else 1e-11
    log(f"[5 {tag}] setup {setup:.3f} s, {res.steps} steps, step_ms "
        f"{step_ms:.3f} (timed), phase seconds "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f"; FOM {fom['FOM']:.6g}, FOM1 {fom['FOM1']:.6g}, FOM2 "
        f"{fom['FOM2']:.6g}, FOM3 {fom['FOM3']:.6g}"
        + f"; CG H1 {res.h1_iters} "
        f"({res.h1_iters / (2 * 3 * res.steps):.2f} per component solve), "
        f"L2 {res.l2_iters} ({res.l2_iters / (2 * res.steps):.2f} per "
        f"solve); energy drift {drift:.3e}; peak device memory "
        f"{peak / 2**30:.3f} GiB; split launches {counts['split']}")
    log(f"[5 {tag}] |e| at step {GATHER_STEPS}: {res.norms[GATHER_STEPS]!r}"
        f" vs lattice Jacobi {res_j.norms[GATHER_STEPS]!r}: rel {rel:.3e} "
        f"(limit {limit:g}); element kernel launches "
        f"{counts['element']} == q-updates {h.qupdate_calls}")
    if not rel <= limit:
        raise AssertionError(f"{tag}: gather and lattice paths disagree in "
                             "|e|")
    if not drift <= 1e-12:
        raise AssertionError(f"{tag}: RK2Avg energy drift {drift:.3e} > "
                             "1e-12")


def _against(res, ref, tag, what):
    """Hold an Ozaki run's final |e| within 1e-9 (relative) of the native
    run `ref` over the same steps."""
    if res.steps != ref.steps:
        raise AssertionError(f"{tag}: {res.steps} steps against {ref.steps} "
                             f"of {what}")
    rel = abs(res.e_norm - ref.e_norm) / ref.e_norm
    log(f"[5 {tag}] |e| after {res.steps} steps vs {what}: rel {rel:.3e} "
        "(limit 1e-9)")
    if not rel <= 1e-9:
        raise AssertionError(f"{tag}: |e| departs from {what}")


def phase_flagship(dev):
    launches = {}
    run_j, counts = flagship_run(FLAGSHIP, "flagship")
    tally(launches, counts, "lattice")
    res_j = run_j.result
    packed_check(run_j.hydro, res_j.S, "flagship")
    del run_j
    run_k, counts = flagship_run(FLAGSHIP_KRON, "kron")
    res_k = run_k.result
    del run_k
    tally(launches, counts, "lattice")
    if res_k.steps != res_j.steps:
        raise AssertionError("kron and Jacobi runs took different steps")
    rel_k = abs(res_k.e_norm - res_j.e_norm) / res_j.e_norm
    log(f"[5 kron] |e| after {res_k.steps} steps vs the Jacobi run: rel "
        f"{rel_k:.3e}; H1 CG iterations {res_k.h1_iters} vs "
        f"{res_j.h1_iters}")

    h, res, setup, counts = gather_run(dev, F64, GATHER_STEPS, 1e-11)
    tally(launches, counts, "element")
    gather_report(h, res, setup, counts, res_j, "gather")
    del h, res

    run_4, counts = flagship_run(NS4, "ns4")
    tally(launches, counts, "lattice")
    res_4 = run_4.result
    timed_ns4 = lattice_mass_checks(run_4.hydro, "5 lattice mass ns4",
                                    csr=True)
    del run_4

    run32, counts, wall32, _ = drive(FLAGSHIP_F32)
    _only(counts, "lattice", run32.hydro.qupdate_calls, "f32 lattice")
    tally(launches, counts, "lattice", F32)
    e32 = run32.result.e_norm
    if not math.isfinite(e32):
        raise AssertionError("f32 flagship state is not finite")
    log(f"[5 f32] lattice: {run32.result.steps} steps in {wall32:.3f} s, "
        f"|e| {e32:.7e}, lattice kernel launches {counts['lattice']}")
    packed_check(run32.hydro, run32.result.S, "f32")
    del run32
    h32, res32, _, counts = gather_run(dev, F32, 2, 2e-7)
    tally(launches, counts, "element", F32)
    log(f"[5 f32] gather: {res32.steps} steps, |e| {res32.e_norm:.7e}, "
        f"element kernel launches {counts['element']}")
    del h32, res32
    torch.cuda.empty_cache()

    # the Ozaki mode on the same shapes, held to the native runs above
    for argv, tag, ref, what in (
            (FLAGSHIP_OZ, "ozaki", res_j, "the native Jacobi run"),
            (FLAGSHIP_OZ_KRON, "ozaki kron", res_j, "the native Jacobi run"),
            (NS4_OZ, "ozaki ns4", res_4, "the native ns4 run")):
        run_o, counts = flagship_run(argv, tag)
        tally(launches, counts, "lattice")
        _against(run_o.result, ref, tag, what)
        del run_o
        torch.cuda.empty_cache()
    h, res, setup, counts = gather_run(dev, F64, GATHER_STEPS, 1e-11,
                                       ozaki=True)
    tally(launches, counts, "element")
    gather_report(h, res, setup, counts, res_j, "ozaki gather")
    del h, res
    torch.cuda.empty_cache()
    return launches, timed_ns4


# ------------------------------------------------------------ phase 6 --
def phase_repeat(dev, fa_res):
    """Two runs of each configuration, final states bit for bit; the -fa
    flagship again, against phase 8's run.  Returns the element kernel
    launches of the -fa run."""
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    for path, rs, kw in (("lattice", 0, dict(t_final=0.6)),
                         ("lattice", 2, dict(t_final=0.6, max_steps=4)),
                         ("gather", 0, dict(t_final=0.6)),
                         ("ozaki lattice", 0, dict(t_final=0.6)),
                         ("ozaki lattice", 2, dict(t_final=0.6,
                                                   max_steps=4))):
        opt = {"gather": GATHER, "lattice": {},
               "ozaki lattice": {"ozaki": True}}[path]
        finals = []
        for _ in range(2):
            m = fmesh.cartesian(3, (2, 2, 2), (1.0, 1.0, 1.0))
            for _ in range(rs):
                m = fmesh.uniform_refine(m)
            h = Hydro(m, Options(problem=1, cg_tol=1e-14, **opt), device=dev)
            if (h._lat is not None) != (path != "gather"):
                raise AssertionError(f"{path} repeat runs built the wrong "
                                     "path")
            finals.append(driver.run(h, vis_steps=10**6, **kw))
        same = all(torch.equal(finals[0].S[k], finals[1].S[k])
                   for k in finals[0].S)
        if not same:
            raise AssertionError(f"two {path}-path rs{rs} runs differ")
        log(f"[6 repeat] two 3D Sedov rs{rs} {path}-path runs "
            f"({finals[0].steps} steps): final states bitwise equal")
    run, counts = fa_run(FLAGSHIP_FA, "fa repeat")
    same = all(torch.equal(run.result.S[k], fa_res.S[k]) for k in fa_res.S)
    log(f"[6 repeat] the -fa flagship ({run.result.steps} steps) again: "
        f"final state bitwise equal to phase 8's: {same}")
    if not same:
        raise AssertionError("two -fa flagship runs differ")
    return counts["element"]


# ------------------------------------------------------------ phase 7 --
def phase_golden_rows():
    """BASELINE rows 5 (1D -fa), 1 (p0, with its velocity error norms)
    and 8 (p4 Gresho, RK2Avg) in full through the CLI on the card, to the
    golden gates (exact steps, printed dt, |e| at 1e-9)."""
    from laghos_tpu_torch import golden

    for row in GOLDEN_ROWS:
        torch.cuda.synchronize()
        reset_counts()
        r = golden.run_row(row, "cuda")
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"[7 golden] {golden.line(r)}; hand-kernel launches {counts}")
        if not r["ok"]:
            raise AssertionError(f"BASELINE row {row} failed on the card")
        if row == 1:
            norms = [ln for ln in r["output"].splitlines()
                     if ln.startswith("L_")]
            log(f"[7 golden] row 1 velocity error norms: {norms}")
            if len(norms) != 3 or not all(
                    math.isfinite(float(ln.split(":")[1])) for ln in norms):
                raise AssertionError("row 1 printed no velocity norms")


def fa_run(argv, tag):
    """One -fa drive of the CLI; logs its figures and returns (run,
    counts)."""
    run, counts, wall, out = drive(argv)
    res, h = run.result, run.hydro
    if h.p_assembly or h._h1_csr is None or h._lat is not None:
        raise AssertionError(f"{tag}: the CLI did not take the FA path")
    step_ms = 1e3 * res.timings["total"] / res.steps
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    peak = torch.cuda.max_memory_allocated()
    A = h._h1_csr
    nbytes = _nbytes((A.crow_indices(), A.col_indices(), A.values()))
    p = f"[8 {tag}]"
    log(f"{p} NE {h.NE}, H1 dofs {h.ndof * 3}; scalar mass CSR "
        f"{A.values().numel()} nonzeros, {nbytes} B (int32 indices); FA "
        f"setup (element matrices, CSR coalescing, L2 inverses) "
        f"{h.fa_setup_seconds:.3f} s of setup {run.setup_seconds:.3f} s")
    t = res.timing_data.t
    log(f"{p} {res.steps} steps, step_ms {step_ms:.3f} (timed run, fences "
        f"per phase), wall {wall:.3f} s; phase seconds "
        + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
        + f"; FOM {run.fom['FOM']:.6g}, FOM1 {run.fom['FOM1']:.6g}")
    log(f"{p} CG-H1 {res.h1_iters} coupled iterations "
        f"({res.h1_iters / (2 * res.steps):.2f} per solve of all 3 "
        f"components); final |e| {res.e_norm!r}, energy drift {drift:.3e}; "
        f"peak device memory {peak / 2**30:.3f} GiB; element kernel "
        f"launches {counts['element']} == q-updates {h.qupdate_calls}")
    if not drift <= 1e-12:
        raise AssertionError(f"{tag}: RK2Avg energy drift {drift:.3e} > "
                             "1e-12")
    _only(counts, "element", h.qupdate_calls, tag, pa=False)
    return run, counts


def csr_check(h):
    """The FA mass product on the flagship CSR: csr_apply (one SpMV per
    component, the port's) against one SpMM with the (ndof, 3) block,
    each applied 50 times to the final velocity: bitwise repeatability and
    device times.  Returns {dtype: the SpMM's ms}, the same in f32 on the
    CSR's f32 copy: one PyTorch call applying the assembled H1 mass to
    three components, the lattice mass kernel's library yardstick at the
    flagship size."""
    from laghos_tpu_torch.ops import assemble as aop
    from laghos_tpu_torch.timing import device_ms

    A, u = h._h1_csr, h.S0["v"] + 1.0
    out = {}
    for name, fn in (("spmv x3", lambda: aop.csr_apply(A, u)),
                     ("spmm", lambda: (A @ u.T).T)):
        y = fn().clone()
        same = sum(torch.equal(fn(), y) for _ in range(50))
        ms = device_ms(fn)
        out[name] = (same, ms, y)
        log(f"[8 fa] CSR product {name}: {same} of 50 applies bitwise "
            f"equal to the first, {ms:.4f} ms")
    diff = float((out["spmm"][2] - out["spmv x3"][2]).abs().max()
                 / out["spmv x3"][2].abs().max())
    log(f"[8 fa] spmm vs spmv x3: rel {diff:.3e}")
    if out["spmv x3"][0] != 50:
        raise AssertionError("the FA mass product does not repeat")
    A32 = torch.sparse_csr_tensor(A.crow_indices(), A.col_indices(),
                                  A.values().float(), A.shape)
    u32 = u.float()
    ms32 = device_ms(lambda: (A32 @ u32.T).T)
    log(f"[8 fa] CSR product spmm in f32 (the values' f32 copy): "
        f"{ms32:.4f} ms")
    return {F64: out["spmm"][1], F32: ms32}


def phase_fa(dev):
    """The flagship under -fa against the gather path under -pa (21 steps
    each, the same call): |e| within 1e-10, energy drift <= 1e-12, the
    element-layout f64 kernel launched once per q-update.  Returns (the -fa
    result, its element kernel launches, csr_check's SpMM ms by dtype)."""
    run, counts = fa_run(FLAGSHIP_FA, "fa")
    res = run.result
    if res.steps != FLAGSHIP_STEPS:
        raise AssertionError(f"fa: {res.steps} steps")
    library = csr_check(run.hydro)
    del run
    h, ref, setup, cg = gather_run(dev, F64, FLAGSHIP_STEPS, 1e-11)
    step_ms = 1e3 * ref.timings["total"] / ref.steps
    peak = torch.cuda.max_memory_allocated()
    rel = abs(res.e_norm - ref.e_norm) / ref.e_norm
    log(f"[8 fa] -pa gather run, same call: setup {setup:.3f} s, "
        f"{ref.steps} steps, step_ms {step_ms:.3f} (timed run, fences per "
        f"phase), CG-H1 {ref.h1_iters} "
        f"({ref.h1_iters / (2 * 3 * ref.steps):.2f} per component solve), "
        f"peak device memory "
        f"{peak / 2**30:.3f} GiB, |e| {ref.e_norm!r}")
    log(f"[8 fa] |e| after {res.steps} steps, -fa vs -pa gather: rel "
        f"{rel:.3e} (limit 1e-10)")
    if not rel <= 1e-10:
        raise AssertionError("fa: |e| departs from the -pa gather run")
    del h, ref
    torch.cuda.empty_cache()
    return res, counts["element"] + cg["element"], library


def phase_checkpoint():
    """10 steps of 3D Sedov at rs3 uninterrupted, against 5 steps with
    --checkpoint then --restore and 5 more: bit for bit.  Returns (the
    launches by kernel, the uninterrupted run's RunResult)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        ck = f"{tmp}/ck.npz"
        full, c1, _, _ = drive(CKPT + ["-ms", "9"])
        first, c2, _, _ = drive(CKPT + ["-ms", "4", "--checkpoint", ck])
        resumed, c3, _, _ = drive(CKPT + ["-ms", "4", "--restore", ck])
    a, b = full.result, resumed.result
    same = all(torch.equal(a.S[k], b.S[k]) for k in a.S)
    log(f"[9 checkpoint] rs3: uninterrupted {a.steps} steps, |e| "
        f"{a.e_norm!r}; {first.result.steps} steps + restore at step "
        f"{first.result.steps + 1} + {b.steps - first.result.steps} steps, "
        f"|e| {b.e_norm!r}; (t, dt) {(a.t, a.dt)} vs {(b.t, b.dt)}; final "
        f"states bitwise equal: {same}")
    if not (same and a.steps == b.steps == 10 and (a.t, a.dt) == (b.t, b.dt)):
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    launches = {}
    for c in (c1, c2, c3):
        tally(launches, c, "lattice")
    return launches, a


def phase_io():
    """-visit -print -k, -mb, -err and --profile on a small card run.
    Returns the launches by kernel."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        base = f"{tmp}/out/sedov"
        run, counts, wall, out = drive(
            IO_RUN + ["-visit", "-print", "-k", base, "--profile",
                      f"{tmp}/prof"])
        h, n = run.hydro, run.result.steps
        txt = open(f"{base}_{n:06d}.vtu").read()
        npts, ncells = map(int, re.search(
            r'NumberOfPoints="(\d+)" NumberOfCells="(\d+)"', txt).groups())
        want = (h.NE * h.nd1**3, h.NE * (h.nd1 - 1)**3)
        rho = re.search(r'Name="density" format="ascii">\n(.*?)</DataArray>',
                        txt, re.S).group(1).split()
        pvd = open(f"{base}.pvd").read().count("<DataSet")
        z = np.load(f"{base}_{n:06d}.npz")
        npz_ok = np.array_equal(z["e"], run.result.S["e"].cpu().numpy())
        trace = json.load(open(f"{tmp}/prof/trace.json"))
    events = trace["traceEvents"]
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    mem = [ln for ln in out.splitlines() if "peak" in ln and "MB" in ln]
    err = re.search(r"Density L2 error: (\S+)", out)
    log(f"[10 io] {n} steps in {wall:.3f} s; VTU points/cells {(npts, ncells)}"
        f" (want {want}), density values {len(rho)}, PVD entries {pvd}, NPZ "
        f"state equal {npz_ok}; -mb: {mem}; -err: "
        f"{err.group(0) if err else None}; profiler trace {len(events)} "
        f"events, {kernels} device kernels; lattice kernel launches "
        f"{counts['lattice']}")
    if not ((npts, ncells) == want and len(rho) == npts and pvd == 2
            and npz_ok and mem and err and math.isfinite(
                float(err.group(1))) and kernels > 0):
        raise AssertionError("the I/O flags' outputs are missing or wrong")
    launches = {}
    tally(launches, counts, "lattice")
    return launches


# ----------------------------------------------------------- phase 11 --
def _same_runs(ra, rb, la, lb, tag):
    same = all(torch.equal(ra.S[k], rb.S[k]) for k in ra.S)
    if not (same and la == lb and ra.norms == rb.norms
            and (ra.steps, ra.t, ra.dt, ra.h1_iters, ra.l2_iters)
            == (rb.steps, rb.t, rb.dt, rb.h1_iters, rb.l2_iters)):
        raise AssertionError(f"{tag}: the device loop differs from the "
                             "host loop")


def _loop_pair(argv, tag):
    """The CLI run `argv` with the host loop, then with --device-loop
    (launch counts reset before and read after each): states bit for
    bit, the same steps, t, dt, norms, CG totals and step lines."""
    runs = []
    for extra in ([], ["--device-loop"]):
        run, counts, wall, out = drive(argv + extra)
        h = run.hydro
        _only(counts, "lattice", h.qupdate_calls,
              f"{tag}{' device loop' if extra else ''}", h.oz is not None)
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("step", "Repeating"))]
        runs.append((run, counts, wall, lines))
    (a, _, _, la), (b, _, _, lb) = runs
    _same_runs(a.result, b.result, la, lb, tag)
    return runs


def _gather_pair(dev):
    """The gather path at the flagship size through driver.run, host loop
    then device loop on one Hydro: bit for bit.  Returns (the launches by
    kernel, the host loop's RunResult without its state)."""
    import contextlib
    import io

    from laghos_tpu_torch import driver

    h = flagship_hydro(dev, cg_tol=1e-11, **GATHER)
    out = []
    for dl in (False, True):
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts()
        calls = h.qupdate_calls
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            r = driver.run(h, t_final=0.6, max_steps=GATHER_STEPS - 1,
                           vis_steps=2, verbose=True, device_loop=dl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        _only(counts, "element", h.qupdate_calls - calls,
              f"11 gather{' device loop' if dl else ''}")
        out.append((r, buf.getvalue().splitlines(), wall, counts))
    (ra, la, wa, ca), (rb, lb, wb, cb) = out
    _same_runs(ra, rb, la, lb, "11 gather")
    ra.S = None                    # phase 16 reads the scalars only
    log(f"[11 device loop] gather: {rb.steps} steps bitwise equal to the "
        f"host loop (step lines too), step_ms host {1e3 * wa / ra.steps:.3f}"
        f" / device {1e3 * wb / rb.steps:.3f} (untimed), CG-H1 "
        f"{rb.h1_iters}, |e| {rb.e_norm!r}, element kernel launches "
        f"{ca['element']} + {cb['element']}")
    del h
    launches = {}
    for c in (ca, cb):
        tally(launches, c, "element")
    return launches, ra


def _syncs(h, steps, device_loop):
    """Host syncs per accepted step of `steps` steps of `h` through
    driver.run, counted on the card (timing.count_syncs)."""
    from laghos_tpu_torch import driver
    from laghos_tpu_torch.timing import count_syncs

    torch.cuda.synchronize()
    with count_syncs() as c:
        r = driver.run(h, t_final=0.6, max_steps=steps - 1, vis_steps=5,
                       device_loop=device_loop)
    return c["syncs"], r.steps


def _timed(h, steps, device_loop):
    """(step_ms, launch counts) of `steps` steps of `h` through
    driver.run, untimed inside (no phase fences), a sync at each end."""
    from laghos_tpu_torch import driver

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    r = driver.run(h, t_final=0.6, max_steps=steps - 1, vis_steps=5,
                   device_loop=device_loop)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / r.steps, read_counts()


def phase_device_loop(dev):
    """The flagship (lattice Jacobi) through the CLI with the host loop
    and with --device-loop, bit for bit, with step_ms and host syncs per
    accepted step of both; the gather path and the Ozaki lattice path
    likewise for a few steps.  Returns (the host run's RunResult, its
    setup seconds, launches by kernel, the host-loop RunResults of the
    gather and Ozaki pairs without their states)."""
    launches = {}
    runs = _loop_pair(FLAGSHIP_RUN, "11 flagship")
    for (run, counts, wall, _), name in zip(runs, ("host", "device")):
        res = run.result
        tally(launches, counts, "lattice")
        log(f"[11 device loop] flagship {name} loop through the CLI: "
            f"{res.steps} steps, step_ms "
            f"{1e3 * res.timings['total'] / res.steps:.3f} (untimed), "
            f"CG-H1 {res.h1_iters}, CG-L2 {res.l2_iters}, |e| "
            f"{res.e_norm!r}; lattice kernel launches {counts['lattice']}")
    log("[11 device loop] flagship: host and device loops bitwise equal "
        "(states, steps, t, dt, norms, CG totals, step lines)")
    ref, setup = runs[0][0].result, runs[0][0].setup_seconds
    h = runs[0][0].hydro
    del runs
    # step_ms interleaved on one Hydro (the host's speed drifts within a
    # call), then the host syncs of each loop in a counted run
    ms = {False: [], True: []}
    for dl in (False, True, False, True):
        t, counts = _timed(h, FLAGSHIP_STEPS, dl)
        ms[dl].append(t)
        tally(launches, counts, "lattice")
    syncs = {dl: _syncs(h, FLAGSHIP_STEPS, dl) for dl in (False, True)}
    for dl, name in ((False, "host"), (True, "device")):
        n, steps = syncs[dl]
        log(f"[11 device loop] flagship {name} loop: step_ms "
            f"{ms[dl][0]:.3f}, {ms[dl][1]:.3f} (its two of four runs, "
            f"alternating, untimed); host syncs {n} over {steps} steps "
            f"({n / steps:.2f} per accepted step, setup and pause reads "
            "included)")
    if not 0 < syncs[True][0] < syncs[False][0]:
        raise AssertionError("the device loop did not cut the host syncs")
    del h
    torch.cuda.empty_cache()
    more, gather_ref = _gather_pair(dev)
    merge(launches, more)
    torch.cuda.empty_cache()
    runs = _loop_pair(OZAKI_RUN, "11 ozaki")
    for run, counts, wall, _ in runs:
        tally(launches, counts, "lattice")
    r = runs[1][0].result
    oz_ref = runs[0][0].result
    oz_ref.S = None
    log(f"[11 device loop] ozaki rs3: {r.steps} steps bitwise equal to the "
        f"host loop, wall host {runs[0][2]:.3f} / device {runs[1][2]:.3f} s "
        f"(setup included), |e| {r.e_norm!r}, kernel launches "
        f"{runs[1][1]}")
    del runs
    torch.cuda.empty_cache()
    return ref, setup, launches, {"gather": gather_ref, "ozaki": oz_ref}


# ----------------------------------------------------------- phase 12 --
def phase_solver_options(dev, ref, ref_setup):
    """--precond schwarz on the flagship for 5 steps (|e| within 1e-10 of
    Jacobi's at step 5), then cg_warm_start over the flagship's 21 steps
    (the same steps, |e| within 1e-6 of the cold run's, no more H1
    iterations) and on the JAX package's warm-start gate (fewer).
    Returns the launches by kernel."""
    from laghos_tpu_torch import driver

    run, counts, wall, _ = drive(SCHWARZ_RUN)
    res, h = run.result, run.hydro
    _only(counts, "lattice", h.qupdate_calls, "12 schwarz")
    n = counts["lattice"]
    launches = {}
    tally(launches, counts, "lattice")
    rel = abs(res.norms[5] - ref.norms[5]) / ref.norms[5]
    log(f"[12 schwarz] {res.steps} steps, {res.h1_iters / (6 * res.steps):.2f}"
        f" H1 iterations per component solve (Jacobi "
        f"{ref.h1_iters / (6 * ref.steps):.2f}), setup {run.setup_seconds:.3f}"
        f" s (Jacobi {ref_setup:.3f} s), step_ms "
        f"{1e3 * res.timings['total'] / res.steps:.3f}; |e| at step 5 rel "
        f"{rel:.3e} to Jacobi's (limit 1e-10); lattice kernel launches {n}")
    if h._schwarz is None or not rel <= 1e-10:
        raise AssertionError("schwarz: wrong preconditioner or |e|")
    del run, h
    h = flagship_hydro(dev, cg_tol=1e-11, precond="jacobi",
                       cg_warm_start=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = driver.run(h, t_final=0.6, max_steps=FLAGSHIP_STEPS - 1,
                     vis_steps=5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    _only(counts, "lattice", h.qupdate_calls, "12 warm start")
    tally(launches, counts, "lattice")
    rel = abs(res.e_norm - ref.e_norm) / ref.e_norm
    log(f"[12 warm start] {res.steps} steps, H1 iterations {res.h1_iters} "
        f"warm against {ref.h1_iters} cold "
        f"({res.h1_iters / (6 * res.steps):.2f} against "
        f"{ref.h1_iters / (6 * ref.steps):.2f} per component solve), L2 "
        f"{res.l2_iters} against {ref.l2_iters}; |e| rel {rel:.3e} to the "
        f"cold run (limit 1e-6); step_ms {1e3 * wall / res.steps:.3f}")
    if not (res.steps == ref.steps and rel <= 1e-6
            and res.h1_iters <= ref.h1_iters):
        raise AssertionError("warm start: steps, |e| or iterations")
    del h
    # the JAX package's own warm-start gate (tests/test_precond.py): 3D
    # Sedov rs1, E0 2, RK4, -cgt 1e-12, 12 steps: fewer iterations warm
    from laghos_tpu_torch.fem import mesh as fmesh
    from laghos_tpu_torch.hydro import Hydro, Options

    its = {}
    for warm in (False, True):
        m = fmesh.uniform_refine(fmesh.cartesian(3, (2, 2, 2),
                                                 (1.0, 1.0, 1.0)))
        hw = Hydro(m, Options(problem=1, blast_energy=2.0, ode_solver=4,
                              cg_tol=1e-12, precond="jacobi",
                              cg_warm_start=warm), device=dev)
        reset_counts()
        r = driver.run(hw, t_final=0.6, max_steps=12)
        tally(launches, read_counts(), "lattice")
        its[warm] = (r.h1_iters, r.steps, r.e_norm)
    rel = abs(its[True][2] - its[False][2]) / its[False][2]
    log(f"[12 warm start] the JAX package's gate (3D Sedov rs1, RK4, -cgt "
        f"1e-12, 13 steps): H1 iterations {its[True][0]} warm against "
        f"{its[False][0]} cold, |e| rel {rel:.3e}")
    if not (its[True][0] < its[False][0] and its[True][1] == its[False][1]
            and rel <= 1e-6):
        raise AssertionError("warm start saves no iteration on the JAX "
                             "package's gate")
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------- phase 13 --
SWEEP_ENERGIES = (0.25, 0.5, 1.0, 2.0)
SWEEP_ATTEMPTS = 6         # step attempts a member (cut from 11 for time)


def phase_sweep(dev):
    """batch.sweep of four blast energies on the flagship mesh for
    SWEEP_ATTEMPTS step attempts each, every member bit for bit its separate run of
    driver.run on the card.  Returns (the launches by kernel, the members'
    digests)."""
    from laghos_tpu_torch import batch, driver

    h = flagship_hydro(dev, cg_tol=1e-11, precond="jacobi")
    Sb = batch.blast_states(h, SWEEP_ENERGIES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = batch.sweep(h, Sb, t_final=0.6, max_steps=SWEEP_ATTEMPTS - 1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    _only(counts, "lattice", h.qupdate_calls, "13 sweep")
    for i, E in enumerate(SWEEP_ENERGIES):
        r = driver.run(h, t_final=0.6, max_steps=SWEEP_ATTEMPTS - 1,
                       vis_steps=10**6,
                       S_init={k: v[i].clone() for k, v in Sb.items()})
        same = all(torch.equal(out["S"][k][i], r.S[k]) for k in r.S)
        if not (same and float(out["t"][i]) == r.t
                and int(out["h1_iters"][i]) == r.h1_iters
                and not bool(out["crashed"][i])):
            raise AssertionError(f"sweep member E0 = {E} differs from its "
                                 "separate run")
    log(f"[13 sweep] {len(SWEEP_ENERGIES)} blast energies "
        f"{SWEEP_ENERGIES} on the flagship mesh, {SWEEP_ATTEMPTS} step "
        f"attempts each: "
        f"{secs:.3f} s ({1e3 * secs / int(out['steps'].sum()):.3f} ms per "
        f"attempt); steps {out['steps'].tolist()}, t "
        f"{[round(x, 6) for x in out['t'].tolist()]}, CG-H1 "
        f"{out['h1_iters'].tolist()}; every member bitwise equal to its "
        f"separate card run; lattice kernel launches {counts['lattice']}")
    digests = [member_digest(out, i) for i in range(len(SWEEP_ENERGIES))]
    del h, Sb, out
    torch.cuda.empty_cache()
    launches = {}
    tally(launches, counts, "lattice")
    return launches, digests


def member_digest(out, i):
    """SHA-256 of sweep member i's final state and scalars: equal digests
    are equal bits."""
    import hashlib

    d = hashlib.sha256()
    for k in ("x", "v", "e"):
        d.update(out["S"][k][i].detach().cpu().numpy().tobytes())
    for k in ("t", "dt", "steps", "crashed", "h1_iters", "l2_iters"):
        d.update(out[k][i].detach().cpu().numpy().tobytes())
    return d.hexdigest()


# ----------------------------------------------------------- phase 14 --
def _index_add_check(th):
    """The simplex mass apply with the JAX package's scatter-add
    (index_add_, atomics on the card) beside the port's incidence gather:
    how many of 50 applies repeat the first bit for bit, and each one's
    device time.  Printed, not asserted for index_add_."""
    from laghos_tpu_torch.timing import device_ms

    u = th.S0["x"] + 0.5
    flat = th.gather.reshape(-1)

    def scatter():
        ye = th._mass_e(u)
        out = torch.zeros((3, th.ndof), dtype=u.dtype, device=u.device)
        return out.index_add_(1, flat, ye.reshape(3, -1))

    def gather():
        return th._assemble(th._mass_e(u))

    res = {}
    for name, fn in (("incidence gather", gather), ("index_add_", scatter)):
        y = fn().clone()
        same = sum(torch.equal(fn(), y) for _ in range(50))
        res[name] = (same, device_ms(fn), y)
        log(f"[14 simplex] mass apply with {name} assembly: {same} of 50 "
            f"applies bitwise equal to the first, {res[name][1]:.4f} ms")
    diff = float((res["index_add_"][2] - res["incidence gather"][2]).abs()
                 .max() / res["incidence gather"][2].abs().max())
    log(f"[14 simplex] index_add_ vs incidence gather: rel {diff:.3e}")
    if res["incidence gather"][0] != 50:
        raise AssertionError("the simplex assembly does not repeat")


def phase_simplex(dev):
    """3D Sedov on cube01_tet refined 3 times (24,576 tets, Q2-Q1, 120
    q-points a tet) with RK2Avg for 10 step attempts twice (drift <= 1e-11,
    bitwise equal), the assembly's repeatability against index_add_, then
    once through the CLI's simplex route."""
    from laghos_tpu_torch import data
    from laghos_tpu_torch.fem import simplex_mesh as fsm
    from laghos_tpu_torch.hydro import Options
    from laghos_tpu_torch.simplex_hydro import SimplexHydro

    t0 = time.perf_counter()
    m = data.get_mesh("cube01_tet")
    for _ in range(SIMPLEX_RS):
        m = fsm.uniform_refine_tet(m)
    th = SimplexHydro(m, Options(problem=1, ode_solver=7, cg_tol=1e-11),
                      device=dev)
    setup = time.perf_counter() - t0
    finals = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        S, t, steps = th.run(0.6, max_steps=SIMPLEX_STEPS - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        finals.append(S)
    peak = torch.cuda.max_memory_allocated()
    (ie0, ke0), (ie, ke) = th.energies(th.S0), th.energies(S)
    E0, E1 = float(ie0 + ke0), float(ie + ke)
    drift = abs(E1 - E0) / abs(E0)
    same = all(torch.equal(finals[0][k], finals[1][k]) for k in S)
    en = float(torch.sqrt(torch.sum(S["e"] * S["e"])))
    log(f"[14 simplex] cube01_tet rs{SIMPLEX_RS}: NE {th.NE}, NQ {th.NQ}, "
        f"{th.NE * th.NQ} q-points, {th.ndof} H1 nodes, setup {setup:.3f} "
        f"s; {steps} steps to t {t:.6f}, step_ms {1e3 * wall / steps:.3f} "
        f"(untimed), CG-H1 {th.h1_iters} coupled iterations "
        f"({th.h1_iters / (2 * steps):.2f} per solve), |e| {en!r}, drift "
        f"{drift:.3e} (limit 1e-11), peak device memory "
        f"{peak / 2**30:.3f} GiB; two runs bitwise equal: {same}")
    if not (steps > 0 and same and drift <= 1e-11 and math.isfinite(en)):
        raise AssertionError("simplex run: steps, drift or repeatability")
    _index_add_check(th)
    del th, finals, S
    torch.cuda.empty_cache()
    run, counts, wall, out = drive(SIMPLEX_CLI)
    last = out.strip().splitlines()[-1]
    res = run.result
    log(f"[14 simplex] CLI {' '.join(SIMPLEX_CLI)}: {last!r}; {res.steps} "
        f"steps in {wall:.3f} s (setup {run.setup_seconds:.3f} s), CG-H1 "
        f"{res.h1_iters}; hand-kernel launches {counts}")
    if not (last.startswith("step") and math.isfinite(res.e_norm)
            and not any(counts.values())):
        raise AssertionError("the CLI's simplex route")


# ----------------------------------------------------------- phase 15 --
# BASELINE AMR rows (amr/README.md:98-103): row 1's 60-attempt prefix, row
# 3's first AMR_ROW3_STEPS accepted steps against the JAX package's trace
# in runs/, row 4 resumed from the JAX package's checkpoint in runs/
AMR_ROW1 = dict(problem=1, blast_energy=0.25, order_v=2, order_e=1,
                cg_tol=1e-8)
AMR_ROW1_PINNED = (51, 70, 390.4794540789)   # tests/test_amr.py:157-179
# cut from 150 and 21 (row 4 then from 6 to 4) to keep the script's run
# inside its limit (PERF.md section 7): the JAX trace and continuation are
# held on their prefixes (row 4's NE changes at every one of its first 6
# steps: up at the first three, down at the fourth).  Row 4's
# prefix rejects no attempt (its first rejection comes after the 11th); the
# AMR step rejection stays on the card in (a) (row 1: 9 of its 60 attempts,
# twice, at the JAX package's pinned steps) and (b) (row 3: 9 of its 59,
# every decision held to the JAX trace)
AMR_ROW3_STEPS = 50
AMR_ROW4_ATTEMPTS = 4
# |e| against the JAX package's runs, relative.  The graded meshes'
# velocity masses are ill-conditioned (condition number 33,105 on row 3's
# initial forest), so the unpreconditioned CG stops at -cgm 300 short of
# -cgt 1e-8, and its unconverged iterate carries the two packages'
# different summation orders up: fed identical inputs, their velocities
# differ by 7.1e-7 after the 300 iterations (a CPU run of both), and row
# 3's |e| by 1.3e-9 at step 1.  The refine/derefine decisions are held
# exactly; |e| to AMR_E_TOL, with the first step past 1e-12 and past 1e-9
# logged.
AMR_E_TOL = 1e-6
# the JAX package's continuation of runs/amr_ckpt_row4.pkl for 21
# attempts (step 1801 on), (ti, NE, |e|) of each accepted step, computed
# on a CPU by the JAX package itself (phase 15 (c) holds its prefix):
#   cp runs/amr_ckpt_row4.pkl CK; AMR_CKPT_PATH=CK AMR_TRACE_PATH=T.json \
#   AMR_CKPT_EVERY=1000 python scripts/amr_golden.py 4 1856
AMR_ROW4_JAX = (
    (1801, 2759, 3225.055791208549),
    (1802, 2773, 3223.366843951816),
    (1803, 2787, 3221.6820221644593),
    (1804, 2766, 3219.8588470836803),
    (1805, 2759, 3218.113020594708),
    (1806, 2745, 3216.33579812192),
    (1807, 2745, 3214.634576350452),
    (1808, 2738, 3212.8974992534922),
    (1809, 2731, 3211.1310151811263),
    (1810, 2738, 3209.409045706923),
    (1811, 2731, 3207.6560534257437),
    (1812, 2738, 3205.9429811611303),
    (1813, 2759, 3204.2343345098775),
    (1814, 2766, 3202.496060491795),
    (1815, 2752, 3200.665004714942),
    (1816, 2752, 3199.1357642205817),
    (1817, 2752, 3197.6100857941387),
    (1818, 2752, 3196.0575505823763),
    (1819, 2759, 3194.477754281646),
    (1820, 2780, 3192.870291107619),
)
# -ms 10 (cut from 20 for time): 6 steps, refined from 13 to 43 zones
AMR_CLI = ["-d", "cuda", "-p", "1", "-m", "square01_quad", "-rs", "3",
           "-tf", "0.8", "-amr", "-ms", "10"]


def _amr_graded(dim, rs):
    from laghos_tpu_torch.amr.forest import Forest

    f = Forest(dim, (2,) * dim, (1.0,) * dim, max_depth=rs)
    for _ in range(rs):
        corner = [k for k in f.leaf_list() if not any(k[1])]
        f.refine(corner, balance=False)
    return f


def _amr_run(h, **kw):
    """run_amr on `h` with a fresh trace: (summary, trace, wall seconds)."""
    from laghos_tpu_torch.amr.driver import run_amr

    trace = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_amr(h, vis_steps=10**9, trace=trace, **kw)
    torch.cuda.synchronize()
    return res, trace, time.perf_counter() - t0


def _same_state(ha, hb):
    return all(torch.equal(ha.state[k], hb.state[k]) for k in "xve")


def _amr_line(tag, h, res, wall, peak):
    sec = res["seconds"]
    log(f"[15 amr] {tag}: steps {res['steps']}, NE {res['NE']}, t "
        f"{res['t']!r}, |e| {res['e_norm']!r}; wall {wall:.3f} s (stepping "
        f"{sec['stepping']:.3f} s, host rebuild {sec['rebuild']:.3f} s over "
        f"{res['mesh_changes']} mesh changes); CG-H1 {int(h.h1_iters)} "
        f"coupled iterations in {h.h1_solves} solves "
        f"({int(h.h1_iters) / max(h.h1_solves, 1):.1f} per solve); peak "
        f"device memory {peak / 2**30:.3f} GiB")


def phase_amr(dev):
    """The AMR variant: (a) BASELINE AMR row 1's 60-attempt prefix twice,
    bitwise equal and at the JAX package's pinned values; (b) row 3's first
    AMR_ROW3_STEPS accepted steps against runs/amr_trace_row3.json; (c) the
    row-4 checkpoint (NE 2,745, 3D) resumed for AMR_ROW4_ATTEMPTS attempts
    twice, bitwise equal and against the JAX package's continuation, with
    host syncs per accepted step; (d) one short CLI run.  The AMR q-update
    is plain torch: a hand-written kernel launch here is a routing fault."""
    from laghos_tpu_torch.amr import driver as adrv
    from laghos_tpu_torch.amr.solver import AMRHydro
    from laghos_tpu_torch.hydro import Options
    from laghos_tpu_torch.timing import count_syncs

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # (a) row 1 prefix, twice
    runs = []
    for _ in range(2):
        h = AMRHydro(_amr_graded(2, 4), Options(**AMR_ROW1), h0=0.25,
                     device=dev)
        runs.append((h,) + _amr_run(h, t_final=0.8, max_steps=60))
    (ha, ra, ta, wall), (hb, rb, tb, _) = runs
    same = _same_state(ha, hb) and ta == tb
    refs = {"row1": (ra, ta, ha.state)}
    steps, ne, en = AMR_ROW1_PINNED
    rel = abs(ra["e_norm"] - en) / en
    _amr_line("(a) row 1 prefix, 60 attempts", ha, ra, wall,
              torch.cuda.max_memory_allocated())
    log(f"[15 amr] (a) two runs bitwise equal (states, traces): {same}; "
        f"pinned {steps} / {ne} / {en}: |e| rel {rel:.3e} (limit 1e-8)")
    if not (same and ra["steps"] == steps and ra["NE"] == ne
            and rel <= 1e-8):
        raise AssertionError("AMR row 1 prefix")

    # (b) row 3, first AMR_ROW3_STEPS accepted steps
    with open("runs/amr_trace_row3.json") as fp:
        jtr = json.load(fp)
    attempts = sum(1 for r in jtr if r["ti"] <= AMR_ROW3_STEPS)
    h = AMRHydro(_amr_graded(3, 3), Options(**AMR_ROW1), h0=0.25,
                 device=dev)
    torch.cuda.reset_peak_memory_stats()
    res, tr, wall = _amr_run(h, t_final=0.6, max_steps=attempts - 1)
    _amr_line(f"(b) row 3, {attempts} attempts", h, res, wall,
              torch.cuda.max_memory_allocated())
    mine = {r["ti"]: r for r in tr if "t" in r}
    ref = {r["ti"]: r for r in jtr if "t" in r and r["ti"] <= res["steps"]}
    first = {1e-12: None, 1e-9: None}
    worst = 0.0
    flips = []
    for ti in sorted(ref):
        a, b = mine.get(ti), ref[ti]
        if a is None or any(a[k] != b[k] for k in ("NE", "n_ref",
                                                   "n_deref")):
            flips.append(ti)
            continue
        d = abs(a["e_norm"] - b["e_norm"]) / b["e_norm"]
        worst = max(worst, d)
        for lim in first:
            if first[lim] is None and d > lim:
                first[lim] = ti
    log(f"[15 amr] (b) against runs/amr_trace_row3.json: {len(ref)} "
        f"accepted steps, decision differences at {flips[:5] or 'none'}, "
        f"max |e| rel {worst:.3e} (limit {AMR_E_TOL:g}), first |e| "
        f"difference > 1e-12 at step {first[1e-12]}, > 1e-9 at step "
        f"{first[1e-9]}")
    if not (len(ref) >= AMR_ROW3_STEPS and not flips
            and worst <= AMR_E_TOL):
        raise AssertionError("AMR row 3 prefix against the JAX trace")
    del h

    # (c) row 4 resumed at NE 2,745, twice
    ck = adrv.load_checkpoint("runs/amr_ckpt_row4.pkl")
    runs = []
    for k in range(2):
        t0 = time.perf_counter()
        h = adrv.resume_amr_hydro(ck, Options(**AMR_ROW1), device=dev)
        setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kw = dict(t_final=0.6, ref_threshold=1e-3, resume=ck,
                  max_steps=ck["steps"] + AMR_ROW4_ATTEMPTS - 1)
        if k == 0:
            res, tr, wall = _amr_run(h, **kw)
            peak = torch.cuda.max_memory_allocated()
        else:
            with count_syncs() as c:
                res, tr, _ = _amr_run(h, **kw)
        runs.append((h, res, tr))
    (ha, ra, ta), (hb, rb, tb) = runs
    acc = [r for r in ta if "t" in r]
    refs["row4"] = ta
    same = _same_state(ha, hb) and ta == tb
    _amr_line(f"(c) row 4 resumed, {AMR_ROW4_ATTEMPTS} attempts", ha, ra,
              wall, peak)
    log(f"[15 amr] (c) NE {len(ck['forest']['leaves'])}, "
        f"{ck['xT'].shape[1]} true H1 nodes at the checkpoint; setup "
        f"{setup:.3f} s; {len(acc)} accepted steps, step_ms "
        f"{1e3 * wall / len(acc):.1f} (stepping "
        f"{1e3 * ra['seconds']['stepping'] / len(acc):.1f}, host rebuild "
        f"{1e3 * ra['seconds']['rebuild'] / len(acc):.1f}); host syncs "
        f"{c['syncs']} ({c['syncs'] / len(acc):.1f} per accepted step, "
        f"counted in the second run); two runs bitwise equal: {same}")
    worst, bad, first9 = 0.0, [], None
    for r, (ti, ne, en) in zip(acc, AMR_ROW4_JAX):
        d = abs(r["e_norm"] - en) / en
        worst = max(worst, d)
        if first9 is None and d > 1e-9:
            first9 = ti
        if r["ti"] != ti or r["NE"] != ne:
            bad.append(ti)
    log(f"[15 amr] (c) against the JAX package's continuation: the first "
        f"{len(acc)} of its {len(AMR_ROW4_JAX)} steps, NE differences at "
        f"{bad or 'none'}, max |e| rel {worst:.3e} (limit {AMR_E_TOL:g}), "
        f"first > 1e-9 at step {first9}")
    # the resumed run rejects one of its first 21 attempts, after the
    # 11th: its first AMR_ROW4_ATTEMPTS attempts are steps 1801 on (a CPU
    # run too)
    if not (same and len(acc) == AMR_ROW4_ATTEMPTS and not bad
            and worst <= AMR_E_TOL):
        raise AssertionError("AMR row 4 resume")
    del ha, hb, runs

    # (d) the CLI's -amr route
    counts = read_counts()
    run, counts_cli, wall, out = drive(AMR_CLI)
    counts = {k: counts[k] + counts_cli[k] for k in counts}
    ne0 = int(out.split("initial AMR mesh: ")[1].split()[0])
    lines = [ln for ln in out.splitlines() if ln.startswith("step")]
    ens = [float(ln.split("|e| = ")[1].split()[0]) for ln in lines]
    log(f"[15 amr] (d) CLI {' '.join(AMR_CLI)}: {len(lines)} step lines in "
        f"{wall:.3f} s, NE {ne0} -> {run['NE']}, last "
        f"{lines[-1] if lines else None!r}")
    if not (lines and all(math.isfinite(e) for e in ens)
            and run["NE"] > ne0):
        raise AssertionError("the CLI's -amr route")
    refs["cli"] = out
    secs = time.perf_counter() - t_phase
    log(f"[15 amr] hand-kernel launches in the AMR runs: {counts} (all 0: "
        f"the AMR q-update is plain torch); phase {secs:.1f} s")
    if any(counts.values()):
        raise AssertionError("a hand-written kernel launched on the AMR "
                             "path")
    return refs


# ----------------------------------------------------------- phase 16 --
# the flagship over 4 ranks sharing the card (gloo: NCCL refuses two ranks
# on one card), through the CLI; the library runs of the phase take
# DIST_STEPS accepted steps
DIST_RANKS = 4
DIST_CLI = FLAGSHIP_RUN + ["-nd", str(DIST_RANKS), "--halo",
                           "--dist-backend", "gloo"]
DIST_STEPS = 5
# (b)'s repeat: the same command for its first DIST_STEPS steps, held bit
# for bit to the 21-step run's lines and to (f)'s slabs run through the
# library (cut from a second CLI run of 21 steps, then of 5, for time)
DIST_CLI_REPEAT = list(DIST_CLI)
DIST_CLI_REPEAT[DIST_CLI_REPEAT.index("-ms") + 1] = str(DIST_STEPS - 1)
DIST_RS = 3                # refinements of the rs3 runs of (e) and (g)
DIST_TIMEOUT = 300.0       # a deadlocked launch fails instead of hanging


def _summary(r):
    return {"steps": r.steps, "t": r.t, "dt": r.dt, "e_norm": r.e_norm,
            "energy_init": r.energy_init, "energy_final": r.energy_final,
            "h1_iters": r.h1_iters, "l2_iters": r.l2_iters,
            "norms": dict(r.norms)}


def _dist_close(a, b, what, e_tol=1e-11):
    """The JAX package's distributed bounds (tests/test_slab.py): steps
    equal, t within 1e-13, |e| and total energy within `e_tol` relative,
    CG-H1 iterations within 1 %.  Returns |e|'s relative difference."""
    rel = abs(a["e_norm"] - b["e_norm"]) / b["e_norm"]
    rel_E = (abs(a["energy_final"] - b["energy_final"])
             / abs(b["energy_final"]))
    ok = (a["steps"] == b["steps"] and abs(a["t"] - b["t"]) < 1e-13
          and rel <= e_tol and rel_E <= e_tol
          and abs(a["h1_iters"] - b["h1_iters"]) <= 0.01 * b["h1_iters"])
    if not ok:
        raise AssertionError(
            f"{what}: steps {a['steps']} / {b['steps']}, t {a['t']!r} / "
            f"{b['t']!r}, |e| rel {rel:.3e}, energy rel {rel_E:.3e}, CG-H1 "
            f"{a['h1_iters']} / {b['h1_iters']} (limit {e_tol:g})")
    return rel


def _drift(a):
    return abs(a["energy_final"] - a["energy_init"]) / abs(a["energy_init"])


def _rank_run(view, tag, out, steps=DIST_STEPS, **kw):
    """A driver.run of `steps` steps of a rank view, its launch counts
    reset before and read after, into out[tag]."""
    from laghos_tpu_torch import driver

    torch.cuda.synchronize()
    reset_counts()
    calls = view.qupdate_calls
    t0 = time.perf_counter()
    r = driver.run(view, t_final=0.6, max_steps=steps - 1, vis_steps=5, **kw)
    torch.cuda.synchronize()
    out[tag] = dict(_summary(r), wall=time.perf_counter() - t0,
                    counts=read_counts(), calls=view.qupdate_calls - calls)
    return r


def _states_equal(comm, A, B):
    """Every rank's local states bitwise equal (all-reduced)."""
    same = all(torch.equal(A[k], B[k]) for k in A)
    return bool(comm.allreduce_min(torch.tensor([float(same)])))


def _rs3_hydro(dtype=F64, **opt):
    """3D Sedov at DIST_RS refinements (Jacobi unless `opt` says
    otherwise), built on the host for the rank views."""
    return flagship_hydro("cpu", dtype, rs=DIST_RS,
                          **{"precond": "jacobi", **opt})


def dist_ranks_flagship(comm):
    """Rank function of phase 16 (c), (d), (f), (g) on 4 ranks sharing the
    card: the flagship's pencils, slabs (host loop, then the device loop)
    and element chunks, and the replicated layout at rs3."""
    from laghos_tpu_torch.parallel.chunk_hydro import ChunkHydro
    from laghos_tpu_torch.parallel.sharding import shard_hydro
    from laghos_tpu_torch.parallel.slab_hydro import SlabHydro

    out = {}
    t0 = time.perf_counter()
    h = flagship_hydro("cpu", cg_tol=1e-11, precond="jacobi")
    out["setup"] = time.perf_counter() - t0
    v = SlabHydro(h, comm, (2, 2))
    _rank_run(v, "pencil", out)
    del v
    v = SlabHydro(h, comm)
    rh = _rank_run(v, "slab host", out)
    # the global state, for (b)'s 5-step CLI run (rank 0 reports it)
    G = v.to_global(rh.S)
    if comm.rank == 0:
        out["slab host state"] = G
    del G
    rd = _rank_run(v, "slab device", out, device_loop=True)
    out["device loop bitwise"] = _states_equal(comm, rh.S, rd.S)
    del v, rh, rd
    v = ChunkHydro(h, comm)
    _rank_run(v, "chunk", out)
    out["chunk NE"] = v.NE
    del v, h
    _rank_run(shard_hydro(_rs3_hydro(), comm), "replicated", out)
    # in f32 (the f32 element kernel), at the f32 runs' -cgt of phase 5
    _rank_run(shard_hydro(_rs3_hydro(F32, cg_tol=2e-7), comm),
              "replicated f32", out)
    out["peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def dist_ranks_pair(comm):
    """Rank function of phase 16 (e), (h) on 2 ranks sharing the card:
    Ozaki slabs at rs3, and batch.sweep(n_devices=2) of phase 13's
    members."""
    from laghos_tpu_torch import batch
    from laghos_tpu_torch.parallel.slab_hydro import SlabHydro

    out = {}
    h = _rs3_hydro(ozaki=True)
    _rank_run(SlabHydro(h, comm), "ozaki", out)
    del h
    hs = flagship_hydro(comm.device, cg_tol=1e-11, precond="jacobi")
    Sb = batch.blast_states(hs, SWEEP_ENERGIES)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sw = batch.sweep(hs, Sb, t_final=0.6, max_steps=SWEEP_ATTEMPTS - 1,
                     n_devices=comm.size,
                     comm=comm)
    torch.cuda.synchronize()
    out["sweep"] = {"wall": time.perf_counter() - t0, "counts": read_counts(),
                    "calls": hs.qupdate_calls,
                    "digests": [member_digest(sw, i)
                                for i in range(len(SWEEP_ENERGIES))]}
    return out


def _only_ranks(launches, infos, layout, what, ozaki=False, dtype=F64):
    """Every rank launched the `layout` kernel once per q-update and no
    other layout; the split kernel iff Ozaki.  Adds the ranks' counts to
    the ledger `launches`."""
    for r, info in enumerate(infos):
        _only(info["counts"], layout, info["calls"], f"{what} rank {r}",
              ozaki)
        tally(launches, info["counts"], layout, dtype)


def phase_distributed(dev, ref, gather_ref, oz_ref, ckpt_ref, digests):
    """Distributed runs (parallel/): (a) the flagship over slabs at world
    size 1 on NCCL against phase 11's lattice Jacobi run; (b) the flagship
    through the CLI over 4 slab ranks sharing the card (gloo) against
    (a), then its first DIST_STEPS steps, bitwise the 21-step run's lines
    and (f)'s run; (c) pencils, (d) element chunks, (f) the device
    loop against the host loop, (g) the replicated layout at rs3, on 4
    ranks; (e) Ozaki slabs at rs3 and (h) the collective sweep on 2 ranks.
    Returns the launches by kernel."""
    from laghos_tpu_torch import cli, driver
    from laghos_tpu_torch.parallel import comm as pcomm
    from laghos_tpu_torch.parallel.slab_hydro import SlabHydro

    t_phase = time.perf_counter()
    launches = {}
    p = "[16 distributed]"
    # (a) world size 1 on NCCL, in this process
    t0 = time.perf_counter()
    h = flagship_hydro("cpu", cg_tol=1e-11, precond="jacobi")
    with pcomm.single("nccl", "cuda") as c:
        v = SlabHydro(h, c)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = driver.run(v, t_final=0.6, max_steps=FLAGSHIP_STEPS - 1,
                       vis_steps=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        G = v.to_global(r.S)
    _only(counts, "lattice", v.qupdate_calls, "16 (a)")
    tally(launches, counts, "lattice")
    one = _summary(r)
    bitwise = all(torch.equal(G[k], ref.S[k].cpu()) for k in G)
    rel = abs(one["e_norm"] - ref.e_norm) / ref.e_norm
    log(f"{p} (a) flagship over slabs, world size 1, NCCL: {one['steps']} "
        f"steps, |e| {one['e_norm']!r} vs phase 11's lattice Jacobi run "
        f"{ref.e_norm!r} (rel {rel:.3e}, limit 1e-13; final state bitwise "
        f"equal: {bitwise}), CG-H1 {one['h1_iters']} vs {ref.h1_iters}; "
        f"setup {setup:.3f} s (host Hydro + block), step_ms "
        f"{1e3 * wall / one['steps']:.3f}; lattice kernel launches "
        f"{counts['lattice']}")
    if one["steps"] != ref.steps or not rel <= 1e-13:
        raise AssertionError("16 (a): the world-1 slab run departs from the "
                             "single-device run")
    del h, v, r, G
    torch.cuda.empty_cache()

    # (b) the flagship through the CLI, 4 ranks sharing the card, then its
    # first DIST_STEPS steps (held bit for bit to (f)'s run below)
    runs_b = []
    for i, argv in enumerate((DIST_CLI, DIST_CLI_REPEAT)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        run = cli.main(argv)
        wall = time.perf_counter() - t0
        if any(read_counts().values()):
            raise AssertionError("16 (b): the parent process launched a "
                                 "kernel; the ranks run the path")
        for r_, rk in enumerate(run.ranks):
            c_ = rk["launches"]
            if not (c_["lattice"] > 0 and c_["mass"] > 0
                    and c_["lattice_mass"] > 0 and c_["element"]
                    == c_["packed"] == c_["split"] == 0):
                raise AssertionError(f"16 (b) rank {r_}: launches {c_}")
            tally(launches, c_, "lattice")
        runs_b.append((run, wall))
        lines = [ln for ln in run.log.splitlines() if ln.startswith("step")]
        log(f"{p} (b) run {i + 1}: `python -m laghos_tpu_torch "
            f"{' '.join(argv)}`: {run.result.steps} steps in {wall:.3f} "
            f"s wall (rank spawn and host setup included; run "
            f"{run.result.timings['total']:.3f} s, step_ms "
            f"{1e3 * run.result.timings['total'] / run.result.steps:.3f}); "
            f"last line {lines[-1]!r}; lattice kernel launches per rank "
            f"{[rk['launches']['lattice'] for rk in run.ranks]}, NE per "
            f"rank {[rk['NE'] for rk in run.ranks]}")
    (b1, _), (b2, _) = runs_b
    rb1, rb2 = b1.result, b2.result

    def head(run):
        """The distinct printed step lines of steps 1..DIST_STEPS."""
        return {ln for ln in run.log.splitlines()
                if (m := re.match(r"step\s+(\d+),", ln))
                and int(m.group(1)) <= DIST_STEPS}

    prefix = (rb2.steps == DIST_STEPS and head(b2) == head(b1)
              and all(rb2.norms[s] == rb1.norms[s] for s in rb2.norms))
    sb = _summary(rb1)
    rel_b = _dist_close(sb, one, "16 (b) against (a)")
    drift_b = _drift(sb)
    log(f"{p} (b) the {DIST_STEPS}-step run's lines and |e| at steps "
        f"1-{DIST_STEPS} bitwise the 21-step run's: {prefix}; the 21-step "
        f"run against (a): |e| rel {rel_b:.3e}, t {sb['t']!r} / "
        f"{one['t']!r}, CG-H1 {sb['h1_iters']} / {one['h1_iters']}; energy "
        f"drift {drift_b:.3e}")
    if not prefix:
        raise AssertionError("16 (b): two runs at world size 4 differ")
    if not drift_b <= 1e-12:
        raise AssertionError(f"16 (b): drift {drift_b:.3e} > 1e-12")
    e5_b = rb1.norms[DIST_STEPS]
    del runs_b, b1, rb1

    # (c), (d), (f), (g) on 4 ranks sharing the card
    t0 = time.perf_counter()
    outs = pcomm.launch(dist_ranks_flagship, DIST_RANKS, "gloo", "cuda",
                        timeout=DIST_TIMEOUT)
    wall4 = time.perf_counter() - t0
    o = outs[0]
    for tag in ("pencil", "slab host", "slab device"):
        _only_ranks(launches, [x[tag] for x in outs], "lattice", f"16 {tag}")
    for tag in ("chunk", "replicated"):
        _only_ranks(launches, [x[tag] for x in outs], "element", f"16 {tag}")
    _only_ranks(launches, [x["replicated f32"] for x in outs], "element",
                "16 replicated f32", dtype=F32)
    pen, sh, sd = o["pencil"], o["slab host"], o["slab device"]
    rel_c = abs(pen["e_norm"] - e5_b) / e5_b
    log(f"{p} (c) pencils 2x2, {pen['steps']} steps: |e| {pen['e_norm']!r} "
        f"vs (b) at step {DIST_STEPS} {e5_b!r} (rel {rel_c:.3e}, limit "
        f"1e-11), step_ms {1e3 * pen['wall'] / pen['steps']:.3f}")
    if pen["steps"] != DIST_STEPS or not rel_c <= 1e-11:
        raise AssertionError("16 (c): pencils depart from the slabs")
    rel_d = _dist_close(o["chunk"], _summary(gather_ref),
                        "16 (d) against phase 11's gather run")
    log(f"{p} (d) element chunks (NE {o['chunk NE']} a rank), "
        f"{o['chunk']['steps']} steps: |e| {o['chunk']['e_norm']!r} vs the "
        f"single-rank gather path {gather_ref.e_norm!r} (rel {rel_d:.3e}), "
        f"CG-H1 {o['chunk']['h1_iters']} / {gather_ref.h1_iters}, step_ms "
        f"{1e3 * o['chunk']['wall'] / o['chunk']['steps']:.3f}; element "
        f"kernel launches per rank "
        f"{[x['chunk']['counts']['element'] for x in outs]}")
    same_f = (o["device loop bitwise"] and sh["norms"] == sd["norms"]
              and all(sh[k] == sd[k] for k in ("steps", "t", "dt",
                                                "h1_iters", "l2_iters")))
    # (b)'s 5-step CLI run against the same slabs' host loop here: two
    # runs at world size 4, through the CLI and the library
    Gf = o.pop("slab host state")
    same_b = (all(torch.equal(rb2.S[k], Gf[k]) for k in Gf)
              and rb2.norms == sh["norms"]
              and (rb2.steps, rb2.t, rb2.dt, rb2.h1_iters, rb2.l2_iters)
              == tuple(sh[k] for k in ("steps", "t", "dt", "h1_iters",
                                        "l2_iters")))
    log(f"{p} (b) the {DIST_STEPS}-step CLI run bitwise (f)'s host-loop "
        f"slab run (global state, |e| norms, steps, t, dt, CG totals): "
        f"{same_b}")
    if not same_b:
        raise AssertionError("16 (b): two runs at world size 4 differ")
    del rb2, Gf
    log(f"{p} (f) slabs, {sd['steps']} steps: device loop bitwise the host "
        f"loop (states on every rank, t, dt, norms, CG totals): {same_f}; "
        f"host loop |e| at step {DIST_STEPS} bitwise (b)'s: "
        f"{sh['e_norm'] == e5_b}; step_ms host "
        f"{1e3 * sh['wall'] / sh['steps']:.3f} / device "
        f"{1e3 * sd['wall'] / sd['steps']:.3f}")
    if not (same_f and sh["e_norm"] == e5_b):
        raise AssertionError("16 (f): the distributed device loop differs "
                             "from the host loop")
    rep = o["replicated"]
    e5 = ckpt_ref.norms[DIST_STEPS]
    rel_g = abs(rep["e_norm"] - e5) / e5
    log(f"{p} (g) replicated layout at rs3 (4 ranks), {rep['steps']} "
        f"steps: |e| {rep['e_norm']!r} vs phase 9's single-device run at "
        f"step {DIST_STEPS} {e5!r} (rel {rel_g:.3e}, limit 1e-11), step_ms "
        f"{1e3 * rep['wall'] / rep['steps']:.3f}; launch of the 4 ranks "
        f"{wall4:.3f} s (host setup {o['setup']:.3f} s), peak "
        f"{o['peak GiB']:.3f} GiB a rank")
    if rep["steps"] != DIST_STEPS or not rel_g <= 1e-11:
        raise AssertionError("16 (g): the replicated layout departs from "
                             "the single-device run")
    r32 = o["replicated f32"]
    rel_32 = abs(r32["e_norm"] - rep["e_norm"]) / rep["e_norm"]
    log(f"{p} (g) the same in f32 (-cgt 2e-7): {r32['steps']} steps, |e| "
        f"{r32['e_norm']!r}, rel {rel_32:.3e} to the f64 run (limit 1e-4); "
        f"f32 element kernel launches per rank "
        f"{[x['replicated f32']['counts']['element'] for x in outs]}")
    if r32["steps"] != DIST_STEPS or not rel_32 <= 1e-4:
        raise AssertionError("16 (g): the f32 replicated run departs from "
                             "the f64 one")

    # (e), (h) on 2 ranks sharing the card
    t0 = time.perf_counter()
    outs = pcomm.launch(dist_ranks_pair, 2, "gloo", "cuda",
                        timeout=DIST_TIMEOUT)
    wall2 = time.perf_counter() - t0
    _only_ranks(launches, [x["ozaki"] for x in outs], "lattice",
                "16 (e) ozaki", ozaki=True)
    oz = outs[0]["ozaki"]
    rel_e = _dist_close(oz, _summary(oz_ref),
                        "16 (e) against phase 11's Ozaki run")
    log(f"{p} (e) Ozaki slabs at rs3 (2 ranks), {oz['steps']} steps: |e| "
        f"{oz['e_norm']!r} vs the single-rank Ozaki run {oz_ref.e_norm!r} "
        f"(rel {rel_e:.3e}), CG-H1 {oz['h1_iters']} / {oz_ref.h1_iters}; "
        f"split launches per rank "
        f"{[x['ozaki']['counts']['split'] for x in outs]}")
    sws = [x["sweep"] for x in outs]
    _only_ranks(launches, sws, "lattice", "16 (h) sweep")
    same_h = all(sw["digests"] == digests for sw in sws)
    log(f"{p} (h) batch.sweep(n_devices=2) of phase 13's "
        f"{len(SWEEP_ENERGIES)} members: every member bitwise its phase 13 "
        f"result on both ranks: {same_h}; {sws[0]['wall']:.3f} s; launch of "
        f"the 2 ranks {wall2:.3f} s")
    if not same_h:
        raise AssertionError("16 (h): the sweep over ranks differs from the "
                             "single-rank sweep")
    log(f"{p} phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------- phase 17 --
# the AMR variant across ranks.  TRAJ is tests/test_torch_dist_amr.py's
# trajectory (2D, 16 elements refined to 127 and derefined to 118 in 25
# attempts, the velocity CG converged to 1e-12), whose records hold over
# ranks at 1e-12 / 1e-10 where the capped CG of the BASELINE rows would
# carry round-off into the decisions
AMR_TRAJ = dict(AMR_ROW1, cg_tol=1e-12, cg_max_iter=2000)
AMR_TRAJ_RUN = dict(t_final=0.8, vis_steps=5, deref_threshold=0.9,
                    max_steps=24)
# cuts (PERF.md section 4): ranks sharing the card take 4 (2 ranks) to 7
# (4 ranks) ms a collective, one host-staged all-reduce a CG iteration, and
# TRAJ's first derefinement comes at its 23rd attempt: so (b) and (c) run
# on 2 ranks, in one launch; (b)'s second run repeats only the first
# AMR_TRAJ_REPEAT_ATTEMPTS attempts (the first refinement included) of the
# first; (c) runs AMR_ROW4_DIST_ATTEMPTS of phase 15 (c)'s
# AMR_ROW4_ATTEMPTS.  tests/test_torch_dist_amr.py holds TRAJ on 2, 3 and
# 4 CPU ranks
AMR_DIST_RANKS = 2
AMR_TRAJ_REPEAT_ATTEMPTS = 5
AMR_ROW4_DIST_ATTEMPTS = 2
AMR_DIST_CLI = AMR_CLI + ["-nd", "2", "--dist-backend", "gloo"]
_CLI_LINE = (r"step\s+(\d+),\s+t = ([\d.]+),\s+dt = ([\d.]+),\s+"
             r"\|e\| = ([\deE+.-]+)\s+NE=(\d+)")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def amr_rank_runs(comm, specs):
    """Rank function of phase 17: `parallel.runs.run_amr_view` of each
    spec, with its wall seconds and the rank's collectives counted."""
    from laghos_tpu_torch.parallel import runs

    calls = [0]
    for name in ("allreduce_sum", "allreduce_min", "allreduce_max",
                 "all_gather"):
        def counted(*a, _fn=getattr(comm, name), **k):
            calls[0] += 1
            return _fn(*a, **k)
        setattr(comm, name, counted)
    out = []
    for sp in specs:
        _sync(comm.device)
        n0, t0 = calls[0], time.perf_counter()
        o = runs.run_amr_view(comm, sp)
        _sync(comm.device)
        o["wall"], o["collectives"] = time.perf_counter() - t0, calls[0] - n0
        out.append(o)
    return out


def _amr_spec(f, opt, run):
    return {"forest": dict(dim=f.dim, base_n=f.base_n, sizes=f.sizes,
                           max_depth=f.max_depth, leaves=list(f.leaf_list())),
            "h0": 0.25, "opt": opt, "run": run}


def _amr_launch(R, specs, what):
    """Every rank's amr_rank_runs of `specs` on R gloo ranks sharing the
    card; raises unless the ranks agree on every record and state bit and
    none launched a hand-written kernel."""
    from laghos_tpu_torch.parallel import comm as pcomm

    t0 = time.perf_counter()
    outs = pcomm.launch(amr_rank_runs, R, "gloo", "cuda", specs,
                        timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        for a, b in zip(o, outs[0]):
            if a["trace"] != b["trace"] or not all(
                    np.array_equal(a["state"][k], b["state"][k])
                    for k in "xve"):
                raise AssertionError(f"17 {what}: rank {r} left lockstep")
            if any(a["launches"].values()):
                raise AssertionError(f"17 {what}: rank {r} launched "
                                     f"{a['launches']}")
    return outs, wall


def _traj_forest():
    from laghos_tpu_torch.amr.forest import Forest

    f = Forest(2, (2, 2), (1.0, 1.0), max_depth=3)
    f.refine(list(f.leaf_list()))
    return f


def phase_amr_distributed(dev, refs):
    """The AMR variant across ranks (`parallel.sharding.shard_amr`):
    (a) BASELINE AMR row 1's 60-attempt prefix at world size 1 on NCCL
    (the CG graphed: the all-reduce of one rank's vector is the identity,
    the dt minimum and the gathers go through NCCL), bit for bit phase 15
    (a); (b) TRAJ on AMR_DIST_RANKS gloo ranks sharing the card against a
    single-card TRAJ (records equal, t and dt at 1e-12, |e| at 1e-10),
    with a refinement and a derefinement and each rank's element count
    after every placement printed, then a second run of its first
    AMR_TRAJ_REPEAT_ATTEMPTS attempts, bitwise its records; (c) row 4
    resumed from the JAX checkpoint (NE 2,745) on the same ranks (the
    launch of (b)) for
    AMR_ROW4_DIST_ATTEMPTS attempts (cut from phase 15's), NE per attempt equal to
    phase 15 (c) and |e| within AMR_E_TOL, with step_ms split and the
    collectives a step; (d) the CLI's `-amr -nd 2 --dist-backend gloo` on
    phase 15 (d)'s arguments, its step lines equal in step, t, dt and NE.
    No hand-written kernel may launch on any rank.  The gloo cells share
    one card, their collectives staged through the host: their times say
    nothing about scaling."""

    from laghos_tpu_torch.amr import driver as adrv
    from laghos_tpu_torch.amr.solver import AMRHydro
    from laghos_tpu_torch.hydro import Options
    from laghos_tpu_torch.parallel import comm as pcomm
    from laghos_tpu_torch.parallel.sharding import shard_amr

    p = "[17 amr ranks]"
    t_phase = time.perf_counter()
    # (a) row 1's prefix, world size 1 on NCCL, in this process
    ra, ta, Sa = refs["row1"]
    reset_counts()
    with pcomm.single("nccl", "cuda") as c:
        h = AMRHydro(_amr_graded(2, 4), Options(**AMR_ROW1), h0=0.25,
                     device="cpu")
        shard_amr(h, c)
        res, tr, wall = _amr_run(h, t_final=0.8, max_steps=60)
        counts = read_counts()
        n = len(tr)
        same = tr == ta and all(torch.equal(h.state[k], Sa[k])
                                for k in "xve")
        _amr_line(f"(a) world size 1, NCCL, row 1, {n} attempts", h, res,
                  wall, torch.cuda.max_memory_allocated())
    log(f"{p} (a) bit for bit phase 15 (a) (trace records, final state): "
        f"{same}; |e| {res['e_norm']!r} vs {ra['e_norm']!r}; launches "
        f"{counts}")
    if not same or any(counts.values()):
        raise AssertionError("17 (a): world size 1 departs from one card")
    del h

    # (b) TRAJ on AMR_DIST_RANKS gloo ranks, twice, and on the card alone;
    # (c) row 4 resumed, in the same launch
    h = AMRHydro(_traj_forest(), Options(**AMR_TRAJ), h0=0.25, device=dev)
    reset_counts()
    r1, t1, wall1 = _amr_run(h, **{k: v for k, v in AMR_TRAJ_RUN.items()
                                   if k != "vis_steps"})
    if any(read_counts().values()):
        raise AssertionError("17 (b): the single-card TRAJ launched a kernel")
    del h
    spec = _amr_spec(_traj_forest(), AMR_TRAJ, AMR_TRAJ_RUN)
    short = _amr_spec(_traj_forest(), AMR_TRAJ, dict(
        AMR_TRAJ_RUN, max_steps=AMR_TRAJ_REPEAT_ATTEMPTS - 1))
    ck_path = "runs/amr_ckpt_row4.pkl"
    ck = adrv.load_checkpoint(ck_path)
    K = AMR_ROW4_DIST_ATTEMPTS
    spec_c = {"ckpt": ck_path, "opt": AMR_ROW1,
              "run": dict(t_final=0.6, ref_threshold=1e-3, vis_steps=10**9,
                          max_steps=ck["steps"] + K - 1)}
    outs, wall_bc = _amr_launch(AMR_DIST_RANKS, [spec, short, spec_c],
                                "(b), (c)")
    b1, b2, o = outs[0]
    same_b = (b2["trace"] == b1["trace"][:AMR_TRAJ_REPEAT_ATTEMPTS]
              and len(b2["trace"]) == AMR_TRAJ_REPEAT_ATTEMPTS
              and any(r.get("changed") for r in b2["trace"]))
    worst = {"t": 0.0, "dt": 0.0, "e_norm": 0.0}
    bad = len(b1["trace"]) != len(t1)
    for a, b in zip(b1["trace"], t1):
        for k in a:
            if k in worst:
                worst[k] = max(worst[k], abs(a[k] - b[k]) / abs(b[k]))
            elif a[k] != b[k]:
                bad = True
    changed = [r for r in b1["trace"] if r.get("changed")]
    events = (any(r["n_ref"] for r in changed),
              any(r["n_deref"] for r in changed))
    log(f"{p} (b) TRAJ on {AMR_DIST_RANKS} gloo ranks sharing the card: "
        f"{b1['summary']['steps']} steps, NE {b1['summary']['NE']}, |e| "
        f"{b1['summary']['e_norm']!r}; a second run's "
        f"{AMR_TRAJ_REPEAT_ATTEMPTS} attempts (a mesh change among them) "
        f"bitwise its first {AMR_TRAJ_REPEAT_ATTEMPTS} records: {same_b}; "
        f"against one card ({r1['steps']} steps, |e| {r1['e_norm']!r}, "
        f"{wall1:.3f} s): records equal {not bad}, max rel t "
        f"{worst['t']:.3e}, dt {worst['dt']:.3e} (limit 1e-12), |e| "
        f"{worst['e_norm']:.3e} (limit 1e-10); refinement, derefinement "
        f"{events}; run walls {b1['wall']:.3f} / {b2['wall']:.3f} s "
        f"(stepping {b1['summary']['seconds']['stepping']:.3f}, rebuild "
        f"{b1['summary']['seconds']['rebuild']:.3f}), "
        f"{b1['collectives']} collectives a rank a run, launch (with (c)) "
        f"{wall_bc:.3f} s; CG-H1 {b1['h1_iters']} iterations")
    for r, ro in enumerate(outs):
        log(f"{p} (b) rank {r} elements after each placement: "
            f"{ro[0]['elements']}")
    if not (same_b and not bad and worst["t"] <= 1e-12
            and worst["dt"] <= 1e-12 and worst["e_norm"] <= 1e-10
            and all(events)):
        raise AssertionError("17 (b): TRAJ over ranks")
    del b1, b2

    # (c) row 4 resumed on the same ranks
    mine = o["trace"][len(ck["trace"]):]
    ref4 = refs["row4"][:len(mine)]
    acc = [r for r in mine if "t" in r]
    ne_same = [(r["ti"], r.get("NE")) for r in mine] == [
        (r["ti"], r.get("NE")) for r in ref4] and len(mine) == K
    worst = max((abs(a["e_norm"] - b["e_norm"]) / b["e_norm"]
                 for a, b in zip(mine, ref4) if "t" in a), default=0.0)
    sec = o["summary"]["seconds"]
    log(f"{p} (c) row 4 resumed on {AMR_DIST_RANKS} gloo ranks, {K} "
        f"attempts (NE "
        f"{len(ck['forest']['leaves'])} at the checkpoint): {len(acc)} "
        f"accepted steps, NE per attempt equal to phase 15 (c): {ne_same} "
        f"({[r['NE'] for r in mine]}), max |e| rel {worst:.3e} (limit "
        f"{AMR_E_TOL:g}); step_ms {1e3 * o['wall'] / max(len(acc), 1):.1f} "
        f"(stepping {1e3 * sec['stepping'] / max(len(acc), 1):.1f}, host "
        f"rebuild {1e3 * sec['rebuild'] / max(len(acc), 1):.1f}; wall "
        f"{o['wall']:.3f} s with the host setup), "
        f"{o['collectives'] / max(len(acc), 1):.1f} collectives a step a "
        f"rank, CG-H1 {o['h1_iters']} iterations; elements a rank "
        f"{[x[2]['elements'] for x in outs]}")
    if not (ne_same and worst <= AMR_E_TOL):
        raise AssertionError("17 (c): row 4 over ranks")
    del outs, o

    # (d) the CLI over 2 gloo ranks
    run, counts, wall, _ = drive(AMR_DIST_CLI)
    mine = re.findall(_CLI_LINE, run["log"])
    ref = re.findall(_CLI_LINE, refs["cli"])
    same_d = len(mine) == len(ref) > 0 and all(
        (a[0], a[1], a[2], a[4]) == (b[0], b[1], b[2], b[4])
        for a, b in zip(mine, ref))
    rank_counts = [rk["launches"] for rk in run["ranks"]]
    log(f"{p} (d) CLI {' '.join(AMR_DIST_CLI)}: {len(mine)} step lines in "
        f"{wall:.3f} s, equal to phase 15 (d)'s in step, t, dt, NE: "
        f"{same_d}; last {mine[-1] if mine else None}; launches: parent "
        f"{counts}, ranks {rank_counts}")
    if not same_d or any(counts.values()) or any(
            v for c_ in rank_counts for v in c_.values()):
        raise AssertionError("17 (d): the CLI's -amr -nd 2")
    log(f"{p} hand-kernel launches on every rank of (a)-(d): 0; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# ------------------------------------------------------------ phase 18 --
# Q8-Q7, the JAX package's production-size row (`q8`, bench.py:291; BASELINE
# configs[2]): 3D on cube01_hex, rule order 3*8 + 7 - 1 = 30, so 16 Gauss
# points an axis and NQ 4,096 a zone; RK2Avg, Jacobi.  At rs3: NE 4,096,
# 16,777,216 q-points, 6,440,067 H1 and 2,097,152 L2 dofs, lattices 129^3
# and 256^3.
Q8_STEPS = 2               # -ms 2: three step attempts
Q8_COMMON = ["-dim", "3", "-ok", "8", "-ot", "7", "-s", "7", "-vs", "1",
             "-ms", str(Q8_STEPS), "--precond", "jacobi", "-f", "-d", "cuda"]
Q8_SEDOV = ["-p", "1", "-rs", "3", "-cgt", "1e-11"] + Q8_COMMON
# the JAX row's own form: f32, Jacobi, the f32 CG tolerance
Q8_SEDOV_F32 = ["-p", "1", "-rs", "3", "-cgt", "2e-7", "--dtype",
                "f32"] + Q8_COMMON
Q8_TG = ["-p", "0", "-rs", "3", "-cgt", "1e-11"] + Q8_COMMON
Q8_OPT = dict(order_v=8, order_e=7, ode_solver=7, cg_tol=1e-11,
              precond="jacobi")
Q8_SIZES = dict(NE=4096, NQ=4096, h1=6440067, l2=2097152,
                lattice=(129, 129, 129))
# Sedov at Q8-Q7: the L2 (energy) CG stops at its 300-iteration cap far from
# convergence (the degree-7 Bernstein element mass has condition ~2.7e11 in
# 3D), so round-off in its right-hand side moves its solution, and |e| with
# it: tests/test_torch_high_order.py's bound for the JAX package against
# the port (4.8e-5 measured there), used here for the card against the CPU
Q8_SEDOV_E_TOL = 1e-4
# the JAX row's f32 form (-cgt 2e-7) against the f64 run (-cgt 1e-11): the
# capped L2 CG carries f32 round-off into |e| as it does a package's; the
# JAX package's own two forms are 3.2e-2 apart at step 2 at rs0, the port's
# 3.2e-2 at rs0 and rs1 (PERF.md, PR 10); the measured gap rounded up to its
# decade
Q8_F32_E_TOL = 1e-1


def steps_run(h, tag, layout=None, attempts=Q8_STEPS + 1, t_final=0.6,
              p="[18 high order]"):
    """`attempts` step attempts of `h` through driver.run, |e| at every
    step; on the card the launches are counted and must be one `layout`
    kernel a q-update.  Returns (result, counts, relative drift)."""
    from laghos_tpu_torch import driver

    card = h.device.type == "cuda"
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    calls = h.qupdate_calls
    reset_counts()
    t0 = time.perf_counter()
    res = driver.run(h, t_final=t_final, max_steps=attempts - 1,
                     vis_steps=1)
    if card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    if not (all(bool(torch.isfinite(res.S[k]).all()) for k in res.S)
            and math.isfinite(res.e_norm) and res.steps > 0):
        raise AssertionError(f"{tag}: {res.steps} steps, |e| {res.e_norm}")
    if card:
        _only(counts, layout, h.qupdate_calls - calls, tag)
    drift = abs(res.energy_final - res.energy_init) / abs(res.energy_init)
    norms = (f"|e| by step {dict(res.norms)}" if len(res.norms) <= 8
             else f"final |e| {res.e_norm:.13e}")
    log(f"{p} {tag}: NE {h.NE}, {res.steps} steps in {wall:.3f} s, "
        f"{norms}, drift {drift:.3e}, "
        f"CG H1 {res.h1_iters} ({res.h1_iters / (6 * res.steps):.2f} per "
        f"component solve), L2 {res.l2_iters} "
        f"({res.l2_iters / (2 * res.steps):.2f} per solve)"
        + (f", peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
           f"launches {counts}" if card else ""))
    return res, counts, drift


def _e_rel(a, b, tag, tol, p="[18 high order]"):
    """max relative |e| difference over the steps of two runs, which must
    have the same steps; raises above `tol`."""
    if sorted(a.norms) != sorted(b.norms) or a.steps != b.steps:
        raise AssertionError(f"{tag}: steps {sorted(a.norms)} against "
                             f"{sorted(b.norms)}")
    rel = max(abs(a.norms[k] - b.norms[k]) / abs(b.norms[k])
              for k in a.norms)
    steps = sorted(a.norms)
    shown = steps if len(steps) <= 8 else f"{steps[0]}..{steps[-1]}"
    log(f"{p} {tag}: max rel |e| over steps {shown}: {rel:.3e} (limit "
        f"{tol:g})")
    if not rel <= tol:
        raise AssertionError(f"{tag}: |e| apart by {rel:.3e} > {tol:g}")
    return rel


def phase_high_order(dev):
    """Q8-Q7 on the card: (a) 3D Sedov at rs3 (NE 4,096, 16.8M q-points)
    through the CLI on the lattice path with Jacobi in f64, with peak
    memory, setup seconds, step_ms and its phase split and the L2
    iterations a solve; (b) the mass kernel, the lattice mass kernel and
    the lattice-, element- and packed-layout q-point kernels, f64 and f32,
    at its q8 shapes against their plain twins (the element and packed
    data are its q-lattice data per zone: NE 4,096 x NQ 4,096);
    (c) the JAX row's own form (f32, -cgt 2e-7) at rs3, |e| within
    Q8_F32_E_TOL of (a)'s at every step; (d) 3D Taylor-Green at rs3,
    drift <= 1e-12; at rs2 (NE 512, NQ 4,096 as at rs3): (e)
    Taylor-Green on the lattice path twice, bitwise, and on the gather
    path, |e| at every step within 1e-11 of the lattice run's, drift <=
    1e-12 in both; (f) Sedov on the lattice path with kron (at most 3
    H1 iterations a component solve: exact on the affine mesh) and on
    the gather path, |e| within Q8_SEDOV_E_TOL of each other; (g) at
    rs0 (NE 8), the card against this machine's CPU: Taylor-Green |e|
    at every step within 1e-11, Sedov within Q8_SEDOV_E_TOL. Returns
    (launches, kernel numbers at q8, (d)'s (result, printed lines))."""
    p = "[18 high order]"
    t_phase = time.perf_counter()
    launches = {}

    def q8(device, rs, problem, **opt):
        """(Hydro at Q8-Q7 on cube01_hex refined `rs` times, setup s)."""
        t0 = time.perf_counter()
        h = flagship_hydro(device, rs=rs,
                           **{**Q8_OPT, "problem": problem, **opt})
        return h, time.perf_counter() - t0

    # (a) Sedov rs3, lattice, Jacobi, f64
    run, counts = flagship_run(Q8_SEDOV, "q8 sedov", phase="18",
                               drift_max=None)
    tally(launches, counts, "lattice")
    h, res_a = run.hydro, run.result
    sizes = dict(NE=h.NE, NQ=h.NQ, h1=3 * h.ndof, l2=h.NE * h.ld,
                 lattice=h._lat_dims)
    if sizes != Q8_SIZES:
        raise AssertionError(f"q8 sedov: sizes {sizes}")
    log(f"{p} (a) q8 sedov: L2 CG at its cap "
        f"({h.opt.cg_max_iter}) in {res_a.l2_iters} of "
        f"{h.opt.cg_max_iter * 2 * res_a.steps} iterations")

    # (b) the kernels at q8 shapes, against their plain twins: the mass
    # kernel on (a)'s tables and D (torch.bmm timed on seeded matrices:
    # q8's dense L2 matrices alone are 8.6 GB), then the q-point kernel
    timed = {}
    for dt, got in mass_checks(h, "18 mass q8", False, seed=18).items():
        timed["mass", dt] = got
    for dt, got in lattice_mass_checks(h, "18 lattice mass q8", 18).items():
        timed["lattice_mass", dt] = got
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lat = lattice_inputs(h, seed=18)
    for dt in (F64, F32):
        timed["lattice", dt] = compare("lattice", lat, dt,
                                       tag="18 kernel q8", h1order=8.0)
    el = eq_inputs(h, lat[0], "element")
    pk = eq_inputs(h, lat[0], "packed")
    del lat
    for dt in (F64, F32):
        timed["element", dt] = compare("element", el, dt,
                                       tag="18 kernel q8", h1order=8.0)
    del el
    # the packed layout (on no time-stepping path) at the same points
    for dt in (F64, F32):
        timed["packed", dt] = compare("packed", pk, dt, tag="18 kernel q8",
                                      h1order=8.0)
    del pk, run, h
    torch.cuda.empty_cache()
    log(f"{p} (b) peak device memory of the kernel checks (inputs, kernel "
        f"and plain twin at 16,777,216 points): "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # (c) the JAX row's form: f32, -cgt 2e-7
    run, counts = flagship_run(Q8_SEDOV_F32, "q8 sedov f32", phase="18",
                               drift_max=None)
    tally(launches, counts, "lattice", F32)
    _e_rel(run.result, res_a, "(c) sedov f32 -cgt 2e-7 vs f64 -cgt 1e-11",
           Q8_F32_E_TOL)
    del run
    torch.cuda.empty_cache()

    # (d) Taylor-Green rs3, phase 19's native reference
    run, counts = flagship_run(Q8_TG, "q8 taylor-green", phase="18")
    tally(launches, counts, "lattice")
    tg = (run.result, run.log)
    del run
    torch.cuda.empty_cache()

    # (e) Taylor-Green rs2: lattice twice, gather
    hl, s_l = q8(dev, 2, 0)
    tg_l, c, d_l = steps_run(hl, "(e) taylor-green rs2 lattice", "lattice")
    tally(launches, c, "lattice")
    tg_l2, c, _ = steps_run(hl, "(e) taylor-green rs2 lattice again",
                         "lattice")
    tally(launches, c, "lattice")
    same = all(torch.equal(tg_l.S[k], tg_l2.S[k]) for k in tg_l.S)
    log(f"{p} (e) lattice run repeated on its Hydro (setup {s_l:.3f} s): "
        f"final state bitwise equal {same}")
    if not same:
        raise AssertionError("18 (e): two q8 lattice runs differ")
    del hl, tg_l2
    hg, s_g = q8(dev, 2, 0, **GATHER)
    if hg._lat is not None:
        raise AssertionError("18 (e): the gather run built the lattice")
    tg_g, c, d_g = steps_run(hg, "(e) taylor-green rs2 gather", "element")
    tally(launches, c, "element")
    log(f"{p} (e) gather setup {s_g:.3f} s")
    del hg
    _e_rel(tg_g, tg_l, "(e) taylor-green rs2 gather vs lattice", 1e-11)
    if not (d_l <= 1e-12 and d_g <= 1e-12):
        raise AssertionError(f"18 (e): drift {d_l:.3e}, {d_g:.3e} > 1e-12")
    torch.cuda.empty_cache()

    # (f) Sedov rs2: lattice with kron, gather with Jacobi
    hk, s_k = q8(dev, 2, 1, precond="kron")
    if "kron" not in hk._lat:
        raise AssertionError("18 (f): no kron factors")
    sk, c, _ = steps_run(hk, "(f) sedov rs2 lattice kron", "lattice")
    tally(launches, c, "lattice")
    if not sk.h1_iters <= 3 * 6 * (Q8_STEPS + 1):
        raise AssertionError(f"18 (f): kron took {sk.h1_iters} H1 "
                             "iterations")
    del hk
    hg, s_g = q8(dev, 2, 1, **GATHER)
    sg, c, _ = steps_run(hg, "(f) sedov rs2 gather", "element")
    tally(launches, c, "element")
    del hg
    log(f"{p} (f) setup kron {s_k:.3f} s, gather {s_g:.3f} s")
    _e_rel(sg, sk, "(f) sedov rs2 gather (Jacobi) vs lattice (kron)",
           Q8_SEDOV_E_TOL)
    torch.cuda.empty_cache()

    # (g) rs0: the card against this machine's CPU
    for problem, name, tol in ((0, "taylor-green", 1e-11),
                               (1, "sedov", Q8_SEDOV_E_TOL)):
        hc, _ = q8(dev, 0, problem)
        rc, c, _ = steps_run(hc, f"(g) {name} rs0 card", "lattice")
        tally(launches, c, "lattice")
        hh, _ = q8("cpu", 0, problem)
        rh, _, _ = steps_run(hh, f"(g) {name} rs0 cpu")
        _e_rel(rc, rh, f"(g) {name} rs0 card vs cpu", tol)
        del hc, hh
    log(f"{p} launches {named(launches)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, timed, tg



# ------------------------------------------------------------ phase 19 --
# phase 18 (d) in the Ozaki mode: every contraction of the step an Ozaki
# product, so the split kernel meets the q8 shapes: the lattice stages at
# k = 129 and 256, the L2 pair's flat operands at k = 512 (the chunked
# branch's threshold) and k = 4,096 (chunked), 16.8M q-lattice points at 6
# slices in the q-update gradients
Q8_TG_OZ = Q8_TG + ["--ozaki"]
# an Ozaki run's |e| against the native run of the same call (PERF.md §2),
# here at every step, and its final velocity field, from solves converged
# to -cgt 1e-11 in both modes
OZ_E_TOL = 1e-9
OZ_V_TOL = 1e-9
_STEP_LINE = (r"step\s+(\d+),\s+t = ([\d.]+),\s+dt = ([\d.]+),|"
              r"Repeating step (\d+)")


def _printed_steps(out):
    """The (step, t, dt) of every printed step line and the step of every
    "Repeating step" line, in order, as printed."""
    return re.findall(_STEP_LINE, out)


def l2_pair_operands(h, e):
    """The two flat operands that the Ozaki L2 mass apply of `h`
    (`ops/mass.mass_apply_e`, the energy CG's operator) splits when it
    applies to the L2 field e (NE, ld): e itself (k = ld) and its
    q-point values times the mass weights, (NE, NQ) (k = NQ)."""
    from laghos_tpu_torch.ops import omm

    fwd, _ = h.oz["l2"]
    return [e.contiguous(), (omm.matmul(e, fwd) * h.massD).contiguous()]


def phase_ozaki_q8(dev, tg):
    """Q8-Q7 in the Ozaki mode on the card: (a) 3D Taylor-Green at rs3
    (NE 4,096, 16,777,216 q-points) through the CLI with --ozaki, on the
    lattice path with the IR velocity solve, against phase 18 (d)'s native
    run `tg` = (result, printed lines): the same printed step lines, t and
    dt at the end within 1e-12, |e| at every step within OZ_E_TOL, the
    final velocity field within OZ_V_TOL, drift <= 1e-12, with setup
    seconds, step_ms and its phase split, the H1 inner sweeps and outers
    and the L2 iterations a solve, peak memory and the split launches; (b)
    the split kernel against its plain twin, bit for bit, at the q8
    shapes: the six stage operands of one Ozaki mass apply of (a)'s Hydro
    (8 and 6 slices), the L2 pair's flat operands (NE, 512) and (NE, 4096)
    of (a)'s final energy field and mixed-magnitude operands of those
    widths with zero, NaN and Inf rows (8, 6 and 4 slices), each timed at
    8 slices.  Returns (launches, the kernels-line numbers at q8: the six
    stages' sums)."""
    p = "[19 ozaki q8]"
    t_phase = time.perf_counter()
    res_n, log_n = tg
    # (a) Taylor-Green rs3 --ozaki against phase 18 (d)
    run, counts = flagship_run(Q8_TG_OZ, "q8 taylor-green ozaki", phase="19")
    launches = {}
    tally(launches, counts, "lattice")
    h, res = run.hydro, run.result
    sizes = dict(NE=h.NE, NQ=h.NQ, h1=3 * h.ndof, l2=h.NE * h.ld,
                 lattice=h._lat_dims)
    if sizes != Q8_SIZES or h._lat_oz is None:
        raise AssertionError(f"q8 ozaki: sizes {sizes}, lattice_oz "
                             f"{h._lat_oz is not None}")
    lines, ref = _printed_steps(run.log), _printed_steps(log_n)
    if lines != ref:
        raise AssertionError(f"q8 ozaki: printed steps {lines} against the "
                             f"native run's {ref}")
    t_rel = abs(res.t - res_n.t) / res_n.t
    dt_rel = abs(res.dt - res_n.dt) / res_n.dt
    log(f"{p} (a) printed step lines equal the native run's ({len(lines)} "
        f"lines); at the end t rel {t_rel:.3e}, dt rel {dt_rel:.3e} "
        "(limit 1e-12)")
    if not (t_rel <= 1e-12 and dt_rel <= 1e-12):
        raise AssertionError("q8 ozaki: t or dt departs from the native run")
    _e_rel(res, res_n, "(a) taylor-green rs3 ozaki vs native", OZ_E_TOL, p)
    # |e| moves ~5e-10 a step here, so the fields say more: v comes from
    # velocity solves converged to -cgt 1e-11 in both modes; the energy's
    # change from L2 solves stopped at their cap (ROADMAP C6), whose
    # iterates ride on round-off (not gated)
    v, vn = res.S["v"], res_n.S["v"]
    v_rel = float((v - vn).abs().max() / vn.abs().max())
    de, de_n = res.S["e"] - h.S0["e"], res_n.S["e"] - h.S0["e"]
    de_rel = float((de - de_n).abs().max() / de_n.abs().max())
    log(f"{p} (a) final v rel {v_rel:.3e} (limit {OZ_V_TOL:g}); the "
        f"energy field's change since t = 0 rel {de_rel:.3e} (capped L2 "
        "CG, not gated)")
    if not v_rel <= OZ_V_TOL:
        raise AssertionError(f"q8 ozaki: v departs from the native run by "
                             f"{v_rel:.3e}")

    # (b) the split kernel at the q8 shapes
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(19)
    timed = stage_splits(h, rng, "19 split q8")
    for A, what in zip(l2_pair_operands(h, res.S["e"]),
                       ("L2 pair operand e (NE, ld)",
                        "L2 pair operand (B e) D (NE, NQ)")):
        for S in (8, 6, 4):
            _split_bitwise(A, S, what, axis=-1)
        _time_split(A, what, "19 split q8")
    for k in (h.ld, h.NQ):
        # mixed magnitudes (2^-30 to 2^30), a zero, a NaN and an Inf row
        A = torch.tensor(rng.standard_normal((67, k)) * np.exp2(
            rng.integers(-30, 30, (67, k))), device=h.device)
        A[1] = 0.0
        A[4, 7] = float("nan")
        A[-1, -1] = float("inf")
        for S in (8, 6, 4):
            d = _split_bitwise(A, S, f"mixed (67, {k})", axis=-1)
        nan_rows = int(torch.isnan(d.scale).sum())
        if nan_rows != 2:
            raise AssertionError(f"mixed (67, {k}): {nan_rows} NaN-scale "
                                 "rows, expected 2")
    log(f"{p} (b) mixed-magnitude operands (67, {h.ld}) and (67, {h.NQ}) "
        "with zero, NaN and Inf rows: bitwise equal at S = 8, 6, 4; peak "
        f"device memory of the split checks "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del run, h, res
    torch.cuda.empty_cache()
    log(f"{p} launches {named(launches)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches, timed


# ------------------------------------------------------------ phase 20 --
# BASELINE.json configs[3], the triple point (-p 3) under RK2Avg, on a 7 x 3
# x 3 box whose element faces lie on the material interfaces (x = 1, y = z
# = 1.5: laghos_tpu_torch/problems.py), written as an MFEM file and read by
# -m; the built-in box01_hex (uniform 4 x 2 x 2) puts element interiors
# across them, where RK2Avg does not conserve the printed energy (ROADMAP
# C7).  rs2: 1,792 zones, Q2-Q1, 51 step attempts
TP_BOX = ((7, 2, 2), (7.0, 3.0, 3.0))
TP_ARGS = ["-p", "3", "-dim", "3", "-rs", "2", "-s", "7", "-cgt", "1e-14",
           "-tf", "5.0", "-ms", "50", "-vs", "1"]
TP_OPT = dict(problem=3, ode_solver=7, cg_tol=1e-14)
# (c)'s CPU run goes in a process of its own, started before phase 19 so
# that it runs beside phase 19's card work; its torch threads leave cores
# to this process's host work
TP_CPU_THREADS = 4
TP_CPU_TIMEOUT = 600.0
_TP_CPU = ("import json, sys\n"
           "from laghos_tpu_torch import cli\n"
           "res = cli.main(sys.argv[1:]).result\n"
           "print('NORMS ' + json.dumps(sorted(res.norms.items())))\n")


class TriplePointCpu:
    """The aligned box's mesh file and the CLI run of phase 20 on this
    machine's CPU, in a child process started here (`python -c`, from the
    checkout's root, TP_CPU_THREADS torch threads); `close()` stops it if
    it still runs and removes the file."""

    def __init__(self):
        import os
        import tempfile

        from laghos_tpu_torch.fem import mesh as fmesh

        self._tmp = tempfile.TemporaryDirectory()
        self.path = os.path.join(self._tmp.name, "box_aligned.mesh")
        fmesh.write_mfem_mesh(fmesh.cartesian(3, *TP_BOX), self.path)
        env = dict(os.environ, OMP_NUM_THREADS=str(TP_CPU_THREADS))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _TP_CPU, "-m", self.path] + TP_ARGS
            + ["-d", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def result(self):
        """(printed step lines, {step: |e|}, wall s) of the finished run;
        raises if it failed or outlasts TP_CPU_TIMEOUT."""
        out, err = self.proc.communicate(timeout=TP_CPU_TIMEOUT)
        wall = time.perf_counter() - self.t0
        tail = [ln for ln in out.splitlines() if ln.startswith("NORMS ")]
        if self.proc.returncode != 0 or len(tail) != 1:
            raise AssertionError(f"the triple point's CPU run failed (exit "
                                 f"{self.proc.returncode}): {err[-2000:]}")
        norms = {int(k): v for k, v in json.loads(tail[0][6:])}
        return _printed_steps(out), norms, wall

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()
        self._tmp.cleanup()


def phase_triple_point(dev, cpu=None):
    """The triple point on the interface-aligned box at rs2: (a) through
    the CLI on the lattice path (the q-lattice kernel, f64), drift <=
    1e-12; (b) the gather path (the element kernel) on the same mesh
    through driver.run, |e| at every step within 1e-11 of (a)'s and drift
    <= 1e-12; (c) (a)'s command on this machine's CPU (`cpu`, a
    TriplePointCpu started earlier, or one started here): the same
    printed step lines, |e| at every step within 1e-11.  Returns the
    launches."""
    from types import SimpleNamespace

    from laghos_tpu_torch.hydro import Hydro, Options

    p = "[20 triple point]"
    t_phase = time.perf_counter()
    own = cpu is None
    if own:
        cpu = TriplePointCpu()
    try:
        argv = ["-m", cpu.path] + TP_ARGS
        # (a) the lattice path through the CLI
        run, counts = flagship_run(argv + ["-f", "-d", "cuda"],
                                   "triple point lattice", phase="20")
        res_l, log_l = run.result, run.log
        ne = 28 * 8 ** int(TP_ARGS[TP_ARGS.index("-rs") + 1])
        if run.hydro.NE != ne:
            raise AssertionError(f"triple point: NE {run.hydro.NE}, not "
                                 f"{ne}")
        launches = {}
        tally(launches, counts, "lattice")
        mesh = run.hydro.mesh
        del run
        # (b) the gather path on the same mesh
        hg = Hydro(mesh, Options(**TP_OPT, **GATHER), device=dev)
        if hg._lat is not None:
            raise AssertionError("triple point: the gather run built the "
                                 "lattice")
        attempts = int(TP_ARGS[TP_ARGS.index("-ms") + 1]) + 1
        res_g, c, drift = steps_run(hg, "(b) gather", "element", attempts,
                                    t_final=5.0, p=p)
        tally(launches, c, "element")
        if not drift <= 1e-12:
            raise AssertionError(f"triple point gather: drift {drift:.3e}")
        _e_rel(res_g, res_l, "(b) gather vs lattice", 1e-11, p)
        del hg
        # (c) the same command on the CPU
        t0 = time.perf_counter()
        lines, norms, wall = cpu.result()
        ref = _printed_steps(log_l)
        log(f"{p} (c) cpu: {len(norms)} steps in {wall:.3f} s from its "
            f"start ({TP_CPU_THREADS} threads; waited "
            f"{time.perf_counter() - t0:.3f} s for it here); printed step "
            f"lines equal the card's: {lines == ref}")
        if lines != ref:
            raise AssertionError("triple point: the CPU run's step lines "
                                 "differ from the card's")
        _e_rel(res_l, SimpleNamespace(norms=norms, steps=len(norms)),
               "(c) card vs cpu", 1e-11, p)
    finally:
        if own:
            cpu.close()
    log(f"{p} launches {named(launches)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def main():
    t0 = time.perf_counter()
    marks = [("", t0)]

    def mark(name):
        """The wall seconds of the phases since the last mark, for the
        budget of the script (PERF.md §4); each also on standard error,
        so a run cut at its time limit shows how far it came."""
        marks.append((name, time.perf_counter()))
        print(f"[chip_smoke] phase {name} done: "
              f"{marks[-1][1] - marks[-2][1]:.1f} s, "
              f"{marks[-1][1] - t0:.1f} s in all", file=sys.stderr,
              flush=True)

    dev = phase_device()
    mark("1 device")
    # nvcc builds the kernels on the host's cores while phase 15 runs on
    # the card: the AMR path launches no hand-written kernel
    from laghos_tpu_torch.ops import kernels
    with ThreadPoolExecutor(1) as ex:
        building = ex.submit(kernels.build)
        amr_refs = phase_amr(dev)
        mark("15 amr (beside the build)")
        built = building.result()
    phase_build(built)
    mark("2 build")
    timed = phase_kernel(dev)
    mark("3 kernel")
    phase_goldens(dev)
    mark("4 goldens")
    launches, timed_ns4 = phase_flagship(dev)
    mark("5 flagship")
    phase_golden_rows()
    mark("7 golden rows")
    # the -fa runs launch the element kernel alone (fa_run's _only holds
    # their split and mass counts at 0)
    fa_res, n_fa, library = phase_fa(dev)
    launches[("element", F64)] += n_fa
    for dt, ms in library.items():
        timed["lattice_mass", dt]["library_ms"] = ms
    mark("8 fa")
    more, ckpt_ref = phase_checkpoint()
    merge(launches, more)
    mark("9 checkpoint")
    merge(launches, phase_io())
    mark("10 io")
    launches[("element", F64)] += phase_repeat(dev, fa_res)
    mark("6 repeat")
    ref, ref_setup, more, refs = phase_device_loop(dev)
    merge(launches, more)
    mark("11 device loop")
    merge(launches, phase_solver_options(dev, ref, ref_setup))
    mark("12 solver options")
    more, digests = phase_sweep(dev)
    merge(launches, more)
    mark("13 sweep")
    phase_simplex(dev)
    mark("14 simplex")
    merge(launches, phase_distributed(dev, ref, refs["gather"], refs["ozaki"],
                                      ckpt_ref, digests))
    mark("16 distributed")
    # the AMR path launches no hand-written kernel (phase 17 raises if one
    # does): its launches add 0 to every entry
    phase_amr_distributed(dev, amr_refs)
    mark("17 amr ranks")
    more, timed_q8, tg = phase_high_order(dev)
    merge(launches, more)
    mark("18 high order")
    # phase 20's CPU run, beside phase 19
    cpu = TriplePointCpu()
    try:
        more, timed_q8["split"] = phase_ozaki_q8(dev, tg)
        del tg
        merge(launches, more)
        mark("19 ozaki q8")
        merge(launches, phase_triple_point(dev, cpu))
        mark("20 triple point")
    finally:
        cpu.close()
    log("phase seconds: " + ", ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in
        enumerate(marks[1:])))
    # launches come from the main-path runs only; the packed layout is on
    # none of them.  The timed numbers are at the flagship's shapes; "q8"
    # holds them at phase 18's (16,777,216 points) and, for the split, at
    # phase 19's
    kernels = [dict(name=f"qphys_{layout}_{str(dt)[6:]}", route="cuda",
                    source=SOURCE, replaces=LAYOUTS[layout][1][dt],
                    launches=launches.get((layout, dt), 0),
                    on_path=layout != "packed", **timed[layout, dt],
                    **({"q8": timed_q8[layout, dt]}
                       if (layout, dt) in timed_q8 else {}))
               for layout in LAYOUTS for dt in (F64, F32)]
    kernels.append(dict(name="split_f64", route="cuda", source=SPLIT_SOURCE,
                        replaces=SPLIT_REPLACES,
                        launches=launches.get("split", 0), on_path=True,
                        **timed["split"], q8=timed_q8["split"]))
    kernels += [dict(name=f"mass_apply_{str(dt)[6:].replace('loat', '')}",
                     route="cuda", source=MASS_SOURCE, replaces=MASS_REPLACES,
                     launches=launches.get(("mass", dt), 0), on_path=True,
                     **timed["mass", dt], q8=timed_q8["mass", dt])
                for dt in (F64, F32)]
    kernels += [dict(name=f"lattice_mass_{str(dt)[6:].replace('loat', '')}",
                     route="cuda", source=LATTICE_MASS_SOURCE,
                     replaces=LATTICE_MASS_REPLACES,
                     launches=launches.get(("lattice_mass", dt), 0),
                     on_path=True, **timed["lattice_mass", dt],
                     ns4=timed_ns4[dt], q8=timed_q8["lattice_mass", dt])
                for dt in (F64, F32)]
    for dt in (F64, F32):
        steps = launches.get(("cg_step", dt), 0)
        if launches.get(("cg_ess_dot", dt), 0) != steps:
            raise AssertionError(f"cg chain {dt}: {steps} steps, "
                                 f"{launches.get(('cg_ess_dot', dt), 0)} "
                                 f"mask-and-dot launches")
        kernels.append(dict(name=f"cg_chain_{str(dt)[6:].replace('loat', '')}",
                            route="cuda", source="laghos_tpu_torch/csrc/cg.cu",
                            replaces=None, launches=steps, on_path=True,
                            **timed["cg"][dt]))
    idle = [k["name"] for k in kernels if k["on_path"] and not k["launches"]]
    if idle:
        raise AssertionError(f"kernels of the path never launched: {idle}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
