"""Process groups and the collectives of a distributed run.

The port's counterpart of the JAX package's device `Mesh` with `ppermute`,
`psum` and `pmin` (`laghos_tpu/parallel/slab_hydro.py`): one process per
rank on `torch.distributed`, each holding a `Comm`.

Backends, chosen by the caller (nothing switches on its own):
- gloo for CPU ranks;
- NCCL for card ranks that each have their own card (NCCL refuses two
  ranks on one card, so `launch` raises for more NCCL ranks than cards);
- gloo with explicit host staging when ranks share a card: gloo's send
  and recv take CPU tensors only, so `exchange` copies each plane through
  a pinned host buffer, and the all-reduces go through host copies.

A gloo isend of float32 into an irecv of float64 delivers garbage without
an error, so the first `exchange` of each (peer, dtype, shape) swaps a
header (dtype and shape) with the peer and raises when the peer's does not
match what this rank expects.  The rank views' layouts are fixed once
built, so later exchanges of a checked (peer, dtype, shape) skip the
header round (and, on NCCL, its host read).

`launch` starts the ranks as spawned processes (CUDA cannot start in a
forked child) that meet through a `file://` store in a fresh temporary
directory (no TCP port to collide), runs `fn(comm, *args)` on each and
returns their results in rank order; any rank's exception is raised in the
caller with that rank's traceback, and the other ranks are stopped.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# dtype codes of the exchange header
_CODES = {torch.float64: 0, torch.float32: 1, torch.int64: 2,
          torch.int32: 3, torch.bool: 4, torch.uint8: 5}
_HEADER = 8          # dtype code, ndim, up to 6 extents


class Comm:
    """This process's rank in a process group: its device, the backend and
    the collectives the rank views use.  Every collective is called by
    every rank of the group in the same order."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 backend: str):
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        # gloo with card tensors: every transfer goes through the host
        self.staged = backend == "gloo" and device.type == "cuda"
        self._wire = device if backend == "nccl" else torch.device("cpu")
        self._pinned = {}
        self._checked = set()          # (peer, shape, dtype) headers swapped

    def __repr__(self):
        return (f"Comm(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    # ---------------------------------------------------- all-reduces --
    def _allreduce(self, t, op):
        out = t.to(self._wire, copy=True)
        dist.all_reduce(out, op=op)
        return out.to(t.device)

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks (a new tensor on t's device)."""
        return self._allreduce(t, dist.ReduceOp.SUM)

    def allreduce_min(self, t: torch.Tensor) -> torch.Tensor:
        return self._allreduce(t, dist.ReduceOp.MIN)

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._allreduce(t, dist.ReduceOp.MAX)

    def all_gather(self, obj) -> list:
        """Every rank's `obj` (picklable, small or host-side), in rank
        order, on every rank."""
        out = [None] * self.size
        dist.all_gather_object(out, obj)
        return out

    # ------------------------------------------------------- exchange --
    def _buffer(self, t, slot):
        """A pinned host buffer for `t`'s shape and dtype (one per slot, so
        a send and a receive never share one)."""
        key = (tuple(t.shape), t.dtype, slot)
        buf = self._pinned.get(key)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[key] = buf
        return buf

    def _header(self, t):
        if t.dtype not in _CODES or t.dim() > _HEADER - 2:
            raise TypeError(f"exchange takes tensors of {list(_CODES)} with "
                            f"at most {_HEADER - 2} dimensions, got {t.dtype} "
                            f"{tuple(t.shape)}")
        h = [_CODES[t.dtype], t.dim()] + list(t.shape)
        h += [-1] * (_HEADER - len(h))
        return torch.tensor(h, dtype=torch.int64, device=self._wire)

    def exchange(self, sends: dict) -> dict:
        """Send `sends[peer]` to each peer and receive from each a tensor
        of the same dtype and shape: {peer: received tensor} on this
        rank's device.  Every peer must call exchange with this rank among
        its own peers.  On the first exchange of a (peer, dtype, shape) the
        two ranks swap headers (dtype and shape) and raise ValueError,
        before any plane moves, if the peer's differs from what this rank
        sends it."""
        peers = sorted(sends)
        ts = {p: sends[p].contiguous() for p in peers}
        for p in peers:
            if ts[p].device != self.device:
                raise ValueError(f"rank {self.rank}: exchange tensor on "
                                 f"{ts[p].device}, the rank is on "
                                 f"{self.device}")
        keys = {p: (p, tuple(ts[p].shape), ts[p].dtype) for p in peers}
        new = [p for p in peers if keys[p] not in self._checked]
        hdrs = {p: self._header(ts[p]) for p in new}
        got = {p: torch.empty_like(hdrs[p]) for p in new}
        _wait([op for p in new for op in (
            dist.P2POp(dist.isend, hdrs[p], p, tag=0),
            dist.P2POp(dist.irecv, got[p], p, tag=0))])
        for p in new:
            if not torch.equal(hdrs[p].cpu(), got[p].cpu()):
                raise ValueError(
                    f"rank {self.rank}: exchange with rank {p} does not "
                    f"match: the peer sends {_describe(got[p])}, this rank "
                    f"expects {_describe(hdrs[p])}")
            self._checked.add(keys[p])
        ops, recvs = [], {}
        for p in peers:
            if self.staged:
                sbuf = self._buffer(ts[p], ("send", p))
                sbuf.copy_(ts[p])
                rbuf = self._buffer(ts[p], ("recv", p))
            else:
                sbuf, rbuf = ts[p], torch.empty_like(ts[p])
            ops += [dist.P2POp(dist.isend, sbuf, p, tag=1),
                    dist.P2POp(dist.irecv, rbuf, p, tag=1)]
            recvs[p] = rbuf
        _wait(ops)
        if self.staged:
            return {p: r.to(self.device, copy=True) for p, r in recvs.items()}
        return recvs

    def close(self):
        self._pinned.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def _wait(ops):
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _describe(hdr):
    code, ndim, *ext = hdr.tolist()
    names = {v: k for k, v in _CODES.items()}
    return f"{names.get(code, code)} {tuple(ext[:ndim])}"


def rank_device(rank: int, device: str) -> torch.device:
    """Rank r's device: cuda:{r % card count}, or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"device must be cpu or cuda, got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks requested but torch.cuda.is_available()"
                           " is False")
    return torch.device("cuda", rank % torch.cuda.device_count())


def default_backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


def check_backend(backend: str, device: str, world: int):
    """Raise unless `backend` can run `world` ranks on `device`."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {backend!r}")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("nccl runs ranks on cards only; CPU ranks run "
                             "with the gloo backend")
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise ValueError(
                f"nccl needs a card per rank: {world} ranks, {cards} card(s)"
                "; ranks that share a card run with the gloo backend "
                "(--dist-backend gloo)")


# how long a rank waits in one collective before it raises (a rank that
# left lockstep or died fails its peers instead of hanging them)
COLLECTIVE_TIMEOUT = 600.0


def init(rank: int, world: int, backend: str, device: str,
         init_method: str, timeout: float = COLLECTIVE_TIMEOUT) -> Comm:
    """Join the process group at `init_method` (a file:// store) as `rank`
    of `world` and return the rank's Comm; a collective that waits longer
    than `timeout` seconds raises."""
    check_backend(backend, device, world)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return Comm(rank, world, dev, backend)


class single:
    """`with single(backend, device) as comm:` a group of one rank in this
    process (world size 1), closed on exit; `device` as in `launch`."""

    def __init__(self, backend: str = None, device: str = "cuda",
                 timeout: float = COLLECTIVE_TIMEOUT):
        self.backend = backend or default_backend(device)
        self.device = device
        self.timeout = timeout

    def __enter__(self) -> Comm:
        self._tmp = tempfile.TemporaryDirectory(prefix="laghos_dist_")
        try:
            self.comm = init(0, 1, self.backend, self.device,
                             f"file://{self._tmp.name}/store", self.timeout)
        except BaseException:
            self._tmp.cleanup()
            raise
        return self.comm

    def __exit__(self, *exc):
        try:
            self.comm.close()
        finally:
            self._tmp.cleanup()


def _rank_main(fn, args, rank, world, backend, device, init_method,
               results):
    """A spawned rank: join the group, run fn(comm, *args), report the
    pickled result or the traceback on `results`."""
    # CPU ranks share the cores: one thread each
    n_threads = 1 if device == "cpu" else max(1, (os.cpu_count() or 1)
                                               // world)
    torch.set_num_threads(n_threads)
    comm = None
    try:
        comm = init(rank, world, backend, device, init_method)
        msg = ("ok", rank, pickle.dumps(fn(comm, *args)))
    except Exception:                  # reported to the launcher, which raises
        msg = ("err", rank, traceback.format_exc())
    results.put(msg)
    results.close()
    results.join_thread()          # flushed before the process can leave
    if msg[0] == "err":
        # the other ranks may wait in a collective: leave without tearing
        # the group down; the launcher stops them
        os._exit(1)
    comm.close()


def launch(fn, world: int, backend: str = None, device: str = "cuda", *args,
           timeout: float = None) -> list:
    """Run `fn(comm, *args)` on `world` spawned ranks and return their
    results in rank order.

    `fn` must be importable (a module-level function) and its arguments
    and result picklable; the ranks import no test module.  `device` is
    "cuda" (the default: without a card it raises) or "cpu"; `backend`
    defaults to nccl on "cuda" and gloo on "cpu".  Raises RuntimeError
    with the failing ranks' tracebacks if any rank raises or dies, and
    TimeoutError if the ranks have not all finished within `timeout`
    seconds (None: no limit on the run; a rank blocked in one collective
    for COLLECTIVE_TIMEOUT seconds fails anyway, so a deadlock fails
    instead of hanging); the other ranks are stopped either way."""
    backend = backend or default_backend(device)
    check_backend(backend, device, world)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA ranks requested but torch.cuda.is_available()"
                           " is False")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="laghos_dist_") as tmp:
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world, backend, device,
                                   f"file://{tmp}/store", results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done, failed = {}, {}
        try:
            done, failed = _collect(results, procs, timeout)
        finally:
            # ranks that reported are leaving on their own; stop the rest
            for r, p in enumerate(procs):
                if r in done and not failed:
                    p.join(timeout=30.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10.0)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failed:
        if "timeout" in failed:
            raise TimeoutError(failed["timeout"])
        raise RuntimeError("distributed run failed:\n" + "\n".join(
            f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
    return [pickle.loads(done[r]) for r in range(world)]


def _collect(results, procs, timeout):
    """Read every rank's report; stop early (after a short grace for the
    other ranks' own reports) once one has failed or died."""
    world = len(procs)
    done, failed = {}, {}
    deadline = None if timeout is None else time.monotonic() + timeout
    grace = None
    while len(done) + len(failed) < world:
        now = time.monotonic()
        if grace is not None and now > grace:
            break
        if deadline is not None and now > deadline:
            failed["timeout"] = (f"the {world} ranks did not finish within "
                                 f"{timeout:g} s")
            break
        try:
            kind, rank, payload = results.get(timeout=0.5)
        except queue.Empty:
            for r, p in enumerate(procs):
                if (p.exitcode not in (None, 0) and r not in done
                        and r not in failed):
                    failed[r] = f"exited with code {p.exitcode}"
            if failed and grace is None:
                grace = time.monotonic() + 5.0
            continue
        (done if kind == "ok" else failed)[rank] = payload
        if failed and grace is None:
            grace = time.monotonic() + 5.0
    return done, failed
