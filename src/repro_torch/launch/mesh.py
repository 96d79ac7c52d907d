"""Process groups for the distributed engine: the port's counterpart of
``repro/launch/mesh.py::make_host_mesh``.

Where the reference maps P workers onto P devices of one process with a
``Mesh``, the port runs one process per rank, each a member of a
``torch.distributed`` process group, and calls ``solve`` in every one of
them (SPMD).  ``process_group`` opens such a group in the calling process
(a world of one runs the distributed engine at P = 1 in-process);
``run_workers`` starts ``workers`` processes and runs a function in each.

The rendezvous is a ``FileStore`` in a temporary directory: no network
port is opened for it.  The backend is always the caller's explicit
choice, never switched automatically:

* ``"nccl"`` where each rank owns a card (rank r takes ``cuda:r``), which
  one card cannot show;
* ``"gloo"`` where the ranks share a card or run on the CPU (every rank
  computes on ``device``; gloo sums CUDA tensors too).
"""
from __future__ import annotations

import contextlib
import io
import tempfile
import time
import traceback
from multiprocessing import connection, resource_tracker
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (choose from "
                         f"{BACKENDS})")


@contextlib.contextmanager
def process_group(backend: str, store_dir, *, rank: int = 0,
                  world_size: int = 1):
    """This process's default ``torch.distributed`` group for the ``with``
    block, as rank ``rank`` of ``world_size``; the ranks meet through the
    file ``store_dir/store``.  Yields the group (``dist.group.WORLD``)."""
    _check_backend(backend)
    store = dist.FileStore(str(Path(store_dir) / "store"), world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def _rank_device(backend: str, device, rank: int) -> torch.device:
    """The device rank ``rank`` computes on: ``cuda:rank`` under nccl,
    ``device`` itself under gloo."""
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"nccl needs CUDA devices, got {device}")
        return torch.device("cuda", rank)
    return device


def _worker(rank, fn, args, workers, backend, device, store_dir, conn):
    try:
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        with process_group(backend, store_dir, rank=rank,
                           world_size=workers) as group:
            out = fn(group, dev, *args)
        buf = io.BytesIO()
        if rank == 0:
            torch.save(out, buf)
        conn.send((None, buf.getvalue()))
    except BaseException:
        conn.send((traceback.format_exc(), None))
        raise
    finally:
        conn.close()


def run_workers(fn, workers: int, *args, backend: str, device,
                timeout: float = 600.0):
    """Run ``fn(group, device, *args)`` in ``workers`` new processes, one
    rank of one process group each, and return rank 0's result.

    ``fn`` must be a module-level function (the processes are started with
    the ``spawn`` method, which imports it by name; ``fork`` after CUDA is
    initialised breaks).  Rank 0's result comes back through
    ``torch.save``, its tensors on the CPU.  A rank that raises or dies,
    or a run longer than ``timeout`` seconds, ends every rank and raises.
    Every process it starts has ended when it returns or raises: the ranks
    and, unless the caller already ran one, the resource tracker that the
    ``spawn`` method starts beside them.
    """
    _check_backend(backend)
    if backend == "nccl" and torch.cuda.device_count() < workers:
        raise ValueError(f"nccl with {workers} ranks needs {workers} cards, "
                         f"found {torch.cuda.device_count()}")
    ctx = mp.get_context("spawn")
    # Each rank answers through a pipe of its own: a pipe holds no named
    # semaphore (a Queue does), so nothing of this call needs the tracker
    # once the ranks have ended, and it can be stopped below.
    tracker = resource_tracker._resource_tracker
    own_tracker = tracker._pid is None
    with tempfile.TemporaryDirectory() as store_dir:
        pipes = [ctx.Pipe(duplex=False) for _ in range(workers)]
        procs = [ctx.Process(target=_worker,
                             args=(r, fn, args, workers, backend, device,
                                   store_dir, pipes[r][1]))
                 for r in range(workers)]
        done = False
        try:
            for p in procs:
                p.start()
            for _, send in pipes:
                send.close()
            pending = {recv: r for r, (recv, _) in enumerate(pipes)}
            payload = {}
            deadline = time.monotonic() + timeout
            while pending:
                ready = connection.wait(list(pending), timeout=1.0)
                for recv in ready:
                    rank = pending.pop(recv)
                    try:
                        err, data = recv.recv()
                    except EOFError:
                        raise RuntimeError(f"rank {rank} died without a "
                                           "result") from None
                    if err is not None:
                        raise RuntimeError(f"rank {rank} failed:\n{err}")
                    payload[rank] = data
                if pending and time.monotonic() > deadline:
                    raise TimeoutError(f"{workers} ranks did not finish in "
                                       f"{timeout} s")
            done = True
        finally:
            for p in procs:
                if p.pid is None:
                    continue
                p.join(timeout=60 if done else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            for recv, send in pipes:
                recv.close()
                send.close()
            if own_tracker:
                tracker._stop()
    return torch.load(io.BytesIO(payload[0]), map_location="cpu",
                      weights_only=False)
