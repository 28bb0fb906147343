"""Run a function as the ranks of a new `torch.distributed` world on this
host: one spawned process per rank.

`run_ranks(fn, n, args, device=...)` starts n processes, gives each a
process group over `tcp://127.0.0.1:<free port>` and calls
`fn(rank, n, device, *args)`, where `device` is the rank's device:
`cpu`, or card `rank % cuda.device_count()`.  The backend follows
mesh.default_backend: NCCL when every rank has a card of its own, gloo
when ranks share a card (NCCL refuses two ranks on one card) or run on
the CPU.  The ranks' return values come back in rank order; they must
pickle without torch (numpy arrays, numbers).  A rank that raises, dies
or outlives `timeout` ends the whole world, and `run_ranks` raises.

`fn` is pickled by reference, so it must live at the top level of a
module that the children can import; they import nothing else of the
caller (spawn, not fork).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import Device, default_device
from .mesh import default_backend


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, port, kind, timeout, fn, args, results):
    try:
        if kind == "cpu":
            torch.set_num_threads(1)
            device = torch.device("cpu")
        else:
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        dist.init_process_group(
            default_backend(device, n), init_method=f"tcp://127.0.0.1:{port}",
            rank=rank, world_size=n, timeout=timedelta(seconds=timeout))
        try:
            out = fn(rank, n, device, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def run_ranks(fn, n: int, args: tuple = (), *,
              device: Device = default_device(), timeout: float = 600.0
              ) -> list:
    """fn(rank, n, rank_device, *args) on n spawned ranks; their return
    values in rank order.  Only the type of `device` counts: the cards
    (the default; raises without one) or the CPU."""
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks: no CUDA device (pass device='cpu' "
                           "for a CPU world)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n, port, kind, timeout, fn, args, results)) for r in range(n)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                rank, err, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} died with exit codes "
                                       f"{[procs[r].exitcode for r in dead]}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks: no result from ranks "
                                       f"{sorted(set(range(n)) - set(out))} "
                                       f"after {timeout:.0f} s")
                continue
            if err is not None:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{err}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
    return [out[r] for r in range(n)]
