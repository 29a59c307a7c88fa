"""Local process groups for the port's data-parallel checks: ``fn(mesh,
*args)`` run in a few spawned processes on this host, joined in one
``torch.distributed`` group with its own collective timeout and a
wall-clock limit on the whole run, so that a rank that dies or hangs fails
the caller instead of blocking it. ``tests/test_torch_parallel.py`` runs
its CPU ranks over gloo with it, and ``chip_smoke.py`` its ranks that
share one card."""

import datetime
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

from unet_convlstm_tpu_torch.parallel.mesh import make_mesh


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_rank_main(rank, nprocs, port, backend, timeout_s, fn, args,
                     results):
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=nprocs, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(make_mesh(group=dist.group.WORLD), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_local_ranks(fn: Callable, nprocs: int, args: tuple = (),
                    backend: str = "gloo", timeout_s: float = 300.0,
                    group_timeout_s: float = 60.0) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``nprocs`` spawned processes joined in one
    process group on localhost; returns the ranks' results in rank order.
    ``fn`` must be importable by name and its result picklable. The group's
    collectives time out after ``group_timeout_s`` and the whole run after
    ``timeout_s`` of wall time: a rank that dies or hangs fails the run
    (the others are killed) instead of blocking the caller."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_local_rank_main,
                         args=(r, nprocs, port, backend, group_timeout_s, fn,
                               args, results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, errors = {}, []
    try:
        while len(got) + len(errors) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} local ranks did not finish in "
                                   f"{timeout_s:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and not results.qsize():
                    raise RuntimeError(
                        f"a local rank exited with code {dead[0].exitcode} "
                        f"and no result")
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
        if errors:
            raise RuntimeError("local ranks failed:\n" + "\n".join(errors))
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)


def to_host(obj):
    """``obj`` with every tensor inside dicts, lists and tuples as a numpy
    array on the host (a picklable result of ``run_local_ranks``)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True).numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj

