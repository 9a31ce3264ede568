"""A world of ranks on one host: the port's stand-in for the JAX package's
device mesh inside one process.

``run_ranks`` starts ``world`` processes with ``torch.multiprocessing``,
joins them into one ``torch.distributed`` group through a file store in a
fresh temporary directory (no port, no network), runs ``fn`` on every rank
and returns what each rank returned.  Every collective of the group is
bounded by ``timeout_s`` and so is the join, so a rank that waits on a
collective its peers never issue fails the call in seconds instead of
hanging; a rank's exception is raised again in the caller.

The backend is the caller's choice and is never switched: ``"nccl"`` puts
each rank on its own card (``cuda:rank % device_count``; NCCL refuses two
ranks on one card), ``"gloo"`` runs on the CPU and also on CUDA tensors,
where several ranks may share one card.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank`` in a world on ``device``: the CPU, or the
    card ``rank % device_count`` of a CUDA host."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA world was asked for and no CUDA device is "
                           "available")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, fn, world, backend, device, store, out_dir, timeout_s,
               args):
    torch.set_num_threads(1)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{store}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, dev, *args)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, backend: str = "gloo", device="cuda", *args,
              timeout_s: float = 300.0):
    """Run ``fn(rank, device, *args)`` on ``world`` spawned ranks of one
    process group and return the list of their results, by rank (each
    saved with ``torch.save`` and loaded on the CPU).  ``fn`` and ``args``
    must pickle (a module-level function; tensors, problems).  The group's
    collectives time out after ``timeout_s`` seconds and the whole call
    after twice that; on a timeout or a rank's exception the remaining
    ranks are ended and the caller gets the error."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    rank_device(device, 0)               # a CUDA world needs a card here too
    tmp = tempfile.mkdtemp(prefix="ranks_")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, str(device),
                              os.path.join(tmp, "store"), tmp, timeout_s,
                              args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + 2 * timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world} ranks did not finish within "
                        f"{2 * timeout_s:g} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
