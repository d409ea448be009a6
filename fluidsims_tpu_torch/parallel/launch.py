"""Start the ranks of a sharded run: the driving half of `shard_map`.

JAX runs a sharded body in one process that sees every device; here
`spawn(fn, world, backend, args)` starts `world` processes (the 'spawn'
start method), joins them into one process group through a `file://`
rendezvous in a temporary directory (no TCP port is involved), runs
`fn(*args)` on each rank and returns each rank's result, with every
tensor in it turned into a numpy array.  `fn` goes to the ranks by
reference, so it must be a module-level function of an importable module;
`_rank_entry`, the function each process starts in, lives here for the
same reason.

Backends are named by the caller; nothing switches them:

* 'nccl': rank r computes on cuda:r; asking for more ranks than GPUs
  raises before any process starts.
* 'gloo': CPU tensors, or several ranks that share one GPU, whose tensors
  the collectives move through the host (parallel/mesh.py).

Each rank runs with one intra-op thread.  If a rank raises, or a process
dies or the run passes `timeout` seconds, `spawn` stops every rank and
raises, with the rank's traceback where there is one.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["spawn", "to_numpy", "tree_map"]


def tree_map(fn, tree):
    """`tree` (tuples, NamedTuples, lists and dicts) with `fn` applied to
    every tensor in it; other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def to_numpy(tree):
    """`tree` with every tensor in it turned into a numpy array on the
    host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _rank_entry(rank: int, world: int, backend: str, init_method: str,
                timeout: float, fn, args, results) -> None:
    """The body of one rank's process: join the group, run fn(*args),
    report (rank, True, result) or (rank, False, traceback)."""
    ok = False
    try:
        torch.set_num_threads(1)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        payload = to_numpy(fn(*args))
        ok = True
    except Exception:  # the rank's boundary: report, then exit non-zero
        payload = traceback.format_exc()
    results.put((rank, ok, payload))
    if ok and dist.is_initialized():
        dist.destroy_process_group()
    results.close()
    results.join_thread()
    if not ok:
        raise SystemExit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)


def spawn(fn, world: int, backend: str = "gloo", args: tuple = (),
          timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `world` ranks of a new process group of
    `backend`; returns the ranks' results in rank order, tensors as numpy
    arrays.  Raises if a rank fails, a process dies, or the run takes
    longer than `timeout` seconds."""
    if world < 1:
        raise ValueError(f"world={world}: want at least one rank")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    if backend == "nccl":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > have:
            raise ValueError(f"backend 'nccl' runs one rank a GPU: {world} "
                             f"ranks asked for, {have} GPU(s) visible")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="fst_ranks_") as d:
        init_method = "file://" + os.path.join(d, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                             args=(r, world, backend, init_method, timeout,
                                   fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            got = _collect(procs, results, timeout)
            for p in procs:
                p.join(60)
        finally:
            _stop(procs)
    bad = [p.name for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with codes "
                           f"{[p.exitcode for p in procs]}")
    return [got[r] for r in range(world)]


def _collect(procs, results, timeout: float) -> dict:
    """Each rank's payload, read before any process is joined (a process
    that has put a large payload exits only once it is read)."""
    got = {}
    deadline = time.monotonic() + timeout
    while len(got) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=0.5)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"rank(s) {dead} died with exit codes "
                                   f"{[procs[r].exitcode for r in dead]} "
                                   "before reporting") from None
            if time.monotonic() > deadline:
                left = sorted(set(range(len(procs))) - set(got))
                raise TimeoutError(f"ranks {left} did not finish in "
                                   f"{timeout} s") from None
            continue
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        got[rank] = payload
    return got
