"""Starting the ranks of a sharded solve: one process a rank.

The JAX package runs one process over a device mesh and has no
counterpart. PyTorch's idiom is a process a rank, so the sharded solves
(:func:`~score_tpu_torch.parallel.solve_conic_chain_sharded`,
:func:`~score_tpu_torch.parallel.solve_conic_sharded`) run inside ranks
that :func:`run_ranks` starts, or that ``torchrun`` starts:

    def work(device, problem, idx):
        return solve_conic_chain_sharded(to_device(problem, device), idx)

    result = run_ranks(work, world=2, device="cpu", args=(problem, idx))

Under ``torchrun`` each process calls ``init_process_group`` itself (the
environment gives the rank and the world size) and then the same solve.
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

__all__ = ["run_ranks"]


def _to_cpu(obj):
    """``obj`` with every tensor inside (tuples, named tuples, lists, dicts)
    moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_cpu(v) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_cpu(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(fn, rank, world, device_type, backend, store_path, timeout, args, results):
    """A rank's process: its device current, the process group joined
    through the file store, ``fn(device, *args)`` run; (rank, True, the
    pickled result with its tensors on the CPU, rank 0 only) or (rank,
    False, the traceback) goes to ``results``."""
    import torch.distributed as dist

    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    try:
        out = fn(device, *args)
        if device_type == "cuda":
            torch.cuda.synchronize(device)
        results.put((rank, True, pickle.dumps(_to_cpu(out)) if rank == 0 else None))
    except Exception:  # the rank's boundary: report, then exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device="cuda", backend=None, args=(), timeout: float = 600.0):
    """Run ``fn(device, *args)`` in ``world`` spawned processes, one a rank
    of a fresh ``torch.distributed`` process group, and return rank 0's
    result (tensors in it come back on the CPU).

    Rank r's device is ``cuda:(r % device_count)`` (current before any
    work) for ``device="cuda"``, the CPU for ``"cpu"``; ``"cuda"`` with no
    card raises, as the solve API does. ``backend`` defaults to NCCL where
    every rank has a card of its own, else gloo (on the CPU, or ranks
    sharing a card). The ranks meet through a ``FileStore`` in a fresh
    temporary directory, so concurrent runs never contend for a port. On
    CUDA the kernel libraries are built here, once, before the spawn.
    ``fn`` and ``args`` are pickled: ``fn`` must be importable by name.

    Any rank's exception fails the call (``RuntimeError`` with its
    traceback), as does a rank that dies, or no result within ``timeout``
    seconds (``TimeoutError``); the other ranks are then terminated. Every
    process started is joined before the call returns."""
    import multiprocessing

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() is False")
        from score_tpu_torch.ops import build

        build.compile_all()
        own_cards = world <= torch.cuda.device_count()
    elif dev.type == "cpu":
        own_cards = False
    else:
        raise ValueError(f"run_ranks: no ranks on device type {dev.type!r}")
    backend = backend or ("nccl" if own_cards else "gloo")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="score_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, dev.type, backend, store, timeout, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            done = _collect(procs, results, timeout)
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return pickle.loads(done[0])


def _collect(procs, results, timeout):
    """{rank: payload} of every rank, waiting at most ``timeout`` seconds;
    on a failure the live ranks are terminated and the failure raised."""
    deadline = time.monotonic() + timeout
    done = {}
    try:
        while len(done) < len(procs):
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]} "
                                       "and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {len(procs) - len(done)} ranks gave no "
                                       f"result in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            done[rank] = payload
    except BaseException:
        for p in procs:
            if p.is_alive():
                p.terminate()
        raise
    return done
