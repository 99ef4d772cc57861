"""Start ranks of the distributed tier, and its dry run.

``loops_tpu`` runs the distributed ops from one controller over every
device; the port runs one process per rank. ``run_ranks`` spawns them on
one machine, joins them into one ``torch.distributed`` group through a
``file://`` rendezvous in a new temporary directory (no fixed port, so
runs side by side do not collide), runs ``fn(rank, world, *args)`` on
each and returns each rank's result to the caller. ``fn`` and its
results cross a process boundary, so ``fn`` is a function of the package
(``parallel/workers.py``) and its results are plain data (numpy arrays,
numbers, lists, dicts). ``single_rank`` makes this process the one rank
of a group: the card's form, one NCCL rank. ``run`` picks between them
by device.

``dryrun_multichip(n)`` is the analog of ``__graft_entry__``'s: one
DistGCN train step on n gloo ranks through the default exchange (the
overlapped halo), whose loss must equal the all-gather oracle's, then
the same step through the hierarchical exchange on a 2 x n/2 mesh, with
its host-stage deduplication factor.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

__all__ = ["run_ranks", "single_rank", "run", "dryrun_multichip"]

BACKENDS = ("gloo", "nccl")


def _init(backend: str, rank: int, world: int, init_file: str,
          timeout: float) -> None:
    import torch
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        from loops_tpu_torch.utils.platform import ensure_platform

        ensure_platform("cuda")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))


def _rank_main(fn, rank, world, args, backend, init_file, timeout,
               results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # every rank is on this machine: gloo talks over the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        _init(backend, rank, world, init_file, timeout)
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str = "nccl",
              init_file: str | None = None, timeout: float = 600.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each
    run in a spawned process that is rank r of a new group of ``world``
    ranks over ``backend`` (``nccl``, one card a rank, by default; pass
    ``gloo`` for ranks on the CPU). Raises ``RuntimeError`` with the
    rank's traceback when a rank fails, and when the ranks have not all
    returned within ``timeout`` seconds (a hung collective); every rank
    is stopped before it returns or raises."""
    import multiprocessing

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        from loops_tpu_torch.utils.platform import ensure_platform

        ensure_platform("cuda")
    ctx = multiprocessing.get_context("spawn")
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="loops_ranks_")
        init_file = os.path.join(tmp, "rendezvous")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, args, backend, init_file,
                               timeout, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out, failure = {}, None
        deadline = time.monotonic() + timeout
        while len(out) < world and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                failure = (f"{world - len(out)} of {world} ranks did not "
                           f"return within {timeout:.0f} s")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    failure = f"a rank exited with code {dead[0]}"
                continue
            if ok:
                out[rank] = value
            else:
                failure = f"rank {rank} failed:\n{value}"
        if failure is not None:
            raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                               f"{world}): {failure}")
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 5.0))
        return [out[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def single_rank(backend: str = "nccl", timeout: float = 600.0):
    """This process as the one rank of a new group over ``backend``
    (``nccl``: the current card), destroyed on exit."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a torch.distributed group is already "
                           "initialised in this process")
    tmp = tempfile.mkdtemp(prefix="loops_rank_")
    try:
        _init(backend, 0, 1, os.path.join(tmp, "rendezvous"), timeout)
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def run(fn, world: int, *args, device="cuda", timeout: float = 600.0) -> list:
    """``run_ranks`` on ``device``'s backend: ``world`` gloo ranks on the
    CPU; one NCCL rank in this process on a card (``single_rank``), or
    ``world`` spawned NCCL ranks, one a card, where that many cards are
    visible."""
    from loops_tpu_torch.utils.platform import ensure_platform

    dev = ensure_platform(device)
    if dev.type == "cpu":
        return run_ranks(fn, world, *args, backend="gloo", timeout=timeout)
    import torch

    if world > torch.cuda.device_count():
        raise ValueError(f"{world} NCCL ranks need {world} cards; "
                         f"{torch.cuda.device_count()} are visible")
    if world > 1:
        return run_ranks(fn, world, *args, backend="nccl", timeout=timeout)
    with single_rank("nccl", timeout):
        return [fn(0, 1, *args)]


def dryrun_multichip(n_devices: int = 8, params=None,
                     timeout: float = 600.0) -> dict:
    """One distributed GCN train step on ``n_devices`` gloo ranks of this
    machine's CPU (tiny shapes): through the overlapped halo exchange,
    against the all-gather oracle from the same parameters, and for an
    even ``n_devices`` of 4 or more through the hierarchical exchange on
    a 2 x n/2 mesh against the flat loss. ``params`` are ``loops_tpu``
    parameters of the [8, 16, 4] GCN (numpy ``[{"w", "b"}, ...]``);
    default: the port's draw from seed 0. Prints one line and returns
    the losses and the deduplication factor."""
    from loops_tpu_torch.parallel.workers import dryrun_rank

    r = run_ranks(dryrun_rank, n_devices, params, backend="gloo",
                  timeout=timeout)[0]
    loss, oracle = r["loss"], r["oracle_loss"]
    if not (abs(oracle - loss) / max(abs(loss), 1e-9) < 1e-4):
        raise AssertionError(
            f"halo-overlap loss {loss} != all_gather oracle {oracle}")
    note = ""
    if r.get("hier_loss") is not None:
        if not (abs(r["hier_loss"] - loss) / max(abs(loss), 1e-9) < 1e-4):
            raise AssertionError(
                f"hier loss {r['hier_loss']} != flat {loss}")
        note = (f", hier 2x{n_devices // 2} host/chip ok (host-stage "
                f"dedup {r['dcn_dedup_factor']:.2f}x)")
    print(f"dryrun_multichip({n_devices}): distributed GCN trained "
          f"through halo-overlap (all_to_all + interior overlap) on "
          f"{n_devices} gloo ranks ok, loss={loss:.4f} == all_gather oracle "
          f"{oracle:.4f}{note}", flush=True)
    return r
