"""Several ranks of the port on the CPU, for its distributed tests.

:func:`run_ranks` starts ``world`` spawned processes, each joining a gloo
process group through ``parallel.mesh.init_distributed`` with a
``file://`` rendezvous in the test's own directory (never a fixed port,
so tests under xdist cannot collide), one torch thread each, and
``FRT_TORCH_DEVICE=cpu``. Each runs ``fn(rank, *args)`` (a function of
an importable module that does not import jax) and its result is read
back with ``torch.load``, its file removed once read. Every spawn has its
own timeout: a rank that hangs is killed and fails its test, and a rank
that raises fails it with its traceback.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import traceback

import torch


def _entry(module: str, name: str, rank: int, world: int, model_parallel: int, tmp: str, args):
    os.environ["FRT_TORCH_DEVICE"] = "cpu"
    torch.set_num_threads(1)
    out = os.path.join(tmp, f"rank{rank}")
    try:
        from faster_rcnn_pytorch_tpu_torch.parallel import mesh

        mesh.init_distributed(
            rank, world, torch.device("cpu"),
            init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
            model_parallel=model_parallel, timeout_s=300,
        )
        fn = getattr(importlib.import_module(module), name)
        torch.save(fn(rank, *args), out + ".pt")
        mesh.shutdown()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world: int, tmp, *args, model_parallel: int = 1, timeout: float = 600.0):
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own rank."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [
        ctx.Process(
            target=_entry,
            args=(fn.__module__, fn.__name__, r, world, model_parallel, tmp, args),
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(world):
        err = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as f:
                errors.append(f"rank {r}:\n{f.read()}")
    if hung or errors or any(p.exitcode for p in procs):
        raise AssertionError(
            f"ranks {hung} hung past {timeout} s; exit codes "
            f"{[p.exitcode for p in procs]}\n" + "\n".join(errors)
        )
    out = []
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.pt")
        out.append(torch.load(path, weights_only=False))
        os.remove(path)
    return out
