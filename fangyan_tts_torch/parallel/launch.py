"""Start a function on n local processes joined in one process group.

    results = spawn(fn, world, args=(...), backend="gloo", timeout=300)

Each process sets up the torch.distributed environment of its rank
(MASTER_ADDR 127.0.0.1, a free port, RANK, WORLD_SIZE, LOCAL_RANK), joins
the default group, calls fn(rank, world, *args) and sends its result (it
must pickle: numpy arrays, CPU tensors, plain data) back. `spawn` returns
the results in rank order, or raises when a process fails or the whole
group has not finished within `timeout` seconds (the processes still
running then print their Python stacks to stderr first); either way it
kills every process it started, so a hung collective cannot outlive the
call. The
processes start by the 'spawn' method: fn is found by its import path.
`threads` sets torch's CPU threads in each process. `Group` starts the
processes and returns at once; its join() collects them as spawn does.
"""

from __future__ import annotations

import faulthandler
import os
import queue
import signal
import socket
import time
import traceback


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, backend: str, threads: int | None, args: tuple, out) -> None:
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    import torch
    import torch.distributed as dist

    faulthandler.register(signal.SIGUSR1, all_threads=True)  # spawn's timeout asks for the stacks
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
        result = fn(rank, world, *args)
        out.put((rank, True, result))
    except BaseException:  # noqa: BLE001 - the parent re-raises it with the traceback
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Group:
    """A running process group (see the module docstring): started by the
    constructor, collected by join(), so that the caller can work while it
    runs. The timeout counts from the start."""

    def __init__(self, fn, world: int, args: tuple = (), backend: str = "gloo", timeout: float = 300.0,
                 threads: int | None = 1):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.out = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, threads, args, self.out),
                                  daemon=True) for r in range(world)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout

    def join(self) -> list:
        """The results in rank order; kills every process before it returns
        or raises."""
        procs, results = self.procs, {}
        try:
            while len(results) < self.world:  # drain the queue before joining (a full pipe blocks its writer)
                try:
                    rank, ok, value = self.out.get(timeout=max(0.1, min(1.0, self.deadline - time.monotonic())))
                except queue.Empty:
                    if time.monotonic() > self.deadline:
                        for p in procs:
                            if p.is_alive():
                                os.kill(p.pid, signal.SIGUSR1)
                        time.sleep(1.0)
                        raise TimeoutError(f"spawn: {self.world - len(results)} of {self.world} processes did not "
                                           f"finish within {self.timeout} s") from None
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead and self.out.empty():
                        raise RuntimeError(f"spawn: a process exited with code {dead[0].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
                results[rank] = value
            for p in procs:
                p.join(timeout=max(1.0, self.deadline - time.monotonic()))
            return [results[r] for r in range(self.world)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
            self.out.close()


def spawn(fn, world: int, args: tuple = (), backend: str = "gloo", timeout: float = 300.0,
          threads: int | None = 1) -> list:
    return Group(fn, world, args, backend, timeout, threads).join()
