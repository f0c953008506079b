"""Run a function SPMD in a world of fresh processes.

The JAX package runs its sharded code from one controller; this port runs it
with one process per rank.  ``start`` launches ``world`` fresh interpreters
(never a fork: CUDA cannot be re-initialised in a forked child), each of
which joins a process group through a ``file://`` rendezvous in a private
directory (no TCP port), calls ``fn(*args)`` and pickles its result there;
``World.wait`` returns the results in rank order.  A rank that fails, or a
world that outlives its timeout, kills every rank and raises: nothing is
retried or rerouted.

    world = launch.start(my_rank_program, 4, "gloo", args=(inputs,))
    results = world.wait(timeout=120)

``fn`` must be a module-level function of a file that imports neither JAX
nor anything heavy it does not need: each rank loads that file by path.
Kernels that need building are built by the caller before ``start``, so
that the ranks do not race the compiler.
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[2]      # the directory holding fhe_tpu_torch
_RANK = ("import sys; from fhe_tpu_torch.parallel import launch; "
         "launch._rank_main(sys.argv[1], int(sys.argv[2]))")


class World:
    """The processes of one started world and their private directory."""

    def __init__(self, procs: list, workdir: Path):
        self.procs = procs
        self.workdir = workdir

    def kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            proc.wait()

    def _log(self, rank: int) -> str:
        text = (self.workdir / f"rank{rank}.log").read_text(errors="replace")
        return text[-4000:]

    def wait(self, timeout: float = 120.0) -> list:
        """Each rank's result, in rank order.  Raises if a rank exits
        nonzero or the world is still running after ``timeout`` seconds;
        every rank is killed first."""
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in self.procs):
                failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} exited "
                                       f"{self.procs[failed[0]].returncode}:\n"
                                       f"{self._log(failed[0])}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"world of {len(self.procs)} still running after "
                                       f"{timeout} s; rank 0:\n{self._log(0)}")
                time.sleep(0.05)
            for rank, proc in enumerate(self.procs):
                if proc.returncode:
                    raise RuntimeError(f"rank {rank} exited {proc.returncode}:\n"
                                       f"{self._log(rank)}")
        finally:
            self.kill()
        results = []
        for rank in range(len(self.procs)):
            with open(self.workdir / f"result{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def start(fn, world: int, backend: str, args: tuple = (), workdir=None) -> World:
    """Launch ``world`` ranks of ``fn(*args)`` on a ``backend`` ("gloo" or
    "nccl") process group; each rank runs one CPU thread, since the ranks
    share the host's cores.  ``workdir`` (default a new temporary
    directory) holds the rendezvous file, the pickled arguments, each
    rank's log and result."""
    workdir = Path(tempfile.mkdtemp(prefix="fhe_world_") if workdir is None else workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec = dict(file=inspect.getfile(fn), name=fn.__name__, world=world, backend=backend,
                args=args, rendezvous=f"file://{workdir / 'rendezvous'}")
    with open(workdir / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen([sys.executable, "-c", _RANK, str(workdir), str(rank)],
                                          stdout=log, stderr=subprocess.STDOUT, env=env))
    return World(procs, workdir)


def _rank_main(workdir: str, rank: int) -> None:
    """One rank: join the group, run the function, pickle its result."""
    import torch
    import torch.distributed as dist

    with open(Path(workdir) / "spec.pkl", "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    mod_spec = importlib.util.spec_from_file_location(f"_rank_program_{rank}", spec["file"])
    module = importlib.util.module_from_spec(mod_spec)
    sys.modules[mod_spec.name] = module
    mod_spec.loader.exec_module(module)
    dist.init_process_group(spec["backend"], init_method=spec["rendezvous"], rank=rank,
                            world_size=spec["world"])
    try:
        result = getattr(module, spec["name"])(*spec["args"])
    finally:
        dist.destroy_process_group()
    with open(Path(workdir) / f"result{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
