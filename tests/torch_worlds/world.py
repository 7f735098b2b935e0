"""A gloo world of processes on the CPU for the port's multi-rank tests.

`spawn(cases, n, tmp)` (or `World(...)`, then `.results()`, to work
while the world runs) starts ``n`` fresh interpreters, each running this
file as a script: rank r joins a `torch.distributed` world of ``n``
through a `FileStore` under ``tmp`` (no port is bound), imports the
cases module at path ``cases`` and calls its ``run(rank, world)``, which
returns a dict of results (tensors, arrays, numbers). Each rank saves its
dict with `torch.save`; `spawn` returns the list of dicts by rank. Every
process group is destroyed before a worker exits. The workers import
torch and the port only; each result dict carries ``"forbidden"``, the
jax or reference modules its worker had loaded (the isolation check).
"""
import importlib.util
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


class World:
    """``n`` workers running ``cases``, started at once; `results` waits
    for them."""

    def __init__(self, cases, n, tmp, timeout=240, env=None):
        self.tmp = str(tmp)
        os.makedirs(self.tmp, exist_ok=True)
        store = os.path.join(self.tmp, "store")
        envs = dict(os.environ, **(env or {}))
        envs["PYTHONPATH"] = REPO + os.pathsep + envs.get("PYTHONPATH", "")
        envs.setdefault("OMP_NUM_THREADS", "1")
        self.deadline = time.monotonic() + timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             os.path.abspath(cases), str(n), str(r), store, self.tmp],
            env=envs, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]

    def results(self):
        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=max(
                    1.0, self.deadline - time.monotonic()))
                logs.append(out)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs)
               if p.returncode]
        if bad:
            raise RuntimeError(f"ranks failed {bad}:\n" + "\n".join(
                f"--- rank {r} ---\n{log[-6000:]}"
                for r, log in enumerate(logs)))
        import torch

        return [torch.load(os.path.join(self.tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(self.procs))]


def spawn(cases, n, tmp, timeout=240, env=None):
    return World(cases, n, tmp, timeout, env).results()


def _main(cases, n, rank, store, tmp):
    import torch
    import torch.distributed as tdist

    torch.set_num_threads(1)
    from incubator_mxnet_tpu_torch.parallel import dist

    dist.initialize(init_method=f"file://{store}", num_processes=n,
                    process_id=rank, backend="gloo")
    spec = importlib.util.spec_from_file_location("world_cases", cases)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    from incubator_mxnet_tpu_torch import cpu

    try:
        with cpu():
            out = mod.run(rank, n)
    finally:
        if tdist.is_initialized():
            tdist.barrier()
        dist._shutdown()
    out["forbidden"] = sorted(
        m for m in sys.modules
        if any(m == f or m.startswith(f + ".") for f in FORBIDDEN))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
          sys.argv[5])
