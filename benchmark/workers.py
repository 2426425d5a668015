"""The reference's worker processes, NumPy only, fed through pipes.

``Workers(n).map(job, args)`` runs ``job`` once for each tuple of
``args`` in a process of its own, at most ``n`` at a time, and returns
their results in order.  A worker is ``python3 -m benchmark.workers
<job>`` from the root of the checkout: it reads its pickled arguments on
standard input and writes its pickled result on standard output.  Pipes
and not a ``multiprocessing`` pool: nothing is written to ``/dev/shm``
or to disk, and every worker has ended when ``map`` returns.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _sketch(seqs, k, w, hpc):
    from .reference.sketch import sketch

    return [sketch(s, k, w, hpc) for s in seqs]


def _count(anchors, p):
    from .reference import chain

    return chain.counts(anchors, p)


JOBS = {"sketch": _sketch, "count": _count}


class Workers:
    def __init__(self, n: int | None = None):
        self.n_workers = n or min(8, os.cpu_count() or 1)

    def _one(self, job: str, args: tuple):
        proc = subprocess.Popen([sys.executable, "-m", "benchmark.workers", job], cwd=ROOT,
                                stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            out, err = proc.communicate(pickle.dumps(args, protocol=pickle.HIGHEST_PROTOCOL))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"reference worker {job} exited {proc.returncode}: {err.decode()[-2000:]}")
        return pickle.loads(out)

    def map(self, job: str, args: list) -> list:
        with ThreadPoolExecutor(self.n_workers) as pool:
            return list(pool.map(lambda a: self._one(job, a), args))


def main(argv=None) -> int:
    (job,) = argv if argv is not None else sys.argv[1:]
    result = JOBS[job](*pickle.load(sys.stdin.buffer))
    sys.stdout.buffer.write(pickle.dumps(result, protocol=pickle.HIGHEST_PROTOCOL))
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
