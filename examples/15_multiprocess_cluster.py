# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Example 15: multi-process cluster execution (the Dice/MPI replacement).

The reference's cluster scale-out story is swapping its eigensolver for an
MPI-launched external C++ program
(``/root/reference/docs/guides/integrate_dice_solver.ipynb``).  The
JAX story is SPMD: every host runs THIS SAME script, joins the
runtime with :func:`sqd_tpu.parallel.init_distributed`, and the sharded
solvers run unchanged over a mesh spanning every host's devices — the
Davidson reductions, panel all-gathers and factor-axis psums ride NCCL
on GPUs (Gloo on CPU).

On a real cluster each host launches ``python 15_multiprocess_cluster.py``
with the coordinator env set (``SQD_TPU_COORDINATOR``/``NUM_PROCESSES``/
``PROCESS_ID``).  For a self-contained demo,
``main()`` plays the launcher itself: it spawns TWO worker processes with 4
virtual CPU devices each and checks both ranks return the identical,
oracle-exact energy through a determinant-row-sharded solve.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

_WORKER = """
import json, os, sys
sys.path.insert(0, os.environ["SQD_REPO"])
import numpy as np
import sqd_tpu.parallel as par

rank, port = int(sys.argv[1]), int(sys.argv[2])
# join the multi-process runtime: Gloo collectives on CPU, NCCL on GPUs
par.init_distributed(
    "127.0.0.1:%d" % port, num_processes=2, process_id=rank, platform="cpu"
)
mesh = par.global_mesh("rows")

from sqd_tpu.ops.dense_fci import all_hamming_strings

rng = np.random.default_rng(21)
norb = 6
h1 = rng.normal(size=(norb, norb)); h1 = (h1 + h1.T) / 2
chol = rng.normal(size=(8, norb, norb)) * 0.3
chol = (chol + chol.transpose(0, 2, 1)) / 2
eri = np.einsum("xpq,xrs->pqrs", chol, chol)
strs = all_hamming_strings(norb, 3)

res = par.solve_sci_rowsharded((strs, strs), h1, eri, norb, (3, 3), mesh=mesh, tol=1e-8)
print(json.dumps({"rank": rank, "energy": res.energy}), flush=True)
"""


def main() -> None:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["SQD_REPO"] = repo
    env.pop("PYTHONPATH", None)
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(rank), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for rank in range(2)
    ]
    try:
        outs = []
        for p in procs:
            out, err = p.communicate(timeout=540)
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{err[-2000:]}")
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)

    e0, e1 = (o["energy"] for o in sorted(outs, key=lambda o: o["rank"]))
    print(f"rank 0 energy: {e0:.12f}")
    print(f"rank 1 energy: {e1:.12f}")
    assert e0 == e1, "SPMD ranks must agree bit-for-bit"

    # oracle check, in this (launcher) process
    from sqd_tpu.ops.dense_fci import all_hamming_strings, build_dense_hamiltonian

    rng = np.random.default_rng(21)
    norb = 6
    h1 = rng.normal(size=(norb, norb)); h1 = (h1 + h1.T) / 2
    chol = rng.normal(size=(8, norb, norb)) * 0.3
    chol = (chol + chol.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", chol, chol)
    strs = all_hamming_strings(norb, 3)
    e_exact = np.linalg.eigvalsh(build_dense_hamiltonian(strs, strs, h1, eri))[0]
    print(f"dense oracle:  {e_exact:.12f}  (|err| = {abs(e0 - e_exact):.2e})")
    assert abs(e0 - e_exact) < 1e-7


if __name__ == "__main__":
    main()
