"""Helpers shared by the port's multi-rank tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_train_mesh.py``):
start N CPU ranks as subprocesses that join one gloo group from the
gang driver's env contract, and move numpy trees through ``.npz``
files. The ranks import no JAX."""

import os
import pathlib
import random
import socket
import subprocess
import sys

import numpy as np

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)
TIMEOUT_S = 120
# Eight ranks of DTensor programs on a loaded machine (the suite's
# workers and other rank groups share its cores) run several times
# slower than alone; the groups that take 20-40 s alone get this.
SLOW_TIMEOUT_S = 300

# The prologue of every rank's script: one torch thread (the suite runs
# several files at once on a few cores), the rendezvous, the directory
# the parent passes (``DIR``), the rank (``RANK``), and tree helpers
# (``unflatten`` of a ``flatten``-ed npz, ``leaves`` as (path, tensor)).
PROLOGUE = """
import os, sys, json
import numpy as np
import torch
torch.set_num_threads(1)
from skypilot_tpu_torch.parallel import distributed
TOPO = distributed.initialize_from_env("cpu")
RANK = distributed.rank()
DIR = sys.argv[1]


def unflatten(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v
"""


def free_port() -> int:
    """A free port below the OS's ephemeral range (32768 up). Rank 0
    binds it seconds later, after importing torch; a port the OS hands
    out can go in the meantime to any socket of a concurrent test (each
    gloo rank opens several), one outside that range cannot."""
    rng = random.Random()
    for _ in range(200):
        port = rng.randrange(20000, 32768)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in 20000-32767")


def rank_env(n: int, rank: int, port: int, extra=None) -> dict:
    """The env the gang driver injects (coordinator, process count and
    id), pointed at a local port, with the repository importable."""
    env = dict(os.environ)
    env.update({"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
                "JAX_NUM_PROCESSES": str(n), "JAX_PROCESS_ID": str(rank),
                "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
                "OMP_NUM_THREADS": "1"})
    env.update(extra or {})
    return env


def spawn(argvs, envs, cwd=None, timeout=TIMEOUT_S):
    """Start one process per (argv, env), wait for all (each within
    ``timeout`` seconds), and return their (stdout, stderr); a failed or
    timed-out rank fails the caller with every rank's output."""
    procs = [subprocess.Popen(argv, env=env, cwd=cwd or ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        text = "\n".join(f"--- rank {i} rc {procs[i].returncode}\n"
                         f"{outs[i][0][-3000:]}\n{outs[i][1][-6000:]}"
                         for i in range(len(outs)))
        raise AssertionError(f"ranks {bad} failed:\n{text}")
    return outs


def run_ranks(n: int, body: str, tmp_dir, extra_env=None,
              timeout=TIMEOUT_S):
    """Run ``PROLOGUE + body`` on ``n`` ranks with ``DIR = tmp_dir``."""
    port = free_port()
    code = PROLOGUE + body
    argvs = [[sys.executable, "-c", code, str(tmp_dir)]] * n
    envs = [rank_env(n, r, port, extra_env) for r in range(n)]
    return spawn(argvs, envs, timeout=timeout)


def flatten(tree, prefix="") -> dict:
    """A nested dict of arrays -> {"a/b/c": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


