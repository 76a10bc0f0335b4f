"""Two processes through threedgrut_torch.parallel.multihost.initialize
(tests/torch_multihost_worker.py; gloo on the loopback), as
tests/test_multihost.py runs the JAX package's: a (2, 1, 1) mesh whose data
axis spans the processes, each loading only its own views of a step
(my_view_indices, host_local_batch). Both end with the same loss and
parameters; the views are the JAX package's schedule; the loss is the mean
of the two views' single-device losses."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_dp_workers as W
from threedgrut_torch.parallel import multihost
from threedgrut_torch.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """torch on one intra-op thread for the module (as
    tests/test_torch_grt.py): many small ops under the parallel run's load
    stall on a pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_rows(num_views, batch_size, step, seed=0):
    """threedgrut_tpu/parallel/multihost.py:222-230's global rows."""
    rng = np.random.default_rng(seed * 100003 + step // max(num_views, 1))
    perm = rng.permutation(num_views)
    return [int(perm[(step * batch_size + i) % num_views])
            for i in range(batch_size)]


def test_two_process_dp_steps():
    port = multihost.free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_multihost_worker.py"),
         str(pid), str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    vals = []
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
        m = re.search(r"MHOK pid=(\d) rows=(\d+),(\d+) loss=(\S+),(\S+) "
                      r"digest=(\w+)", out)
        assert m and int(m.group(1)) == pid, out[-4000:]
        vals.append(m.groups()[1:])
    # Each process rendered its own row of the JAX schedule ...
    for step in range(2):
        assert [int(v[step]) for v in vals] == jax_rows(4, 2, step)
    # ... and both hold the same mean loss and the same state, bit for bit.
    assert vals[0][2:] == vals[1][2:]
    ds = W.dataset()
    losses = []
    for i in jax_rows(4, 2, 0):
        tr = Trainer(W.config(), ds, params=W.params_of(W.initial_fields(ds)),
                     device="cpu")
        losses.append(float(tr.train_step(ds[i])["terms"]["total"]))
    np.testing.assert_allclose(float(vals[0][2]), np.mean(losses),
                               rtol=1e-6)
