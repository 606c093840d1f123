"""The port's multi-process data parallelism (esr_tpu_torch/parallel/
multihost.py and dp.py) on the CPU, as tests/test_multihost_mp.py checks
the JAX package's: N processes of ``python -m
esr_tpu_torch.parallel.multihost --device cpu`` joined over localhost (gloo)
report what one process reports on the same global batch, and one
data-parallel step over 2 ranks equals JAX's ``make_dp_train_step`` on the
same weights (the port's seeded ones, carried to JAX by
``load_rrdb_from_torch``) and the same batch."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_workers as W
from esr_tpu.models.architecture import RRDBNet as JRRDBNet
from esr_tpu.models.networks import load_rrdb_from_torch
from esr_tpu.parallel import make_dp_train_step as jmake_dp_train_step
from esr_tpu.parallel import make_mesh as jmake_mesh
from esr_tpu.parallel import shard_batch as jshard_batch
from esr_tpu_torch.models import state_dict_from_jax
from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel.multihost import global_device_array, host_shard, init_distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _run(args: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return subprocess.Popen([sys.executable, "-m", "esr_tpu_torch.parallel.multihost", "--device", "cpu", *args],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)


def _parse(proc: subprocess.Popen) -> dict:
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, f"worker failed rc={proc.returncode}\n{out}\n{err}"
    return json.loads(out.strip().splitlines()[-1])


def test_multiprocess_dp_step_matches_single_process():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    n = 2
    workers = [_run(["--coordinator", f"localhost:{port}", "--num-processes", str(n), "--process-id", str(i),
                     "--backend", "gloo"]) for i in range(n)]
    results = [_parse(w) for w in workers]
    single = _parse(_run([]))
    for i, r in enumerate(results):
        assert r["process"] == i and r["process_count"] == n == r["n_devices"]
    assert single["process_count"] == 1
    assert results[0]["loss"] == results[1]["loss"] and results[0]["param_l1"] == results[1]["param_l1"]
    assert single["loss"] == pytest.approx(results[0]["loss"], rel=1e-5)
    assert single["param_l1"] == pytest.approx(results[0]["param_l1"], rel=1e-5)


def test_dp_step_matches_jax(tmp_path):
    """2 ranks, each on its half of a batch of 4: the loss and every parameter
    after one SGD step are those of JAX's DP step over a 2-device 'data'
    mesh on the same global batch, and the same on both ranks."""
    state = {k: v.numpy() for k, v in RRDBNet(nf=4, nb=1, gc=2, scale=4, seed=3).state_dict().items()}
    rng = np.random.default_rng(0)
    lr = rng.random((4, 8, 8, 3)).astype(np.float32)
    hr = rng.random((4, 32, 32, 3)).astype(np.float32)

    model = JRRDBNet(nf=4, nb=1, gc=2, scale=4)
    params = load_rrdb_from_torch(state, nb=1)["params"]
    tx = optax.sgd(1e-2)

    def train_step(st, batch, _rng):
        p, o = st

        def loss_fn(pp):
            return jnp.mean(jnp.abs(model.apply({"params": pp}, batch["LR"]) - batch["HR"]))

        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(grads, o)
        return (optax.apply_updates(p, upd), o), loss

    mesh = jmake_mesh(2)
    step = jmake_dp_train_step(train_step, mesh, n_state_args=1, n_extra_args=1, donate=False)
    (p_after, _), jloss = step((params, tx.init(params)), jshard_batch({"LR": lr, "HR": hr}, mesh),
                               jax.random.PRNGKey(0))
    want = {k: v.numpy() for k, v in state_dict_from_jax(jax.device_get(p_after)).items()}

    ranks = comm.spawn(W.dp_sgd_step, 2, tmp_path, args=(state, lr, hr), timeout=TIMEOUT)
    for r in ranks:
        assert r["loss"] == pytest.approx(float(jloss), rel=1e-5)
        for k, v in want.items():
            np.testing.assert_allclose(r["state"][k], v, rtol=0, atol=1e-6, err_msg=k)
    for k, v in ranks[0]["state"].items():
        np.testing.assert_array_equal(ranks[1]["state"][k], v)


def test_multihost_helpers_single_process():
    """One process: no group, host_shard's strided share, the rows as tensors."""
    from esr_tpu_torch.parallel import make_mesh

    assert init_distributed(device="cpu") == (0, 1)
    items = list(range(10))
    assert host_shard(items) == items
    assert host_shard(items, process_index=1, process_count=4) == [1, 5, 9]
    batch = global_device_array({"HR": np.ones((8, 4, 4, 3), np.float32)}, make_mesh(), device="cpu")
    assert tuple(batch["HR"].shape) == (8, 4, 4, 3) and str(batch["HR"].device) == "cpu"
