"""Multi-process data-parallel training helpers (port of
esr_tpu/parallel/multihost.py): process-group setup, each host's share of a
dataset, its rows of a global batch, and a dry run that shows several
processes compute what one does.

    python -m esr_tpu_torch.parallel.multihost [--coordinator HOST:PORT \\
        --num-processes N --process-id I] [--backend gloo|nccl] [--device cpu]

runs one data-parallel SGD step of a tiny RRDB on a seeded global batch and
prints one JSON line; every process prints the same loss and ``param_l1``,
those of one process on the same batch. Without ``--coordinator`` the
process group comes from the launcher's environment (``torchrun``), or there
is none. Runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from esr_tpu_torch.parallel import comm

__all__ = ["global_device_array", "host_shard", "init_distributed", "run_dryrun_step"]


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None,
                     device: str | torch.device = "cuda") -> tuple[int, int]:
    """Join the process group when running multi-process; nothing for one
    process. ``coordinator_address`` (``host:port``, with the process count
    and id) or, without it, the launcher's ``WORLD_SIZE`` > 1 (``env://``).
    Returns (process index, process count)."""
    if dist.is_available() and dist.is_initialized():
        return comm.world()
    if coordinator_address:
        comm.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                                rank=process_id, device=device)
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        comm.init_process_group(backend, device=device)
    return comm.world()


def host_shard(items: list, process_index: int | None = None, process_count: int | None = None) -> list:
    """This process's share of a dataset's items (every ``process_count``-th
    from ``process_index``)."""
    rank, size = comm.world()
    pi = rank if process_index is None else process_index
    pc = size if process_count is None else process_count
    return items[pi::pc]


def global_device_array(local_batch, mesh, device: str | torch.device | None = None):
    """This process's rows of a global batch, on ``device`` (this rank's GPU,
    ``comm.rank_device("cuda")``, unless given): the local shard that JAX's
    ``make_array_from_process_local_data`` places over the 'data' axis, here
    as tensors (a dict of arrays or one array)."""
    device = comm.rank_device("cuda") if device is None else torch.device(device)
    g = mesh.group("data")

    def put(x):
        t = torch.as_tensor(np.asarray(x), device=device)
        if g.size > 1:  # every process must hand in the same number of rows
            n = torch.tensor([t.shape[0]], device=device)
            if any(int(v) != t.shape[0] for v in comm.gather_list(n, g)):
                raise ValueError("every process must hand in the same number of rows")
        return t

    return {k: put(v) for k, v in local_batch.items()} if isinstance(local_batch, dict) else put(local_batch)


def run_dryrun_step(seed: int = 0, global_batch: int = 4, device: str | torch.device = "cuda") -> dict:
    """One deterministic data-parallel SGD step (lr 1e-2) of a tiny RRDB
    (nf 4, nb 1, gc 2, x4, f32) on a seeded global batch (LR 8x8, HR 32x32),
    each process on its rows: every process reports the same metrics, equal
    to one process's run on the whole batch."""
    from esr_tpu_torch.models.architecture import RRDBNet
    from esr_tpu_torch.parallel.dp import make_dp_train_step
    from esr_tpu_torch.parallel.mesh import make_mesh

    pi, pc = comm.world()
    dev = comm.rank_device(device)
    mesh = make_mesh()
    model = RRDBNet(nf=4, nb=1, gc=2, scale=4, seed=seed).to(dev)
    params = list(model.parameters())
    rng = np.random.default_rng(seed)
    lr_g = rng.random((global_batch, 8, 8, 3)).astype(np.float32)
    hr_g = rng.random((global_batch, 32, 32, 3)).astype(np.float32)
    if global_batch % pc:
        raise ValueError(f"global_batch {global_batch} not divisible by {pc} processes")
    per = global_batch // pc
    local = global_device_array({"LR": lr_g[pi * per : (pi + 1) * per], "HR": hr_g[pi * per : (pi + 1) * per]},
                                mesh, dev)

    def loss_fn(batch, bc):
        return bc.mean(torch.abs(model(batch["LR"]) - batch["HR"]))

    @torch.no_grad()
    def sgd(grads):
        torch._foreach_add_(params, grads, alpha=-1e-2)

    step = make_dp_train_step(loss_fn, params, sgd, mesh, local_rows=True)
    loss = step(local)
    return {"n_devices": pc, "loss": float(loss), "param_l1": float(params[0].abs().sum())}


def _main(argv=None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=4)
    ap.add_argument("--backend", default=None, help="nccl (CUDA default) or gloo (CPU default)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    pi, pc = init_distributed(a.coordinator, a.num_processes, a.process_id, a.backend, a.device)
    try:
        out = run_dryrun_step(global_batch=a.global_batch, device=a.device)
        print(json.dumps({"process": pi, "process_count": pc, **out}), flush=True)
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    _main()
