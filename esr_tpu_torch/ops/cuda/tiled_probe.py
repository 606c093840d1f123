"""The fused RDB kernel at the batch-1 DIV2K eval shape (port of
esr_tpu/ops/pallas/tiled_probe.py)::

    python -m esr_tpu_torch.ops.cuda.tiled_probe

The JAX probe asked whether width-tiled Pallas RDB tiles beat XLA's block
on 1 x 336 x 504 x 64 (nf 64, gc 32), the eval shape whose full-width tile
overflowed the TPU's VMEM. Here the same shape goes through
``rdb5c_tc_kernel`` (bf16, weight layout built once), which takes no tile
hint (it picks its tile from the input's shape, ``rdb_conv.rdb5c_tile``),
beside the plain block (``rdb5c_reference`` in bf16): ms per call (CUDA
events) and the max error against the plain block. The JAX probe's other
shape (nf 128 / gc 64, B8 x 128^2) is the ``fold=2`` trunk, a TPU lane
layout with no counterpart in the port. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import json

import torch

__all__ = ["run_tiled_probe"]

SHAPE, NF, GC = (1, 336, 504), 64, 32


@torch.no_grad()
def run_tiled_probe(device="cuda") -> dict:
    """{"shape", "plain_ms", "kernel_ms", "max_abs_err"} at the DIV2K eval
    shape, with seeded Kaiming-scale weights."""
    from esr_tpu_torch.ops.cuda.conv_bench import kaiming_rdb_weights, launch_ms
    from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_kernel_weights, rdb5c_launch, rdb5c_reference

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("tiled_probe times the card's RDB kernel: device must be CUDA")
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(*SHAPE, NF, device=dev, generator=g).bfloat16()
    params = kaiming_rdb_weights(NF, GC, g)
    kw = rdb5c_kernel_weights(params, torch.bfloat16, dev)
    err = (rdb5c_launch(x, kw).float() - rdb5c_reference(x, params).float()).abs().max().item()
    return {"shape": [*SHAPE, NF], "plain_ms": launch_ms(lambda: rdb5c_reference(x, params), reps=5, windows=3),
            "kernel_ms": launch_ms(lambda: rdb5c_launch(x, kw), reps=10, windows=3), "max_abs_err": err}


if __name__ == "__main__":
    print(json.dumps({"card": torch.cuda.get_device_name(0), **run_tiled_probe()}), flush=True)
