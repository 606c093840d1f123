"""The fused RDB kernel under tile hints at the batch-1 DIV2K eval shape
(port of esr_tpu/ops/pallas/tiled_probe.py)::

    python -m esr_tpu_torch.ops.cuda.tiled_probe

The JAX probe asked whether width-tiled Pallas RDB tiles beat XLA's block
on 1 x 336 x 504 x 64 (nf 64, gc 32), the eval shape whose full-width tile
overflowed the TPU's VMEM. Here the same shape goes through
``rdb5c_tc_kernel`` (bf16, weight layout built once) with each tile hint
of ``TILES`` passed to ``rdb5c_launch`` (the tensor-core kernel runs its own
16 x 16 tiles whatever is asked: the hint is a schedule hint), beside the
plain block (``rdb5c_reference`` in bf16): ms per call (CUDA events) and
the max error against the plain block. The JAX probe's other shape (nf 128
/ gc 64, B8 x 128^2) is the ``fold=2`` trunk, a TPU lane layout with no
counterpart in the port. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import json

import torch

__all__ = ["TILES", "run_tiled_probe"]

SHAPE, NF, GC = (1, 336, 504), 64, 32
TILES = ((16, 16), (22, 38), (54, 38))  # the kernel's own tile; the JAX probe's strips 22 / 54 at wtile 38


@torch.no_grad()
def run_tiled_probe(tiles=TILES, device="cuda") -> dict:
    """{"plain_ms", "kernel_ms" per hint, "max_abs_err" per hint,
    "same_output": every hint's answer bit-equal to the first's} at the
    DIV2K eval shape, with seeded Kaiming-scale weights."""
    from esr_tpu_torch.ops.cuda.conv_bench import launch_ms
    from esr_tpu_torch.ops.cuda.rdb_conv import rdb5c_kernel_weights, rdb5c_launch, rdb5c_reference

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("tiled_probe times the card's RDB kernel: device must be CUDA")
    g = torch.Generator(dev).manual_seed(0)
    x = torch.randn(*SHAPE, NF, device=dev, generator=g).bfloat16()
    params = {}
    for k in range(1, 6):
        cin, cout = NF + (k - 1) * GC, NF if k == 5 else GC
        params[f"w{k}"] = torch.randn(3, 3, cin, cout, device=dev, generator=g) * (2.0 / (9 * cin)) ** 0.5
        params[f"b{k}"] = torch.zeros(cout, device=dev)
    kw = rdb5c_kernel_weights(params, torch.bfloat16, dev)
    plain = rdb5c_reference(x, params)
    res = {"shape": [*SHAPE, NF], "plain_ms": launch_ms(lambda: rdb5c_reference(x, params), reps=5, windows=3),
           "kernel_ms": {}, "max_abs_err": {}}
    outs = []
    for strip, wtile in tiles:
        key = f"{strip}x{wtile}"
        res["kernel_ms"][key] = launch_ms(lambda s=strip, w=wtile: rdb5c_launch(x, kw, s, w), reps=10, windows=3)
        outs.append(rdb5c_launch(x, kw, strip, wtile))
        res["max_abs_err"][key] = (outs[-1].float() - plain.float()).abs().max().item()
    res["same_output"] = all(torch.equal(o, outs[0]) for o in outs)
    return res


if __name__ == "__main__":
    print(json.dumps({"card": torch.cuda.get_device_name(0), **run_tiled_probe()}), flush=True)
