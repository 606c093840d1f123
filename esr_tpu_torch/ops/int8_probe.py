"""int8 and FP8 against bf16 on Hopper's tensor cores: a measurement (port of
esr_tpu/ops/int8_probe.py, which asked the same of the TPU's MXU)::

    python -m esr_tpu_torch.ops.int8_probe

H100's dense int8 and FP8 peaks are twice its bf16 peak. Is that rate
there for this model's convs? The probe times library GEMMs, as the JAX
probe timed XLA's: bf16 (``torch.matmul``), int8 (``torch._int_mm``, int32
out) and FP8 e4m3 (``torch._scaled_mm``, per-tensor scales, bf16 out) on

- an 8192^3 matmul, and
- the four conv shapes of the JAX probe at B8 x 128 x 128 (Cin -> Cout:
  128 -> 384, 128 -> 128, 64 -> 320, 256 -> 256) as im2col GEMMs
  (B*H*W x 9 Cin times 9 Cin x Cout; the im2col itself is not timed), each
  with its max error against the f32 conv (TF32 off), relative to the f32
  output's largest magnitude: symmetric per-tensor quantization of inputs
  and weights, 127 levels for int8, e4m3's range (448) for FP8.

Rates are TFLOP/s (TOP/s for int8) of 2 M K N per GEMM, CUDA events around
back-to-back calls. Nothing on any path of the port uses int8 or FP8; the
rates are the libraries', not a kernel of this port. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from esr_tpu_torch.device import full_f32

__all__ = ["CONV_SHAPES", "run_probes"]

CONV_SHAPES = ((128, 384), (128, 128), (64, 320), (256, 256))
FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def _scale(t: torch.Tensor, top: float) -> torch.Tensor:
    return (t.abs().max().float() / top).clamp_min(1e-12)


def _gemms(a: torch.Tensor, b: torch.Tensor) -> dict:
    """The three GEMMs of f32 ``a`` (M, K) and ``b`` (K, N): name -> (call, product)."""
    ab, bb = a.bfloat16(), b.bfloat16()
    sa8, sb8 = _scale(a, 127.0), _scale(b, 127.0)
    ai = torch.round(a / sa8).clamp(-127, 127).to(torch.int8)
    bi = torch.round(b / sb8).clamp(-127, 127).to(torch.int8).t().contiguous().t()
    sa, sb = _scale(a, FP8_MAX), _scale(b, FP8_MAX)
    af = (a / sa).to(torch.float8_e4m3fn)
    bf = (b / sb).to(torch.float8_e4m3fn).t().contiguous().t()  # column-major, as _scaled_mm takes it
    return {
        "bf16": (lambda: ab @ bb, lambda: (ab @ bb).float()),
        "int8": (lambda: torch._int_mm(ai, bi), lambda: torch._int_mm(ai, bi).float() * (sa8 * sb8)),
        "fp8": (lambda: torch._scaled_mm(af, bf, scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16),
                lambda: torch._scaled_mm(af, bf, scale_a=sa, scale_b=sb, out_dtype=torch.float32)),
    }


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """NHWC x -> (N*H*W, 9*C) rows of its 3x3 SAME patches, (tap, channel) order."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=-1).reshape(n * h * w, 9 * c)


@torch.no_grad()
def run_probes(shapes=CONV_SHAPES, matmul_n: int = 8192, batch: int = 8, size: int = 128, device="cuda") -> dict:
    """{name: rate or error}: ``{dtype}_matmul_{n}_tfs`` and, per conv shape,
    ``{dtype}_conv_{cin}x{cout}_tfs`` and ``{dtype}_conv_{cin}x{cout}_max_rel_err``."""
    from esr_tpu_torch.ops.cuda.conv_bench import launch_ms

    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("int8_probe times the card's tensor cores: device must be CUDA")
    g = torch.Generator(dev).manual_seed(0)
    out = {}
    with full_f32():
        if matmul_n:
            n = matmul_n
            a = torch.rand(n, n, device=dev, generator=g) - 0.5
            b = torch.rand(n, n, device=dev, generator=g) - 0.5
            for name, (call, _) in _gemms(a, b).items():
                out[f"{name}_matmul_{n}_tfs"] = 2 * n**3 / (launch_ms(call, reps=10, windows=3) / 1e3) / 1e12
            del a, b
        for cin, cout in shapes:
            x = torch.randn(batch, size, size, cin, device=dev, generator=g)
            w = torch.randn(3, 3, cin, cout, device=dev, generator=g) * (2.0 / (9 * cin)) ** 0.5
            ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
            ref = ref.reshape(-1, cout)
            top = ref.abs().max().item()
            a, b = _im2col(x), w.reshape(9 * cin, cout)
            flops = 2 * a.shape[0] * a.shape[1] * cout
            for name, (call, product) in _gemms(a, b).items():
                out[f"{name}_conv_{cin}x{cout}_tfs"] = flops / (launch_ms(call, reps=10, windows=3) / 1e3) / 1e12
                out[f"{name}_conv_{cin}x{cout}_max_rel_err"] = (product() - ref).abs().max().item() / top
            del x, a, b, ref
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--matmul_n", type=int, default=8192, help="the square matmul's size (0 skips it)")
    args = ap.parse_args()
    res = run_probes(matmul_n=args.matmul_n)
    print(json.dumps({"card": torch.cuda.get_device_name(0), **res}), flush=True)
