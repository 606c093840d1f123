"""esr_tpu_torch — Explorable Super Resolution on PyTorch and CUDA (Hopper).

The port of ``esr_tpu`` (the JAX/Flax/Pallas package beside it, which stays
the reference). It imports neither JAX nor ``esr_tpu``. Public functions take
NHWC tensors, as the JAX package does; entry points run on CUDA unless the
caller passes ``device="cpu"``. Every Pallas kernel of the ported path has a
hand-written CUDA counterpart under ``ops/cuda``:

  cem/      — consistency module, matmul mode  (esr_tpu/cem/)
  models/   — RRDBNet generator, define_G, eval forward, the SR models' eval
              surface (create_model), JAX weight bridge
  ops/      — resize, color, metrics, x8 self-ensemble, fused upsample,
              CUDA kernels
  data/     — eval datasets and loader, a PNG codec (stdlib zlib + numpy)
  options/  — options parser and the test JSONs
  utils/    — logger setup, watchdog
  scripts/  — export_model, serve (HTTP)
  test.py   — the eval CLI;  export.py — serving artifacts
"""

__version__ = "0.1.0"
