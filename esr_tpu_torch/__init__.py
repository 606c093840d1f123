"""esr_tpu_torch — Explorable Super Resolution on PyTorch and CUDA (Hopper).

The port of ``esr_tpu`` (the JAX/Flax/Pallas package beside it, which stays
the reference). It imports neither JAX nor ``esr_tpu``. Public functions take
NHWC tensors, as the JAX package does; entry points run on CUDA unless the
caller passes ``device="cpu"``. Every Pallas kernel of the ported path has a
hand-written CUDA counterpart under ``ops/cuda``:

  cem/      — consistency module, matmul mode  (esr_tpu/cem/)
  models/   — RRDBNet generator, DiscriminatorVGG128, VGG19 features,
              define_G/D/F, eval forward, losses, the SR and GAN trainers
              (create_model), JAX weight bridges
  ops/      — resize, color, metrics, x8 self-ensemble, fused upsample,
              CUDA kernels and their autograd Functions
  data/     — datasets (eval and train phases, PACKED), loader, the train
              pipeline, a PNG codec (stdlib zlib + numpy)
  options/  — options parser and the test and train JSONs
  utils/    — logger setup, train logger, watchdog
  scripts/  — export_model, serve (HTTP)
  train.py  — the train CLI;  test.py — the eval CLI;  export.py — serving
"""

__version__ = "0.1.0"
