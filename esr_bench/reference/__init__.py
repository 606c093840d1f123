"""The plain reference the benchmark judges the port against.

Plain PyTorch in float32 with TF32 off (:func:`exact`), written from the
published descriptions: ESRGAN's RRDBNet (Wang et al. 2018) with the
explorable fork's Z input (Bahat & Michaeli, CVPR 2020), SRResNet (Ledig et
al. 2017, BasicSR's MSRResNet without BatchNorm), and the CEM projection
with MATLAB's bicubic kernel. It imports nothing of the port, of JAX or of
the JAX package: the bicubic matrices are its own copy, and it reads only
the weights and inputs the benchmark made.

``prec`` selects the arithmetic: ``"f32"`` is the reference; ``"fp8"`` is
the control, the step below the configuration's bf16 convs (every conv's
input and weight rounded to float8 e4m3 with a per-tensor scale, and its
output gradient to e5m2, as fp8 training does) with the CEM's matmuls in TF32, the step below its f32. The control must fail the
comparison that the reference passes.
"""

from esr_bench.reference.cem import Cem
from esr_bench.reference.nets import exact, generator, generator_shapes

__all__ = ["Cem", "exact", "generator", "generator_shapes"]
