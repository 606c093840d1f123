from esr_tpu_torch.cem.cemnet import CEM, CEMConf, make_cem
from esr_tpu_torch.cem.kernels import bicubic_downsample_kernel_1d, downsample_kernel_2d

# Blind-SR kernel estimation (KernelGAN-style) lives in esr_tpu_torch.cem.kernelgan;
# imported where it is used (the blind CLIs and scripts), not here.
