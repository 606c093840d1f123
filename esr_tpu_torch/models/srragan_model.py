"""SRRaGANModel, eval side (port of esr_tpu/models/srragan_model.py).

At eval time the GAN model is its generator behind the CEM projection,
exactly as ``SRModel`` is: the discriminator, the feature extractor and the
RaGAN step come with the training slice (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

from esr_tpu_torch.models.sr_model import SRModel

__all__ = ["SRRaGANModel"]


class SRRaGANModel(SRModel):
    pass
