from esr_tpu_torch.models.architecture import HAT, DiscriminatorVGG128, RRDBNet, SRResNet, SwinIR, VGG19FeatureExtractor
from esr_tpu_torch.models.base_model import BaseModel, make_eval_forward
from esr_tpu_torch.models.networks import (
    define_D,
    define_F,
    define_G,
    discriminator_state_dict_from_jax,
    kernelgan_state_dict_from_jax,
    normalize_rrdb_keys,
    normalize_swinir_keys,
    rrdb_options_from_state,
    srresnet_state_dict_from_jax,
    state_dict_from_jax,
    vgg_state_dict_from_jax,
)


def create_model(opt: dict, device="cuda"):
    """The model ``opt['model']`` names (port of esr_tpu/models/__init__.py)
    on ``device``: a trainer when ``opt['is_train']``, else the eval model."""
    model = (opt.get("model") or "sr").lower()
    if model == "sr":
        from esr_tpu_torch.models.sr_model import SRModel

        return SRModel(opt, device=device)
    if model in ("srragan", "srgan", "esrgan"):
        from esr_tpu_torch.models.srragan_model import SRRaGANModel

        return SRRaGANModel(opt, device=device)
    raise NotImplementedError(f"model {model} not recognized")
