"""What the trunk-parallel wrappers share (port of esr_tpu/parallel/common.py).

Pipeline and tensor parallelism replace only the nb-block trunk (~90% of
the generator's FLOPs); conv_first, trunk_conv, the upconvs, HRconv and
conv_last stay the model's own modules, run alike on every rank, and so keep
their kernels. ``RRDBNet.forward`` takes the trunk as an argument, and the
``latent_input='all_layers'`` Z rides the trunk's carry as in the plain
forward. The JAX package's scan-layout restriction has no counterpart (the
port's trunk is a module list), and ``network_G.fold`` computes the same
function unfolded.
"""

from __future__ import annotations

__all__ = ["check_trunk_parallel_model", "make_outer_apply"]


def check_trunk_parallel_model(model, what: str) -> None:
    """The trunk-parallel wrappers take an RRDB generator."""
    from esr_tpu_torch.models.architecture import RRDBNet

    if not isinstance(model, RRDBNet):
        raise ValueError(f"{what} requires an RRDB generator, got {type(model).__name__}")


def make_outer_apply(model, trunk_fn):
    """``apply(lr, z=None) -> sr``: ``model``'s forward with its nb-block trunk
    delegated to ``trunk_fn(carry) -> carry`` (carry: the trunk features, or
    ``(trunk, z)`` with ``latent_input='all_layers'``)."""

    def apply(lr, z=None):
        return model(lr, z, trunk_fn=trunk_fn)

    return apply
