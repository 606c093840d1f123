"""The explorable-SR editor (port of esr_tpu/explore): Z-search objectives,
the Z optimizer, the headless session, the view-model, the CLI and the Qt
GUI."""

from esr_tpu_torch.explore.objectives import (
    Objective,
    adversarial_objective,
    brightness_objective,
    histogram_objective,
    imprint_objective,
    periodicity_objective,
    random_diverse_objective,
    tv_objective,
    variance_objective,
)
from esr_tpu_torch.explore.session import ExplorationSession
from esr_tpu_torch.explore.viewmodel import EditorViewModel
from esr_tpu_torch.explore.z_optimizer import ZOptimizer, optimize_z, optimize_z_adaptive
