"""The port's counterpart of every component of tests/test_inventory.py's
INVENTORY (the reference's component list), and of the JAX package's files
that no INVENTORY label names (the dry run, the probes, the export CLI):
each label names the port's ``(module, symbol)``, and the symbol is there
after importing the module in a process that has not loaded JAX, with
neither ``jax`` nor ``esr_tpu`` loaded by it. A label whose component is a
TPU layout or a JAX-side tool carries a written reason instead. One
parametrised case a label.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from test_inventory import INVENTORY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# labels whose port counterpart is not ``esr_tpu`` -> ``esr_tpu_torch`` with the same symbol
RENAMED = {
    "pallas hot-op kernel": ("esr_tpu_torch.ops.cuda.rdb_conv", "fused_rdb5c"),
    "5.5 device-side uint8 eval fetch": ("esr_tpu_torch.ops.color", "to_uint8"),
    # manifest.json + G.pth, not StableHLO + orbax: the serving artifact's documented divergence
    "serving: AOT StableHLO export": ("esr_tpu_torch.export", "export_servable"),
    # names that exist only with the feature (the JAX labels name the classes that carry it)
    "5.3 async checkpointing": ("esr_tpu_torch.models.base_model", "CheckpointWriter"),
    "2.14 logger": ("esr_tpu_torch.utils.logger", "open_tb_writer"),
}
NOT_APPLICABLE = {
    "perf: MXU-lane batch fold": "fold is a TPU MXU-lane layout (batch folded into channels); the port runs "
                                 "the same per-image math unfolded",
    "5.4 reverse converter (jax -> torch .pth)": "JAX-side: it turns a JAX param tree into a torch state dict, "
                                                 "which the port writes natively (save_network)",
    "5.4 reverse converter CLI": "JAX-side: export_torch_weights turns an orbax checkpoint into the .pth that the "
                                 "port's save_network writes itself",
}
# the JAX package's files that no INVENTORY label names
EXTRA = {
    "dry run: compile check entry": ("esr_tpu_torch.graft_entry", "entry"),
    "dry run: multi-device checks": ("esr_tpu_torch.graft_entry", "dryrun_multichip"),
    "5.1 step timer": ("esr_tpu_torch.utils.profiler", "StepTimer"),
    "5.2 step output checks": ("esr_tpu_torch.utils.checks", "checkify_step"),
    "probe: int8 / FP8 against bf16": ("esr_tpu_torch.ops.int8_probe", "run_probes"),
    "probe: RDB kernel tiles at the DIV2K eval shape": ("esr_tpu_torch.ops.cuda.tiled_probe", "run_tiled_probe"),
    "probe: folded VGG19 extractor": "fold is a TPU MXU-lane layout; the question of vgg_fold_probe does not "
                                     "arise without it",
    "serving: model-code-free loader of the artifact": ("esr_tpu_torch.export", "load_servable"),
    "loader: n_workers decode workers (create_grain_loader)": ("esr_tpu_torch.data", "create_worker_loader"),
}


def port_target(label: str):
    """The port's (module, symbol) of ``label``, or its n/a reason (a str)."""
    if label in EXTRA:
        return EXTRA[label]
    if label in NOT_APPLICABLE:
        return NOT_APPLICABLE[label]
    if label in RENAMED:
        return RENAMED[label]
    module, symbol = INVENTORY[label]
    return module.replace("esr_tpu", "esr_tpu_torch", 1), symbol


LABELS = sorted(INVENTORY) + sorted(EXTRA)
TARGETS = {label: port_target(label) for label in LABELS}


@pytest.fixture(scope="module")
def imported():
    """label -> (symbol found, JAX-side modules loaded by the import), from one
    process importing each label's module in turn."""
    todo = {label: t for label, t in TARGETS.items() if not isinstance(t, str)}
    code = (
        "import importlib, json, sys\n"
        f"todo = json.loads({json.dumps(json.dumps(todo))})\n"
        "out = {}\n"
        "for label, (module, symbol) in todo.items():\n"
        "    mod = importlib.import_module(module)\n"
        "    bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'esr_tpu') or "
        "m.startswith(('jax.', 'flax.', 'esr_tpu.')))\n"
        "    out[label] = [hasattr(mod, symbol), bad]\n"
        "print(json.dumps(out))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("label", LABELS)
def test_port_counterpart(label, imported):
    target = TARGETS[label]
    if isinstance(target, str):
        assert len(target) > 40, f"{label}: an n/a label needs a written reason"
        return
    found, bad = imported[label]
    assert found, f"{label}: {target[0]}.{target[1]} missing"
    assert not bad, f"{label}: importing {target[0]} loaded {bad}"
