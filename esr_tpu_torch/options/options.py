"""Options (port of esr_tpu/options/options.py; stdlib only).

JSON (with ``//`` comments allowed) -> nested dict: expands dataset and model
paths, sets ``is_train``, propagates ``scale`` into each dataset block and
``network_G``, and wraps everything in a ``NoneDict`` so missing keys read as
``None``; ``check_resume`` points the pretrain paths at a resume state's
checkpoints; ``save`` dumps the parsed options into the experiment or
results dir. The schema is the JAX package's, so its JSON files
(``options/test/*.json`` and ``options/train/*.json``, copied here) parse to
the same dict.
"""

from __future__ import annotations

import copy
import json
import os
from collections import OrderedDict

__all__ = ["parse", "dict_to_nonedict", "NoneDict", "check_resume", "save"]


class NoneDict(dict):
    """dict whose missing keys read as None."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict({k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(x) for x in opt]
    return opt


def _strip_json_comments(text: str) -> str:
    lines = []
    for line in text.splitlines():
        pos = line.find("//")
        # keep '//' inside strings: only strip when the prefix has an even
        # number of quotes
        if pos >= 0 and line[:pos].count('"') % 2 == 0:
            line = line[:pos]
        lines.append(line)
    return "\n".join(lines)


def parse(opt_path: str | dict, is_train: bool = True) -> NoneDict:
    """Load an options JSON file (or dict) into a NoneDict."""
    if isinstance(opt_path, dict):
        # deep-copy, not a JSON round-trip: programmatic opts may carry
        # non-JSON leaves (e.g. a numpy downsampling kernel under opt['kernel'])
        opt = copy.deepcopy(opt_path)
    else:
        with open(opt_path) as f:
            opt = json.loads(_strip_json_comments(f.read()), object_pairs_hook=OrderedDict)

    opt["is_train"] = is_train
    scale = opt.get("scale", 4)

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        for key in ("dataroot_HR", "dataroot_LR"):
            if dataset.get(key):
                dataset[key] = os.path.expanduser(dataset[key])

    path_opt = opt.setdefault("path", {})
    for key, p in list(path_opt.items()):
        if p and "root" not in key and isinstance(p, str):
            path_opt[key] = os.path.expanduser(p)
    root = path_opt.get("root") or os.getcwd()
    path_opt["root"] = root
    if is_train:
        experiments_root = os.path.join(root, "experiments", opt.get("name", "exp"))
        path_opt["experiments_root"] = experiments_root
        path_opt["models"] = os.path.join(experiments_root, "models")
        path_opt["training_state"] = os.path.join(experiments_root, "training_state")
        path_opt["log"] = experiments_root
        path_opt["val_images"] = os.path.join(experiments_root, "val_images")
        if "debug" in opt.get("name", ""):
            train_opt = opt.setdefault("train", {})
            train_opt["val_freq"] = 8
            logger_opt = opt.setdefault("logger", {})
            logger_opt["print_freq"] = 1
            logger_opt["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(root, "results", opt.get("name", "exp"))
        path_opt["results_root"] = results_root
        path_opt["log"] = results_root

    if "network_G" in opt:
        opt["network_G"]["scale"] = scale

    return dict_to_nonedict(opt)


def check_resume(opt: dict) -> None:
    """With ``path.resume_state`` set, point ``pretrain_model_G`` (and, for a
    GAN model, ``pretrain_model_D``) at that state's network checkpoints,
    ``<experiment>/models/<iter>_G.pth``, unless they are set."""
    state_path = opt["path"].get("resume_state")
    if not state_path:
        return
    models = os.path.join(os.path.dirname(os.path.dirname(state_path)), "models")
    step = os.path.splitext(os.path.basename(state_path))[0]
    if not opt["path"].get("pretrain_model_G"):
        opt["path"]["pretrain_model_G"] = os.path.join(models, f"{step}_G.pth")
    if "gan" in (opt.get("model") or "") and not opt["path"].get("pretrain_model_D"):
        opt["path"]["pretrain_model_D"] = os.path.join(models, f"{step}_D.pth")


def _json_default(o):
    """Serialize non-JSON option leaves (numpy kernels etc.) best-effort: the
    dump is a human-readable record, not the source of truth."""
    if hasattr(o, "tolist"):
        return o.tolist()
    return repr(o)


def save(opt: dict, dump_dir: str | None = None) -> str:
    """Dump parsed options into the experiment or results dir."""
    dump_dir = dump_dir or opt["path"].get("experiments_root") or opt["path"].get("results_root")
    os.makedirs(dump_dir, exist_ok=True)
    dump_path = os.path.join(dump_dir, "options.json")
    with open(dump_path, "w") as f:
        json.dump(opt, f, indent=2, default=_json_default)
    return dump_path
