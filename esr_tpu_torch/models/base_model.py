"""The eval forward and the models' shared surface (port of the single-device
parts of esr_tpu/models/base_model.py).

``make_eval_forward``: the generator, then the exact CEM projection (on
CUDA, a CUDA graph per input shape: ``EvalForward``).
``BaseModel``: what the CLIs and the export path call on a model —
``_make_forward`` (the options' wrappers around ``make_eval_forward``),
``load_network``, the visuals getters and the training surface: losses,
learning rate, and checkpoints as torch files (``<iter>_<net>.pth`` network
state_dicts, ``<iter>.state`` training states; the JAX package writes orbax
directories, which the port cannot read).

The optimiser is optax's: ``multistep_schedule`` is its piecewise-constant
MultiStepLR (a milestone m applies from count m on), ``step_keyed`` reads it
at the 1-based global step for an optimiser that updates every step, and ``Adam``
computes ``m_hat / (sqrt(v_hat) + eps)`` after an optional global-norm clip
written to ``optax.clip_by_global_norm``'s formula.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from torch import nn

import esr_tpu_torch.parallel as P
from esr_tpu_torch.data.util import parse_size
from esr_tpu_torch.models.architecture import RRDBNet
from esr_tpu_torch.models.networks import normalize_rrdb_keys
from esr_tpu_torch.ops.color import tensor2img, to_uint8
from esr_tpu_torch.ops.ensemble import make_self_ensemble
from esr_tpu_torch.parallel import comm
from esr_tpu_torch.parallel.dp import BatchComm, GradSync, StepParallel
from esr_tpu_torch.utils.graphs import StepGraphs

__all__ = [
    "Adam",
    "BaseModel",
    "EvalForward",
    "TrainStep",
    "make_eval_forward",
    "multistep_schedule",
    "opt_float",
    "step_generator",
    "step_keyed",
]

def opt_float(cfg: dict | None, key: str, default: float) -> float:
    """Numeric option that honours an explicit 0 (``gan_weight: 0`` is an
    ablation, not the default): only a missing or None key takes ``default``."""
    v = (cfg or {}).get(key)
    return float(default if v is None else v)


def multistep_schedule(lr: float, steps, gamma: float = 0.5):
    """MultiStepLR as optax's ``piecewise_constant_schedule``: ``lr`` times
    ``gamma`` for every milestone at or below ``count``."""
    bounds = sorted(int(s) for s in (steps or []))

    def schedule(count: int) -> float:
        return float(lr * gamma ** sum(count >= b for b in bounds))

    return schedule


def step_keyed(schedule):
    """A count-keyed schedule read at the 1-based global step, for an
    optimiser that updates every step: the k-th update reads ``schedule(k)``
    (optax reads the k-th update at count k - 1)."""
    return lambda count: schedule(count + 1)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one train step's random numbers (augment codes,
    Z, the WGAN-GP weights): a pure function of (seed, step), so a resumed
    run draws what the original drew."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return torch.Generator().manual_seed(int(state[0]) << 32 | int(state[1]))


class Adam:
    """optax ``adam`` (b1, b2, eps 1e-8), after ``clip_by_global_norm`` when
    ``grad_clip`` is set, over a list of parameters. ``step(grads, lr)``
    applies one update with learning rate ``lr``; ``count`` is the number of
    updates applied. Skipping ``step`` leaves the moments and the count as
    they are (a gated update).

    The update reads its step scalars (the learning rate and the bias
    corrections ``1 - b1^t``, ``1 - b2^t``) from ``scalars``, a tensor on
    the parameters' device, never from Python floats: a CUDA graph of a step
    replays with the values written there before each replay. The host
    computes them (:meth:`next_scalars`: float64, then the parameters'
    dtype) and counts the update; ``step(grads, lr)`` does both and updates,
    ``step(grads)`` updates at the scalars staged before (:meth:`stage`, or
    a slot copy of a chunk's rows: ``scalar_rows``)."""

    def __init__(self, params, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 grad_clip: float | None = None):
        self.params = [p for p in params]
        self.b1, self.b2, self.eps, self.grad_clip = b1, b2, eps, grad_clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        p0 = self.params[0]
        self.scalars = torch.zeros(3, dtype=p0.dtype, device=p0.device)  # lr, 1 - b1^t, 1 - b2^t

    def next_scalars(self, lr: float) -> tuple[float, float, float]:
        """Count one update and return its step scalars, on the host."""
        self.count += 1
        return float(lr), 1 - self.b1**self.count, 1 - self.b2**self.count

    def scalar_rows(self, rows) -> torch.Tensor:
        """Rows of :meth:`next_scalars` as one (k, 3) tensor on the device (one upload)."""
        table = torch.tensor(rows, dtype=torch.float64).to(self.scalars.dtype)
        return table.to(self.scalars.device, non_blocking=True)

    def set_scalars(self, row) -> None:
        """Write one row of :meth:`next_scalars` for the next :meth:`step`."""
        self.scalars.copy_(self.scalar_rows([row])[0])

    def stage(self, lr: float) -> None:
        """Count one update at ``lr`` and write its scalars for the next :meth:`step`."""
        self.set_scalars(self.next_scalars(lr))

    def clip(self, grads: list, sq_sum=None) -> list:
        """optax: ``g`` if the global norm is below ``grad_clip``, else
        ``g / norm * grad_clip`` (no epsilon, unlike ``clip_grad_norm_``).
        ``sq_sum(grads)``: the squared global norm when ``grads`` are one
        rank's share of it (``GradSync.sq_sum``); by default their own."""
        sq = sq_sum(grads) if sq_sum is not None else sum(torch.sum(g.float() ** 2) for g in grads)
        norm = torch.sqrt(sq)
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        return [g * scale.to(g.dtype) for g in grads]

    @torch.no_grad()
    def step(self, grads: list, lr: float | None = None, sq_sum=None) -> None:
        """One update: at ``lr`` (staged here), or with ``lr`` None at the
        scalars staged before; ``sq_sum`` as in :meth:`clip`. Device work
        only when ``lr`` is None (what a CUDA graph captures)."""
        if lr is not None:
            self.stage(lr)
        if self.grad_clip:
            grads = self.clip(grads, sq_sum)
        lr_t, bc1, bc2 = self.scalars.unbind()
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        # lr * upd rounded, then subtracted: the host-scalar form's alpha=-lr fused the two
        torch._foreach_mul_(upd, lr_t)
        torch._foreach_sub_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": list(self.mu), "nu": list(self.nu)}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
            for d, v in zip(dst, state[key], strict=True):
                d.copy_(v)


class TrainStep:
    """A train step in two parts, so that its device part can be a CUDA
    graph (``utils/graphs.py``):

    - ``prepare(*args) -> (key, inputs, rows)``, eager: the data pipeline and
      the host's draws (``inputs``: the tensors the device part reads), the
      host decision that selects the graph (``key``), and each optimiser's
      step scalars (``rows``: ``[(opt, opt.next_scalars(lr)), ...]``, which
      counts its update);
    - ``core(key, **inputs) -> metrics``: forward, backward and the updates
      (``opt.step(grads)`` at the staged scalars), device work only.

    Calling it runs one step eagerly: prepare, stage the rows, core."""

    def __init__(self, prepare, core):
        self.prepare, self.core = prepare, core

    def __call__(self, *args, **kwargs) -> dict:
        key, inputs, rows = self.prepare(*args, **kwargs)
        for opt, row in rows:
            opt.set_scalars(row)
        return self.core(key, **inputs)


class EvalForward:
    """``fwd(lr, z=None) = cem.project(g(lr, z), lr)`` (:func:`make_eval_forward`).

    ``graphs`` (a ``StepGraphs``): on CUDA in one process, without
    ``apply_fn``, one CUDA graph per shape of ``lr`` and ``z`` (``z`` None
    is a shape of its own), the port's counterpart of the JAX package's
    per-shape compiled forward. The first call of a shape runs eagerly on a
    side stream (the kernels' build, cuDNN's and cuBLAS's choices, CEM's
    per-shape constants) and captures; later calls copy ``lr`` and ``z``
    into the graph's buffers and replay. Each call returns a fresh tensor (a
    device copy of the graph's output), which the next call does not
    overwrite. The graphs hold the addresses of the kernels' weight
    layouts: every call compares ``g.layout_generation`` (a host int) with
    the one its graphs were captured at and drops them when it has moved
    (``prepare_kernels`` / ``release_kernels`` since). Elsewhere (the CPU,
    several ranks, a sharded ``apply_fn``, ``graphs=False``) every call runs
    eagerly."""

    def __init__(self, g: RRDBNet, cem=None, self_ensemble: bool = False, apply_fn=None, graphs: bool = True):
        self.g = g
        self.device = next(g.parameters()).device
        g.prepare_kernels()
        self.generation = g.layout_generation
        apply_raw = apply_fn or g
        apply_raw = make_self_ensemble(apply_raw) if self_ensemble else apply_raw

        @torch.no_grad()
        def run(key, lr: torch.Tensor, z: torch.Tensor | None) -> torch.Tensor:  # noqa: ARG001
            raw = apply_raw(lr, z)
            return cem.project(raw, lr) if cem is not None else raw

        self._run = run
        on_card = graphs and self.device.type == "cuda"
        n_world = comm.world()[1]
        if on_card and (apply_fn is not None or n_world > 1):
            logging.getLogger("base").info(
                "eval forward: %s runs each call eagerly, not as a CUDA graph per shape",
                "a sharded forward" if apply_fn is not None else f"each of {n_world} ranks")
        self.graphs = StepGraphs(run, self.device, "eval forward",
                                 enabled=on_card and apply_fn is None and n_world == 1)

    def _sync_layouts(self) -> None:
        """Drop the graphs when the generator's weight layouts changed since their capture."""
        if self.g.layout_generation != self.generation:
            self.graphs.clear()
            self.generation = self.g.layout_generation

    @torch.no_grad()
    def __call__(self, lr: torch.Tensor, z: torch.Tensor | None = None) -> torch.Tensor:
        for name, t in (("lr", lr), ("z", z)):
            if t is not None and t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the generator on {self.device}")
        if not self.graphs.enabled:
            return self._run(None, lr, z)
        self._sync_layouts()
        return self.graphs.run(None, {"lr": lr, "z": z}).clone()


def make_eval_forward(g: RRDBNet, cem=None, self_ensemble: bool = False, apply_fn=None,
                      graphs: bool = True) -> EvalForward:
    """``fwd(lr, z=None) = cem.project(g(lr, z), lr)`` (raw ``g`` when ``cem``
    is None), without autograd. With ``self_ensemble`` the generator call is
    the x8 dihedral mean (``ops/ensemble.py``: two batched calls), projected
    once. lr: (N, H, W, 3) and z: (N, H, W, nz) on the generator's device;
    the answer is (N, sH, sW, 3) f32. ``apply_fn(lr, z)``: the generator's
    forward when it is not ``g`` itself (a sharded one of ``parallel/``). The
    kernels' weight layout is built here, once: make a new forward after
    changing g's weights. On CUDA in one process each input shape is a CUDA
    graph (:class:`EvalForward`); ``graphs=False`` runs every call eagerly."""
    return EvalForward(g, cem, self_ensemble, apply_fn, graphs)


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """NHWC ``x`` with its last row repeated ``n`` more times (edge padding of H)."""
    return torch.cat([x, x[:, -1:].expand(-1, n, -1, -1)], dim=1)


class BaseModel:
    """Eval surface shared by the SR models. Subclasses set ``g_module``,
    ``cem``, ``nz``, ``scale`` and ``device``."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.is_train = bool(opt.get("is_train"))
        self._visuals: dict = {}
        self._losses: dict = {}
        self.schedulers: dict = {}  # name -> schedule (logging)
        self.step = 0

    def _parallel_shards(self, key: str) -> int:
        """A shard-count option (``eval_tp`` / ``eval_pp`` / ``eval_spatial`` /
        ``train_tp`` / ``train_pp`` / ``train_spatial``, top level or in the
        ``train`` block): unset, 0 or false -> 0; ``true`` or 1 raise (the
        count of ranks must be given); else the count."""
        v = self.opt.get(key)
        if v is None:
            v = (self.opt.get("train") or {}).get(key)
        if not v:
            return 0
        if isinstance(v, bool) or int(v) < 2:
            raise ValueError(f"{key} must be the shard count (an integer >= 2), got {v!r}; e.g. {key}: "
                             f"{max(2, comm.world()[1])}")
        return int(v)

    def _make_forward(self, graphs: bool = True):
        """The eval forward of ``make_eval_forward`` with the options' wrappers:
        ``self_ensemble`` outermost around the generator, then CEM.
        ``network_G.fold`` > 1 runs the unfolded forward (its spatial-fold
        rewrite is a TPU lane layout computing the same function).

        The sharded forwards, over the ranks of the process group (one per
        device; ``parallel/``): ``eval_tp: T`` channel-shards the trunk over a
        'model' axis, ``eval_pp: S`` pipelines it over S stages (microbatches
        from each call's batch, ``eval_pp_micro`` to set them),
        ``eval_spatial: S`` shards LR height over a 'spatial' axis with the
        exact-edge windows (``eval_spatial_halo``, 32 by default; heights
        edge-padded to a multiple of S with at least 2*halo rows a shard,
        the SR cropped back), and with ``eval_tp`` the composed spatial x TP
        forward. ``dist_eval`` / ``eval_batch`` add a 'data' axis of the
        ranks left over to TP or spatial; ``eval_pp`` streams the batch. The
        mesh is kept (``_eval_mesh``) for the evaluator, which deals images
        over its 'data' axis. ``eval_tp`` with ``eval_pp``, ``eval_spatial``
        with ``eval_pp``, and spatial x TP x data raise, as in the JAX
        package. Every rank of the mesh calls the forward alike. ``graphs``:
        as in ``make_eval_forward`` (a trainer's validation forward, built
        anew for each validation, runs eagerly)."""
        lg = logging.getLogger("base")
        tp = self._parallel_shards("eval_tp")
        pp = self._parallel_shards("eval_pp")
        sp = self._parallel_shards("eval_spatial")
        if tp > 1 and pp > 1:
            raise ValueError("eval_tp and eval_pp are mutually exclusive")
        if sp > 1 and pp > 1:
            raise ValueError("eval_spatial and eval_pp are mutually exclusive (the GPipe ring owns the whole "
                             "trunk; shard H with eval_spatial alone or with eval_tp)")
        batched = bool(self.opt.get("dist_eval")) or int(self.opt.get("eval_batch") or 0) > 1
        if sp > 1 and tp > 1 and batched:
            raise ValueError("eval_spatial x eval_tp does not additionally compose with dist_eval/eval_batch "
                             "— drop one of the three")
        fold = int((self.opt.get("network_G") or {}).get("fold") or 1)
        if fold > 1:
            lg.info("network_G.fold=%d: the port runs the unfolded forward (the same function); "
                    "eval_spatial_fold does not apply", fold)
        n_world = comm.world()[1]
        g, apply_raw = self.g_module, None
        self._eval_mesh = None
        if sp > 1:
            hv = self.opt.get("eval_spatial_halo")
            halo = 32 if hv is None else int(hv)
            if tp > 1:
                self._eval_mesh = P.make_spatial_tp_mesh(sp, tp)
                sharded = P.spatial_tp_apply(g, self._eval_mesh, halo=halo, scale=self.scale)
            else:
                data_n = max(1, n_world // sp) if batched else 1
                self._eval_mesh = P.make_mesh(sp * data_n, data=data_n, spatial=sp)
                sharded = P.spatial_window_forward(g, self._eval_mesh, scale=self.scale, halo=halo)

            def apply_raw(lr, z, _f=sharded, _s=sp):
                # any height: edge-pad H to a shard multiple with >= 2*halo rows a shard, crop the SR back
                h = lr.shape[1]
                hp = max(-(-h // _s), 2 * halo) * _s
                if hp != h:
                    lr = _pad_rows(lr, hp - h)
                    z = None if z is None else _pad_rows(z, hp - h)
                return _f(lr, z)[:, : h * self.scale]
        elif tp > 1:
            data_n = max(1, n_world // tp) if batched else 1
            self._eval_mesh = P.make_tp_mesh(tp, data=data_n)
            apply_raw = P.tp_rrdb_apply(g, self._eval_mesh)
        elif pp > 1:
            self._eval_mesh = P.make_stage_mesh(pp)
            apply_raw = P.pipeline.pipelined_rrdb_apply_auto(g, self._eval_mesh, requested=self.opt.get("eval_pp_micro"))
        se = bool(self.opt.get("self_ensemble"))
        if se:
            lg.info("self_ensemble: x8 dihedral eval forward (two batched calls: 4 flips + "
                    "4 transposed), CEM-projected mean")
        return make_eval_forward(g, self.cem, self_ensemble=se, apply_fn=apply_raw, graphs=graphs)

    def _train_parallel(self) -> StepParallel:
        """The train step's parallel axes (port of the JAX package's
        ``maybe_dp_step`` and ``_train_parallel_apply``), over the ranks of
        the process group:

        - ``dist``: data parallelism over every rank (unset: on when there
          are several ranks and the train batch divides over them; ``false``
          off, ``true`` on);
        - ``train_tp: T``: the trunk channel-sharded in place (each rank
          keeps 1/T of the trunk's conv kernels and of their Adam moments)
          with DP over the ranks left (the largest divisor of the batch);
        - ``train_pp: S``: the trunk pipelined over S stages (microbatches
          from the batch, ``train_pp_micro`` to set them); the batch is not
          split;
        - ``train_spatial: S``: LR crop height sharded over S ranks with the
          exact-edge windows (``train_spatial_halo``: min(32, local/2) when
          unset), with DP over the ranks left or with ``train_tp``.

        The divisibility and halo errors come here, before the first step."""
        tp = self._parallel_shards("train_tp")
        pp = self._parallel_shards("train_pp")
        sp = self._parallel_shards("train_spatial")
        if tp > 1 and pp > 1:
            raise ValueError("train_tp and train_pp are mutually exclusive")
        if sp > 1 and pp > 1:
            raise ValueError("train_spatial and train_pp are mutually exclusive (the GPipe ring owns the whole "
                             "trunk; shard H with train_spatial alone or with train_tp)")
        lg = logging.getLogger("base")
        g = self.g_module
        n_world = comm.world()[1]
        batch = int(((self.opt.get("datasets") or {}).get("train") or {}).get("batch_size") or 0)

        def data_count(per: int) -> int:
            most = max(1, n_world // per)
            return max(d for d in range(1, most + 1) if batch % d == 0) if batch else most

        def g_ops(group_op, shard_op=None):
            names = [n for n, _ in g.named_parameters()]
            sharded = set(P.tensor.sharded_names(g))
            return lambda i: shard_op if names[i] in sharded else group_op

        if not (tp > 1 or pp > 1 or sp > 1):
            dist = self.opt.get("dist")
            use_dp = (n_world > 1 and batch > 0 and batch % n_world == 0) if dist is None else bool(dist)
            if not (use_dp and n_world > 1):
                return StepParallel()
            mesh = P.make_mesh(n_world)
            data = mesh.group("data")
            lg.info("dist: data parallelism over %d ranks", n_world)
            return StepParallel(mesh, None, BatchComm(data), GradSync([(data, "sum")]), GradSync([(data, "sum")]))
        if sp > 1:
            scale = self.scale
            hr_size = parse_size(((self.opt.get("datasets") or {}).get("train") or {}).get("HR_size"))[0]
            lr_rows = hr_size // scale
            if lr_rows % sp:
                raise ValueError(f"train_spatial: LR crop height {lr_rows} (HR_size {hr_size} / scale {scale}) does "
                                 f"not divide over {sp} spatial shards — pick HR_size so that (HR_size/scale) % {sp} "
                                 "== 0, or change train_spatial")
            local = lr_rows // sp
            if local < 2:
                raise ValueError(f"train_spatial: {sp} shards leave {local} LR rows per device at HR_size {hr_size} "
                                 f"(scale {scale}) — shrink the shard count or grow the crop")
            hv = (self.opt.get("train") or {}).get("train_spatial_halo")
            if hv is None:
                hv = self.opt.get("train_spatial_halo")
            halo = min(32, local // 2) if hv is None else int(hv)
            if 2 * halo > local:
                raise ValueError(f"train_spatial_halo {halo} needs 2*halo <= the local LR strip ({local} rows = "
                                 f"HR_size {hr_size} / scale {scale} / {sp} shards) — shrink the halo/shards or "
                                 "grow the crop")
            (lg.warning if halo < 8 else lg.info)(
                "train_spatial: %d-way H sharding, halo %d LR rows (window %d/%d rows per device)%s", sp, halo,
                local + 2 * halo, local,
                " — below the measured halo-decay floor (8); gradients are noticeably approximate at this crop "
                "size" if halo < 8 else "")
            if tp > 1:
                mesh = P.make_spatial_tp_mesh(sp, tp)
                lg.info("train_spatial x train_tp: %dx%d (spatial x model) mesh — activations 1/S, trunk params "
                        "1/T", sp, tp)
                fwd = P.spatial_tp_apply(g, mesh, halo=halo, scale=scale)
                spa, model = mesh.group("spatial"), mesh.group("model")
                return StepParallel(mesh, fwd, BatchComm(), GradSync([(spa, "sum"), (model, g_ops("mean"))]),
                                    GradSync([(spa, "mean"), (model, "mean")]))
            data_n = data_count(sp)
            mesh = P.make_mesh(data_n * sp, data=data_n, spatial=sp)
            lg.info("train_spatial: %dx%d (data x spatial) mesh — batch over 'data', LR height over 'spatial'",
                    data_n, sp)
            fwd = P.spatial_window_forward(g, mesh, scale=scale, halo=halo)
            data, spa = mesh.group("data"), mesh.group("spatial")
            return StepParallel(mesh, fwd, BatchComm(data), GradSync([(data, "sum"), (spa, "sum")]),
                                GradSync([(data, "sum"), (spa, "mean")]))
        if tp > 1:
            data_n = data_count(tp)
            mesh = P.make_tp_mesh(tp, data=data_n)
            lg.info("train_tp: %dx%d (data x model) mesh — batch sharded over 'data', trunk channels over 'model'",
                    data_n, tp)
            fwd = P.tp_rrdb_apply(g, mesh)
            data, model = mesh.group("data"), mesh.group("model")
            return StepParallel(mesh, fwd, BatchComm(data), GradSync([(data, "sum"), (model, g_ops("mean"))]),
                                GradSync([(data, "sum"), (model, "mean")]))
        mesh = P.make_stage_mesh(pp)
        req = (self.opt.get("train") or {}).get("train_pp_micro") or self.opt.get("train_pp_micro")
        fwd = P.pipeline.pipelined_rrdb_apply_auto(g, mesh, requested=req)
        stage = mesh.group("stage")
        names = [n for n, _ in g.named_parameters()]
        # the blocks a stage owns get their gradients there alone: summed; the rest alike: averaged
        owned = [n.startswith(("RRDB_trunk.", "latent_proj.")) for n in names]
        return StepParallel(mesh, fwd, BatchComm(), GradSync([(stage, lambda i: "sum" if owned[i] else "mean")]),
                            GradSync([(stage, "mean")]))

    def load_network(self, path: str) -> None:
        """Load a torch ``.pth`` state dict with the reference ESRGAN keys
        into the generator, strictly: the file this port's ``save_network``
        or ``esr_tpu/scripts/export_torch_weights.py`` writes, or a released
        reference ``*_G.pth`` in either of its key layouts
        (``networks.normalize_rrdb_keys``). The kernels' weight layouts built
        from the old weights are dropped, and an eval forward is rebuilt on
        the new ones, and so are the train step's CUDA graphs."""
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory (an orbax checkpoint of the JAX package?); the port loads a "
                "torch .pth state dict — convert it with `python -m esr_tpu.scripts.export_torch_weights "
                f"--kind rrdb --ckpt {path} --out G.pth`")
        state = normalize_rrdb_keys(torch.load(path, map_location=self.device, weights_only=True))
        self._drop_step_graphs()
        self._load_state(self.g_module, state)
        self.g_module.release_kernels()
        if getattr(self, "_forward", None) is not None:
            self._forward = self._make_forward()

    def feed_data(self, data: dict) -> None:
        self._data = data

    def get_current_visuals(self) -> dict:
        """Visuals as host numpy float arrays (fetched once, on demand)."""
        self._visuals = {
            k: v.float().cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in self._visuals.items()
        }
        return self._visuals

    def get_visuals_device(self) -> dict:
        """The stored visuals: tensors on the device where ``test()`` left
        them, host numpy for loader entries such as HR."""
        return self._visuals

    def get_visuals_uint8(self) -> dict:
        """Visuals as uint8 HWC images, converted on the device before the
        fetch (:func:`esr_tpu_torch.ops.color.to_uint8`)."""
        out = {}
        for k, v in self._visuals.items():
            if isinstance(v, np.ndarray):
                out[k] = tensor2img(v)
            else:
                a = to_uint8(v).cpu().numpy()
                out[k] = a[..., 0] if a.ndim == 3 and a.shape[-1] == 1 else a
        return out

    # -- training surface ----------------------------------------------------

    def _make_step_graphs(self, name: str) -> StepGraphs:
        """The train step's device part (``TrainStep.core``) as CUDA graphs,
        one per key, on CUDA in one process. Eager on the CPU, and with
        several ranks (logged): gloo's collectives cannot be captured, and a
        capture of NCCL's has not been checked."""
        n_world = comm.world()[1]
        if self.device.type == "cuda" and n_world > 1:
            logging.getLogger("base").info(
                "%s: %d ranks run each step eagerly, not as a CUDA graph (gloo collectives cannot be captured; "
                "a capture under NCCL is unverified)", name, n_world)
        return StepGraphs(self._train_step.core, self.device, name, enabled=self.device.type == "cuda" and n_world == 1)

    def _drop_step_graphs(self) -> None:
        """Drop the train step's graphs before weights or optimiser states are
        loaded again: they are written in place, and a graph holds addresses."""
        if getattr(self, "_step_graphs", None) is not None:
            self._step_graphs.clear()

    def _run_steps(self, prepared: list) -> dict:
        """Run prepared train steps in order (``TrainStep.prepare``'s ``(key,
        inputs, rows)``): each optimiser's step scalars for all of them, and
        their host-drawn inputs, uploaded at once; then for each step the slot
        copies of its scalars and its device part (a graph replay on CUDA).
        Returns the last step's metrics."""
        rows_of: dict = {}
        for _, _, rows in prepared:
            for opt, row in rows:
                rows_of.setdefault(opt, []).append(row)
        slots = {opt: iter(opt.scalar_rows(rows)) for opt, rows in rows_of.items()}
        if self.device.type == "cuda":
            for name, v in prepared[0][1].items():
                if isinstance(v, torch.Tensor) and v.device.type == "cpu":
                    up = torch.stack([inputs[name] for _, inputs, _ in prepared]).to(self.device, non_blocking=True)
                    for (_, inputs, _), t in zip(prepared, up):
                        inputs[name] = t
        metrics: dict = {}
        for key, inputs, rows in prepared:
            for opt, _ in rows:
                opt.scalars.copy_(next(slots[opt]))
            metrics = self._step_graphs.run(key, inputs)
        return metrics

    def _prep_batch(self, data: dict):
        """The loader batch as the train step takes it, on the device: the HR
        crops, or ``{'HR', 'LR'}`` when ``dataroot_LR`` is configured (paired
        LR, never synthesised)."""
        hr = torch.as_tensor(np.asarray(data["HR"])).to(self.device, non_blocking=True)
        if not getattr(self, "_paired_lr", False):
            return hr
        if data.get("LR") is None:
            raise ValueError("dataroot_LR is configured (paired-LR training) but the batch carries "
                             "no LR array — check the dataset/loader")
        return {"HR": hr, "LR": torch.as_tensor(np.asarray(data["LR"])).to(self.device)}

    def get_current_losses(self) -> dict:
        """The last step's metrics as host floats, fetched in one copy."""
        items = list(self._losses.items())
        if not items:
            return {}
        packed = torch.stack([torch.as_tensor(v, dtype=torch.float32).reshape(-1)[-1].to(self.device)
                              for _, v in items]).cpu().tolist()
        return {k: float(v) for (k, _), v in zip(items, packed)}

    def get_current_learning_rate(self) -> float:
        sched = next(iter(self.schedulers.values()), None)
        return float(sched(self.step)) if sched is not None else 0.0

    @staticmethod
    def _full_state(net: nn.Module) -> dict:
        """``net``'s state dict with the reference keys and shapes: a
        channel-sharded trunk's slices are gathered (collective)."""
        return P.tensor.full_state_dict(net) if getattr(net, "tp_group", None) is not None else net.state_dict()

    @staticmethod
    def _load_state(net: nn.Module, state: dict) -> None:
        """Load a reference state dict strictly, cut to the slices of a
        channel-sharded trunk."""
        if getattr(net, "tp_group", None) is not None:
            P.tensor.load_full_state_dict(net, state)
        else:
            net.load_state_dict(state, strict=True)

    def _opt_state(self, net: nn.Module, opt: Adam) -> dict:
        """``opt``'s state with the moments of a sharded trunk's slices gathered."""
        state = opt.state_dict()
        for key in ("mu", "nu"):
            state[key] = P.tensor.full_param_tensors(net, state[key])
        return state

    def _load_opt_state(self, net: nn.Module, opt: Adam, state: dict) -> None:
        state = dict(state)
        for key in ("mu", "nu"):
            state[key] = P.tensor.local_param_tensors(net, state[key])
        opt.load_state_dict(state)

    def save_network(self, net: nn.Module, network_label: str, iter_label) -> str:
        """``<models>/<iter>_<label>.pth``, written by rank 0 (every rank calls it)."""
        path = os.path.join(self.opt["path"]["models"], f"{iter_label}_{network_label}.pth")
        state = self._full_state(net)
        if comm.world()[0] == 0:
            torch.save(state, path)
        return path

    def _load_module(self, net: nn.Module, path: str) -> None:
        if os.path.isdir(path):
            raise ValueError(f"{path} is a directory (an orbax checkpoint of the JAX package?); the port "
                             "loads torch .pth state dicts")
        net.load_state_dict(torch.load(path, map_location=self.device, weights_only=True), strict=True)

    def save_training_state(self, epoch: int, iter_step: int, states: dict) -> str:
        """``<training_state>/<iter>.state``: epoch, iter and, per network, its
        state_dict and its optimiser's state; written by rank 0."""
        path = os.path.join(self.opt["path"]["training_state"], f"{iter_step}.state")
        if comm.world()[0]:
            return path
        tmp = path + ".tmp"
        torch.save({"epoch": int(epoch), "iter": int(iter_step), **states}, tmp)
        os.replace(tmp, path)
        return path

    def restore_training_state(self, path: str) -> dict:
        return torch.load(path, map_location=self.device, weights_only=True)

    @staticmethod
    def latest_state_path(state_dir: str) -> str | None:
        """The newest ``<iter>.state`` in ``state_dir`` (auto-resume)."""
        if not os.path.isdir(state_dir):
            return None
        states = [f for f in os.listdir(state_dir) if f.endswith(".state")]
        if not states:
            return None
        states.sort(key=lambda f: int(f.split(".")[0]))
        return os.path.join(state_dir, states[-1])
