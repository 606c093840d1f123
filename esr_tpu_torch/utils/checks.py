"""Numerical-safety checks (port of esr_tpu/utils/checks.py): scans for NaN
and Inf over nested dicts, lists and tuples of tensors (or numpy arrays),
reported by key path (``['G'][0]``, as JAX's ``keystr`` writes them, dict
keys in sorted order), a
step wrapper that reports its non-finite outputs, and a purity check (the
same inputs give the same outputs: no hidden state, reused random streams
or inputs modified in place)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["assert_finite", "assert_pure", "checkify_step", "find_nonfinite"]


def _leaves(tree, path: str = ""):
    if isinstance(tree, dict):  # in sorted key order, as JAX flattens a dict
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype, np.floating):
        return bool(np.isfinite(leaf).all())
    if isinstance(leaf, float):
        return bool(np.isfinite(leaf))
    return True


def find_nonfinite(tree) -> list[str]:
    """Key paths of the float leaves holding a NaN or an Inf (one host read
    per leaf)."""
    return [path for path, leaf in _leaves(tree) if not _finite(leaf)]


def assert_finite(tree, what: str = "tree") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad[:10]}")


class StepError:
    """What :func:`checkify_step` found: ``get()`` is the message or None;
    ``throw()`` raises ``FloatingPointError`` with it."""

    def __init__(self, bad: list[str]):
        self.bad = bad

    def get(self) -> str | None:
        return f"non-finite step outputs: {self.bad[:10]}" if self.bad else None

    def throw(self) -> None:
        if self.bad:
            raise FloatingPointError(self.get())


def checkify_step(step_fn):
    """``wrapped(*args, **kwargs) -> (err, out)`` with ``err`` a
    :class:`StepError` naming the step's non-finite outputs; ``err.throw()``
    raises. This checks what the step returns, once it has run, not every
    operation inside it as JAX's ``checkify`` float checks do: a NaN that
    the step makes and then drops goes unseen."""

    def wrapped(*args, **kwargs):
        out = step_fn(*args, **kwargs)
        return StepError(find_nonfinite(out)), out

    return wrapped


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy(v) for v in tree)
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree.clone() if isinstance(tree, torch.Tensor) else tree.copy()
    return tree


def assert_pure(step_fn, *args, atol: float = 0.0) -> None:
    """Run ``step_fn`` on a copy of ``args``, then on ``args``, and require
    the same outputs (to ``atol``), leaf by leaf."""
    out1 = step_fn(*_copy(args))
    out2 = step_fn(*args)
    leaves1, leaves2 = list(_leaves(out1)), list(_leaves(out2))
    if [p for p, _ in leaves1] != [p for p, _ in leaves2]:
        raise AssertionError("the two runs returned differently shaped results")
    for (path, a), (_, b) in zip(leaves1, leaves2):
        if isinstance(a, (torch.Tensor, np.ndarray)):
            a, b = torch.as_tensor(a), torch.as_tensor(b)
            diff = 0.0 if a.numel() == 0 else (a.double() - b.double()).abs().max().item()
            if not (diff <= atol if atol else torch.equal(a, b)):
                raise AssertionError(f"step is not pure at {path}: max |out1 - out2| {diff}")
        elif a != b:
            raise AssertionError(f"step is not pure at {path}: {a!r} != {b!r}")
