"""Checkpoints of the port, and ``exsr``'s generator weights as ``.npz``.

``exsr`` keeps Orbax checkpoints, which cannot be read without JAX and
Orbax.  The port has its own format: :class:`CheckpointManager` keeps one
``torch.save``d dict per step, ``<directory>/<step>.pt``, with ``exsr``'s
method names and its retention of the newest ``max_to_keep`` steps.

:func:`load_exsr_npz` reads an ``exsr`` generator exported as ``.npz``: one
array per leaf of its ``g_params`` tree, keyed by the leaf's path joined by
``/`` (the README gives the export, run where ``exsr`` is installed).  The
bridges of :mod:`exsr_torch.models.convert` take the tree from there.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

_STEP = re.compile(r'^(\d+)\.pt$')


class CheckpointManager:
    """A directory of steps, ``<step>.pt`` each, holding the dict given to
    :meth:`save`; the newest ``max_to_keep`` are kept (None keeps all)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'{step}.pt')

    def all_steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> bool:
        """Write ``state`` (tensors, numbers, nested dicts) as ``step``;
        False, and nothing written, if that step exists already.  The file
        is written beside its place and renamed into it, so a reader never
        sees half a step."""
        if step in self.all_steps():
            return False
        os.makedirs(self.directory, exist_ok=True)
        tmp = self._path(step) + '.tmp'
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def restore(self, step: int | None = None, map_location='cpu') -> dict:
        """The dict saved at ``step`` (the latest when None)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f'no checkpoint in {self.directory}')
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)


def load_exsr_npz(path: str) -> dict:
    """An ``.npz`` of ``exsr``'s ``g_params`` leaves, keyed by their paths
    joined by ``/``, as the nested dict of numpy arrays it was flattened
    from."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            node = tree
            *parents, leaf = key.split('/')
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = f[key]
    return tree
