"""Checkpoints of the port, and ``exsr``'s generator weights as ``.npz``.

``exsr`` keeps Orbax checkpoints, which cannot be read without JAX and
Orbax.  The port has its own format: :class:`CheckpointManager` keeps one
``torch.save``d dict per step, ``<directory>/<step>.pt``, readable with
``weights_only=True``, with ``exsr``'s method names, its retention of the
newest ``max_to_keep`` steps and its save interval.  A training step's dict
is :meth:`exsr_torch.train.srragan.TrainState.state_dict` (the generator
under ``'g_params'``, which evaluation loads, D with its running
statistics, both Adam states, the L_struct ring, the random-number
generator, ``step`` and ``lr_scale``) plus the host controller's state
under ``'controller'``.

:func:`load_exsr_npz` reads an ``exsr`` generator exported as ``.npz``: one
array per leaf of its ``g_params`` tree, keyed by the leaf's path joined by
``/`` (the README gives the export, run where ``exsr`` is installed).  The
bridges of :mod:`exsr_torch.models.convert` take the tree from there.
"""
from __future__ import annotations

import os
import re
import warnings

import numpy as np
import torch

_STEP = re.compile(r'^(\d+)\.pt$')


class CheckpointManager:
    """A directory of steps, ``<step>.pt`` each; the newest
    ``max_to_keep`` are kept (None keeps all).  :meth:`save` writes a step
    when it is a multiple of ``save_interval_steps``, when the directory
    holds none yet, or when forced, and never over an existing or earlier
    step (Orbax's policy, as ``exsr`` configures it)."""

    def __init__(self, directory: str, max_to_keep: int | None = 3,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

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

    def save(self, step: int, state, controller_state: dict | None = None,
             force: bool = False) -> bool:
        """Write ``state`` (a dict of tensors, numbers and nested dicts, or
        anything with a ``state_dict()``) as ``step``, with
        ``controller_state`` beside it; False, and nothing written, when
        the policy says no.  The file is written beside its place and
        renamed into it, so a reader never sees half a step."""
        latest = self.latest_step()
        if step in self.all_steps():
            return False
        if not force and latest is not None and (
                latest >= step or step % self.save_interval_steps):
            return False
        payload = dict(state.state_dict() if hasattr(state, 'state_dict')
                       else state)
        if controller_state is not None:
            payload['controller'] = dict(controller_state)
        os.makedirs(self.directory, exist_ok=True)
        tmp = self._path(step) + '.tmp'
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        return True

    def restore_raw(self, step: int | None = None, map_location='cpu'
                    ) -> dict:
        """The dict saved at ``step`` (the latest when None)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f'no checkpoint in {self.directory}')
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)

    def restore(self, state=None, step: int | None = None,
                with_controller: bool = False, map_location='cpu'):
        """The step ``step`` (the latest when None): loaded into ``state``
        (anything with a ``load_state_dict``) and ``state`` returned, or,
        without one, the raw dict.  With ``with_controller`` the pair
        ``(state, controller state)``; a step saved without the controller
        warns and gives None for it."""
        raw = self.restore_raw(step, map_location)
        controller = raw.pop('controller', None)
        if state is not None:
            state = state.load_state_dict(raw) or state
        else:
            state = raw
        if not with_controller:
            return state
        if controller is None:
            warnings.warn(f'checkpoint step {step or self.latest_step()} '
                          'has no controller state; resuming with the '
                          "controller's defaults")
        return state, controller

    def restore_before(self, state, max_step: int):
        """Rollback: ``(step, state)`` restored from the newest checkpoint
        at or before ``max_step``, else the oldest there is."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError('no checkpoints available for rollback')
        eligible = [s for s in steps if s <= max_step]
        step = max(eligible) if eligible else min(steps)
        return step, self.restore(state, step)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


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
