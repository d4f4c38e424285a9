"""Training checkpoints and resume.

Counterpart of ``revisit_anything_tpu/training/checkpoint.py``:
``save_train_state``, ``latest_checkpoint``, ``save_best_state`` and
``restore_train_state``, with the ``step_%08d`` names and the
best-metric retention (mode max). The card's machine has no orbax, so
the port's format is its own: one ``torch.save`` file holding the
model's and the optimizer's state dicts and the step, written under a
temporary name and moved into place with ``os.replace``, so a crash
mid-save never leaves a partial file under a checkpoint's name. JAX
(orbax) checkpoints are not read; parameters cross between the packages
through ``weights.py``. A sharded state (``train.ShardedTrainState``)
writes the one-device state's file: every rank gathers, rank 0 writes,
and a restore slices the file to each rank, so a run resumes at another
(dp, tp); every rank of a sharded state calls these functions.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

_PARTIAL = ".partial"


def _save(path: str, state) -> None:
    model_sd, optimizer_sd = state.state_dicts()
    if state.writes_files:
        tmp = path + _PARTIAL
        torch.save({"model": model_sd, "optimizer": optimizer_sd,
                    "step": int(state.step)}, tmp)
        os.replace(tmp, path)
    state.barrier()


def save_train_state(ckpt_dir: str, state) -> str:
    """Save ``state`` (a ``train.VPRTrainState``) as
    ``<ckpt_dir>/step_<step:08d>``; returns the checkpoint path."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{int(state.step):08d}")
    _save(path, state)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest-step complete checkpoint in ``ckpt_dir``, or None
    (partial saves are skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [d for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(_PARTIAL)]
    if not steps:
        return None
    return os.path.join(ckpt_dir, sorted(steps)[-1])


def save_best_state(ckpt_dir: str, state, metric: float,
                    monitor: str) -> Optional[str]:
    """Write ``<ckpt_dir>/best`` when ``metric`` improves on the value in
    ``best_metric.json`` (ModelCheckpoint(monitor=..., mode='max'));
    returns the path when saved, None otherwise."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    meta_path = os.path.join(ckpt_dir, "best_metric.json")
    prev = -float("inf")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            prev = json.load(f)["metric"]
    if metric <= prev:
        return None
    path = os.path.join(ckpt_dir, "best")
    _save(path, state)
    if state.writes_files:
        tmp = meta_path + _PARTIAL
        with open(tmp, "w") as f:
            json.dump({"metric": float(metric), "monitor": monitor,
                       "step": int(state.step)}, f)
        os.replace(tmp, meta_path)
    state.barrier()
    return path


def restore_train_state(path: str, state) -> None:
    """Load a checkpoint into ``state`` (a train state built for the same
    configuration, one-device or sharded: its model, optimizer and step
    are overwritten)."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.load_state_dicts(ckpt["model"], ckpt["optimizer"])
    state.step = int(ckpt["step"])
