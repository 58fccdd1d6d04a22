"""Atomic, versioned checkpointing: the port of
``repro.train.checkpoint``, in its on-disk format, so that each package
restores the other's checkpoints bit for bit.

Layout on disk:
  <dir>/step_<N>/arrays.npz      the tree's leaves as ``leaf_<i>``, in
                                 JAX's leaf order (``core.tree``)
  <dir>/step_<N>/manifest.json   the tree's structure (``str`` of JAX's
                                 treedef), shapes, dtypes, metadata
  <dir>/step_<N>/.complete       commit marker (written LAST)

Guarantees:
  * atomic: a checkpoint is only valid once ``.complete`` exists; the
    step is written into a ``.tmp_*`` directory and renamed, and an
    interrupted write is removed by the next save;
  * ``keep_last`` trimming for bounded disk usage.

Differences from the reference, by design: ``restore`` takes ``device``
(default: each leaf on the device of its ``like`` leaf) where the
reference takes JAX shardings; ``train/elastic.recover`` restores onto
the host and places each leaf on a mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.core import tree

COMPLETE = ".complete"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, tree_: Any, metadata: dict | None = None,
         keep_last: int = 3) -> str:
    """Write one checkpoint atomically; returns the committed path."""
    leaves, treedef = tree.flatten(tree_)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "treedef": str(treedef),
            "n_leaves": len(leaves),
            "shapes": [list(np.shape(a)) for a in arrays.values()],
            "dtypes": [str(a.dtype) for a in arrays.values()],
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, COMPLETE), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    # remove orphaned tmp dirs from crashed saves
    for name in os.listdir(ckpt_dir):
        if name.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, name, COMPLETE)):
            out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_tensor(a: np.ndarray, like, device) -> torch.Tensor:
    """Leaf ``a`` as a tensor of ``like``'s dtype on ``device`` (``like``'s
    own device when None)."""
    t = torch.from_numpy(np.array(a))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device if device is None else device,
                    dtype=like.dtype)
    return t if device is None else t.to(device)


def restore(ckpt_dir: str, like: Any, step: int | None = None,
            device=None) -> tuple[Any, int]:
    """Restore into the structure of ``like`` (a tree template): each
    leaf in its ``like`` leaf's dtype, on ``device`` (default: the
    ``like`` leaf's device).  Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = _step_dir(ckpt_dir, step)
    if not os.path.exists(os.path.join(d, COMPLETE)):
        raise FileNotFoundError(f"checkpoint {d} incomplete")
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = [z[f"leaf_{i}"] for i in range(len(z.files))]
    like_leaves, treedef = tree.flatten(like)
    if len(arrays) != len(like_leaves):
        raise ValueError(f"leaf count mismatch: {len(arrays)} vs "
                         f"{len(like_leaves)}")
    placed = [_to_tensor(a, b, device) for a, b in zip(arrays, like_leaves)]
    return tree.unflatten(treedef, placed), step


def read_metadata(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)["metadata"]
