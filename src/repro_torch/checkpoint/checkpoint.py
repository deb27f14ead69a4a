"""Atomic, resumable checkpoints in the layout of
``repro/checkpoint/checkpoint.py``, so that a checkpoint written by either
package restores in the other.

Layout::

    <dir>/step_00001234.tmp/      (written first)
        arrays.npz                flattened tree leaves by path key
        manifest.json             {step, keys, shapes, dtypes, extra}
    <dir>/step_00001234/          (atomic rename after manifest fsync)

A path key joins dict keys (sorted) and tuple indices with "/", as JAX
names them.  npz cannot hold bfloat16: such a leaf is stored as its uint16
bits, with "bfloat16" as its dtype in the manifest.

  * a crash mid-save leaves only a ``.tmp`` dir — ``latest_step`` ignores
    it, so restart resumes from the previous complete checkpoint;
  * ``restore`` places every leaf on the device of the matching leaf of
    the tree it is given, in that leaf's dtype, or, given ``shardings``,
    distributes it onto its ``(mesh, placements)`` target: save on one
    mesh, restore on another (the elastic restart);
  * ``save`` of a DTensor leaf writes the full tensor (a collective: every
    rank of its mesh calls ``save``, and global rank 0 writes);
  * the data cursor rides in ``extra``.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Placement

from ..tree import leaves_with_path

__all__ = ["save", "restore", "latest_step", "gc_old"]

# torch dtypes that numpy lacks: stored as the bits of this numpy type
# (read back through int16, which both have)
_VIEW_AS = {torch.bfloat16: (np.uint16, torch.int16)}
_DTYPE_NAME = {torch.bfloat16: "bfloat16"}
_BY_NAME = {"bfloat16": torch.bfloat16}


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype in _VIEW_AS:
        np_bits, torch_bits = _VIEW_AS[t.dtype]
        return t.view(torch_bits).numpy().view(np_bits)
    return t.numpy()


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor) and t.dtype in _DTYPE_NAME:
        return _DTYPE_NAME[t.dtype]
    return str(_to_numpy(t).dtype)


def _gather_full(tree):
    """The tree with every DTensor leaf gathered to its full tensor, and
    whether there was one."""
    found = []

    def leaf(t):
        if isinstance(t, DTensor):
            found.append(True)
            return t.full_tensor()
        return t

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(walk(v) for v in t)
        return leaf(t)

    return walk(tree), bool(found)


def save(ckpt_dir, step: int, tree, extra: Optional[dict] = None,
         keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    tree, sharded = _gather_full(tree)
    if sharded and dist.is_initialized():
        # one writer; the others wait until the step is published
        if dist.get_rank() == 0:
            _write(ckpt_dir, step, tree, extra, keep)
        dist.barrier()
        return ckpt_dir / f"step_{step:08d}"
    return _write(ckpt_dir, step, tree, extra, keep)


def _write(ckpt_dir: Path, step: int, tree, extra: Optional[dict],
           keep: int) -> Path:
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat: Dict[str, np.ndarray] = {}
    logical_dtypes = {}
    for key, leaf in leaves_with_path(tree):
        flat[key] = _to_numpy(leaf)
        logical_dtypes[key] = _dtype_name(leaf)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": logical_dtypes,
        "extra": extra or {},
    }
    mpath = tmp / "manifest.json"
    mpath.write_text(json.dumps(manifest))
    with open(mpath) as f:          # ensure manifest durably on disk
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)          # atomic publish
    gc_old(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_") \
                and not p.name.endswith(".tmp") \
                and (p / "manifest.json").exists():
            try:
                steps.append(int(p.name[5:]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def restore(ckpt_dir, step: int, tree_like, shardings=None
            ) -> tuple[Any, dict]:
    """Load a checkpoint into the structure of ``tree_like`` (nested dicts
    and tuples of tensors): each leaf takes the dtype and device of its
    counterpart there.  ``shardings``: a tree of the same structure whose
    leaves are ``(mesh, placements)`` targets (``param_shardings``) or
    None: a leaf with a target is distributed onto it (every rank of the
    mesh calls ``restore``)."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    data = np.load(d / "arrays.npz")
    targets = (dict(_targets(shardings)) if shardings is not None
               else {})
    out = []
    for key, like in leaves_with_path(tree_like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        ldt = _BY_NAME.get(manifest["dtypes"].get(key, str(arr.dtype)))
        if ldt is not None and arr.dtype == _VIEW_AS[ldt][0]:
            t = torch.from_numpy(np.array(arr).view(np.int16)).view(ldt)
        else:
            t = torch.from_numpy(np.array(arr))
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(
                f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs "
                f"expected {tuple(like.shape)}")
        t = t.to(device=like.device, dtype=like.dtype)
        if targets.get(key) is not None:
            from ..distributed.sharding import distribute
            t = distribute(t, targets[key])
        out.append(t)
    return _rebuild(tree_like, iter(out)), manifest["extra"]


def _is_target(x) -> bool:
    return (isinstance(x, tuple) and len(x) == 2
            and isinstance(x[1], (tuple, list))
            and all(isinstance(p, Placement) for p in x[1]))


def _targets(tree, prefix: str = ""):
    """(path, target) of a shardings tree, whose leaves are ``(mesh,
    placements)`` pairs or None, paths named as ``leaves_with_path``
    names them."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)) and not _is_target(tree):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _targets(v, f"{prefix}/{k}" if prefix else k)


def gc_old(ckpt_dir, keep: int) -> None:
    ckpt_dir = Path(ckpt_dir)
    steps = sorted(
        int(p.name[5:]) for p in ckpt_dir.iterdir()
        if p.is_dir() and p.name.startswith("step_")
        and not p.name.endswith(".tmp"))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
