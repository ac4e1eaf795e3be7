"""Fault-tolerant checkpointing: atomic, content-hashed, async.

The counterpart of ``repro/checkpoint/checkpoint.py``, with its layout and
guarantees.  Layout:  <dir>/step_<N>/arrays.npz + manifest.json; a
checkpoint becomes visible only by the final atomic rename of its temp
directory, so a crash mid-save can never corrupt the restore path.  The
manifest records per-leaf tree paths, shapes, dtypes and a payload sha256 —
restore verifies integrity before any array reaches a device.

A tree is nested dicts, lists, tuples and NamedTuples (`optim.adamw.
AdamWState`) of tensors, numpy arrays or Python numbers, and an
``nn.Module`` stands for its ``state_dict()``; leaf paths are written as
the reference's ``jax.tree_util.keystr`` writes them (``['key']``, ``[0]``,
``.field``).  bf16 leaves are stored as their uint16 bits (npz cannot hold
bfloat16, and the port does not import ``ml_dtypes``).  Leaves are copied
to the host before `save` returns, so an async save (a thread) may run
while the caller updates its tensors in place, as the trainer does.
`restore` writes into the example tree's tensors in place and returns it.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _items(tree, prefix=""):
    """(path, leaf) of every leaf, in order."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, f"{prefix}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _items(getattr(tree, k), f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _host(leaf):
    """(numpy array as stored, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        x = leaf.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = x.numpy().copy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _flatten(tree):
    out, dtypes = {}, {}
    for key, leaf in _items(tree):
        out[key], dtypes[key] = _host(leaf)
    return out, dtypes


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def save(ckpt_dir: str, step: int, tree, *, keep_last: int = 3,
         blocking: bool = True) -> str:
    """Write checkpoint; returns final path.  blocking=False writes in a
    background thread (the leaves are on the host before this returns)."""
    flat, dtypes = _flatten(tree)

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(ckpt_dir, f"step_{step:09d}")
        os.makedirs(tmp, exist_ok=True)
        payload = os.path.join(tmp, "arrays.npz")
        np.savez(payload, **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "sha256": _sha256(payload),
            "leaves": {k: {"shape": list(v.shape), "dtype": dtypes[k]}
                       for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomicity point
        _gc(ckpt_dir, keep_last)
        return final

    if blocking:
        return _write()
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return int(steps[-1].split("_")[1]) if steps else None


def _leaf(arr, dtype: str, like):
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {tuple(t.shape)} {t.dtype} "
                             f"does not fit {tuple(like.shape)} "
                             f"{like.dtype}")
        return t
    return type(like)(t.item()) if isinstance(like, (int, float)) else \
        t.numpy()


def restore(ckpt_dir: str, example_tree, step: int | None = None):
    """Restore into the structure of ``example_tree``: its tensors are
    overwritten in place (on their own devices), other leaves replaced.
    Integrity (sha256) is verified before anything is read.  Returns (tree,
    step)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    payload = os.path.join(path, "arrays.npz")
    if _sha256(payload) != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed integrity check")
    arrays = np.load(payload)
    return _fill(example_tree, arrays, manifest["leaves"], ""), step


def _fill(tree, arrays, leaves, prefix):
    if isinstance(tree, torch.nn.Module):
        _fill(tree.state_dict(), arrays, leaves, prefix)
        return tree
    if isinstance(tree, dict):
        return {k: _fill(v, arrays, leaves, f"{prefix}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_fill(getattr(tree, k), arrays, leaves,
                                  f"{prefix}.{k}") for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(v, arrays, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    value = _leaf(arrays[prefix], leaves[prefix]["dtype"], tree)
    if isinstance(tree, torch.Tensor):
        with torch.no_grad():
            tree.copy_(value)
        return tree
    return value
