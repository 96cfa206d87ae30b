"""Checkpointing with async writes and deterministic restart. Counterpart
of ``repro.training.checkpoint``, with its layout on disk (one directory
per step):

    ckpt_dir/step_000123/
        MANIFEST.json       — step, wall-clock, extra (e.g. the data
                              cursor), and each leaf's name, shape, dtype
        <leaf-path>.npy     — one file per leaf, on the host
        COMMITTED           — written last; restore ignores dirs without it

A step is written into ``step_<n>.tmp`` and renamed into place after
``COMMITTED``, so a crash mid-write leaves a directory that restore skips.
Leaves are named by their tree path (dict keys; ``_i`` for list entries;
joined by dots; dict keys visited in sorted order, as JAX flattens them).

numpy has no bfloat16: a bf16 leaf is stored as its ``uint16`` bit
pattern with ``"bfloat16"`` in the manifest, so a round trip is bit-exact.

``AsyncCheckpointer.save`` copies the trees to the host synchronously on
the caller's thread (a consistent snapshot: later in-place writes to the
tensors cannot tear it) and writes on a worker thread, so the train loop
overlaps the disk I/O with its next steps.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_map

MANIFEST = "MANIFEST.json"
COMMITTED = "COMMITTED"
BF16 = "bfloat16"


def _join(prefix: str, key) -> str:
    part = f"_{key}" if isinstance(key, int) else str(key)
    return f"{prefix}.{part}" if prefix else part


def _named(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path name, leaf) of every tensor of a nested dict/list tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named(tree[k], _join(prefix, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, _join(prefix, i))
    else:
        yield prefix, tree


def _rebuild(like, prefix: str, load: Callable):
    """``like``'s nesting with each leaf replaced by ``load(name, leaf)``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, _join(prefix, k), load)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, _join(prefix, i), load)
                for i, v in enumerate(like)]
    return load(prefix, like)


def _host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_copy(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def save(ckpt_dir: str, step: int, params, opt_state=None,
         extra: Optional[Dict] = None) -> str:
    """Synchronous checkpoint write. Returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)

    tree = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    manifest = {"step": step, "time": time.time(), "extra": extra or {},
                "leaves": [], "treedef": None}
    for name, leaf in _named(tree):
        arr, dtype = _host(leaf)
        np.save(os.path.join(tmp_dir, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "shape": list(arr.shape), "dtype": dtype})
    with open(os.path.join(tmp_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp_dir, COMMITTED), "w") as f:
        f.write("ok\n")
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    return step_dir


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training; keeps the last ``keep``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, params, opt_state=None,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        host_params = _host_copy(params)
        host_opt = _host_copy(opt_state) if opt_state is not None else None

        def work():
            try:
                save(self.ckpt_dir, step, host_params, host_opt, extra)
                self._gc()
            except Exception as e:          # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in list_steps(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, COMMITTED)):
            steps.append(int(m.group(1)))
    return sorted(steps)


def restore(ckpt_dir: str, step: int, like_params, like_opt=None):
    """Restore into the structure of ``like_*``: each leaf takes the
    like-leaf's device and dtype, and its shape is checked.

    Returns (step, params, opt_state, extra).
    """
    step_dir = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(step_dir, MANIFEST)) as f:
        manifest = json.load(f)
    dtypes = {e["name"]: e["dtype"] for e in manifest["leaves"]}

    def load(name, leaf):
        arr = np.load(os.path.join(step_dir, name + ".npy"))
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        if dtypes[name] == BF16:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=leaf.device, dtype=leaf.dtype)

    params = _rebuild(like_params, "params", load)
    opt_state = (_rebuild(like_opt, "opt_state", load)
                 if like_opt is not None else None)
    return manifest["step"], params, opt_state, manifest.get("extra", {})


def restore_latest(ckpt_dir: str, like_params, like_opt=None):
    steps = list_steps(ckpt_dir)
    if not steps:
        return None
    return restore(ckpt_dir, steps[-1], like_params, like_opt)
