"""Checkpointing: atomic, async-capable, in the reference's on-disk format.

Layout (``repro.ckpt``'s, file for file): <dir>/step_<N>/
  meta.json               step, leaf paths, shapes, dtypes
  <flattened-path>.npy    one file per leaf ("/" in the path -> "__"),
                          bfloat16 stored as its uint16 bits

so a checkpoint written by either package restores into the other.

Atomicity: write into step_<N>.tmp, fsync, rename — a crash mid-save
leaves the previous checkpoint intact, and `latest_step` never sees a
.tmp directory.  Async: ``save(..., background=True)`` copies every leaf
to the host first (the only blocking part) and writes the files on a
worker thread.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.optim import flatten_with_paths, unflatten_like


def _to_host(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf -> (savable numpy array, dtype name): bfloat16 as a uint16
    view, as the reference stores it."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_savable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir, step: int, state, *, background: bool = False,
         keep: int = 3) -> Optional[threading.Thread]:
    """Checkpoint `state` (a nested dict of tensors) at `step`; returns
    the writer thread when `background`."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    host = {path: _to_host(leaf)
            for path, leaf in flatten_with_paths(state).items()}

    def _write():
        tmp = ckpt_dir / f"step_{step}.tmp"
        final = ckpt_dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        meta = {"step": step, "leaves": {}}
        for path, (arr, dname) in host.items():
            fn = path.replace("/", "__") + ".npy"
            np.save(tmp / fn, arr)
            meta["leaves"][path] = {"file": fn, "shape": list(arr.shape),
                                    "dtype": dname}
        (tmp / "meta.json").write_text(json.dumps(meta))
        for f in tmp.iterdir():                     # durability before rename
            fd = os.open(f, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(ckpt_dir, keep)

    if background:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if not p.name.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, template):
    """Load `step` into the structure of `template`, each leaf on the
    device of the template's leaf at that path."""
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    meta = json.loads((d / "meta.json").read_text())
    out = {}
    for path, like in flatten_with_paths(template).items():
        info = meta["leaves"][path]
        t = _from_savable(np.load(d / info["file"]), info["dtype"])
        if list(t.shape) != info["shape"]:
            raise ValueError(f"{path}: file shape {list(t.shape)} vs "
                             f"meta {info['shape']}")
        out[path] = t.to(like.device)
    return unflatten_like(template, out)
