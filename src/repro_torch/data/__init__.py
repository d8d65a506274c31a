"""Deterministic synthetic data pipeline with a prefetching host thread:
the reference's ``repro.data``.

Every batch is a pure function of (seed, step) — `synth_batch`, numpy,
bitwise the reference's — so a restart resumes the exact data stream and
no loader state goes into checkpoints.  `ShardedPipeline` builds each
batch in a background thread on the host, in pinned memory when the
target is a CUDA device, and the consumer copies it to the device on its
current stream (`__next__`).  With `shardings` (one
`sharding.NamedSharding` per batch key, `train.batch_pspecs` on a mesh
with process groups) each rank keeps only its block of every global
batch: its rows, ranks numbered pod-major (rank = pod * D + data, the
order ``jax.make_mesh`` gives devices).  The global batch is still a pure
function of (seed, step), so the ranks' rows tile it.

Prefetch threads and interpreter exit: a pipeline that is never closed
leaves its daemon thread producing batches forever, and a thread still
inside the runtime while CPython tears the process down can abort it
after an otherwise green exit.  Every live pipeline is tracked in a weak
set and stopped by an atexit hook (atexit runs before interpreter
teardown, so the threads are joined while the runtime is whole).  Prefer
`close()` (or ``with ShardedPipeline(...) as pipe:``): the hook is the
backstop, not the API.
"""
from __future__ import annotations

import atexit
import queue
import threading
import weakref
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device

_LIVE_PIPELINES: "weakref.WeakSet" = weakref.WeakSet()


def _close_all_pipelines() -> None:
    """atexit backstop: stop every still-running prefetch thread."""
    for pipe in list(_LIVE_PIPELINES):
        pipe.close()


atexit.register(_close_all_pipelines)


def synth_batch(cfg: ModelConfig, step: int, batch: int, seq: int,
                seed: int = 0) -> dict:
    """Markov-ish synthetic tokens (learnable structure, so the loss
    falls), as CPU tensors of the reference's numpy arrays' dtypes and
    bits: int64 tokens (numpy's cumsum widens), int32 targets, or float32
    / bf16 frame embeddings for ``input_mode="embeddings"``."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    v = cfg.vocab
    base = rng.integers(0, v, size=(batch, 1), dtype=np.int32)
    drift = rng.integers(0, 7, size=(batch, seq), dtype=np.int32)
    toks = (base + np.cumsum(drift, axis=1)) % v
    if cfg.input_mode == "embeddings":
        emb = torch.from_numpy(
            rng.standard_normal((batch, seq, cfg.d_model)).astype(np.float32))
        inputs = emb.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" \
            else emb
    else:
        inputs = torch.from_numpy(toks)
    targets = torch.from_numpy(np.roll(toks, -1, axis=1).astype(np.int32))
    return {"inputs": inputs, "targets": targets}


class ShardedPipeline:
    """Prefetching iterator of (step, batch on `device`)."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq: int,
                 shardings: Optional[dict] = None, seed: int = 0,
                 depth: int = 2, start_step: int = 0,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.shardings = shardings
        self.seed = seed
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        _LIVE_PIPELINES.add(self)
        self._thread.start()

    def _make(self, step: int) -> dict:
        host = synth_batch(self.cfg, step, self.batch, self.seq, self.seed)
        if self.shardings is not None:
            host = {k: self.shardings[k].local(v).contiguous()
                    for k, v in host.items()}
        if self._pin:
            host = {k: v.pin_memory() for k, v in host.items()}
        return host

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                self._q.put((self._step, self._make(self._step)),
                            timeout=0.5)
                self._step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, host = self._q.get()
        return step, {k: v.to(self.device, non_blocking=self._pin)
                      for k, v in host.items()}

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
        if self._thread.is_alive():
            # the worker re-checks _stop every <= 0.5 s put attempt, so it
            # can only be finishing one batch build: wait it out rather
            # than leave a thread running at interpreter teardown
            self._thread.join(timeout=60)
        if not self._thread.is_alive():
            # a thread that still has not joined stays in the weak set so
            # the atexit backstop gets another chance at teardown
            _LIVE_PIPELINES.discard(self)

    def __enter__(self) -> "ShardedPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
