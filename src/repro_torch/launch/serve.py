"""Batched serving driver on one card: prefill + decode with a padded KV
cache (the reference's ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --requests 16 --prompt-len 64 --gen 32 [--batch 8] \\
      [--device cpu]

Continuous-batching lite: requests queue up, the engine packs up to
`batch` of them per wave (left-padded to the wave's longest prompt),
prefills once, then decodes step by step; a request leaving the wave
frees its slot for the next wave.  Greedy sampling (argmax) for
determinism.  The serving stats are the reference's: TTFT p50 (from
submission, every request submitted at the start, to its first token on
the host), inter-token p50 ((done - first) / (tokens - 1) per request),
tokens/s and wall seconds.  `--device` defaults to cuda (with no card it
raises).  The engine runs under ``torch.inference_mode()``.

On a mesh (``mesh=``, a `sharding.Mesh` with its DeviceMesh; every rank
of its group runs the same engine on the same requests) the params are
DTensors placed by `param_pspecs` under the config's profile rules, each
wave's rows split on "kv_batch", the cache placed as `cache_defs`
resolve it (the prefill's `shard` sites; each decode step writes its
token into every rank's block), and the greedy tokens gathered whole on
every rank; the mesh engine runs under ``torch.no_grad()``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: "np.ndarray"
    max_new: int
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    out: Optional[list] = None


class Engine:
    """One model on one device, or on a mesh.  `params` is a parameter
    tree on the device (e.g. the reference's carried across with
    ``models.params.tree_from_arrays``; placed on the mesh); None draws
    them from a ``torch.Generator`` seeded with `seed`."""

    def __init__(self, cfg, *, batch: int, max_len: int, mesh=None,
                 params=None, seed: int = 0, device=None):
        import torch

        from repro_torch import models, sharding, train
        from repro_torch.device import resolve_device

        self.torch, self.sharding = torch, sharding
        self.cfg, self.batch, self.max_len = cfg, batch, max_len
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = sharding.profile_rules(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = models.init_params(cfg, gen, mesh=mesh)
        elif mesh is not None:
            with sharding.use_mesh(mesh, self.rules):
                sh = sharding.spec_tree_to_shardings(
                    mesh, models.param_pspecs(cfg))
            params = sharding.distribute(params, sh)
        self.params = params
        self.prefill = train.make_prefill_step(cfg, max_len)
        self.decode = train.make_decode_step(cfg)

    def wave_inputs(self, reqs: list[Request]):
        """The wave's prefill inputs: left-padded tokens, or frame
        embeddings from default_rng(0) in the embeddings mode."""
        torch, cfg = self.torch, self.cfg
        B = len(reqs)
        S = max(len(r.prompt) for r in reqs)
        if cfg.input_mode == "embeddings":
            x = np.random.default_rng(0).standard_normal(
                (B, S, cfg.d_model)).astype(np.float32)
            return torch.from_numpy(x).to(self.device).to(cfg.cdtype())
        toks = np.zeros((B, S), np.int32)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt      # left-pad
        return torch.from_numpy(toks).to(self.device)

    def _step_inputs(self, nxt: np.ndarray):
        torch, cfg = self.torch, self.cfg
        if cfg.input_mode == "embeddings":
            return torch.zeros((len(nxt), 1, cfg.d_model),
                               dtype=cfg.cdtype(), device=self.device)
        return torch.from_numpy(nxt[:, None].copy()).to(self.device)

    def _placed(self, x):
        """A wave's inputs on the mesh: rows split on "kv_batch"."""
        if self.mesh is None:
            return x
        sh = self.sharding
        return sh.distribute(x, sh.named_sharding(
            "kv_batch", *([None] * (x.dim() - 1)), shape=x.shape))

    def _tokens(self, logits) -> np.ndarray:
        """The greedy tokens on the host, gathered whole on a mesh."""
        if self.sharding.is_dtensor(logits):
            logits = logits.full_tensor()
        return logits.argmax(-1).to(self.torch.int32).cpu().numpy()

    def run_wave(self, reqs: list[Request]) -> None:
        import contextlib
        ctx = (self.sharding.use_mesh(self.mesh, self.rules)
               if self.mesh is not None else contextlib.nullcontext())
        with ctx:
            self._run_wave(reqs)

    def _run_wave(self, reqs: list[Request]) -> None:
        # DTensor's views fail under inference mode (an inference tensor
        # has no version counter to share): a mesh serves under no_grad
        off = self.torch.no_grad if self.mesh is not None \
            else self.torch.inference_mode
        with off():
            logits, cache, pos = self.prefill(
                self.params, self._placed(self.wave_inputs(reqs)))
            nxt = self._tokens(logits)
            now = time.perf_counter()
            for i, r in enumerate(reqs):
                r.t_first = now
                r.out = [int(nxt[i])]
            max_new = max(r.max_new for r in reqs)
            for _ in range(max_new - 1):
                logits, cache = self.decode(
                    self.params, cache, self._placed(self._step_inputs(nxt)),
                    pos)
                pos += 1
                nxt = self._tokens(logits)
                now = time.perf_counter()
                for i, r in enumerate(reqs):
                    if len(r.out) < r.max_new:
                        r.out.append(int(nxt[i]))
                        if len(r.out) == r.max_new:
                            r.t_done = now
        for r in reqs:
            r.t_done = r.t_done or time.perf_counter()


def serve(cfg, requests: list[Request], *, batch: int, max_len: int,
          mesh=None, params=None, seed: int = 0, device=None) -> dict:
    """Serve `requests` in waves of `batch`; the reference's stats, and
    the first two completions."""
    eng = Engine(cfg, batch=batch, max_len=max_len, mesh=mesh,
                 params=params, seed=seed, device=device)
    t0 = time.perf_counter()
    for r in requests:
        r.t_submit = t0
    waves = [requests[i:i + batch] for i in range(0, len(requests), batch)]
    for wave in waves:
        eng.run_wave(wave)
    wall = time.perf_counter() - t0
    ttft = [r.t_first - r.t_submit for r in requests]
    tokens = sum(len(r.out) for r in requests)
    lat = [(r.t_done - r.t_first) / max(len(r.out) - 1, 1) for r in requests]
    return {"requests": len(requests), "tokens": tokens,
            "wall_s": wall, "tok_per_s": tokens / wall,
            "ttft_p50_ms": 1e3 * float(np.median(ttft)),
            "itl_p50_ms": 1e3 * float(np.median(lat)),
            "completions": [r.out for r in requests[:2]]}


def make_requests(cfg, n: int, prompt_len: int, gen: int,
                  seed: int = 0) -> list[Request]:
    """The CLI's requests: prompts drawn from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab, prompt_len,
                                    dtype=np.int32), gen)
            for i in range(n)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen)
    stats = serve(cfg, reqs, batch=args.batch,
                  max_len=args.prompt_len + args.gen, device=args.device)
    for k, v in stats.items():
        print(f"{k}: {v}")
    return stats


if __name__ == "__main__":
    main()
