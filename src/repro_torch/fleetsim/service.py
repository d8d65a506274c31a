"""Persistent sweep service: content-addressed scenario cache, batched
what-if query planning and streamed grid results.

The port of ``repro.fleetsim.service``.  Three layers of reuse:

**Content-addressed scenario cache.**  A scenario is addressed by the hash
of its BUILD REQUEST (builder kind plus its kwargs with the defaults bound
in, `scenario_key`), not by the built spec, because building the spec is
the cost being avoided.  `cached_scenario` maps the request to an `.npz`
bundle (FluidNet arrays, the RouteLayout and PathTable, FleetParams, the
lb / churn / rel / fault families, `is_inter`, `link_tier`, `link_dc`)
under `$UNO_SCENARIO_CACHE` (default ``~/.cache/uno_fleetsim/scenarios``).
Bundles are written from host numpy, atomically (tempfile + rename), and
loaded onto the service's device; a corrupt, truncated or version-skewed
bundle loads as None and is rebuilt in place.  The array names are the
reference's, but the port's layout holds fewer fields, so the bundle
format is the port's own: `scenario_key` folds `PACKAGE` into every
address beside `CACHE_VERSION`, and a cache directory shared with the
reference never hands one package's bundle to the other.  The spec
fingerprints themselves (`scenarios.fingerprint`) are the reference's.
`$FLEETSIM_CACHE_BYTES` caps the directory (LRU by access time).

**Bucket-ladder query planner.**  `SweepService.stream` / `submit` bucket
queries by signature (the shapes and dtypes of the scenario's tensors,
its epoch period `dt`, and the run config), then cut each bucket against
the ladder (default 1/2/4/8/16): greedily the largest rung that fits, a
remainder below the smallest rung padded up by repeating the last cell.
Each rung batch is one stacked grid (`sweeps.stack_scenarios`, one
batched epoch for all its cells); per-query seeds ride an explicit seeds
array, so a cell's result does not depend on its batch.

**Grid-layout memo.**  The reference skips a warm batch's jit trace; the
port is eager, and its per-batch set-up is the stacked grid's RouteLayout
(`links.compute_layout` over the block-diagonal routes).  That layout
depends only on the cells' routes, their link count and whether they
carry a PathTable, so the service keeps the layouts it built under
exactly that key: per cell, in batch order (their count is the rung), a
content digest of its routes and its PathTable's shapes, then the link
count and the device.  A warm batch of addressed queries builds no
layout, and neither does a batch of what-ifs that keep the routes of
cells seen before (a drain or capacity what-if).  A routes tensor is
digested once (host copy + blake2b) while it lives, and treated as
immutable.  `stats()` reports `grid_layouts: {built, reused}` beside the
scenario-cache counts.

`repro_torch.fleetsim.sweep_server` is the command-line front end.
"""
from __future__ import annotations

import collections
import contextlib
import hashlib
import inspect
import json
import os
import pathlib
import tempfile
import weakref
import zipfile
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fleetsim import links as L
from repro_torch.fleetsim import sweeps
from repro_torch.fleetsim.carry import scenario_from_arrays
from repro_torch.fleetsim.faults import FaultSchedule
from repro_torch.fleetsim.reliability import RelParams
from repro_torch.fleetsim.state import ChurnParams, FleetParams, LbParams

# bump when the bundle format or the scenario compiler's output changes:
# the version folds into every content address, so old bundles are never
# loaded again (the reference's counter, whose v3 this port compiles)
CACHE_VERSION = 3
# folds into every address and is checked on load: this package's bundles
PACKAGE = "repro_torch"

_META_KEY = "__meta__"

# (prefix, NamedTuple type) families the bundle writes field by field
_FAMILIES = (("par_", FleetParams), ("lb_", LbParams),
             ("churn_", ChurnParams), ("rel_", RelParams),
             ("fault_", FaultSchedule))

_EVICTIONS = [0]        # process-lifetime prune_cache eviction count

DEFAULT_LADDER = (1, 2, 4, 8, 16)
# grid layouts a service keeps, least recently used dropped first: one
# 8-cell batch of the 100k-flow fat tree's layout is ~0.9 GB of device
# memory
MAX_GRID_LAYOUTS = 4


def default_cache_dir() -> pathlib.Path:
    """$UNO_SCENARIO_CACHE, else ~/.cache/uno_fleetsim/scenarios."""
    env = os.environ.get("UNO_SCENARIO_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "uno_fleetsim" / "scenarios"


def cache_size_cap() -> int:
    """$FLEETSIM_CACHE_BYTES as an int cap; 0 / unset / junk = unlimited."""
    try:
        return max(int(os.environ.get("FLEETSIM_CACHE_BYTES", "0")), 0)
    except ValueError:
        return 0


def prune_cache(cache_dir=None, max_bytes: Optional[int] = None) -> int:
    """Evict least-recently-used bundles until the cache fits `max_bytes`
    (default `$FLEETSIM_CACHE_BYTES`; 0 = unlimited, a no-op).  Recency is
    the file's mtime, which `load_bundle` refreshes on every read.  Runs
    after every `save_bundle`; returns the number of bundles evicted."""
    if max_bytes is None:
        max_bytes = cache_size_cap()
    if max_bytes <= 0:
        return 0
    root = pathlib.Path(cache_dir or default_cache_dir())
    sized = []
    try:
        for p in root.glob("*.npz"):
            with contextlib.suppress(OSError):
                st = p.stat()
                sized.append((st.st_mtime, st.st_size, p))
    except OSError:
        return 0
    sized.sort()                       # oldest access first
    total = sum(s for _, s, _ in sized)
    evicted = 0
    for _, size, p in sized:
        if total <= max_bytes:
            break
        with contextlib.suppress(OSError):
            p.unlink()
            total -= size
            evicted += 1
    _EVICTIONS[0] += evicted
    return evicted


def cache_stats(cache_dir=None) -> dict:
    """On-disk scenario-cache occupancy and this process's evictions."""
    root = pathlib.Path(cache_dir or default_cache_dir())
    n = total = 0
    with contextlib.suppress(OSError):
        for p in root.glob("*.npz"):
            with contextlib.suppress(OSError):
                total += p.stat().st_size
                n += 1
    return {"bundles": n, "bytes": total,
            "max_bytes": cache_size_cap(), "evictions": _EVICTIONS[0]}


def bundle_path(key: str, cache_dir=None) -> pathlib.Path:
    return pathlib.Path(cache_dir or default_cache_dir()) / f"{key}.npz"


# ------------------------------------------------------- content addresses

def _builder(kind: str):
    from repro_torch.scenarios import (dumbbell_scenario, fat_tree_spec,
                                       multi_dc_spec)
    builders = {"dumbbell": dumbbell_scenario, "fat_tree": fat_tree_spec,
                "multi_dc": multi_dc_spec}
    if kind not in builders:
        raise ValueError(f"unknown scenario kind {kind!r}; "
                         f"expected one of {sorted(builders)}")
    return builders[kind]


def scenario_key(kind: str, **kwargs) -> str:
    """Content address of a scenario build request: `kwargs` bound against
    the builder's signature with its defaults applied (passing a default
    explicitly does not change the address), fingerprinted with
    `CACHE_VERSION` and `PACKAGE`.  Spec NamedTuples (LbSpec, ChurnSpec,
    RelSpec, FaultSpec) fingerprint structurally."""
    from repro_torch.scenarios.spec import fingerprint
    bound = inspect.signature(_builder(kind)).bind(**kwargs)
    bound.apply_defaults()
    return fingerprint({"kind": kind, "kwargs": dict(bound.arguments)},
                       CACHE_VERSION, PACKAGE)


# --------------------------------------------------------- bundle save/load

def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else \
        np.asarray(v)


def save_bundle(path, fs, *, key: str = "") -> pathlib.Path:
    """Write a FleetScenario to an `.npz` bundle from host numpy.

    Atomic: the arrays land in a same-directory tempfile renamed over
    `path`, so concurrent writers and readers never see a partial bundle.
    Absent members (lb / churn / rel / fault / p_loss / link_tier /
    link_dc / the layout, and None fields inside a family) are simply not
    written, and load back as None.  Prunes the directory afterwards
    (`prune_cache`)."""
    path = pathlib.Path(path)
    net = fs.net
    arrays = {"net_" + f: _host(getattr(net, f)) for f in net._fields
              if f != "layout" and getattr(net, f) is not None}
    if net.layout is not None:
        arrays.update(L.layout_to_arrays(net.layout))
    for prefix, cls in _FAMILIES:
        field = prefix.rstrip("_")
        val = getattr(fs, "params" if field == "par" else field, None)
        if val is not None:
            arrays.update({prefix + f: _host(getattr(val, f))
                           for f in cls._fields
                           if getattr(val, f) is not None})
    for f in ("is_inter", "link_tier", "link_dc"):
        if getattr(fs, f) is not None:
            arrays[f] = _host(getattr(fs, f))
    arrays[_META_KEY] = np.asarray(json.dumps(
        {"version": CACHE_VERSION, "package": PACKAGE, "key": key,
         "seed": int(fs.seed)}))
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise
    prune_cache(path.parent)
    return path


def load_bundle(path, device=None):
    """The bundle's FleetScenario on `device` (default cuda), or None
    when it cannot be trusted: missing, truncated, corrupt, of another
    format version or package, or missing a required array.  The caller
    then rebuilds and overwrites it; a cache never crashes its process.
    A successful read refreshes the bundle's mtime (LRU by access)."""
    dev = resolve_device(device)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z[_META_KEY][()]))
            if meta.get("version") != CACHE_VERSION or \
                    meta.get("package") != PACKAGE:
                return None
            fs = scenario_from_arrays(z, device=dev)
        with contextlib.suppress(OSError):
            os.utime(path)
        return fs
    except (OSError, ValueError, KeyError, TypeError, EOFError,
            zipfile.BadZipFile, json.JSONDecodeError):
        return None


def cached_scenario(kind: str, *, cache_dir=None, refresh: bool = False,
                    device=None, **kwargs):
    """Compile a scenario through the content-addressed cache onto
    `device` (default cuda).  Returns `(FleetScenario, source)`: "disk"
    loaded the bundle (no spec build, no layout compile), "build" ran the
    builder + `to_fleetsim` and published the bundle.  `refresh=True`
    rebuilds and overwrites."""
    dev = resolve_device(device)
    key = scenario_key(kind, **kwargs)
    path = bundle_path(key, cache_dir)
    if not refresh:
        fs = load_bundle(path, device=dev)
        if fs is not None:
            return fs, "disk"
    from repro_torch.scenarios import to_fleetsim
    fs = to_fleetsim(_builder(kind)(**kwargs), device=dev)
    save_bundle(path, fs, key=key)
    return fs, "build"


def publish_scenario(fs, key: str, cache_dir=None) -> pathlib.Path:
    """Write an already-compiled scenario's bundle unless it exists;
    return its path."""
    path = bundle_path(key, cache_dir)
    if not path.exists():
        save_bundle(path, fs, key=key)
    return path


# ------------------------------------------------------------ query planner

class SweepQuery(NamedTuple):
    """One what-if query: a scenario (anything `sweeps.run_grid` takes as
    a cell) and its run config.  Queries of one signature and one config
    share batches; `seed` stays per query."""
    scenario: object
    scheme: str = "uno"
    n_warm: int = 2_000
    n_meas: int = 500
    seed: int = 0
    backend: str = "auto"


def _leaves(x):
    """(shape, dtype) of every tensor leaf of nested NamedTuples, None
    where a member is absent."""
    if x is None:
        return (None,)
    if isinstance(x, torch.Tensor):
        return ((tuple(x.shape), str(x.dtype)),)
    if not isinstance(x, tuple):
        return ((tuple(np.shape(x)), type(x).__name__),)
    return tuple(leaf for v in x for leaf in _leaves(v))


def _query_signature(q: SweepQuery):
    norm = sweeps._norm_scenario(q.scenario)
    return (_leaves(norm), float(norm[0].dt), q.scheme, q.n_warm, q.n_meas,
            q.backend)


def _cut_ladder(n: int, ladder: Sequence[int]):
    """Decompose a bucket of n cells into rungs: yields (n_live, rung),
    greedily the largest rung that fits, then a remainder below the
    smallest rung padded up to it."""
    rungs = sorted(set(int(r) for r in ladder))
    if not rungs or rungs[0] < 1:
        raise ValueError(f"ladder must be positive ints, got {ladder!r}")
    while n > 0:
        if n >= rungs[0]:
            rung = max(r for r in rungs if r <= n)
            yield rung, rung
            n -= rung
        else:
            yield n, rungs[0]
            n = 0


class SweepService:
    """The persistent query surface: scenario cache, planner, streaming,
    grid-layout memo (module docstring).  One instance per process; not
    thread-safe.  Scenarios load onto `device` (default cuda)."""

    def __init__(self, cache_dir=None, ladder=DEFAULT_LADDER, device=None):
        self.cache_dir = pathlib.Path(cache_dir or default_cache_dir())
        self.ladder = tuple(ladder)
        self.device = resolve_device(device)
        self._memo: dict = {}
        # id(routes) -> (weakref to the tensor, digest of its content)
        self._digests: dict = {}
        self._layouts: collections.OrderedDict = collections.OrderedDict()
        self._stats = {"memo_hits": 0, "disk_hits": 0, "builds": 0,
                       "queries": 0, "batches": 0, "padded_cells": 0}
        self._layout_stats = {"built": 0, "reused": 0}

    # ------------------------------------------------------------ scenarios

    def scenario(self, kind: str, *, refresh: bool = False, **kwargs):
        """`cached_scenario` behind an in-memory memo."""
        key = scenario_key(kind, **kwargs)
        if not refresh and key in self._memo:
            self._stats["memo_hits"] += 1
            return self._memo[key]
        fs, source = cached_scenario(kind, cache_dir=self.cache_dir,
                                     refresh=refresh, device=self.device,
                                     **kwargs)
        self._stats["disk_hits" if source == "disk" else "builds"] += 1
        self._memo[key] = fs
        return fs

    # -------------------------------------------------------------- queries

    def _routes_digest(self, routes: torch.Tensor) -> str:
        """Content digest of a routes tensor, computed once per tensor."""
        hit = self._digests.get(id(routes))
        if hit is not None and hit[0]() is routes:
            return hit[1]
        a = np.ascontiguousarray(routes.detach().cpu().numpy())
        h = hashlib.blake2b(repr((a.shape, a.dtype.str)).encode(),
                            digest_size=16)
        h.update(a.tobytes())
        self._digests = {k: v for k, v in self._digests.items()
                         if v[0]() is not None}
        self._digests[id(routes)] = (weakref.ref(routes), h.hexdigest())
        return h.hexdigest()

    def _layout_key(self, cells):
        """What the batch's grid layout depends on (module docstring)."""
        nets = [sweeps._norm_scenario(c)[0] for c in cells]
        per_cell = tuple(
            (self._routes_digest(n.routes),
             None if n.layout is None or n.layout.path_table is None
             else tuple(tuple(v.shape) for v in n.layout.path_table))
            for n in nets)
        return per_cell, nets[0].n_links, str(nets[0].routes.device)

    def _stack(self, cells):
        """The batch's stacked grid, its layout from the memo if there."""
        key = self._layout_key(cells)
        lay = self._layouts.get(key)
        g = sweeps.stack_scenarios(cells, layout=lay)
        if lay is not None:
            self._layouts.move_to_end(key)
            self._layout_stats["reused"] += 1
            return g
        self._layout_stats["built"] += 1
        self._layouts[key] = g.net.layout
        while len(self._layouts) > MAX_GRID_LAYOUTS:
            self._layouts.popitem(last=False)
        return g

    def stream(self, queries: Sequence[SweepQuery]):
        """Yield `(query_index, final_state, rates)` per completed cell,
        bucket by bucket, in submission order within a bucket, as each
        rung batch finishes.  Each result equals the query run alone
        (per-query seeds; padding cells are dropped)."""
        queries = list(queries)
        buckets: dict = {}
        for i, q in enumerate(queries):
            buckets.setdefault(_query_signature(q), []).append(i)
        for idxs in buckets.values():
            q0 = queries[idxs[0]]
            pos = 0
            for live, rung in _cut_ladder(len(idxs), self.ladder):
                take = idxs[pos:pos + live]
                pos += live
                cells = [queries[i].scenario for i in take]
                seeds = [queries[i].seed for i in take]
                if live < rung:
                    cells += [cells[-1]] * (rung - live)
                    seeds += [seeds[-1]] * (rung - live)
                    self._stats["padded_cells"] += rung - live
                final, rates = sweeps.run_stacked(
                    self._stack(cells), np.asarray(seeds, np.int64),
                    scheme=q0.scheme, n_warm=q0.n_warm, n_meas=q0.n_meas,
                    backend=q0.backend)
                if rates.is_cuda:
                    torch.cuda.synchronize(rates.device)
                self._stats["batches"] += 1
                self._stats["queries"] += live
                for j, qid in enumerate(take):
                    yield qid, sweeps._map(lambda v, k=j: v[k], final), \
                        rates[j]

    def submit(self, queries: Sequence[SweepQuery]):
        """Blocking `stream`: [(final_state, rates)] in input order."""
        out = [None] * len(queries)
        for qid, final, rates in self.stream(queries):
            out[qid] = (final, rates)
        return out

    # ---------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Every cache layer's counts, for reports and checks."""
        return {"scenario_cache": dict(self._stats),
                "bundle_cache": cache_stats(self.cache_dir),
                "grid_layouts": dict(self._layout_stats),
                "ladder": self.ladder, "cache_dir": str(self.cache_dir),
                "device": str(self.device)}


def summarize_rates(rates) -> dict:
    """Compact per-cell result summary (what the CLI emits as JSONL)."""
    r = torch.as_tensor(rates).detach().cpu().to(torch.float32)
    return {"n_flows": int(r.shape[-1]),
            "mean_rate": round(float(r.mean()), 6),
            "min_rate": round(float(r.min()), 6),
            "max_rate": round(float(r.max()), 6),
            "jain": round(float(sweeps.jain(r)), 4)}
