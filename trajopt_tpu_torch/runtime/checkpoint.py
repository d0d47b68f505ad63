"""Checkpoint / resume for solver state.

A JAX-free copy of `trajopt_tpu/runtime/checkpoint.py` (``save``, ``load``,
``load_full`` and ``CheckpointManager``) for the torch port.  The ``.npz``
layout is the JAX writer's, so a checkpoint written by either package
resumes in the other: one array per `SolverState` field, the plane caches
as ``plane_cache_*`` / ``pair_cache_*`` arrays with int32 ids, and the
``_trajopt_meta`` JSON bytes (step, fields, extra, has_plane_cache,
cache_kind).  The save is atomic (a temporary file, then `os.replace`).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from ..types import PairPlaneCache, PlaneCache, SolverState

_META = "_trajopt_meta"
_CACHE_PREFIX = "plane_cache_"
_PAIR_PREFIX = "pair_cache_"
_ID_FIELDS = ("obs_id", "partner")


def _to_numpy(name: str, x: torch.Tensor) -> np.ndarray:
    a = x.detach().cpu().numpy()
    return a.astype(np.int32) if name in _ID_FIELDS else a


def save(path: str, state: SolverState, *, step: int = 0, extra: dict | None = None,
         cache=None) -> None:
    """Atomic .npz checkpoint of a (possibly robot-batched) SolverState.

    ``cache``: the persistent ``optimal_plane=True`` plane state, saved so
    that a resume keeps the accumulated refinement: a single-robot
    `PlaneCache`, or the fleet's ``(obstacle PlaneCache [U,...],
    PairPlaneCache)``."""
    arrays = {f: _to_numpy(f, x) for f, x in zip(state._fields, state)}
    cache_kind = None
    if isinstance(cache, tuple) and not isinstance(cache, PlaneCache):
        obs, pair = cache
        arrays.update({_CACHE_PREFIX + f: _to_numpy(f, x) for f, x in zip(obs._fields, obs)})
        arrays.update({_PAIR_PREFIX + f: _to_numpy(f, x) for f, x in zip(pair._fields, pair)})
        cache_kind = "multi"
    elif cache is not None:
        arrays.update({_CACHE_PREFIX + f: _to_numpy(f, x) for f, x in zip(cache._fields, cache)})
        cache_kind = "single"
    meta = {
        "step": step,
        "fields": list(state._fields),
        "extra": extra or {},
        "has_plane_cache": cache is not None,
        "cache_kind": cache_kind,
    }
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays, **{_META: np.frombuffer(json.dumps(meta).encode(),
                                                          dtype=np.uint8)})
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str, *, device, dtype) -> tuple[SolverState, dict]:
    """Restore (state, meta); floating fields become ``dtype`` on ``device``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META]).decode())
        state = SolverState(**{f: torch.as_tensor(z[f], dtype=dtype, device=device)
                               for f in meta["fields"]})
    return state, meta


def load_full(path: str, *, device, dtype) -> tuple[SolverState, dict, object]:
    """Restore (state, meta, plane cache): the cache is None when the
    checkpoint holds none, a `PlaneCache` for a single-robot checkpoint, or
    ``(obstacle PlaneCache, PairPlaneCache)`` for a fleet's; ids come back
    as int64."""
    state, meta = load(path, device=device, dtype=dtype)
    cache = None
    if meta.get("has_plane_cache"):
        ids = dict(dtype=torch.int64, device=device)
        floats = dict(dtype=dtype, device=device)
        with np.load(path) as z:
            obs = PlaneCache(obs_id=torch.as_tensor(z[_CACHE_PREFIX + "obs_id"], **ids),
                             c=torch.as_tensor(z[_CACHE_PREFIX + "c"], **floats))
            if meta.get("cache_kind") == "multi":
                cache = (obs, PairPlaneCache(
                    partner=torch.as_tensor(z[_PAIR_PREFIX + "partner"], **ids),
                    c=torch.as_tensor(z[_PAIR_PREFIX + "c"], **floats),
                    d=torch.as_tensor(z[_PAIR_PREFIX + "d"], **floats)))
            else:
                cache = obs
    return state, meta, cache


class CheckpointManager:
    """Keep the latest ``keep`` checkpoints, save every ``every`` iterations."""

    def __init__(self, directory: str, every: int = 10, keep: int = 3):
        self.directory = directory
        self.every = max(1, every)
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, it: int, state: SolverState, extra: dict | None = None,
                   cache=None) -> bool:
        if it % self.every != 0:
            return False
        save(os.path.join(self.directory, f"ckpt_{it:08d}.npz"), state, step=it, extra=extra,
             cache=cache)
        self._gc()
        return True

    def _checkpoints(self) -> list[str]:
        return sorted(f for f in os.listdir(self.directory)
                      if f.startswith("ckpt_") and f.endswith(".npz"))

    def _gc(self) -> None:
        for f in self._checkpoints()[: -self.keep]:
            os.unlink(os.path.join(self.directory, f))

    def latest(self) -> str | None:
        ck = self._checkpoints()
        return os.path.join(self.directory, ck[-1]) if ck else None

    def restore_latest(self, *, device, dtype) -> tuple[SolverState, dict] | None:
        p = self.latest()
        return load(p, device=device, dtype=dtype) if p else None

    def restore_latest_full(self, *, device, dtype):
        """(state, meta, cache) of the latest checkpoint (`load_full`), or None."""
        p = self.latest()
        return load_full(p, device=device, dtype=dtype) if p else None
