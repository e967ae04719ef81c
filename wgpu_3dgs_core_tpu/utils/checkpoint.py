"""Sharded checkpoint save/restore for training-scale gaussian scenes.

The reference's persistence layer is the file formats themselves (SURVEY.md
§5 checkpoint/resume: PLY lossless, SPZ lossy). Those remain the
interchange path; this module adds the device-scale piece the reference has no
analog for — saving a sharded SoA (plus arbitrary optimizer/training state
pytrees) one file per shard, with a manifest, and restoring onto a possibly
different mesh size.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np

from ..models.gaussian import GaussianSoA

_MANIFEST = "manifest.json"

_FIELDS = ("rot", "pos", "color", "sh", "scale")


def save_sharded(path: str, soa: GaussianSoA, n_shards: int,
                 extra: Optional[dict[str, Any]] = None) -> None:
    """Save a scene as n_shards npz files + manifest.

    ``extra``: optional dict of arrays sharded along axis 0 with the
    gaussians (e.g. optimizer moments).
    """
    os.makedirs(path, exist_ok=True)
    n = len(soa)
    bounds = [(s * n) // n_shards for s in range(n_shards + 1)]
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        payload = {f: getattr(soa, f)[lo:hi] for f in _FIELDS}
        if extra:
            for k, v in extra.items():
                payload[f"extra.{k}"] = np.asarray(v)[lo:hi]
        np.savez(os.path.join(path, f"shard_{s:05d}.npz"), **payload)
    manifest = {
        "num_gaussians": n,
        "num_shards": n_shards,
        "bounds": bounds,
        "extra_keys": sorted(extra) if extra else [],
        "format_version": 1,
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


def load_sharded(path: str, shard: Optional[int] = None,
                 n_shards: Optional[int] = None):
    """Restore a scene (and extras).

    With ``shard``/``n_shards``, loads only this host's slice of the
    gaussian axis — resharding onto a different host count than it was
    saved with; otherwise loads everything.

    Returns (GaussianSoA, extras dict).
    """
    manifest = load_manifest(path)
    n = manifest["num_gaussians"]
    if shard is None:
        lo, hi = 0, n
    else:
        if n_shards is None:
            raise ValueError("n_shards is required with shard")
        lo = (shard * n) // n_shards
        hi = ((shard + 1) * n) // n_shards

    fields: dict[str, list] = {f: [] for f in _FIELDS}
    extras: dict[str, list] = {k: [] for k in manifest["extra_keys"]}
    bounds = manifest["bounds"]
    for s in range(manifest["num_shards"]):
        s_lo, s_hi = bounds[s], bounds[s + 1]
        if s_hi <= lo or s_lo >= hi:
            continue
        with np.load(os.path.join(path, f"shard_{s:05d}.npz")) as data:
            a = max(lo, s_lo) - s_lo
            b = min(hi, s_hi) - s_lo
            for f in _FIELDS:
                fields[f].append(data[f][a:b])
            for k in extras:
                extras[k].append(data[f"extra.{k}"][a:b])

    soa = GaussianSoA(**{f: np.concatenate(v) for f, v in fields.items()})
    return soa, {k: np.concatenate(v) for k, v in extras.items()}
