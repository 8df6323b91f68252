"""Typed configuration for the scan and merge paths.

The port's own copy of the JAX package's config dataclasses, cut to what
``reconstruct`` and ``merge-360`` read. Field names and defaults are the
same, so one JSON config file loads in both packages:

  - ``projector``, ``decode``, ``triangulate`` and ``merge`` are whole
    copies; an unknown key there is an error, as in the JAX package;
  - ``parallel`` carries ``compute_batch`` and ``io_workers``, ``pipeline``
    carries ``packed_ingest`` and ``min_views``. Other keys of these two
    sections, and whole sections the port does not model (``clean``,
    ``mesh``, ``serving``, …), configure stages the port does not run yet:
    they load without effect.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any

__all__ = ["ProjectorConfig", "DecodeConfig", "TriangulateConfig",
           "MergeConfig", "ParallelConfig", "PipelineConfig", "Config",
           "load_config"]


@dataclass
class ProjectorConfig:
    """Projector geometry."""

    width: int = 1920
    height: int = 1080
    screen_offset_x: int = 1920  # projector is the second monitor
    brightness: int = 200        # white level of projected patterns
    downsample: int = 1          # pattern downsample factor


@dataclass
class DecodeConfig:
    """Gray-code decode."""

    n_cols: int = 1920
    n_rows: int = 1080
    n_sets_col: int = 11     # how many FIRST column bit-planes to use
    n_sets_row: int = 11     # how many FIRST row bit-planes to use
    thresh_mode: str = "otsu"  # 'otsu' | 'manual'
    shadow_val: float = 40.0
    contrast_val: float = 10.0


@dataclass
class TriangulateConfig:
    """Ray-plane triangulation."""

    row_mode: int = 1          # 0=columns only, 1=epipolar filter, 2=merge col+row clouds
    epipolar_tol: float = 2.0  # mm
    # 'table' = gather stored plane equations; 'quadratic' = closed-form
    # per-pixel plane evaluation (the fused decode+triangulate kernel)
    plane_eval: str = "table"
    # export-path triangulation through a host twin; not ported yet —
    # reconstruct raises when it is set
    bitexact: bool = False


@dataclass
class MergeConfig:
    """360-degree merge. ``method='posegraph'`` loads but is not ported: the
    merge raises NotImplementedError for it. ``stream``, ``pair_batch`` and
    ``incremental`` are schedule knobs; the port reads ``pair_batch``."""

    voxel_size: float = 3.0
    icp_dist_ratio: float = 1.5
    icp_iters: int = 30
    ransac_trials: int = 4096
    outlier_nb: int = 20
    outlier_std: float = 2.0
    sample_before: int = 0       # uniform sample every k-th point before register (0=off)
    sample_after: int = 0
    final_voxel: float = 0.5
    method: str = "sequential"   # 'sequential' | 'posegraph'
    stream: bool = True
    pair_batch: int = 4          # pairs per registration launch group
    incremental: bool = False


@dataclass
class ParallelConfig:
    """Host-side execution knobs of the reconstruct lanes."""

    # host I/O threads for frame decode. Env override: SL3D_IO_WORKERS.
    io_workers: int = field(
        default_factory=lambda: int(os.environ.get("SL3D_IO_WORKERS", "4")))
    # views per device launch for batch reconstruct; <=1 runs one view per
    # launch. Env override: SL3D_COMPUTE_BATCH.
    compute_batch: int = field(
        default_factory=lambda: int(os.environ.get("SL3D_COMPUTE_BATCH", "8")))


@dataclass
class PipelineConfig:
    """Ingest format of the batched reconstruct lane, the merge's view floor."""

    # load each view as a packed bit-plane stack (frames.slbp where present,
    # packed at load otherwise) and decode from the bits on the device;
    # outputs are byte-identical to raw ingest (batched lane only)
    packed_ingest: bool = False
    # merge proceeds when at least max(2, min_views) views are readable
    min_views: int = 2


@dataclass
class Config:
    """Root configuration of the scan and merge paths."""

    projector: ProjectorConfig = field(default_factory=ProjectorConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    triangulate: TriangulateConfig = field(default_factory=TriangulateConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    pipeline: PipelineConfig = field(default_factory=PipelineConfig)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


# classes copied in part from the JAX package's schema: keys they do not
# carry belong to stages the port does not run yet and are dropped
_PARTIAL = (Config, ParallelConfig, PipelineConfig)


def _from_dict(cls: type, data: dict[str, Any]) -> Any:
    import typing

    hints = typing.get_type_hints(cls)
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - known
    if unknown and cls not in _PARTIAL:
        raise ValueError(
            f"Unknown key(s) in config section {cls.__name__}: {sorted(unknown)}; "
            f"valid keys: {sorted(known)}")
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name)
        if isinstance(v, dict) and dataclasses.is_dataclass(ftype):
            kwargs[f.name] = _from_dict(ftype, v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


def _coerce(cur: Any, value: Any) -> Any:
    """Coerce an override value to the type of the current field value."""
    if dataclasses.is_dataclass(cur):
        raise ValueError(
            f"Cannot override a whole config section with {value!r}; "
            f"use a dotted leaf key like section.field=value")
    if value is None or cur is None:
        return value
    if isinstance(cur, bool):
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("1", "true", "yes", "on"):
                return True
            if low in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"Cannot interpret {value!r} as a boolean")
        return bool(value)
    if isinstance(cur, int):
        as_float = float(value)
        if as_float != int(as_float):
            raise ValueError(f"Expected an integer, got {value!r}")
        return int(as_float)
    return type(cur)(value)


def load_config(path: str | None = None,
                overrides: dict[str, Any] | None = None) -> Config:
    """Load a Config from JSON, with optional dotted-key overrides
    (``{"decode.thresh_mode": "manual"}``)."""
    cfg = Config()
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"Config file not found: {path}")
        with open(path) as f:
            cfg = _from_dict(Config, json.load(f))
    for key, value in (overrides or {}).items():
        obj: Any = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        leaf = parts[-1]
        cur = getattr(obj, leaf)  # raises AttributeError on unknown keys
        setattr(obj, leaf, _coerce(cur, value))
    return cfg
