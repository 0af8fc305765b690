"""A cell of BENCHMARK.json and the files it names.

Everything that belongs to one configuration, one traffic mix or one
per-layer metric sits in a file of its own, found by its name:
`configs/<config>.json`, `traffic/<traffic>.json` and
`metrics/<metric>.py` under this folder (a metric's module also names
the program calls its layer's spans wrap: spans.py). Adding a cell, a mix, a
configuration or a metric adds files and entries and edits none.

A configuration file holds the port's EncoderConfig fields at its top
level, beside keys that document it (DOC_KEYS). A traffic file holds the
fields it sets (`encoder`: the QP, the IDR spacing) and the parameters of
the closed-loop client:

- `warmup_periods`: whole periods of frames that set-up submits before
  the window, so that the window starts with the pipeline full and every
  frame it emits went in after the first emission (which, in a fresh
  checkout, builds the native CABAC library);
- `check_frames`: how many frames of the window, beside the one with the
  most bits, the correctness check decodes (drawn from the seed).

A period is the batch of an all-intra configuration (its frames in
flight), else one frame, times the IDR spacing where the mix sets one:
the window starts and ends on a period boundary, so it holds whole batches
and whole IDR segments.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os

HERE = os.path.dirname(os.path.abspath(__file__))
DOC_KEYS = {"source", "deployment", "guarantees", "assumed", "changed",
            "why"}
TRAFFIC_KEYS = {"encoder", "warmup_periods", "check_frames", "why"}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # EncoderConfig fields of the configuration
    traffic: dict
    end_to_end: list      # the manifest's end_to_end entries of this cell
    per_layer: list       # the manifest's per_layer entries of this cell

    def encoder_fields(self) -> dict:
        return {**self.config, **self.traffic.get("encoder", {})}

    @property
    def batch(self) -> int:
        f = self.encoder_fields()
        return (max(1, int(f.get("num_frames_in_flight", 1)))
                if int(f.get("gop_size", 2)) == 0 else 1)

    @property
    def idr_period(self) -> int:
        f = self.encoder_fields()
        if int(f.get("gop_size", 2)) == 0:
            return 1
        return max(0, int(f.get("intra_period", 0)))

    @property
    def period(self) -> int:
        return math.lcm(self.batch, max(1, self.idr_period))


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, manifest_path: str, root: str = HERE) -> Cell:
    with open(manifest_path) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {manifest_path}")
    w = cells[name]
    config = read_json(os.path.join(root, "configs", w["config"] + ".json"))
    traffic = read_json(os.path.join(root, "traffic", w["traffic"] + ".json"))
    bad = set(traffic) - TRAFFIC_KEYS
    if bad:
        raise ValueError(f"traffic {w['traffic']}: unknown keys {sorted(bad)}")
    return Cell(name, int(w["chips"]), config_fields(config), traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def config_fields(config: dict) -> dict:
    """The EncoderConfig fields of a configuration file."""
    return {k: v for k, v in config.items() if k not in DOC_KEYS}


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def encoder_config(cell: Cell, config_module):
    """The EncoderConfig (of `config_module`: the port's, or the
    reference's frozen copy) that the cell states; unknown fields raise."""
    cls = config_module.EncoderConfig
    names = {f.name for f in dataclasses.fields(cls)}
    fields = cell.encoder_fields()
    bad = set(fields) - names
    if bad:
        raise ValueError(f"{cell.name}: unknown encoder fields {sorted(bad)}")
    enums = {"motion_estimation_precision": "MEPrecision",
             "rd_mode": "RDMode", "bitrate_mode": "BitrateMode",
             "performance_mode": "PerformanceMode"}
    kw = {k: (getattr(config_module, enums[k])(v) if k in enums else v)
          for k, v in fields.items()}
    return cls(**kw)


def metric_module(metric: str, root: str = HERE):
    """The module metrics/<metric>.py (under `root`): its `read`, and the
    `SPANS` and `install` of the layer it reads, if any (spans.py)."""
    if root == HERE:
        return importlib.import_module(f"hevcbench.metrics.{metric}")
    spec = importlib.util.spec_from_file_location(
        f"hevcbench_metric_{metric}",
        os.path.join(root, "metrics", metric + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
