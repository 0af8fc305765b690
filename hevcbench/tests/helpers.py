"""A cell shrunk to a size the CPU runs in seconds: a cell of
BENCHMARK.json, or one made from the configuration and traffic files
alone (the IPPP files wait for their cells: PERF.md)."""

import dataclasses
import json
import os

from hevcbench import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
# metrics of the P-frame layer, which no cell of the manifest reads yet
P_METRICS = [{"name": n, "unit": u} for n, u in (
    ("inter_ms", "ms/frame"), ("inter_ops_per_frame", "ops/frame"),
    ("me_sad_roofline_pct", "%"))]


def any_cell(name: str) -> cells.Cell:
    """The manifest's cell `name`, else `<config>.<traffic>` from the
    files with the manifest's metrics that every cell reports, the I-frame
    metrics and P_METRICS."""
    bench = json.load(open(MANIFEST))
    if name in {w["name"] for w in bench["workloads"]}:
        return cells.load_cell(name, MANIFEST)
    config, traffic = name.split(".", 1)
    return dataclasses.replace(
        cells.load_cell(bench["workloads"][0]["name"], MANIFEST),
        name=name,
        config=cells.config_fields(cells.read_json(os.path.join(
            cells.HERE, "configs", config + ".json"))),
        traffic=cells.read_json(os.path.join(cells.HERE, "traffic",
                                             traffic + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if "workloads" not in m],
        per_layer=[m for m in bench["per_layer"]
                   if "workloads" not in m or m["name"].startswith("intra")]
        + P_METRICS)


def small_cell(name: str, w: int = 128, h: int = 64, batch: int = 4,
               idr: int = 6) -> cells.Cell:
    cell = any_cell(name)
    cfg = dict(cell.config, width=w, height=h)
    if cfg.get("gop_size") == 0:
        cfg["num_frames_in_flight"] = batch
    enc = dict(cell.traffic.get("encoder", {}))
    if enc.get("intra_period"):
        enc["intra_period"] = idr
    return dataclasses.replace(cell, config=cfg,
                               traffic={**cell.traffic, "encoder": enc})
