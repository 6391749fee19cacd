"""The tiny three-tier cell the benchmark's CPU tests run: the 1024-node
configuration on an 8-node tree, each traffic kind at a tiny size."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# 8 nodes: 2 pods x 2 racks x 2 nodes, one uplink of each rack to each of
# 2 aggregation switches, 2 core uplinks each
TINY_FABRIC = {"pods": 2, "racks": 4, "nodes_per_rack": 2, "uplinks": 2, "core_uplinks": 2}
TINY_TRAFFIC = {
    "permutation": {"kind": "permutation", "size_bytes": 65536, "cross": "pod"},
    "incast": {"kind": "incast", "degree": 6, "size_bytes": 32768},
    "alltoall": {"kind": "alltoall", "nodes": 4, "size_bytes": 16384, "window": 2},
}


def load(rel: str) -> dict:
    with open(ROOT / rel) as f:
        return json.load(f)


def make_tiny(tmp_path, kind: str = "permutation", max_ticks: int = 4000):
    """``(bench, cell name, mixes dir)``: BENCHMARK.json with one more
    cell, the 1024-node configuration on the 8-node tree and the traffic
    ``kind`` at a tiny size, 2 points x 2 seeds a study, its files in
    ``tmp_path``."""
    conf = load("portbench/configs/smartt_1024n_3t.json")
    conf.update(name="tiny", fabric=TINY_FABRIC, max_ticks=max_ticks)
    (tmp_path / "tiny.json").write_text(json.dumps(conf))
    mix = load("portbench/mixes/perm_sweep256.json")
    mix.update(traffic=TINY_TRAFFIC[kind], points=mix["points"][5:7], seeds_per_study=2)
    mixes = tmp_path / "mixes"
    mixes.mkdir(exist_ok=True)
    (mixes / "tinymix.json").write_text(json.dumps(mix))
    bench = load("BENCHMARK.json")
    bench["configs"].append(dict(name="tiny", source="test", file=str(tmp_path / "tiny.json"),
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny.cell", config="tiny", traffic="tinymix",
                                   chips=1, why="test"))
    return bench, "tiny.cell", mixes
