"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix, cell parameters (``cells/<cell>.json``: rate, checked
requests, the limits of the correctness numbers) and metric readers."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

from bench import metrics

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Spec:
    def __init__(self, bench_file: Path = ROOT / "BENCHMARK.json",
                 data_dir: Path = BENCH_DIR, root: Path = ROOT,
                 metrics_dir: Path = BENCH_DIR / "metrics"):
        self.bench = json.loads(Path(bench_file).read_text())
        self.data = Path(data_dir)
        self.root = Path(root)
        self.metrics_dir = Path(metrics_dir)

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: Dict) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r}")

    def mix(self, cell: Dict) -> Dict:
        return json.loads((self.data / "traffic"
                           / f"{cell['traffic']}.json").read_text())

    def params(self, cell: Dict) -> Dict:
        return json.loads((self.data / "cells"
                           / f"{cell['name']}.json").read_text())

    def metrics(self, cell: Dict, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        return metrics.load(self.metrics_dir, name)
