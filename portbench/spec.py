"""``BENCHMARK.json`` and the files it names, each found by its name.

A checkout's root holds ``BENCHMARK.json``; its ``portbench/`` holds the
data and the readers:

- a configuration's file is the one ``BENCHMARK.json`` names under
  ``configs``; its ``estimate`` key names the system under test,
  ``entries/<estimate>.py``, and its plain reference,
  ``reference/<estimate>.py``;
- a traffic mix is ``traffic/<traffic>.json``;
- a metric's reader is ``metrics/<name>.py`` (dots and all), loaded by
  path.

A later cell, mix or metric is new files and new entries, never an edit.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spec:
    """The benchmark of one checkout (``root``)."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = self.root / "portbench"
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[str, ModuleType] = {}

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"BENCHMARK.json has no config {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.data / "traffic" / f"{name}.json").read_text())

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics: every cell reports each of them."""
        return self.bench["end_to_end"]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics that list this cell under ``workloads``."""
        return [m for m in self.bench["per_layer"] if cell in m["workloads"]]

    def _load(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self._modules:
            self._modules[key] = _module(
                self.data / kind / f"{name}.py", f"portbench_{kind}_{name}".replace(".", "_")
            )
        return self._modules[key]

    def reader(self, metric: str) -> ModuleType:
        return self._load("metrics", metric)

    def entry(self, estimate: str) -> ModuleType:
        return self._load("entries", estimate)

    def reference(self, estimate: str) -> ModuleType:
        return self._load("reference", estimate)
