"""Where the harness finds the files of a configuration, a traffic mix, a
client and a metric: by the name ``BENCHMARK.json`` gives, under each
search root in turn (the ``perfbench`` folder first, then any root a
caller passes, such as a test's temporary directory).

  configs/<config>.json    sizes, the engine's settings, the guarantee
  traffic/<mix>.json       the mix's parameters, read by harness/traffic
  clients/<client>.py      the calls a mix's ``client`` makes
  metrics/<metric>.py      an end-to-end metric's reader
  layers/<metric>.py       a per-layer metric's reader
  reference/<name>.py      a configuration's plain reference
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


class Finder:
    def __init__(self, extra_roots=()):
        self.roots = [Path(r) for r in extra_roots] + [HERE]

    def path(self, kind: str, name: str, ext: str) -> Path:
        for root in self.roots:
            p = root / kind / f"{name}{ext}"
            if p.is_file():
                return p
        raise FileNotFoundError(
            f"no {kind}/{name}{ext} under {[str(r) for r in self.roots]}")

    def json(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def module(self, kind: str, name: str):
        p = self.path(kind, name, ".py")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{kind}_{name}".replace(".", "_").replace("-", "_"),
            p)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
