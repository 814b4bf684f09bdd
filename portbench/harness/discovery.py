"""Find the benchmark's data and plug-in files by name.

Everything that belongs to one configuration, traffic mix, mode, per-layer
metric or kernel count sits in a file of its own under the benchmark's
root, found from the name alone, so a cell, a configuration or a metric is
added by adding files:

  configs/<config>.json      the configuration as it is run, with its source
  workloads/<cell>.json      the cell: its mode, configuration and traffic
  modes/<mode>.py            how a cell of that mode is set up, timed, checked
  metrics/<metric>.py        the reader of one per-layer metric
  counts/<kernel>.py         one kernel's operations and bytes from its shapes
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")


class UnknownName(LookupError):
    """A name with no file behind it."""


def _path(root: Path, kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise UnknownName(f"{kind[:-1]} name {name!r} is not a benchmark name "
                          f"(letters, digits, _ . -; at most 64)")
    path = Path(root) / kind / f"{name}{suffix}"
    if not path.is_file():
        known = sorted(p.name[:-len(suffix)] for p in (Path(root) / kind).glob(f"*{suffix}"))
        raise UnknownName(f"no {kind[:-1]} {name!r} (no {kind}/{name}{suffix}); known: "
                          f"{', '.join(known) or 'none'}")
    return path


def _json(root, kind, name) -> dict:
    with open(_path(root, kind, name, ".json")) as f:
        out = json.load(f)
    out["name"] = name
    return out


def load_workload(name: str, root: Path = ROOT) -> dict:
    return _json(root, "workloads", name)


def load_config(name: str, root: Path = ROOT) -> dict:
    return _json(root, "configs", name)


def _module(root, kind, name) -> ModuleType:
    path = _path(root, kind, name, ".py")
    key = f"_portbench_{kind}_{abs(hash(str(path))):x}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_mode(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "modes", name)


def load_count(kernel: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "counts", kernel)


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    return _module(root, "metrics", name)


def metric_readers(root: Path = ROOT) -> Dict[str, ModuleType]:
    """Every per-layer metric's reader, by the metric's name."""
    return {p.name[:-3]: load_metric(p.name[:-3], root)
            for p in sorted((Path(root) / "metrics").glob("*.py")) if NAME.match(p.name[:-3])}
