"""Finding a cell's files by name.

A cell ``<config>.<traffic>`` is one file, ``workloads/<cell>.json``,
naming its configuration and its traffic and holding its check's sample
sizes and limits.  The configuration is ``configs/<config>.json`` (its
source, the port's parameters it sets, the runner that runs it), the
traffic ``traffic/<traffic>.json`` (the sizes one generator reads).  A
per-layer metric is ``metrics/<metric>.py`` with a ``read(ctx)``; a
hand-written kernel the roofline share counts is ``kernels/<kernel>.json``;
a class of library operations is ``classes/<class>.json``.  The
end-to-end and per-layer metrics a cell reports are those of
``BENCHMARK.json`` (beside ``root``) whose ``workloads`` list names it, or
that have no such list.  Adding a cell, a configuration, a metric or a
kernel is adding a file (and the cell's name to its metrics' lists).
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(name: str) -> str:
    if not NAME.match(name or ''):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Bench:
    """The benchmark's files under ``root`` (this package by default)."""

    def __init__(self, root: Path = ROOT, benchmark: dict | None = None):
        self.root = Path(root)
        if benchmark is None:
            path = self.root.parent / 'BENCHMARK.json'
            benchmark = _load(path) if path.exists() else {}
        self.benchmark = benchmark

    def names(self, kind: str) -> list:
        """The names of every ``<kind>/*.json`` or ``*.py`` file."""
        return sorted(p.stem for p in (self.root / kind).glob('*.*')
                      if p.suffix in ('.json', '.py')
                      and not p.stem.startswith('_'))

    def cell(self, name: str) -> dict:
        """The cell ``name``: its file, with ``config`` and ``traffic``
        replaced by their files' contents."""
        cell = _load(self.root / 'workloads' / f'{_named(name)}.json')
        cell['name'] = name
        cell['config'] = dict(
            _load(self.root / 'configs' / f"{_named(cell['config'])}.json"),
            name=cell['config'])
        cell['traffic'] = dict(
            _load(self.root / 'traffic' / f"{_named(cell['traffic'])}.json"),
            name=cell['traffic'])
        return cell

    def _applies(self, metric: dict, cell: str) -> bool:
        return 'workloads' not in metric or cell in metric['workloads']

    def end_to_end(self, cell: str, measured: dict) -> dict:
        """The cell's end-to-end metrics out of ``measured``
        ({name: (value, unit)})."""
        names = [m['name'] for m in self.benchmark.get('end_to_end', [])
                 if self._applies(m, cell)]
        return {n: measured[n] for n in names if n in measured}

    def readers(self, cell: str) -> dict:
        """{metric name: (read function, unit)} of the cell's per-layer
        metrics."""
        out = {}
        for m in self.benchmark.get('per_layer', []):
            if self._applies(m, cell):
                path = self.root / 'metrics' / f"{_named(m['name'])}.py"
                out[m['name']] = (self._module(path).read, m['unit'])
        return out

    def kernels(self) -> dict:
        """{kernel name: its file} of every hand-written kernel named."""
        return {n: _load(self.root / 'kernels' / f'{n}.json')
                for n in self.names('kernels')}

    def classes(self) -> dict:
        """{class name: [compiled name patterns]} of the library classes."""
        return {n: [re.compile(p) for p in
                    _load(self.root / 'classes' / f'{n}.json')['patterns']]
                for n in self.names('classes')}

    @staticmethod
    def _module(path: Path):
        spec = importlib.util.spec_from_file_location(
            'chbench_metric_' + path.stem.replace('.', '_'), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
