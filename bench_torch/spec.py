"""Load and check `BENCHMARK.json` and the files it names.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's file is the one `configs[].file` gives: its sizes, the
program's entry with its keyword arguments, and the reference's semantics,
`semantics/<name>.py`. The traffic mix is `traffic/<traffic>.json`, whose
library and source kinds are `traffic/<kind>.py`; each metric is read by
`metrics/<metric>.py`; each kernel's roofline count is
`kernels/<kernel>.py`. Adding a cell, a configuration, a semantics, a
traffic kind, a metric or a kernel count is adding files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
_UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
_SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
_E2E_SOURCES = ("host_clock", "device_trace")


class SpecError(ValueError):
    """A benchmark file breaks the contract."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not _NAME.fullmatch(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 of [A-Za-z0-9_.-], "
                        "starting with a letter, a digit or _")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not _UNIT.fullmatch(unit):
        raise SpecError(f"{what}: unit {unit!r} is 1-16 of [A-Za-z0-9_/%.-]")
    return unit


def check_line(text, what: str) -> str:
    if (not isinstance(text, str) or not 1 <= len(text) <= 200
            or "\n" in text or "\t" in text):
        raise SpecError(f"{what}: 1-200 characters on one line, no tab")
    return text


def _keys(entry: dict, required: set, optional: set, what: str) -> None:
    keys = set(entry)
    if not required <= keys or not keys <= required | optional:
        raise SpecError(f"{what}: keys {sorted(keys)}, expected {sorted(required)}"
                        + (f" and optionally {sorted(optional)}" if optional else ""))


def _unique(names: list, what: str) -> None:
    if len(set(names)) != len(names):
        raise SpecError(f"two {what} share a name")


@dataclass
class Benchmark:
    """`BENCHMARK.json`, checked against the contract's rules of form."""

    raw: dict
    root: Path = ROOT
    configs: dict = field(default_factory=dict)
    workloads: dict = field(default_factory=dict)
    metrics: dict = field(default_factory=dict)

    def cell(self, name: str) -> dict:
        if name not in self.workloads:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json")
        return self.workloads[name]

    def metrics_of(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: the end-to-end ones with
        `trace` off, the per-layer ones with it on; each kept where it has
        no `workloads` or lists the cell."""
        group = "per_layer" if trace else "end_to_end"
        return [m for m in self.raw[group]
                if "workloads" not in m or cell in m["workloads"]]


def load_benchmark(path: Path | None = None) -> Benchmark:
    path = Path(path) if path is not None else ROOT / "BENCHMARK.json"
    raw = json.loads(path.read_text())
    bench = Benchmark(raw=raw, root=path.parent)
    _keys(raw, {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                "per_layer"}, set(), "BENCHMARK.json")
    if not (isinstance(raw["run_seconds"], int) and 1 <= raw["run_seconds"] <= 51):
        raise SpecError("run_seconds is a whole number from 1 to 51")
    for c in raw["configs"]:
        _keys(c, {"name", "source", "file", "reduced", "why"}, set(), "a config")
        check_name(c["name"], "config")
        check_line(c["source"], f"config {c['name']} source")
        check_line(c["why"], f"config {c['name']} why")
        for k in c["reduced"]:
            check_name(k, f"config {c['name']} reduced key")
        bench.configs[c["name"]] = c
    _unique([c["name"] for c in raw["configs"]], "configs")
    _unique([c["file"] for c in raw["configs"]], "configs' files")
    for w in raw["workloads"]:
        _keys(w, {"name", "config", "traffic", "chips", "why"}, set(), "a workload")
        check_name(w["name"], "workload")
        check_name(w["traffic"], f"workload {w['name']} traffic")
        check_line(w["why"], f"workload {w['name']} why")
        if w["config"] not in bench.configs:
            raise SpecError(f"workload {w['name']}: no config {w['config']!r}")
        if w["chips"] not in (1, 4):
            raise SpecError(f"workload {w['name']}: chips is 1 or 4")
        bench.workloads[w["name"]] = w
    _unique([w["name"] for w in raw["workloads"]], "workloads")
    _unique([(w["config"], w["traffic"]) for w in raw["workloads"]],
            "workloads (config, traffic pairs)")
    for group, sources in (("end_to_end", _E2E_SOURCES), ("per_layer", _SOURCES)):
        for m in raw[group]:
            req = {"name", "unit", "better", "source"}
            req |= {"bound"} if group == "end_to_end" else {"layer", "moves"}
            _keys(m, req, {"workloads"}, f"metric {m.get('name')}")
            check_name(m["name"], "metric")
            check_unit(m["unit"], f"metric {m['name']}")
            if m["better"] not in ("lower", "higher"):
                raise SpecError(f"metric {m['name']}: better is lower or higher")
            if m["source"] not in sources:
                raise SpecError(f"metric {m['name']}: source {m['source']!r}")
            for cell in m.get("workloads", []):
                if cell not in bench.workloads:
                    raise SpecError(f"metric {m['name']}: no workload {cell!r}")
            if group == "per_layer":
                check_line(m["layer"], f"metric {m['name']} layer")
            bench.metrics[m["name"]] = m
    _unique(list(bench.metrics), "metrics")
    for m in raw["per_layer"]:
        if m["moves"] not in {e["name"] for e in raw["end_to_end"]}:
            raise SpecError(f"metric {m['name']}: moves {m['moves']!r}, no such "
                            "end-to-end metric")
    return bench


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def config_of(bench: Benchmark, cell: dict) -> dict:
    """The cell's configuration file, as run."""
    return load_json(bench.root / bench.configs[cell["config"]]["file"])


def traffic_of(cell: dict, base: Path = HERE) -> dict:
    """The cell's traffic mix, `traffic/<traffic>.json`."""
    return load_json(base / "traffic" / f"{check_name(cell['traffic'], 'traffic')}.json")


def load_module(kind: str, name: str, base: Path = HERE):
    """`<base>/<kind>/<name>.py` as a module (names may hold dots, so the
    file is loaded by path)."""
    path = base / kind / f"{check_name(name, kind)}.py"
    if not path.is_file():
        raise SpecError(f"no {kind} file {path.relative_to(base.parent)}")
    spec = importlib.util.spec_from_file_location(f"bench_torch_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
