"""A cell, found by name: its entry in ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
its limits (``limits/<workload>.json``) and the readers of its metrics
(``metrics/<metric>.py``). Nothing here knows a cell by name."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

from reference.lm import Model

BENCH = Path(__file__).resolve().parents[1]  # portbench/
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    @property
    def mode(self) -> str:
        return self.mix["mode"]

    @property
    def layers(self) -> int:
        return int(self.config["layers_run"][self.mode])

    def model(self) -> Model:
        c = self.config
        return Model(
            d=c["hidden_size"], heads=c["num_attention_heads"],
            kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            ff=c["intermediate_size"], vocab=c["vocab_size"], layers=self.layers,
            rope_theta=float(c["rope_theta"]), eps=float(c["rms_norm_eps"]))

    def arch(self):
        """The program's configuration object for the same model."""
        from repro_torch.configs import ArchConfig

        m, c = self.model(), self.config
        return ArchConfig(
            name=c["name"], family="dense", n_layers=m.layers, d_model=m.d, n_heads=m.heads,
            n_kv_heads=m.kv_heads, d_ff=m.ff, vocab_size=m.vocab, head_dim=m.head_dim,
            mlp_act="swiglu", rope_theta=m.rope_theta, norm_eps=m.eps,
            embedding_mode="hier_ps")


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load(workload: str, bench_file: Path | None = None, config: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json``. ``config`` replaces the
    configuration file's contents (the tests run cells at small widths)."""
    spec = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = config or json.loads((ROOT / cfg["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    return Cell(workload, int(entry["chips"]), config, mix, limits,
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)])


def _load(folder: str, name: str, attr: str):
    path = BENCH / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, attr)


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(run) -> value or None``."""
    return _load("metrics", metric, "read")


def count(op: str):
    """``counts/<op>.py``'s ``count(**shapes) -> (flops, bytes)``."""
    return _load("counts", op, "count")
