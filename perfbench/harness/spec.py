"""What one cell is: its ``BENCHMARK.json`` entry and the files it names.

``Cell.load(root, name)`` reads the workload entry, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``),
its own data (``cells/<cell>.json``: a serving cell's fixed rate, the
limits of the comparison that decides ``correct``) and the metrics it
reports.  ``load_bench(root, parked=True)`` adds the cells taken out of
``BENCHMARK.json`` until the program can run their configuration as it
is stated, which the tests and tools still run.  Nothing here imports
the program.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, List


def load_bench(root, parked: bool = False) -> dict:
    """``BENCHMARK.json``; with ``parked``, also the entries that a cell
    taken out of it keeps under ``parked`` in ``cells/<cell>.json`` (its
    workload, end-to-end and per-layer metrics, as they would go back)."""
    root = pathlib.Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if parked:
        for path in sorted((root / "perfbench" / "cells").glob("*.json")):
            entries = json.loads(path.read_text()).get("parked")
            if entries:
                bench["workloads"].append(entries["workload"])
                bench["end_to_end"] += entries["end_to_end"]
                bench["per_layer"] += entries["per_layer"]
    return bench


@dataclasses.dataclass
class Cell:
    root: pathlib.Path            # the checkout: BENCHMARK.json and perfbench/
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    data: dict                    # cells/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @classmethod
    def load(cls, root, name: str, bench: dict = None) -> "Cell":
        root = pathlib.Path(root)
        if bench is None:
            bench = load_bench(root)
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise SystemExit(f"unknown workload {name!r}; known: "
                             f"{[w['name'] for w in bench['workloads']]}")
        wl = found[0]
        cfg_entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
        here = root / "perfbench"
        config = json.loads((root / cfg_entry["file"]).read_text())
        traffic = json.loads((here / "traffic" / f"{wl['traffic']}.json").read_text())
        data = json.loads((here / "cells" / f"{name}.json").read_text())
        e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if name in m.get("workloads", [name]) and m["moves"] in e2e_names]
        return cls(root, bench, wl, config, traffic, data, e2e, per_layer)


def program_config(config: dict):
    """The port's ``LMConfig`` for a configuration file: the registry's
    entry with the file's overrides, its widths held to the file's (a
    mismatch raises: the file states the configuration as it runs)."""
    import dataclasses as dc

    from repro_torch import configs

    prog = config["program"]
    if prog.get("smoke"):       # the tests' small sizes, on the CPU
        cfg = dc.replace(configs.get_smoke_config(prog["arch"]), **prog.get("overrides", {}))
    else:
        cfg = configs.get_config(prog["arch"], **prog.get("overrides", {}))
    want = widths(config)
    got = {"layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "tied": cfg.tie_embeddings}
    if cfg.mixer == "attn":
        got.update(heads=cfg.n_heads, kv_heads=cfg.n_kv, head_dim=cfg.hd, d_ff=cfg.d_ff,
                   rope_theta=cfg.rope_theta, qkv_bias=cfg.qkv_bias)
    else:
        from repro_torch.models.config import ssm_dims

        d_inner, dt_rank = ssm_dims(cfg)
        got.update(d_inner=d_inner, d_state=cfg.ssm.d_state, d_conv=cfg.ssm.d_conv,
                   dt_rank=dt_rank)
    for k, v in got.items():
        if want[k] != v:
            raise ValueError(f"{config['name']}: the program's {k} is {v}, the file states "
                             f"{want[k]}")
    return cfg


def reference(config: dict):
    """The configuration's plain reference module, ``reference/<name>.py``."""
    import importlib

    return importlib.import_module(f"reference.{config['reference']}")


def widths(config: dict) -> Dict[str, object]:
    """The sizes every side reads, under one set of names, from the
    configuration file's published keys (the reference module's map)."""
    return reference(config).widths(config)
