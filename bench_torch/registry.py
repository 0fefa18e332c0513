"""Find a configuration, a cell, a traffic kind, an end-to-end metric or a
per-layer metric by its name, as a file under one of the roots:

    configs/<config>.json   cells/<cell>.json   traffic/<kind>.py
    e2e/<metric>.py         metrics/<metric>.py

A later cell, configuration, traffic kind or metric is a new file; no file
that is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_ROOT = os.path.dirname(os.path.abspath(__file__))


def find(roots, sub: str, name: str, ext: str) -> str:
    for root in roots:
        path = os.path.join(root, sub, name + ext)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {sub}/{name}{ext} under {list(roots)}")


def load_json(roots, sub: str, name: str) -> dict:
    with open(find(roots, sub, name, ".json")) as f:
        return json.load(f)


def load_module(roots, sub: str, name: str):
    """The module of ``sub/name.py`` (a name may hold dots)."""
    path = find(roots, sub, name, ".py")
    spec = importlib.util.spec_from_file_location(f"{sub}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(roots, name: str) -> dict:
    return load_json(roots, "cells", name)


def config(roots, name: str) -> dict:
    return load_json(roots, "configs", name)


def traffic(roots, kind: str):
    return load_module(roots, "traffic", kind)


def e2e_metric(roots, name: str):
    return load_module(roots, "e2e", name)


def layer_metric(roots, name: str):
    return load_module(roots, "metrics", name)


def cell_metrics(spec: dict, cell_name: str):
    """The end-to-end and per-layer metric entries of BENCHMARK.json that
    the cell reports."""
    def applies(m):
        return cell_name in m["workloads"] if "workloads" in m else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if applies(m) and ("workloads" in m or m["moves"] in names)]
    return e2e, layer
