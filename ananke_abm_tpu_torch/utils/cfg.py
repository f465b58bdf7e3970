"""Config loading and small filesystem helpers (the port's copy of
``ananke_abm_tpu.utils.cfg``).

Configs are the reference's {data, model, train} (or {crf}) YAML / JSON
dict trees. YAML is read through a lazy ``import yaml``, so a machine
without PyYAML can still import this module and pass configs as dicts.
"""
from __future__ import annotations

import json
import os


def load_config(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml

        return yaml.safe_load(f)


def ensure_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path
