"""Hydra-style config composition (counterpart of
``newsreclib_tpu/config/compose.py:30-170``): a root config with a
``defaults`` list of ``group: name`` entries, group files merged under their
group key, an ``experiment=<name>`` overlay deep-merged last, dotted
``a.b.c=value`` overrides (``group=name`` selects another group file) and
``${a.b}`` interpolation after merging.

The port composes the JAX package's YAML files under
``newsreclib_tpu/configs/`` (``CONFIG_DIR``), read as data with
``yaml_lite``: one source of hyperparameters for both packages, and no
Python import of the JAX package.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, List, Optional, Sequence

from newsreclib_tpu_torch.config import yaml_lite

CONFIG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "newsreclib_tpu", "configs")

_INTERP = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_INLINE = re.compile(r"\$\{([^}]+)\}")
_SCI_FLOAT = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def deep_merge(base: Dict, overlay: Dict) -> Dict:
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _load_yaml(path: str) -> Dict:
    return yaml_lite.load(path) or {}


def parse_override_value(val: str) -> Any:
    """A CLI override value, read as YAML; bare scientific notation
    (``lr=1e-05``), which YAML 1.1 leaves a string, becomes a float, as in
    the JAX package.  Quote it (``name='"2e5"'``) to keep a string."""
    parsed = yaml_lite.loads(val)
    if isinstance(parsed, str) and _SCI_FLOAT.match(parsed):
        return float(parsed)
    return parsed


def _get_path(cfg: Dict, dotted: str) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        node = node[part]
    return node


def _set_path(cfg: Dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _resolve_interpolations(cfg: Dict) -> Dict:
    def resolve(node: Any, depth: int = 0) -> Any:
        if depth > 20:
            raise ValueError("interpolation cycle")
        if isinstance(node, dict):
            return {k: resolve(v, depth) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v, depth) for v in node]
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:
                return resolve(_get_path(cfg, m.group(1)), depth + 1)
            return _INTERP_INLINE.sub(
                lambda mm: str(resolve(_get_path(cfg, mm.group(1)), depth + 1)), node
            )
        return node

    return resolve(cfg)


def compose(config_dir: str = CONFIG_DIR, config_name: str = "train",
            overrides: Optional[Sequence[str]] = None) -> Dict:
    """The composed config tree, e.g. ``compose(overrides=["experiment=nrms_demo",
    "data.batch_size=32", "model=naml"])``."""
    overrides = list(overrides or [])
    root = _load_yaml(os.path.join(config_dir, f"{config_name}.yaml"))
    defaults: List = root.pop("defaults", [])

    # group selections (group=name) replace entries of the defaults
    group_sel: Dict[str, str] = {}
    leaf_overrides: List[str] = []
    experiment = None
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"invalid override {ov!r}")
        key, val = ov.split("=", 1)
        if key == "experiment":
            experiment = val
        elif "." not in key and os.path.isdir(os.path.join(config_dir, key)):
            group_sel[key] = val
        else:
            leaf_overrides.append(ov)

    cli_groups = set(group_sel)
    cfg: Dict = dict(root)
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                continue
            group, name = entry.split("/", 1) if "/" in entry else (entry, None)
        else:
            (group, name), = entry.items()
        name = group_sel.pop(group, name)
        if name in (None, "null"):
            continue
        cfg = deep_merge(cfg, {group: _load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))})
    # groups selected on the command line but absent from the defaults
    for group, name in group_sel.items():
        cfg = deep_merge(cfg, {group: _load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))})

    if experiment:
        exp = _load_yaml(os.path.join(config_dir, "experiment", f"{experiment}.yaml"))
        # an experiment's own group selections yield to the command line's
        for entry in exp.pop("defaults", []):
            if isinstance(entry, str):
                continue
            (group, name), = entry.items()
            group = group.removeprefix("override /").removeprefix("/")
            if name in (None, "null") or group in cli_groups:
                continue
            cfg[group] = _load_yaml(os.path.join(config_dir, group, f"{name}.yaml"))
        for group in cli_groups:
            exp.pop(group, None)
        cfg = deep_merge(cfg, exp)
        cfg["experiment_name"] = experiment

    for ov in leaf_overrides:
        key, val = ov.split("=", 1)
        _set_path(cfg, key, parse_override_value(val))

    return _resolve_interpolations(cfg)
