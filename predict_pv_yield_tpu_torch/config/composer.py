"""Hydra-compatible YAML config composition (a copy of the JAX package's
``config/composer.py``).

This module implements the slice of hydra's semantics the reference relies
on (reference ``configs/config.yaml``,
``run.py:16``, SURVEY §2.1.2), over the same file layout:

* a root config with a ``defaults`` list of ``group: name`` entries, each
  loading ``<config_dir>/<group>/<name>.yaml`` into ``cfg[group]``;
* ``# @package _global_`` files (experiments, hparams_search) that merge at
  the root and may re-select groups via ``override /group: name`` entries in
  their own ``defaults`` list;
* group files with their own ``defaults`` list of sibling files (e.g.
  ``logger/many_loggers.yaml``) merged into the group;
* command-line overrides: ``group=name`` (re-select), ``key.path=value``
  (merge, YAML-typed), ``+key=value`` (add), ``~key`` (delete);
* ``${...}`` interpolation: config references (``${work_dir}``),
  ``${oc.env:VAR[,default]}``, ``${now:%fmt}``, ``${hydra:runtime.cwd}``.

The composed result is a plain nested dict — no framework object — which the
instantiate registry (``config/instantiate.py``) turns into live objects.
PyYAML is imported inside the functions that read YAML, so the rest of the
port runs where it is not installed (a literal dict config into ``train``).
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Any, Dict, List, Optional, Tuple

#: the repo's ``configs/`` tree, beside this package
_CONFIG_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "configs")

#: hydra's package directive: a comment line of exactly this form in the
#: file header (a file merely MENTIONING the marker in prose must not be
#: silently merged at the config root)
_GLOBAL_PACKAGE_RE = re.compile(r"^\s*#\s*@package\s+_global_\s*$")


def _load_yaml(path: str) -> Tuple[Dict[str, Any], bool]:
    """Load a YAML file; returns (data, is_global_package)."""
    import yaml

    with open(path, "r") as fh:
        text = fh.read()
    is_global = any(
        _GLOBAL_PACKAGE_RE.match(line) for line in text.split("\n", 10)[:10]
    )
    data = yaml.safe_load(text) or {}
    return data, is_global


def _group_file(config_dir: str, group: str, name: str) -> str:
    name = str(name)
    if not name.endswith(".yaml"):
        name += ".yaml"
    return os.path.join(config_dir, group, name)


def deep_merge(base: Dict[str, Any], overlay: Dict[str, Any]) -> Dict[str, Any]:
    """Recursively merge ``overlay`` into ``base`` (overlay wins)."""
    for key, value in overlay.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            deep_merge(base[key], value)
        else:
            base[key] = value
    return base


def _parse_defaults(defaults: List) -> List[Tuple[str, Any, bool]]:
    """Normalise a defaults list into (group, name, is_override) tuples."""
    entries = []
    for item in defaults or []:
        if isinstance(item, str):
            entries.append((item.replace(".yaml", ""), item, False))
            continue
        for key, name in item.items():
            is_override = False
            group = key
            if group.startswith("override "):
                group = group[len("override "):]
                is_override = True
            group = group.strip().lstrip("/")
            entries.append((group, name, is_override))
    return entries


def _load_group(
    config_dir: str,
    group: str,
    name: Any,
    data: Optional[Dict[str, Any]] = None,
) -> Optional[Dict[str, Any]]:
    """Load one group selection, following intra-group defaults lists.

    ``data`` short-circuits the file read when the caller already parsed the
    YAML (compose() reads each group file once to check its package marker)."""
    if name in (None, "null", "None"):
        return None
    if data is None:
        data, _ = _load_yaml(_group_file(config_dir, group, name))
    sub_defaults = data.pop("defaults", None)
    if sub_defaults:
        merged: Dict[str, Any] = {}
        for _, sub_name, _ in _parse_defaults(sub_defaults):
            sub = _load_group(config_dir, group, sub_name)
            if sub:
                deep_merge(merged, sub)
        deep_merge(merged, data)
        data = merged
    return data


#: PyYAML implements YAML 1.1, whose float regex requires a decimal point
#: before the exponent — ``yaml.safe_load("1e-5")`` returns the STRING
#: "1e-5" while hydra (YAML 1.2) parses a float. String learning rates
#: crash optimisers, so post-correct the 1.2 forms.
_SCI_FLOAT_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def parse_override_value(raw: str) -> Any:
    import yaml

    try:
        value = yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw
    if isinstance(value, str) and _SCI_FLOAT_RE.match(value):
        return float(value)
    return value


def _set_path(cfg: Dict[str, Any], dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = value


def _del_path(cfg: Dict[str, Any], dotted: str) -> None:
    keys = dotted.split(".")
    node = cfg
    for key in keys[:-1]:
        node = node.get(key)
        if node is None:
            return
    node.pop(keys[-1], None)


_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _resolve_value(expr: str, root: Dict[str, Any]) -> Any:
    if expr.startswith("oc.env:"):
        parts = expr[len("oc.env:"):].split(",", 1)
        default = parts[1].strip() if len(parts) > 1 else None
        value = os.environ.get(parts[0].strip(), default)
        if value is None:
            raise KeyError(f"environment variable {parts[0]!r} is not set")
        return value
    if expr.startswith("now:"):
        return datetime.datetime.now().strftime(expr[len("now:"):])
    if expr.startswith("hydra:"):
        if expr == "hydra:runtime.cwd":
            return os.getcwd()
        return ""  # other hydra internals are not modelled
    # config reference by dotted path
    node: Any = root
    for key in expr.split("."):
        if not isinstance(node, dict) or key not in node:
            return "${" + expr + "}"  # unresolved: leave as-is
        node = node[key]
    return node


def _interpolate(node: Any, root: Dict[str, Any], depth: int = 0) -> Any:
    if depth > 8:
        return node
    if isinstance(node, dict):
        return {k: _interpolate(v, root, depth) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root, depth) for v in node]
    if isinstance(node, str) and "${" in node:
        match = _INTERP_RE.fullmatch(node)
        if match:  # whole-string interpolation keeps the value's type
            resolved = _resolve_value(match.group(1), root)
            if isinstance(resolved, str) and "${" in resolved and resolved != node:
                return _interpolate(resolved, root, depth + 1)
            return resolved
        return _INTERP_RE.sub(
            lambda m: str(_resolve_value(m.group(1), root)), node
        )
    return node


def compose(
    config_name: str = "config",
    overrides: Optional[List[str]] = None,
    config_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Compose the full run config (the ``hydra.main``/``compose`` analog)."""
    if config_dir is None:
        config_dir = _CONFIG_DIR
    config_dir = os.path.abspath(config_dir)
    overrides = list(overrides or [])

    if not config_name.endswith(".yaml"):
        config_name += ".yaml"
    root_raw, _ = _load_yaml(os.path.join(config_dir, config_name))
    defaults = _parse_defaults(root_raw.pop("defaults", []))

    # Split overrides into group selections vs value overrides.
    group_names = {group for group, _, _ in defaults}
    selections: Dict[str, Any] = {}
    value_overrides: List[str] = []
    for override in overrides:
        if override.startswith(("+", "~")) or "=" not in override:
            value_overrides.append(override)
            continue
        key, _, value = override.partition("=")
        if key in group_names and "." not in key:
            selections[key] = parse_override_value(value)
        else:
            value_overrides.append(override)

    cfg: Dict[str, Any] = {}
    global_overlays: List[Dict[str, Any]] = []

    for group, default_name, _ in defaults:
        name = selections.get(group, default_name)
        if group == "hydra":
            # hydra run-dir config is loaded but kept under its key
            data = _load_group(config_dir, group, name)
            if data is not None:
                cfg["hydra"] = data
            continue
        if name in (None, "null", "None"):
            continue
        path = _group_file(config_dir, group, name)
        data, is_global = _load_yaml(path)
        if is_global:
            overlay_defaults = _parse_defaults(data.pop("defaults", []))
            for o_group, o_name, _ in overlay_defaults:
                if o_group in selections:
                    # hydra priority: an explicit command-line group
                    # selection beats the experiment file's `override
                    # /group` re-selection (CLI overrides compose last)
                    continue
                o_data = _load_group(config_dir, o_group, o_name)
                if o_data is not None:
                    cfg[o_group] = o_data
            global_overlays.append(data)
        else:
            cfg[group] = _load_group(config_dir, group, name, data=data)

    # root-level plain keys
    deep_merge(cfg, root_raw)
    # experiment/hparams_search overlays merge last (they win over root)
    for overlay in global_overlays:
        deep_merge(cfg, overlay)

    # value overrides
    for override in value_overrides:
        if override.startswith("~"):
            _del_path(cfg, override[1:])
            continue
        key, _, value = override.lstrip("+").partition("=")
        _set_path(cfg, key, parse_override_value(value))

    # Iterate to a fixpoint so chained references (${work_dir} ->
    # ${hydra:runtime.cwd}) resolve fully.
    for _ in range(8):
        resolved = _interpolate(cfg, cfg)
        if resolved == cfg:
            break
        cfg = resolved
    return cfg
