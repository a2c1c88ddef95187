"""YAML configs: load, merge left to right, apply `a.b.c=value` overrides.

A copy of the loading part of `jointimagegeneration_tpu/core/config.py`.
`yaml` is imported only when a file or an override is parsed, so the rest of
the port runs where PyYAML is not installed.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["load_yaml_config", "apply_overrides"]


def load_yaml_config(*paths, overrides: Optional[Sequence[str]] = None) -> dict:
    """Merge YAML files left to right, then apply key=value dotlist overrides."""
    import yaml

    cfg: dict = {}
    for p in paths:
        with open(p) as f:
            _deep_merge(cfg, yaml.safe_load(f) or {})
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def apply_overrides(cfg: dict, overrides: Sequence[str]) -> dict:
    """'a.b.c=value' dotlist; values parsed as YAML scalars."""
    import yaml

    for ov in overrides:
        key, sep, raw = ov.partition("=")
        if not sep:
            raise ValueError(f"override {ov!r} must be key=value")
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw)
    return cfg
