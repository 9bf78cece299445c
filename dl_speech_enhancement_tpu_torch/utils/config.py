"""YAML config system, schema-compatible with the reference's config/**.

The port's own copy of dl_speech_enhancement_tpu/utils/config.py (the port
imports nothing of the JAX package). Checkpoints are loaded with the
``config.yml`` beside them (bin/utils.py:17-22).
"""

from __future__ import annotations

import os

import yaml


def load_config(path: str, overrides: dict | None = None) -> dict:
    with open(path) as f:
        config = yaml.safe_load(f)
    if overrides:
        config.update(overrides)
    return config


def save_config(path: str, config: dict):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(_plain(config), f, sort_keys=False)


def _plain(obj):
    """Make the config YAML-serializable (tuples -> lists etc.)."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def load_config_beside(checkpoint_path: str) -> dict:
    """Load the config.yml stored next to a checkpoint (bin/utils.py:10-22)."""
    config_path = os.path.join(os.path.dirname(checkpoint_path), "config.yml")
    if not os.path.exists(config_path):
        raise FileNotFoundError(f"config.yml not found beside {checkpoint_path}")
    return load_config(config_path)
