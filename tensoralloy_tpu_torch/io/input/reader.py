"""Layered TOML experiment configuration
(reference `tensoralloy/io/input/reader.py:37-214`).

Semantics: user file merged over `defaults.toml`; enumerated values
validated against `choices.toml`; relative paths resolved against the
input file's directory; dotted-keypath access (`reader['nn.loss.energy
.weight']` / `.get(...)`).
"""
from __future__ import annotations

import os
import tomllib
from typing import Any, Optional

from ...utils import nested_get, nested_set

_HERE = os.path.dirname(os.path.abspath(__file__))

_PATH_KEYS = ("dataset.sqlite3", "dataset.tfrecords_dir",
              "train.model_dir", "nn.loss.extra_constraint.filename",
              "train.ckpt.checkpoint_filename")


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _validate(config: dict, choices: dict, prefix: str = ""):
    for k, allowed in choices.items():
        path = f"{prefix}{k}"
        if isinstance(allowed, dict):
            _validate(config.get(k, {}) if isinstance(config.get(k), dict)
                      else {}, allowed, path + ".")
        else:
            value = nested_get(config, path) if not prefix else \
                config.get(k)
            if value is None or value is False:
                continue
            if isinstance(value, str) and "@" in value and \
                    value.split("@")[0] in allowed:
                continue  # named preset bank of an allowed algorithm
            if value not in allowed:
                raise ValueError(
                    f"'{value}' is not a valid choice for '{path}' "
                    f"(allowed: {allowed})")


class InputReader:
    """Parse and validate a TOML experiment file."""

    def __init__(self, filename_or_dict, validate: bool = True):
        with open(os.path.join(_HERE, "defaults.toml"), "rb") as fh:
            defaults = tomllib.load(fh)
        with open(os.path.join(_HERE, "choices.toml"), "rb") as fh:
            self._choices = tomllib.load(fh)

        if isinstance(filename_or_dict, dict):
            user = dict(filename_or_dict)
            base_dir = os.getcwd()
        else:
            with open(filename_or_dict, "rb") as fh:
                user = tomllib.load(fh)
            base_dir = os.path.dirname(os.path.abspath(filename_or_dict))

        config = _deep_merge(defaults, user)

        # resolve relative paths against the input file location
        for keypath in _PATH_KEYS:
            value = nested_get(config, keypath)
            if isinstance(value, str) and value and \
                    value != "required" and not os.path.isabs(value):
                nested_set(config, keypath,
                           os.path.normpath(os.path.join(base_dir, value)))

        if validate:
            self._check_required(config)
            _validate(config, self._choices)
        self._config = config

    @staticmethod
    def _check_required(config: dict):
        for keypath in ("dataset.sqlite3", "dataset.name"):
            if nested_get(config, keypath) == "required":
                raise ValueError(f"'{keypath}' must be provided")

    # ------------------------------------------------------------------
    def __getitem__(self, keypath: str) -> Any:
        value = nested_get(self._config, keypath, default=KeyError)
        if value is KeyError:
            raise KeyError(keypath)
        return value

    def get(self, keypath: str, default: Optional[Any] = None) -> Any:
        return nested_get(self._config, keypath, default=default)

    def __contains__(self, keypath: str) -> bool:
        return nested_get(self._config, keypath, KeyError) is not KeyError

    def as_dict(self) -> dict:
        return dict(self._config)

    @property
    def config(self) -> dict:
        return self._config
