"""TOML experiment files: defaults, choices and the reader."""
from .reader import InputReader  # noqa: F401
