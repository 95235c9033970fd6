"""Model registry: named helicopter parameter sets.

The model files are the JAX package's data files, read in place by path
(`heligym_tpu/models/<name>.yaml`); no module of that package is imported.
They use a small subset of YAML (nested mappings by indentation, numbers,
quoted strings, comments), which `_parse_yaml` reads without PyYAML so the
port needs no package beyond torch and numpy. `register_model_path` adds a
directory of the user's own airframes, searched first.
"""
from __future__ import annotations

import functools
import os
from typing import List

from .schema import HeliParams, precalculate

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODEL_DIR = os.path.join(_REPO_ROOT, "heligym_tpu", "models")
_SEARCH_PATHS: List[str] = [_MODEL_DIR]


def register_model_path(path: str) -> None:
    """Add a directory to search for `<name>.yaml` model files, ahead of the
    others (a path already listed is not added twice). `load_params` caches
    each name at its first load, as the JAX package's does: a name loaded
    before its directory was registered keeps what was found then (give a
    user airframe a name of its own)."""
    if path not in _SEARCH_PATHS:
        _SEARCH_PATHS.insert(0, path)


def available_models() -> List[str]:
    names = []
    for d in _SEARCH_PATHS:
        if os.path.isdir(d):
            names += [f[:-5] for f in os.listdir(d) if f.endswith(".yaml")]
    return sorted(set(names))


def _scalar(text: str):
    """A YAML plain scalar as PyYAML's safe loader reads the model files:
    int, then float, else a (possibly quoted) string."""
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    for conv in (int, float):
        try:
            return conv(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#":
            return line[:i]
    return line


def _parse_yaml(text: str) -> dict:
    """Nested `key: value` mappings by indentation (the model-file subset)."""
    root: dict = {}
    stack = [(-1, root)]
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep:
            raise ValueError(f"unsupported YAML line: {raw!r}")
        while stack[-1][0] >= indent:
            stack.pop()
        parent = stack[-1][1]
        value = value.strip()
        if value:
            parent[key.strip()] = _scalar(value)
        else:
            child: dict = {}
            parent[key.strip()] = child
            stack.append((indent, child))
    return root


@functools.lru_cache(maxsize=None)
def load_params(name: str = "aw109") -> HeliParams:
    """Load and precalculate the named model's parameters (cached)."""
    for d in _SEARCH_PATHS:
        path = os.path.join(d, name + ".yaml")
        if os.path.isfile(path):
            with open(path) as f:
                raw = _parse_yaml(f.read())
            return precalculate(raw, name=name)
    raise FileNotFoundError(
        f"No model named {name!r}; searched {_SEARCH_PATHS}. "
        f"Available: {available_models()}")
