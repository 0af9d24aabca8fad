"""YAML config system, compatible with the reference templates.

Replaces ``template_params`` / ``check_output_dir`` (reference
``backend.py:234-280``): the same ``paths.yaml`` + ``templates/*.yaml`` files
run unchanged. ``check_output_dir`` keeps the reference's self-healing
interactive loop but adds a non-interactive mode (create-if-missing) for
headless jobs.

The templates are flat ``key: value`` maps whose values are scalars or lists
of scalars, so they are read by a small built-in reader (``load_flat_yaml``)
instead of PyYAML: the engine runs on JAX, numpy and the standard library.
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

# YAML 1.1 scalar resolution, as PyYAML's safe loader applies it
_BOOLS = {v: True for v in ("y", "Y", "yes", "Yes", "YES", "true", "True",
                            "TRUE", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("n", "N", "no", "No", "NO", "false",
                                  "False", "FALSE", "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"
)


def _strip_comment(text: str) -> str:
    """Drop a ``#`` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return json.loads(text)
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        low = text.lower().replace("_", "")
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        return float("nan") if low.endswith("nan") else float(low)
    if text[:1] in "[{&*!|>%@`":
        raise ValueError(f"unsupported YAML value: {text!r}")
    return text


def _flow_list(text: str) -> list:
    inner = text.strip()[1:-1].strip()
    if not inner:
        return []
    if any(ch in inner for ch in "[]{}'\""):
        raise ValueError(f"unsupported YAML flow list: {text!r}")
    return [_scalar(item) for item in inner.split(",")]


def load_flat_yaml(text: str) -> dict:
    """Parse the YAML subset the templates use: top-level ``key: value``
    lines whose values are scalars, ``[a, b]`` flow lists, or ``- item``
    block lists. Anything else raises ``ValueError``."""
    out: dict = {}
    block_key = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        item = line.lstrip()
        if item.startswith("- ") or item == "-":
            if block_key is None:
                raise ValueError(f"list item outside a key: {raw!r}")
            if out[block_key] is None:
                out[block_key] = []
            out[block_key].append(_scalar(item[1:]))
            continue
        if line[0] in " \t":
            raise ValueError(f"nested YAML mappings are not supported: {raw!r}")
        key, sep, value = line.partition(":")
        if not sep or (value and value[0] not in " \t"):
            raise ValueError(f"expected 'key: value': {raw!r}")
        key, value = key.strip(), value.strip()
        if value.startswith("["):
            out[key] = _flow_list(value)
            block_key = None
        else:
            out[key] = _scalar(value)
            block_key = key if not value else None
    return out


def template_params(path: str) -> dict:
    """Parameters dict from a YAML template file (``backend.py:234-238``)."""
    with open(path, "r") as file:
        return load_flat_yaml(file.read())


def check_output_dir(
    paths_file: str = "paths.yaml",
    interactive: Optional[bool] = None,
) -> str:
    """Read the output root from ``paths.yaml`` and make sure it exists
    (``backend.py:241-280``). In non-interactive mode (the default when stdin
    is not a TTY) a missing directory is created instead of prompting."""
    keys = template_params(paths_file)
    output_dir = keys["output_dir"]

    if interactive is None:
        import sys

        interactive = sys.stdin.isatty()

    while not os.path.isdir(output_dir):
        if not interactive:
            os.makedirs(output_dir, exist_ok=True)
            break
        print(f'\nSimulation output directory: "{output_dir}" does not exist!')
        user = input('Do you want to make this directory? If "n", you can specify'
                     " the correct path (y/n): ")
        print()
        if user == "y":
            os.makedirs(output_dir)
            break
        elif user == "n":
            output_dir = input("Correct path (absolute) to output directory: ")
            keys["output_dir"] = output_dir
            with open(paths_file, "w") as file:
                file.writelines(f"{k}: {json.dumps(v)}\n" for k, v in keys.items())
        else:
            print('Either type "y" or "n"')

    separator = os.path.sep
    if output_dir[-1] != separator:
        output_dir += separator
    return output_dir


def check_direct(path: str) -> None:
    """Make sure a directory exists (``backend.py:163-167``)."""
    if not os.path.isdir(path):
        os.makedirs(path, exist_ok=True)


def ensure_compilation_cache() -> None:
    """Point JAX at a persistent compilation cache unless one is already
    set. ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own choice and is
    left alone; otherwise the cache lives at the fixed ``.jax_cache/``
    directory of the checkout, so every process of a run (and every rerun)
    finds what an earlier one compiled."""
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.config.jax_compilation_cache_dir:
        return
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)
