"""The CLI's YAML config reader, on plain nested dicts (the ``load`` and
``apply_dot_overrides`` of p2p_bridge_tpu/utils/config.py; tests hold
them equal).

``yaml`` is imported inside the functions: nothing else of the port reads
YAML, and the machine with the card has no PyYAML.
"""

from __future__ import annotations

import logging
from typing import Any, List


def parse_scalar(text: str) -> Any:
    """A CLI string parsed as YAML would parse it (int, float, bool, null,
    list); the string itself where YAML refuses it."""
    import yaml

    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_yaml(path: str) -> dict:
    """A YAML file whose top level is a mapping -> nested dicts."""
    import yaml

    with open(path, "r") as handle:
        data = yaml.safe_load(handle) or {}
    if not isinstance(data, dict):
        raise ValueError(f"Top-level YAML in {path} must be a mapping")
    return data


def set_dotted(cfg: dict, dotted: str, value: Any) -> None:
    """cfg["a"]["b"]["c"] = value for "a.b.c", creating (or replacing
    non-mapping) parents."""
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        if not isinstance(node.get(part), dict):
            node[part] = {}
        node = node[part]
    node[parts[-1]] = value


def apply_dot_overrides(cfg: dict, argv: List[str]) -> List[str]:
    """Consume ``--a.b.c value``, ``--a.b.c=value`` and ``a.b.c=value``
    from argv into ``cfg``; returns (and logs) the tokens left over."""
    leftover: List[str] = []
    i = 0
    while i < len(argv):
        tok = argv[i]
        if "=" in tok:
            key, value = tok.lstrip("-").split("=", 1)
            set_dotted(cfg, key, parse_scalar(value))
            i += 1
        elif tok.startswith("--") and i + 1 < len(argv):
            set_dotted(cfg, tok[2:], parse_scalar(argv[i + 1]))
            i += 2
        else:
            leftover.append(tok)
            i += 1
    if leftover:
        logging.getLogger("p2pb").warning("Unrecognized CLI tokens (ignored): %s", leftover)
    return leftover
