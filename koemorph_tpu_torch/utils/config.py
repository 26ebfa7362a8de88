"""Hydra-style YAML config composition: the counterpart of
``koemorph_tpu.utils.config``, giving the same dicts for the same files and
overrides.

- ``defaults:`` list with ``group: name`` entries (loaded from
  ``<config_dir>/<group>/<name>.yaml`` into key ``group``), ``_self_``
  ordering, and ``override group: name`` entries;
- ``${a.b.c}`` interpolation (absolute paths into the merged tree);
- the ``${eval:<expr>}`` arithmetic resolver;
- dot-notation overrides: ``model.d_model=128``, ``+new.key=1``,
  ``group=name`` (a group swap).

Files are read with PyYAML's ``yaml.safe_load``, as in the reference.
"""

from __future__ import annotations

import ast
import copy
import operator
import re
from pathlib import Path
from typing import Any, Iterable, Optional, Union

import yaml

__all__ = ["Config", "load_config", "merge", "apply_overrides", "to_dict"]

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config(dict):
    """A dict with attribute access and recursive wrapping (stands in for
    OmegaConf's DictConfig for the key-access patterns the trainers use)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    @staticmethod
    def wrap(value: Any) -> Any:
        if isinstance(value, dict):
            return Config({k: Config.wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config.wrap(v) for v in value]
        return value


def to_dict(cfg: Any) -> Any:
    """Recursively convert Config back to plain dict (for checkpointing)."""
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, list):
        return [to_dict(v) for v in cfg]
    return cfg


def merge(base: dict, update: dict) -> dict:
    """Deep merge ``update`` into ``base`` (update wins), returning base."""
    for key, value in update.items():
        if (key in base and isinstance(base[key], dict)
                and isinstance(value, dict)):
            merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


# -- ${eval:...} ------------------------------------------------------------

_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_UNARY_OPS = {ast.USub: operator.neg, ast.UAdd: operator.pos}


def _safe_eval(expr: str) -> Any:
    """Evaluate a pure-arithmetic expression (no names, no calls except
    int/float/min/max/round)."""
    allowed_calls = {"int": int, "float": float, "min": min, "max": max,
                     "round": round, "abs": abs}

    def ev(node: ast.AST) -> Any:
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp) and type(node.op) in _UNARY_OPS:
            return _UNARY_OPS[type(node.op)](ev(node.operand))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in allowed_calls and not node.keywords:
            return allowed_calls[node.func.id](*[ev(a) for a in node.args])
        if isinstance(node, ast.Compare) and len(node.ops) == 1:
            cmp_ops = {ast.Lt: operator.lt, ast.Gt: operator.gt,
                       ast.LtE: operator.le, ast.GtE: operator.ge,
                       ast.Eq: operator.eq, ast.NotEq: operator.ne}
            if type(node.ops[0]) in cmp_ops:
                return cmp_ops[type(node.ops[0])](
                    ev(node.left), ev(node.comparators[0]))
        if isinstance(node, ast.IfExp):
            return ev(node.body) if ev(node.test) else ev(node.orelse)
        raise ValueError(f"Disallowed expression node: {type(node).__name__}")

    return ev(ast.parse(expr, mode="eval"))


# -- interpolation ------------------------------------------------------------

def _resolve_node(value: Any, root: dict, depth: int = 0) -> Any:
    if depth > 16:
        raise ValueError("Interpolation recursion limit exceeded")
    if isinstance(value, dict):
        return {k: _resolve_node(v, root, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_node(v, root, depth) for v in value]
    if not isinstance(value, str):
        return value

    def lookup(path: str) -> Any:
        node: Any = root
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(
                    f"Interpolation key not found: ${{{path}}}")
            node = node[part]
        return _resolve_node(node, root, depth + 1)

    # whole-string ${eval:...} with (possibly nested) interpolations inside:
    # resolve the body first, then evaluate
    stripped = value.strip()
    if stripped.startswith("${eval:") and stripped.endswith("}"):
        body = _resolve_node(stripped[len("${eval:"):-1], root, depth + 1)
        return _safe_eval(str(body))

    full = _INTERP_RE.fullmatch(stripped)
    if full:  # whole-string interpolation preserves type
        return lookup(full.group(1))

    def sub(match: re.Match) -> str:
        expr = match.group(1)
        if expr.startswith("eval:"):
            body = _resolve_node(expr[len("eval:"):], root, depth + 1)
            return str(_safe_eval(str(body)))
        return str(lookup(expr))

    resolved = _INTERP_RE.sub(sub, value)
    if resolved != value and "${" in resolved:
        return _resolve_node(resolved, root, depth + 1)
    return resolved


def resolve(cfg: dict) -> dict:
    """Resolve all interpolations against the tree itself."""
    return _resolve_node(cfg, cfg)


# -- defaults-list composition -------------------------------------------------

def _compose(path: Path, config_dir: Path, group_key: Optional[str],
             overrides_groups: dict[str, str]) -> dict:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    defaults = raw.pop("defaults", None)
    if defaults is None:
        return raw

    merged: dict = {}
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            merge(merged, raw)
            self_merged = True
            continue
        if isinstance(entry, str):
            # bare file in same dir
            merge(merged, _compose(path.parent / f"{entry}.yaml",
                                   config_dir, None, overrides_groups))
            continue
        (key, name), = entry.items()
        is_override = False
        if key.startswith("override "):
            key = key[len("override "):]
            is_override = True
        if name is None:
            continue
        if key in overrides_groups:
            name = overrides_groups[key]
        group_dir = config_dir / key
        sub = _compose(group_dir / f"{name}.yaml", config_dir, key,
                       overrides_groups)
        if is_override:
            # hydra 'override group:' semantics: REPLACE the previous
            # selection, don't layer on top of it
            merged[key] = {}
        # group configs land under their group key
        merge(merged.setdefault(key, {}), sub)
    if not self_merged:
        merge(merged, raw)
    return merged


_SCI_RE = re.compile(r"^[+-]?\d+(\.\d*)?[eE][+-]?\d+$")


def _parse_value(text: str) -> Any:
    if _SCI_RE.match(text):  # YAML 1.1 parses bare "3e-4" as a string
        return float(text)
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def apply_overrides(cfg: dict, overrides: Iterable[str],
                    config_dir: Optional[Path] = None) -> dict:
    """Apply Hydra-CLI-style dot overrides to a composed config."""
    for ov in overrides:
        ov = ov.lstrip("+")
        if "=" not in ov:
            raise ValueError(f"Override must be key=value: {ov!r}")
        key, _, value_text = ov.partition("=")
        key = key.strip()
        value = _parse_value(value_text.strip())
        # group swaps (`model=dual_stream`) are composition-time concerns:
        # load_config already routed them into _compose, preserving the
        # root config's inline customizations for the group — skip here
        if config_dir is not None and "." not in key and \
                isinstance(value, str) and \
                (config_dir / key / f"{value}.yaml").exists():
            continue
        node = cfg
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return cfg


def load_config(
    path: Union[str, Path],
    overrides: Iterable[str] = (),
    config_dir: Optional[Union[str, Path]] = None,
) -> Config:
    """Compose a root config file with its defaults list, apply CLI
    overrides, and resolve interpolations. Equivalent surface to
    ``@hydra.main(config_path=..., config_name=...)``."""
    path = Path(path)
    config_dir = Path(config_dir) if config_dir else path.parent
    # group swaps must influence composition (like hydra)
    group_swaps = {}
    for ov in overrides:
        key, _, value = ov.lstrip("+").partition("=")
        if "." not in key and config_dir and \
                (config_dir / key.strip()).is_dir():
            group_swaps[key.strip()] = _parse_value(value.strip())
    composed = _compose(path, config_dir, None, group_swaps)
    apply_overrides(composed, overrides, config_dir)
    return Config.wrap(resolve(composed))
