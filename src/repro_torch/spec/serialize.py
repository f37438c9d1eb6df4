"""TOML/JSON (de)serialization for experiment specs.

A copy of ``repro.spec.serialize`` (JSON, TOML and numpy only), so that the port
imports nothing of the JAX package.

One spec file == one :class:`~repro_torch.spec.types.ExperimentSpec` in its
``to_dict`` shape: top-level ``name``/``seed`` scalars plus one table per
section (``[task]``, ``[algorithm]``, ``[fleet]``, ``[policy]``,
``[codec]``, ``[engine]``)::

    name = "fig6-deadline-cell"
    seed = 0

    [task]
    kind = "logreg"
    d = 4000
    ...

The format is chosen by file extension: ``.toml`` or ``.json``. TOML
reading uses the stdlib ``tomllib`` (Python >= 3.11) or the ``tomli``
backport; TOML writing is a small emitter here (neither library writes),
restricted to the value shapes a spec can contain -- strings, bools, ints,
floats, and flat lists. The emitter is exact: ``loads(dumps(d)) == d``,
which is what makes ``ExperimentSpec.dump``/``load`` idempotent
(tests/test_spec.py pins this).
"""
from __future__ import annotations

import json
import pathlib

from repro_torch.spec.types import SpecError

try:
    import tomllib as _toml_reader          # Python >= 3.11
except ModuleNotFoundError:                 # pragma: no cover - version dep
    try:
        import tomli as _toml_reader        # the declared backport
    except ModuleNotFoundError:
        _toml_reader = None


# ---------------------------------------------------------------------------
# minimal exact TOML emitter (spec-shaped dicts only)
# ---------------------------------------------------------------------------

_BARE_KEY = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_-")


def _toml_key(key: str) -> str:
    if key and set(key) <= _BARE_KEY:
        return key
    return _toml_str(key)


def _toml_str(s: str) -> str:
    out = s.replace("\\", "\\\\").replace('"', '\\"')
    out = out.replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")
    return f'"{out}"'


def _toml_value(where: str, v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v or v in (float("inf"), float("-inf")):
            raise SpecError(f"{where}: non-finite float {v!r} is not "
                            f"serializable; omit the field instead "
                            f"(None means 'no cutoff')")
        r = repr(v)
        return r if ("." in r or "e" in r or "E" in r) else r + ".0"
    if isinstance(v, str):
        return _toml_str(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(where, x) for x in v) + "]"
    raise SpecError(f"{where}: {type(v).__name__} is not TOML-serializable")


def toml_dumps(d: dict) -> str:
    """Emit a spec-shaped dict (scalars at top level, one flat table per
    section) as TOML text."""
    lines = []
    sections = []
    for key, val in d.items():
        if isinstance(val, dict):
            sections.append((key, val))
        else:
            lines.append(f"{_toml_key(key)} = {_toml_value(key, val)}")
    for sec, body in sections:
        lines.append("")
        lines.append(f"[{_toml_key(sec)}]")
        for key, val in body.items():
            if isinstance(val, dict):
                raise SpecError(f"[{sec}] {key}: nested tables are not "
                                f"part of the spec schema")
            lines.append(f"{_toml_key(key)} = "
                         f"{_toml_value(f'[{sec}] {key}', val)}")
    return "\n".join(lines) + "\n"


def toml_loads(text: str) -> dict:
    if _toml_reader is None:                # pragma: no cover - env dep
        raise SpecError(
            "no TOML reader available: install 'tomli' (Python < 3.11) or "
            "use a .json spec file")
    return _toml_reader.loads(text)


# ---------------------------------------------------------------------------
# file IO
# ---------------------------------------------------------------------------


def read_spec_file(path) -> dict:
    """Read a .toml/.json spec file into its plain-dict form."""
    p = pathlib.Path(path)
    if not p.exists():
        raise SpecError(f"spec file not found: {p}")
    text = p.read_text()
    if p.suffix == ".toml":
        try:
            return toml_loads(text)
        except SpecError:
            raise
        except Exception as e:
            raise SpecError(f"{p}: invalid TOML: {e}") from e
    if p.suffix == ".json":
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"{p}: invalid JSON: {e}") from e
    raise SpecError(f"{p}: unknown spec extension {p.suffix!r} "
                    f"(expected .toml or .json)")


def write_spec_file(path, d: dict) -> None:
    """Write the plain-dict form as .toml or .json (by extension)."""
    p = pathlib.Path(path)
    if p.suffix == ".toml":
        p.write_text(toml_dumps(d))
    elif p.suffix == ".json":
        p.write_text(json.dumps(d, indent=1) + "\n")
    else:
        raise SpecError(f"{p}: unknown spec extension {p.suffix!r} "
                        f"(expected .toml or .json)")
