"""INI parser/writer for view metadata (reference: libs/util/ini_parser.h).

The reference stores view metadata as flat ``section.key -> value`` maps
(ini_parser.h:22-29). Keys are case-sensitive, values are arbitrary
strings; sections are ``[name]`` headers; comments start with ``#`` or
``;``. We keep that exact data model (a flat dict with dotted keys) so
``meta.ini`` files round-trip against the reference.
"""

from __future__ import annotations

from typing import Dict, TextIO


def parse_ini(stream: TextIO) -> Dict[str, str]:
    """Parse an INI stream into a flat {"section.key": value} dict."""
    result: Dict[str, str] = {}
    section = ""
    for lineno, raw in enumerate(stream, 1):
        line = raw.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("[") and line.endswith("]"):
            section = line[1:-1].strip()
            continue
        if "=" not in line:
            raise ValueError(f"line {lineno}: invalid INI line: {line!r}")
        key, _, value = line.partition("=")
        key = key.strip()
        prefix = section + "." if section else ""
        result[prefix + key] = value.strip()
    return result


def save_ini(data: Dict[str, str], stream: TextIO) -> None:
    """Write a flat dotted-key dict as INI, grouped by section."""
    sections: Dict[str, Dict[str, str]] = {}
    for full_key, value in data.items():
        section, _, key = full_key.rpartition(".")
        sections.setdefault(section, {})[key] = value
    for i, section in enumerate(sorted(sections)):
        if i:
            stream.write("\n")
        if section:
            stream.write(f"[{section}]\n")
        for key in sorted(sections[section]):
            stream.write(f"{key} = {sections[section][key]}\n")


def parse_ini_file(path: str) -> Dict[str, str]:
    with open(path, "r") as f:
        return parse_ini(f)


def save_ini_file(data: Dict[str, str], path: str) -> None:
    with open(path, "w") as f:
        save_ini(data, f)
