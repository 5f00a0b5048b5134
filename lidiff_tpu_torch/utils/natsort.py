"""Natural sorting (replacement for the `natsort` dependency used by the
reference, e.g. diff_completion_pipeline.py:196)."""

from __future__ import annotations

import re

_NUM = re.compile(r"(\d+)")


def natural_key(s: str):
    return [int(p) if p.isdigit() else p for p in _NUM.split(str(s))]


def natsorted(items):
    return sorted(items, key=natural_key)
