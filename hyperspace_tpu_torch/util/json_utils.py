"""JSON helpers: the log's pretty-printed, insertion-ordered layout (the same
`json.dumps` arguments as `hyperspace_tpu/util/json_utils.py`, so both packages
write byte-identical log text for equal entries)."""

from __future__ import annotations

import json
from typing import Any


def to_json(obj: Any) -> str:
    return json.dumps(obj, indent=2, ensure_ascii=False)


def from_json(text: str) -> Any:
    return json.loads(text)
