"""Structured benchmark results writer: one JSON line per run (matrix,
method, dtype, device, times, GFlops, nnz/s), appended to a file."""
from __future__ import annotations

import json
import os
import time
from typing import Any


def write_result(path: str, record: dict[str, Any]) -> None:
    record = dict(record)
    record.setdefault("ts", time.time())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def read_results(path: str) -> list[dict[str, Any]]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
