"""Structured training logs: jsonl file + stderr (copy of
carel_tpu/train/logging.py)."""

from __future__ import annotations

import json
import os
import sys
import time


class JsonlLogger:
    def __init__(self, log_dir: str = "", name: str = "train",
                 echo: bool = True):
        self.echo = echo
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            ts = time.strftime("%Y%m%d-%H%M%S")
            self.path = os.path.join(log_dir, f"{name}_{ts}.jsonl")
            self._fh = open(self.path, "a", buffering=1)
        else:
            self.path = ""

    def log(self, record: dict) -> None:
        record = {"time": round(time.time(), 3), **record}
        line = json.dumps(record, default=float)
        if self._fh:
            self._fh.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
