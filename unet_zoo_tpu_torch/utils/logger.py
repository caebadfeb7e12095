"""Console + file logger. Counterpart of ``unet_zoo_tpu/utils/logger.py``
(pure Python, copied so that the port imports nothing of the JAX package)."""

from __future__ import annotations

import datetime
import os
from typing import Optional


class Logger:
    def __init__(self, log_file_path: Optional[str] = None):
        self.log_file_path = log_file_path
        self._fh = None
        if log_file_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_file_path)), exist_ok=True)
            self._fh = open(log_file_path, "a")
            self._fh.write(
                f"\n{'=' * 70}\nLog started at "
                f"{datetime.datetime.now().isoformat(timespec='seconds')}\n{'=' * 70}\n"
            )
            self._fh.flush()

    def log_both(self, message: str) -> None:
        print(message)
        self.log_file_only(message)

    def log_file_only(self, message: str) -> None:
        if self._fh:
            self._fh.write(message + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.write(
                f"Log closed at "
                f"{datetime.datetime.now().isoformat(timespec='seconds')}\n"
            )
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
