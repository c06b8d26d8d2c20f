"""Structured metrics logging [SURVEY §5.5] — JSONL stream + console.

The reference prints loss/accuracy to stdout; here every metric row is an
append-only JSONL record (machine-readable for benches/dashboards) mirrored
to the console.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Optional, TextIO


class MetricLogger:
    def __init__(
        self,
        path: Optional[str | Path] = None,
        echo: bool = True,
        tensorboard: bool = False,
    ):
        self.path = Path(path) if path else None
        self.echo = echo
        self._fh: Optional[TextIO] = None
        self._tb = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
            if tensorboard:
                try:  # TF is heavyweight and optional [SURVEY §5.5]
                    import tensorflow as tf

                    self._tb = tf.summary.create_file_writer(
                        str(self.path.parent / "tb")
                    )
                except Exception:
                    self._tb = None

    def log(self, **metrics) -> None:
        row = {"ts": time.time(), **metrics}
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if self._tb is not None and "step" in metrics:
            import tensorflow as tf

            with self._tb.as_default(step=int(metrics["step"])):
                for k, v in metrics.items():
                    if isinstance(v, (int, float)) and k != "step":
                        tf.summary.scalar(k, float(v))
        if self.echo:
            compact = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in metrics.items()
            )
            print(compact, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
        if self._tb is not None:
            self._tb.close()
