"""Metric logging: a plain JSONL mirror (``metrics.jsonl``, one
``{"t", "tag", "value", "step"}`` object per line, the tags the reference's
SummaryWriter uses) that tests and headless runs read back, plus
TensorBoard events when ``torch.utils.tensorboard`` imports."""

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir, use_tensorboard=True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        # line-buffered: the file doubles as a liveness signal
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=log_dir)
            except Exception:
                self._tb = None

    def scalar(self, tag, value, step):
        v = float(value)
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag, "value": v,
                                     "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, v, int(step))

    def scalars(self, d, step, prefix=""):
        for k, v in d.items():
            self.scalar(prefix + k, v, step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
