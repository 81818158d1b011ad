"""Metric logging: a plain JSONL mirror (``metrics.jsonl``, one
``{"t", "tag", "value", "step"}`` object per line, the tags the reference's
SummaryWriter uses) that tests and headless runs read back, plus
TensorBoard events (scalars and image panels) when
``torch.utils.tensorboard`` imports."""

import json
import os
import time

import numpy as np


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

    def image(self, tag, img_hwc, step):
        if self._tb is not None:
            img = np.asarray(img_hwc)
            if img.ndim == 2:
                img = img[:, :, None]
            self._tb.add_image(tag, img.transpose(2, 0, 1), int(step))

    def image_panel(self, tag, images, step):
        """Log a horizontal panel of images cut to the lowest one's height
        (the reference's gt/pred/albedo/shadows/depth strips,
        utils.py:128-144)."""
        imgs = []
        for im in images:
            a = np.asarray(im, np.float32)
            if a.ndim == 2:
                a = a[:, :, None]
            if a.shape[2] == 1:
                a = np.repeat(a, 3, axis=2)
            imgs.append(np.clip(a, 0, 1))
        h = min(a.shape[0] for a in imgs)
        self.image(tag, np.concatenate([a[:h] for a in imgs], axis=1), step)

    def flush(self):
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """A logger that writes nothing: a data-parallel trainer's ranks other
    than 0 (rank 0 logs the global values)."""

    def scalar(self, tag, value, step):
        pass

    def scalars(self, d, step, prefix=""):
        pass

    def image_panel(self, tag, images, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass
