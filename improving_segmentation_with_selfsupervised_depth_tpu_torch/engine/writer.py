"""The run's metrics sink: the port's copy of the JAX package's
`engine/writer.py`. Every scalar goes to `<logdir>/metrics.jsonl`; scalars
and images also go to tensorboard where the `tensorboard` package is
installed. The tags are the reference's (train.py:952-953): training/*,
validation/*, val_metrics/*."""

from __future__ import annotations

import importlib.util
import json
import os
import time

import numpy as np


class MetricsWriter:
    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if importlib.util.find_spec("tensorboard") is not None:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(logdir)

    def add_scalar(self, tag: str, value, step: int):
        value = float(value)
        self._jsonl.write(json.dumps({"t": time.time(), "tag": tag,
                                      "value": value, "step": int(step)}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_image(self, tag: str, img: np.ndarray, step: int, dataformats: str = "HWC"):
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats=dataformats)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """The metrics sink of a rank other than the first: writes nothing."""

    def add_scalar(self, tag: str, value, step: int):
        pass

    def add_image(self, tag: str, img: np.ndarray, step: int, dataformats: str = "HWC"):
        pass

    def close(self):
        pass
