"""Seeding, filesystem glob and the run's file logger: the port's copy of
the JAX package's `utils/misc.py` (reference utils/utils.py)."""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import random

import numpy as np


@contextlib.contextmanager
def np_local_seed(seed: int):
    """Temporarily seed numpy's global RNG (reference utils/utils.py:9-16),
    for the bit-identical subset selection of `data/utils.py`."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


def recursive_glob(rootdir: str = ".", suffix: str = ""):
    return [
        os.path.join(looproot, filename)
        for looproot, _, filenames in os.walk(rootdir)
        for filename in filenames
        if filename.endswith(suffix)
    ]


def get_logger(logdir: str, name: str = "segsde_torch") -> logging.Logger:
    """The logger `name` with a new `<logdir>/run_<timestamp>.log` handler."""
    logger = logging.getLogger(name)
    ts = str(datetime.datetime.now()).split(".")[0].replace(" ", "_")
    ts = ts.replace(":", "_").replace("-", "_")
    os.makedirs(logdir, exist_ok=True)
    hdlr = logging.FileHandler(os.path.join(logdir, f"run_{ts}.log"))
    hdlr.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(hdlr)
    logger.setLevel(logging.INFO)
    return logger


def set_seeds(seed: int):
    """Seed the host's numpy and python RNGs, which the data layer draws from
    (reference train.py:104-108)."""
    np.random.seed(seed)
    random.seed(seed)
