"""Debug and logging helpers (counterpart of ``quiver_tpu/debug.py``).

``show_tensor_info`` prints a tensor's shape, dtype, placement and size
(the reference's ``qv.show_tensor_info``); ``log`` is the package's
logger.

The handler is attached once, marked, and only when the logger has none,
so a re-import cannot double-log and an application's own handler keeps
the output. The level comes from ``QT_LOG_LEVEL`` (a name such as
``INFO`` or a number); without it the logger stays at ``NOTSET`` and
defers to the application's logging configuration.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

logger = logging.getLogger("quiver_tpu_torch")

_HANDLER_MARK = "_quiver_tpu_torch_handler"


def _configure(force: bool = False) -> None:
    """Attach the marked handler (once) and apply ``QT_LOG_LEVEL``;
    ``force`` re-reads the variable."""
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[quiver_tpu_torch] %(message)s"))
        setattr(h, _HANDLER_MARK, True)
        logger.addHandler(h)
    level = os.environ.get("QT_LOG_LEVEL", "")
    if not level:
        if force:
            logger.setLevel(logging.NOTSET)
        return
    try:
        logger.setLevel(int(level) if level.isdigit() else level.upper())
    except ValueError:
        # a bad value must not stop the import
        logger.warning("ignoring invalid QT_LOG_LEVEL=%r", level)


_configure()


def log(msg: str, *args):
    logger.info(msg, *args)


def show_tensor_info(x) -> str:
    """Shape, dtype, placement and bytes of a tensor (its device; a
    DTensor's mesh and placements too) or, as in the JAX package, of a
    numpy array; printed and returned."""
    if torch.is_tensor(x):
        placement = f"device={x.device}"
        if hasattr(x, "placements") and hasattr(x, "device_mesh"):
            placement += (f" mesh={tuple(x.device_mesh.mesh.shape)} "
                          f"placements={tuple(x.placements)}")
        nbytes = x.numel() * x.element_size()
        info = (f"torch.Tensor shape={tuple(x.shape)} dtype={x.dtype} "
                f"{placement} nbytes={nbytes}")
    else:
        arr = np.asarray(x)
        info = (f"numpy shape={arr.shape} dtype={arr.dtype} "
                f"nbytes={arr.nbytes}")
    print(info)
    return info
