"""Logging for the port (the part of ``quiver_tpu/debug.py`` that
``datasets.py`` needs, as the port's own copy).

The handler is attached once, marked, and only when the logger has none,
so a re-import cannot double-log and an application's own handler keeps
the output. The level comes from ``QT_LOG_LEVEL`` (a name such as
``INFO`` or a number); without it the logger stays at ``NOTSET`` and
defers to the application's logging configuration.
"""

from __future__ import annotations

import logging
import os

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
