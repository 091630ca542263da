"""Logger setup (reference log.py:5-44): stderr at INFO + logfile at DEBUG."""

from __future__ import annotations

import logging
import logging.config
from pathlib import Path


def setup_logger(logdir: str = "logs", name: str = "run") -> logging.Logger:
    Path(logdir).mkdir(parents=True, exist_ok=True)
    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "plain": {"format": "%(asctime)s %(levelname)s %(name)s: %(message)s"},
        },
        "handlers": {
            "stderr": {"class": "logging.StreamHandler", "level": "INFO",
                       "formatter": "plain"},
            "file": {"class": "logging.FileHandler", "level": "DEBUG",
                     "formatter": "plain",
                     "filename": str(Path(logdir) / f"{name}.log")},
        },
        "root": {"level": "DEBUG", "handlers": ["stderr", "file"]},
    })
    logger = logging.getLogger(name)
    logger.flush = lambda: [h.flush() for h in logging.getLogger().handlers]  # type: ignore
    return logger
