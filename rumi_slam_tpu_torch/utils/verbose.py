"""Leveled logging (copy of ``rumi_slam_tpu/utils/verbose.py``): levels
QUIET < NORMAL < VERBOSE < VERY_VERBOSE < DEBUG and one process-wide
threshold that ``SlamSystem`` sets from ``Config.verbosity``."""

from __future__ import annotations

import enum
import sys


class Level(enum.IntEnum):
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4


_threshold = Level.QUIET


def set_level(level: Level | int | str) -> None:
    global _threshold
    if isinstance(level, str):
        level = Level[level.upper()]
    _threshold = Level(level)


def get_level() -> Level:
    return _threshold


def print_mess(msg: str, level: Level | int = Level.NORMAL, *, file=None) -> None:
    if Level(level) <= _threshold:
        print(msg, file=file or sys.stderr)
