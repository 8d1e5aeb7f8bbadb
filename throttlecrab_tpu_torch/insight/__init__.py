"""Bounded heavy-hitter counting for the metrics leaderboard
(`sketch.py`).  The device-side insight tier is not ported yet."""

from .sketch import SpaceSavingSketch

__all__ = ["SpaceSavingSketch"]
