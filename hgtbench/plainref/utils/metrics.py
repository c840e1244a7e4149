"""The reference's stand-in for the port's run metrics: the frozen
pipeline code records stage walls and counters through these names, and
the reference keeps none of them."""

from __future__ import annotations

import contextlib


def add(counter: str, value: float) -> None:
    pass


def record(series: str, value: float) -> None:
    pass


@contextlib.contextmanager
def stage(name: str):
    yield
