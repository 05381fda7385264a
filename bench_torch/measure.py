"""Arithmetic of the end-to-end metrics."""

from __future__ import annotations


def rate(amount: float, seconds: float) -> float:
    """Work over the time it took."""
    if seconds <= 0:
        raise ValueError("a rate needs a positive time")
    return amount / seconds

