"""Basic geometry types used across the codestream layer."""
from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class Point:
    x: int = 0
    y: int = 0


@dataclass(frozen=True, slots=True)
class Size:
    w: int = 0
    h: int = 0

    @property
    def area(self) -> int:
        return self.w * self.h


@dataclass(frozen=True, slots=True)
class Rect:
    """Half-open rectangle [x0, x1) x [y0, y1) on the canvas."""
    x0: int = 0
    y0: int = 0
    x1: int = 0
    y1: int = 0

    @property
    def w(self) -> int:
        return self.x1 - self.x0

    @property
    def h(self) -> int:
        return self.y1 - self.y0

    @property
    def empty(self) -> bool:
        return self.x1 <= self.x0 or self.y1 <= self.y0


def ceil_div(a: int, b: int) -> int:
    return (a + b - 1) // b
