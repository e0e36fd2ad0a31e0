"""Circle-intersection geometry for range-measurement visualization.

Computes the exact boundary of the intersection of N disks (the region where
range measurements localize a landmark/pose). A copy of
:mod:`score_tpu.utils.circles` (numpy only; matplotlib is imported inside
the drawing helpers): the of an N-disk intersection is, for each circle, the angular set of
its perimeter lying inside every other disk — computed here by exact
interval intersection on S^1 instead of incremental pairwise arc updates.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Point",
    "Arc",
    "Circle",
    "CircleIntersection",
    "circles_have_no_overlap",
    "disk_interval_on_circle",
    "intersect_angular_intervals",
]

_TWO_PI = 2.0 * math.pi


@dataclasses.dataclass(frozen=True)
class Point:
    """A 2D point."""

    x: float
    y: float

    @property
    def bearing(self) -> float:
        return math.atan2(self.y, self.x) % _TWO_PI

    # alias kept for parity with the reference naming (circle_utils.py:15-23)
    theta = bearing

    @property
    def distance(self) -> float:
        return math.hypot(self.x, self.y)

    def is_close(self, other: "Point", tol: float = 0.01) -> bool:
        return abs(self.x - other.x) < tol and abs(self.y - other.y) < tol

    def angle_to_point(self, other: "Point") -> float:
        return math.atan2(other.y - self.y, other.x - self.x) % _TWO_PI

    def __add__(self, other: "Point") -> "Point":
        return Point(self.x + other.x, self.y + other.y)

    def __sub__(self, other: "Point") -> "Point":
        return Point(self.x - other.x, self.y - other.y)

    def __neg__(self) -> "Point":
        return Point(-self.x, -self.y)

    def as_array(self) -> np.ndarray:
        return np.array([self.x, self.y])


@dataclasses.dataclass
class Arc:
    """A section of a circle's perimeter: angles [thetas[0], thetas[1]]
    (radians, increasing; may exceed 2*pi to express wraparound).
    ``thetas=None`` denotes the empty arc."""

    center: Point
    radius: float
    thetas: Optional[Tuple[float, float]]

    def __post_init__(self):
        assert self.radius > 0, "Radius must be greater than 0"
        if self.thetas is not None:
            assert self.thetas[0] <= self.thetas[1], "Thetas must be increasing"

    @property
    def is_empty(self) -> bool:
        return self.thetas is None

    @property
    def arc_length_radians(self) -> float:
        if self.is_empty:
            return 0.0
        return self.thetas[1] - self.thetas[0]

    @property
    def end_points(self) -> List[Point]:
        if self.is_empty:
            return []
        return [
            Point(
                self.radius * math.cos(t) + self.center.x,
                self.radius * math.sin(t) + self.center.y,
            )
            for t in self.thetas
        ]

    def sample(self, resolution: int = 50) -> np.ndarray:
        """(resolution, 2) points along the arc."""
        if self.is_empty:
            return np.zeros((0, 2))
        th = np.linspace(self.thetas[0], self.thetas[1], resolution)
        return np.stack(
            [
                self.radius * np.cos(th) + self.center.x,
                self.radius * np.sin(th) + self.center.y,
            ],
            axis=1,
        )

    def contains_angle(self, angle: float, tol: float = 1e-9) -> bool:
        if self.is_empty:
            return False
        lo, hi = self.thetas
        a = (angle - lo) % _TWO_PI
        return a <= (hi - lo) + tol


def _normalize_interval(lo: float, hi: float) -> Tuple[float, float]:
    """Map to lo in [0, 2pi), keep hi - lo (assumed in [0, 2pi])."""
    width = hi - lo
    lo = lo % _TWO_PI
    return lo, lo + width


def intersect_angular_intervals(
    intervals: Sequence[Tuple[float, float]],
) -> List[Tuple[float, float]]:
    """Exact intersection of angular intervals on S^1.

    Each interval is (lo, hi) with hi - lo in [0, 2*pi] (hi may exceed 2*pi
    to express wraparound). A width-2*pi interval is the full circle.
    Returns a list of disjoint (lo, hi) intervals (possibly empty).
    """
    full = [iv for iv in intervals if iv[1] - iv[0] >= _TWO_PI - 1e-12]
    parts = [
        _normalize_interval(*iv)
        for iv in intervals
        if iv[1] - iv[0] < _TWO_PI - 1e-12
    ]
    if not parts:
        return [(0.0, _TWO_PI)] if full or intervals else []

    # Split wraparound intervals at 2*pi so all pieces live in [0, 2*pi].
    def pieces(iv):
        lo, hi = iv
        if hi <= _TWO_PI:
            return [(lo, hi)]
        return [(lo, _TWO_PI), (0.0, hi - _TWO_PI)]

    current = pieces(parts[0])
    for iv in parts[1:]:
        nxt = []
        for a_lo, a_hi in current:
            for b_lo, b_hi in pieces(iv):
                lo, hi = max(a_lo, b_lo), min(a_hi, b_hi)
                if hi > lo + 1e-12:
                    nxt.append((lo, hi))
        current = nxt
        if not current:
            return []
    # merge pieces that were split at the 0/2*pi seam
    current.sort()
    merged: List[Tuple[float, float]] = []
    for lo, hi in current:
        if merged and abs(merged[-1][1] - lo) < 1e-9:
            merged[-1] = (merged[-1][0], hi)
        else:
            merged.append((lo, hi))
    if (
        len(merged) > 1
        and abs(merged[0][0]) < 1e-9
        and abs(merged[-1][1] - _TWO_PI) < 1e-9
    ):
        first = merged.pop(0)
        lo, _ = merged[-1]
        merged[-1] = (lo, _TWO_PI + first[1])
    return merged


def disk_interval_on_circle(
    circle: "Circle", disk: "Circle"
) -> Optional[Tuple[float, float]]:
    """The angular interval of ``circle``'s perimeter lying inside ``disk``.

    Returns None when the perimeter is entirely outside the disk, the full
    circle (0, 2*pi) when entirely inside, otherwise the interval centered
    at the bearing from circle.center to disk.center with half-width
    acos((d^2 + r^2 - R^2) / (2 d r)).
    """
    d = math.hypot(
        disk.center.x - circle.center.x, disk.center.y - circle.center.y
    )
    r, R = circle.radius, disk.radius
    if d >= r + R:
        return None  # separated (or tangent): no perimeter inside
    if d + r <= R:
        return (0.0, _TWO_PI)  # circle entirely inside disk
    if d + R <= r:
        return None  # disk strictly inside circle: perimeter outside disk
    cos_half = (d * d + r * r - R * R) / (2.0 * d * r)
    half = math.acos(min(1.0, max(-1.0, cos_half)))
    center_angle = math.atan2(
        disk.center.y - circle.center.y, disk.center.x - circle.center.x
    )
    return (center_angle - half, center_angle + half)


@dataclasses.dataclass(frozen=True)
class Circle:
    """A circle (and, as a region, the closed disk it bounds)."""

    center: Point
    radius: float

    def point_is_inside(self, pt: Point, tol: float = 1e-12) -> bool:
        return (
            math.hypot(pt.x - self.center.x, pt.y - self.center.y)
            <= self.radius + tol
        )

    def intersection_arcs_inside(self, others: Sequence["Circle"]) -> List[Arc]:
        """Arcs of this circle's perimeter inside every other disk."""
        intervals: List[Tuple[float, float]] = []
        for other in others:
            iv = disk_interval_on_circle(self, other)
            if iv is None:
                return []
            intervals.append(iv)
        if not intervals:
            return [Arc(self.center, self.radius, (0.0, _TWO_PI))]
        return [
            Arc(self.center, self.radius, iv)
            for iv in intersect_angular_intervals(intervals)
        ]

    def get_circle_intersection_points(
        self, other: "Circle"
    ) -> Optional[Tuple[Point, Point]]:
        """The two perimeter intersection points with another circle (None
        when the circles do not cross)."""
        iv = disk_interval_on_circle(self, other)
        if iv is None or iv[1] - iv[0] >= _TWO_PI - 1e-12:
            return None
        lo, hi = iv
        return (
            Point(
                self.center.x + self.radius * math.cos(lo),
                self.center.y + self.radius * math.sin(lo),
            ),
            Point(
                self.center.x + self.radius * math.cos(hi),
                self.center.y + self.radius * math.sin(hi),
            ),
        )


def circles_have_no_overlap(circles: Sequence[Circle]) -> bool:
    """True when the common intersection of the disks is empty (parity with
    circle_utils.py:676-690's emptiness check, generalized to N disks)."""
    return CircleIntersection(list(circles)).is_empty


class CircleIntersection:
    """Incrementally maintained intersection region of N disks.

    API parity with the reference's CircleIntersection
    (circle_utils.py:526-673): ``add_circle``, ``draw_intersection``,
    ``draw_circles``; the region boundary is recomputed exactly from the
    stored disks on each query.
    """

    def __init__(self, circles: Optional[List[Circle]] = None):
        self._circles: List[Circle] = list(circles) if circles else []

    @property
    def circles(self) -> List[Circle]:
        return list(self._circles)

    @property
    def num_circles(self) -> int:
        return len(self._circles)

    def add_circle(self, circle: Circle) -> None:
        self._circles.append(circle)

    def boundary_arcs(self) -> List[Arc]:
        """All arcs forming the boundary of the intersection region."""
        arcs: List[Arc] = []
        for i, c in enumerate(self._circles):
            others = self._circles[:i] + self._circles[i + 1 :]
            arcs.extend(c.intersection_arcs_inside(others))
        return arcs

    @property
    def is_empty(self) -> bool:
        if not self._circles:
            return True
        if len(self._circles) == 1:
            return False
        if self.boundary_arcs():
            return False
        # No boundary arcs: either empty, or one disk contains the rest's
        # intersection without its perimeter touching it. The smallest disk's
        # center is in the region in the containment case.
        smallest = min(self._circles, key=lambda c: c.radius)
        return not all(
            c.point_is_inside(smallest.center) for c in self._circles
        )

    def boundary_polygon(self, resolution: int = 30) -> np.ndarray:
        """(M, 2) polygon vertices tracing the region boundary (ordered by
        angle around the region centroid)."""
        arcs = self.boundary_arcs()
        if not arcs:
            return np.zeros((0, 2))
        pts = np.concatenate([a.sample(resolution) for a in arcs], axis=0)
        centroid = pts.mean(axis=0)
        order = np.argsort(
            np.arctan2(pts[:, 1] - centroid[1], pts[:, 0] - centroid[0])
        )
        return pts[order]

    def draw_intersection(self, ax, color: str = "blue", alpha: float = 0.3):
        """Fill the intersection region on a matplotlib axes."""
        poly = self.boundary_polygon()
        if poly.shape[0] == 0:
            return None
        import matplotlib.patches as mpatches

        patch = mpatches.Polygon(poly, closed=True, color=color, alpha=alpha)
        ax.add_patch(patch)
        return patch

    def draw_circles(self, ax, color: str = "black", alpha: float = 0.6):
        import matplotlib.patches as mpatches

        out = []
        for c in self._circles:
            patch = mpatches.Circle(
                (c.center.x, c.center.y),
                c.radius,
                fill=False,
                color=color,
                alpha=alpha,
            )
            ax.add_patch(patch)
            out.append(patch)
        return out
