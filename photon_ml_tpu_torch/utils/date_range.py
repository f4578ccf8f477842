"""Date ranges and dated input-path resolution.

Port of ``photon_ml_tpu/utils/date_range.py`` (a copy: the port imports
nothing of the JAX package).

Re-design of the reference's dated-ingestion utilities (reference:
photon-ml/src/main/scala/com/linkedin/photon/ml/util/DateRange.scala:27-100
and util/IOUtils.scala:85-126 getInputPathsWithinDateRange): training/
validation directories laid out as ``<base>/daily/yyyy/MM/dd`` are selected
by a ``yyyyMMdd-yyyyMMdd`` range string or a ``start-end`` days-ago pair
(the GAME driver's --train-date-range / --train-date-range-days-ago flags,
cli/game/training/Params.scala).
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import os
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class DateRange:
    """Inclusive [start, end] day range (util/DateRange.scala:27)."""

    start: _dt.date
    end: _dt.date

    def __post_init__(self):
        if self.start > self.end:
            raise ValueError(
                f"Invalid range: start date {self.start} comes after end "
                f"date {self.end}.")

    def __str__(self) -> str:
        return f"{self.start}-{self.end}"

    def days(self) -> list[_dt.date]:
        n = (self.end - self.start).days
        return [self.start + _dt.timedelta(days=i) for i in range(n + 1)]

    @staticmethod
    def from_dates(start: str, end: str,
                   pattern: str = "%Y%m%d") -> "DateRange":
        try:
            s = _dt.datetime.strptime(start, pattern).date()
            e = _dt.datetime.strptime(end, pattern).date()
        except ValueError as exc:
            raise ValueError(
                f"Couldn't parse the date range: {start}-{end}") from exc
        return DateRange(s, e)  # range-order errors propagate as-is

    @staticmethod
    def from_range(range_str: str,
                   pattern: str = "%Y%m%d") -> "DateRange":
        """``yyyyMMdd-yyyyMMdd`` (DateRange.fromDateString analog)."""
        parts = range_str.split("-")
        if len(parts) != 2:
            raise ValueError(
                f"Couldn't parse the date range: {range_str!r} (expected "
                f"'yyyyMMdd-yyyyMMdd')")
        return DateRange.from_dates(parts[0], parts[1], pattern)

    @staticmethod
    def from_days_ago(start_days_ago: int, end_days_ago: int,
                      today: Optional[_dt.date] = None) -> "DateRange":
        """``start-end`` days-ago pair → concrete range
        (util/DateRange.fromDaysAgo analog; start is further back)."""
        today = today or _dt.date.today()
        return DateRange(today - _dt.timedelta(days=start_days_ago),
                         today - _dt.timedelta(days=end_days_ago))

    @staticmethod
    def from_days_ago_range(range_str: str,
                            today: Optional[_dt.date] = None) -> "DateRange":
        parts = range_str.split("-")
        if len(parts) != 2:
            raise ValueError(
                f"Couldn't parse the days-ago range: {range_str!r} "
                f"(expected 'start-end')")
        return DateRange.from_days_ago(int(parts[0]), int(parts[1]), today)


def input_paths_within_date_range(
        input_dirs: Sequence[str] | str,
        date_range: DateRange,
        error_on_missing: bool = False) -> list[str]:
    """``<base>/daily/yyyy/MM/dd`` paths within the range
    (util/IOUtils.scala:85-126). Missing days are skipped unless
    ``error_on_missing``; an entirely empty result raises."""
    if isinstance(input_dirs, str):
        input_dirs = [input_dirs]
    out: list[str] = []
    for base in input_dirs:
        daily = os.path.join(base, "daily")
        candidates = [
            os.path.join(daily, f"{d.year:04d}", f"{d.month:02d}",
                         f"{d.day:02d}")
            for d in date_range.days()]
        if error_on_missing:
            for p in candidates:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Path {p} does not exist!")
        existing = [p for p in candidates if os.path.exists(p)]
        if not existing:
            raise FileNotFoundError(
                f"No data folder found between {date_range.start} and "
                f"{date_range.end} in {daily}")
        out.extend(existing)
    return out


def resolve_input_paths(
        input_dirs: str,
        date_range: Optional[str] = None,
        date_range_days_ago: Optional[str] = None,
        today: Optional[_dt.date] = None) -> list[str]:
    """GAME driver flag resolution: comma-separated input dirs, optionally
    narrowed by --*-date-range / --*-date-range-days-ago (the two flags are
    mutually exclusive, cli/game/training/Params.scala)."""
    dirs = [d for d in input_dirs.split(",") if d.strip()]
    if date_range and date_range_days_ago:
        raise ValueError(
            "date-range and date-range-days-ago are mutually exclusive")
    if date_range:
        return input_paths_within_date_range(
            dirs, DateRange.from_range(date_range))
    if date_range_days_ago:
        return input_paths_within_date_range(
            dirs, DateRange.from_days_ago_range(date_range_days_ago,
                                                today))
    return dirs
