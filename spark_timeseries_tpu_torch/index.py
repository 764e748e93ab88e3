"""Date-time indexing (port of ``index.py``).

The shared ``DateTimeIndex`` that maps positions <-> timestamps for every
series in a panel, plus the calendar-aware ``Frequency`` hierarchy
(duration, calendar-period and business-day frequencies).  The index is
host metadata: this module is numpy only, with the reference's names,
semantics and string forms, so an index persisted by either package reads
back in the other.

Reference parity (upstream spark-ts):
  - ``com.cloudera.sparkts.DateTimeIndex`` — ``UniformDateTimeIndex``,
    ``IrregularDateTimeIndex``, ``HybridDateTimeIndex``; methods
    ``locAtDateTime``, ``dateTimeAtLoc``, ``slice``, ``islice``,
    ``insertionLoc``, ``size``, ``first``, ``last``; companion factories
    ``uniform``, ``irregular``, ``hybrid``, ``fromString``/``toString``.
  - ``com.cloudera.sparkts.Frequency`` — ``advance``/``difference``;
    ``DayFrequency``, ``BusinessDayFrequency``, ``HourFrequency``, etc.

All timestamps are int64 nanoseconds since the Unix epoch, UTC.  Lookups are
vectorized numpy on the host; ``instants()`` is the ``int64[size]`` array a
caller moves to the device when it needs timestamps there.  Business-day
arithmetic is closed-form vectorized day-of-week math, never a Python loop.
"""

from __future__ import annotations

import re
from abc import ABC, abstractmethod
from typing import Iterable, List, Sequence, Tuple, Union

import numpy as np

NANOS_PER_SECOND = 1_000_000_000
NANOS_PER_MINUTE = 60 * NANOS_PER_SECOND
NANOS_PER_HOUR = 60 * NANOS_PER_MINUTE
NANOS_PER_DAY = 24 * NANOS_PER_HOUR

DateTimeLike = Union[str, int, np.datetime64, "np.integer"]


def to_nanos(dt: DateTimeLike) -> int:
    """Convert a datetime-like value to int64 nanoseconds since epoch (UTC)."""
    if isinstance(dt, (int, np.integer)):
        return int(dt)
    if isinstance(dt, np.datetime64):
        return int(dt.astype("datetime64[ns]").astype(np.int64))
    if isinstance(dt, str):
        return int(np.datetime64(dt, "ns").astype(np.int64))
    # datetime.datetime and pandas.Timestamp both stringify cleanly
    return int(np.datetime64(dt, "ns").astype(np.int64))


def to_nanos_array(dts: Iterable[DateTimeLike]) -> np.ndarray:
    arr = np.asarray(dts)
    if arr.dtype.kind == "M":
        return arr.astype("datetime64[ns]").astype(np.int64)
    if arr.dtype.kind in "iu":
        return arr.astype(np.int64)
    return np.array([to_nanos(d) for d in arr.ravel()], dtype=np.int64).reshape(arr.shape)


def nanos_to_datetime64(nanos) -> np.ndarray:
    return np.asarray(nanos, dtype=np.int64).view("datetime64[ns]")


def _weekday(nanos) -> np.ndarray:
    """Day of week for nanos timestamps: 0 = Monday ... 6 = Sunday.

    The Unix epoch (1970-01-01) was a Thursday (weekday 3).
    """
    days = np.floor_divide(np.asarray(nanos, dtype=np.int64), NANOS_PER_DAY)
    return ((days + 3) % 7).astype(np.int64)


# ---------------------------------------------------------------------------
# Frequencies
# ---------------------------------------------------------------------------


class Frequency(ABC):
    """A calendar-aware step size between consecutive index positions."""

    @abstractmethod
    def advance(self, nanos, n):
        """Advance timestamp(s) by ``n`` periods (vectorized, n may be array)."""

    @abstractmethod
    def difference(self, nanos1, nanos2):
        """Number of complete periods from ``nanos1`` to ``nanos2`` (floor)."""

    @abstractmethod
    def to_string(self) -> str:
        ...

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.to_string()!r})"

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.to_string() == other.to_string()

    def __hash__(self) -> int:
        # lint: nondet(in-process dict identity only; never persisted)
        return hash((type(self).__name__, self.to_string()))


class DurationFrequency(Frequency):
    """A fixed-duration frequency expressed in nanoseconds."""

    def __init__(self, nanos: int, label: str | None = None):
        if nanos <= 0:
            raise ValueError(f"frequency duration must be positive, got {nanos}")
        self.nanos = int(nanos)
        self._label = label

    def advance(self, nanos, n):
        return np.asarray(nanos, dtype=np.int64) + np.asarray(n, dtype=np.int64) * self.nanos

    def difference(self, nanos1, nanos2):
        delta = np.asarray(nanos2, dtype=np.int64) - np.asarray(nanos1, dtype=np.int64)
        return np.floor_divide(delta, self.nanos)

    def to_string(self) -> str:
        return self._label if self._label else f"duration {self.nanos}"


class NanosecondFrequency(DurationFrequency):
    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods, f"nanoseconds {periods}")


class MillisecondFrequency(DurationFrequency):
    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods * 1_000_000, f"milliseconds {periods}")


class SecondFrequency(DurationFrequency):
    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods * NANOS_PER_SECOND, f"seconds {periods}")


class MinuteFrequency(DurationFrequency):
    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods * NANOS_PER_MINUTE, f"minutes {periods}")


class HourFrequency(DurationFrequency):
    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods * NANOS_PER_HOUR, f"hours {periods}")


class DayFrequency(DurationFrequency):
    """Calendar days.  UTC-only framework => a day is exactly 24h."""

    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods * NANOS_PER_DAY, f"days {periods}")


class WeekFrequency(DurationFrequency):
    def __init__(self, periods: int = 1):
        self.periods = int(periods)
        super().__init__(periods * 7 * NANOS_PER_DAY, f"weeks {periods}")


class MonthFrequency(Frequency):
    """Calendar months: advance preserves day-of-month, clamped to month end."""

    def __init__(self, periods: int = 1):
        self.periods = int(periods)

    def advance(self, nanos, n):
        nanos = np.asarray(nanos, dtype=np.int64)
        n = np.asarray(n, dtype=np.int64) * self.periods
        dt = nanos_to_datetime64(nanos)
        month0 = dt.astype("datetime64[M]")
        intra = nanos - month0.astype("datetime64[ns]").astype(np.int64)
        newmonth = month0 + n.astype("timedelta64[M]")
        # clamp day-of-month to the target month's length, keep time-of-day
        day_off = np.floor_divide(intra, NANOS_PER_DAY)
        tod = intra - day_off * NANOS_PER_DAY
        month_days = np.floor_divide(
            (newmonth + np.timedelta64(1, "M")).astype("datetime64[ns]").astype(np.int64)
            - newmonth.astype("datetime64[ns]").astype(np.int64),
            NANOS_PER_DAY,
        )
        day_off = np.minimum(day_off, month_days - 1)
        return (
            newmonth.astype("datetime64[ns]").astype(np.int64)
            + day_off * NANOS_PER_DAY
            + tod
        )

    def difference(self, nanos1, nanos2):
        n1 = np.asarray(nanos1, dtype=np.int64)
        n2 = np.asarray(nanos2, dtype=np.int64)
        m1 = nanos_to_datetime64(n1).astype("datetime64[M]").astype(np.int64)
        m2 = nanos_to_datetime64(n2).astype("datetime64[M]").astype(np.int64)
        months = m2 - m1
        # floor: if the target hasn't reached the same intra-month point, back off
        reached = self.advance(n1, np.floor_divide(months, self.periods)) <= n2
        months = np.where(reached, months, months - self.periods)
        return np.floor_divide(months, self.periods)

    def to_string(self) -> str:
        return f"months {self.periods}"


class YearFrequency(MonthFrequency):
    def __init__(self, periods: int = 1):
        super().__init__(periods * 12)
        self.year_periods = int(periods)

    def to_string(self) -> str:
        return f"years {self.year_periods}"


class BusinessDayFrequency(Frequency):
    """Business days, vectorized closed-form day-of-week arithmetic.

    ``first_day_of_week`` follows the reference API (0 = Monday .. 6 =
    Sunday); the week's first five days are business days and its last two
    the weekend, so e.g. ``first_day_of_week=6`` gives a Sunday-Thursday
    business week with a Friday/Saturday weekend.
    """

    def __init__(self, days: int = 1, first_day_of_week: int = 0):
        if not 0 <= int(first_day_of_week) <= 6:
            raise ValueError("first_day_of_week must be in 0..6 (0 = Monday)")
        self.days = int(days)
        self.first_day_of_week = int(first_day_of_week)

    def _to_bday_ordinal(self, nanos) -> Tuple[np.ndarray, np.ndarray]:
        """Map timestamps to (business-day ordinal, intra-day nanos).

        Weekend timestamps map to the preceding last-business-day ordinal at
        end-of-day (intra = NANOS_PER_DAY), so the (ordinal, intra) pair —
        and hence ``difference``/``insertion_loc`` — stays monotone in time:
        a weekend instant sorts after any instant of the last business day
        and before any instant of the next one.
        """
        nanos = np.asarray(nanos, dtype=np.int64)
        days = np.floor_divide(nanos, NANOS_PER_DAY)
        intra = nanos - days * NANOS_PER_DAY
        # epoch day 0 (1970-01-01) is a Thursday (weekday 3, 0=Mon); align
        # week numbers so the first_day_of_week-th weekday starts a week
        shifted = days + 3 - self.first_day_of_week
        weeks = np.floor_divide(shifted, 7)
        wd = shifted - weeks * 7  # 0..6 relative to the week start
        is_weekend = wd > 4
        ordinal = weeks * 5 + np.minimum(wd, 4)
        intra = np.where(is_weekend, NANOS_PER_DAY, intra)
        return ordinal, intra

    def _from_bday_ordinal(self, ordinal, intra) -> np.ndarray:
        ordinal = np.asarray(ordinal, dtype=np.int64)
        weeks = np.floor_divide(ordinal, 5)
        wd = ordinal - weeks * 5
        days = weeks * 7 + wd - 3 + self.first_day_of_week
        return days * NANOS_PER_DAY + np.asarray(intra, dtype=np.int64)

    def advance(self, nanos, n):
        ordinal, intra = self._to_bday_ordinal(nanos)
        return self._from_bday_ordinal(ordinal + np.asarray(n, dtype=np.int64) * self.days, intra)

    def difference(self, nanos1, nanos2):
        o1, i1 = self._to_bday_ordinal(nanos1)
        o2, i2 = self._to_bday_ordinal(nanos2)
        whole = o2 - o1
        # true floor on the intra-day remainder (sign-independent, matching
        # DurationFrequency.difference's floor_divide semantics)
        whole = np.where(i2 < i1, whole - 1, whole)
        return np.floor_divide(whole, self.days)

    def to_string(self) -> str:
        return f"businessDays {self.days} {self.first_day_of_week}"


_FREQ_PARSERS = {
    "nanoseconds": lambda p: NanosecondFrequency(int(p[0])),
    "milliseconds": lambda p: MillisecondFrequency(int(p[0])),
    "seconds": lambda p: SecondFrequency(int(p[0])),
    "minutes": lambda p: MinuteFrequency(int(p[0])),
    "hours": lambda p: HourFrequency(int(p[0])),
    "days": lambda p: DayFrequency(int(p[0])),
    "weeks": lambda p: WeekFrequency(int(p[0])),
    "months": lambda p: MonthFrequency(int(p[0])),
    "years": lambda p: YearFrequency(int(p[0])),
    "businessDays": lambda p: BusinessDayFrequency(int(p[0]), int(p[1]) if len(p) > 1 else 0),
    "duration": lambda p: DurationFrequency(int(p[0])),
}


def frequency_from_string(s: str) -> Frequency:
    parts = s.strip().split(" ")
    name, args = parts[0], parts[1:]
    if name not in _FREQ_PARSERS:
        raise ValueError(f"unknown frequency string: {s!r}")
    return _FREQ_PARSERS[name](args)


# ---------------------------------------------------------------------------
# DateTimeIndex
# ---------------------------------------------------------------------------


class DateTimeIndex(ABC):
    """Maps positions <-> timestamps for every series sharing the index."""

    # -- core protocol ------------------------------------------------------

    @property
    @abstractmethod
    def size(self) -> int:
        ...

    @abstractmethod
    def date_time_at_loc(self, loc: int) -> np.datetime64:
        ...

    @abstractmethod
    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        """Exact location of ``dt``, or -1 if absent."""

    @abstractmethod
    def insertion_loc(self, dt: DateTimeLike) -> int:
        """Location where ``dt`` would be inserted to keep the index sorted
        (first position strictly after ``dt``)."""

    @abstractmethod
    def instants(self) -> np.ndarray:
        """``int64[size]`` nanosecond timestamps — the device-side form."""

    @abstractmethod
    def islice(self, start: int, end: int) -> "DateTimeIndex":
        """Sub-index for positions ``[start, end)``."""

    @abstractmethod
    def to_string(self) -> str:
        ...

    # -- derived ------------------------------------------------------------

    @property
    def first(self) -> np.datetime64:
        return self.date_time_at_loc(0)

    @property
    def last(self) -> np.datetime64:
        return self.date_time_at_loc(self.size - 1)

    def slice(self, start: DateTimeLike, end: DateTimeLike) -> "DateTimeIndex":
        """Sub-index covering ``[start, end]`` (inclusive, as upstream)."""
        lo = self.loc_at_or_after(start)
        hi = self.loc_at_or_before(end)
        return self.islice(lo, hi + 1)

    def loc_range(self, start: DateTimeLike, end: DateTimeLike) -> Tuple[int, int]:
        """Positions ``[lo, hi)`` covering timestamps in ``[start, end]``."""
        lo = self.loc_at_or_after(start)
        hi = self.loc_at_or_before(end)
        return lo, hi + 1

    def loc_at_or_before(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = int(np.searchsorted(self.instants(), nanos, side="right")) - 1
        if loc < 0:
            raise ValueError(f"{dt} precedes the index start {self.first}")
        return loc

    def loc_at_or_after(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = int(np.searchsorted(self.instants(), nanos, side="left"))
        if loc >= self.size:
            raise ValueError(f"{dt} follows the index end {self.last}")
        return loc

    def locs_at_datetimes(self, dts: Iterable[DateTimeLike]) -> np.ndarray:
        """Vectorized exact lookup; -1 where absent.  The ingest hot path."""
        nanos = to_nanos_array(dts)
        inst = self.instants()
        locs = np.searchsorted(inst, nanos, side="left")
        locs_clamped = np.minimum(locs, self.size - 1)
        hit = inst[locs_clamped] == nanos
        return np.where(hit, locs_clamped, -1).astype(np.int64)

    def datetimes(self) -> np.ndarray:
        return nanos_to_datetime64(self.instants())

    def __len__(self) -> int:
        return self.size

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, DateTimeIndex)
            and self.size == other.size
            and bool(np.array_equal(self.instants(), other.instants()))
        )

    def __hash__(self) -> int:
        # lint: nondet(in-process dict identity only; never persisted)
        return hash((self.size, self.instants().tobytes()))

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}({self.to_string()!r})"


class UniformDateTimeIndex(DateTimeIndex):
    """``periods`` timestamps starting at ``start``, advancing by ``frequency``.

    For pure-duration frequencies every lookup is O(1) arithmetic (jittable);
    calendar frequencies (months, business days) use the frequency's
    closed-form vectorized advance/difference.
    """

    def __init__(
        self,
        start: DateTimeLike,
        periods: int,
        frequency: Frequency,
        _anchor: Tuple[int, int] | None = None,
    ):
        self.start_nanos = to_nanos(start)
        self.periods = int(periods)
        self.frequency = frequency
        # Calendar frequencies (months, years) clamp day-of-month relative to
        # the anchor date; a sliced sub-index must keep generating timestamps
        # from the ORIGINAL anchor or the clamping re-derives from the new
        # start and timestamps silently shift (e.g. Jan-31-anchored monthly
        # sliced at Feb-29 would yield Mar-29 instead of Mar-31).
        self._anchor_nanos, self._offset = _anchor if _anchor else (self.start_nanos, 0)
        self._instants: np.ndarray | None = None

    @property
    def size(self) -> int:
        return self.periods

    def date_time_at_loc(self, loc: int) -> np.datetime64:
        loc = int(loc)
        if loc < 0:
            loc += self.periods
        return nanos_to_datetime64(
            self.frequency.advance(self._anchor_nanos, self._offset + loc)
        )[()]

    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        n = int(self.frequency.difference(self._anchor_nanos, nanos)) - self._offset
        if 0 <= n < self.periods and int(
            self.frequency.advance(self._anchor_nanos, self._offset + n)
        ) == nanos:
            return n
        return -1

    def insertion_loc(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        if nanos < self.start_nanos:
            return 0
        n = int(self.frequency.difference(self._anchor_nanos, nanos)) - self._offset
        return min(n + 1, self.periods)

    def instants(self) -> np.ndarray:
        if self._instants is None:
            self._instants = np.asarray(
                self.frequency.advance(
                    self._anchor_nanos,
                    self._offset + np.arange(self.periods, dtype=np.int64),
                ),
                dtype=np.int64,
            )
        return self._instants

    def locs_at_datetimes(self, dts: Iterable[DateTimeLike]) -> np.ndarray:
        nanos = to_nanos_array(dts)
        n = (
            np.asarray(self.frequency.difference(self._anchor_nanos, nanos), dtype=np.int64)
            - self._offset
        )
        exact = (
            np.asarray(self.frequency.advance(self._anchor_nanos, self._offset + n), dtype=np.int64)
            == nanos
        )
        ok = (n >= 0) & (n < self.periods) & exact
        return np.where(ok, n, -1).astype(np.int64)

    def islice(self, start: int, end: int) -> "UniformDateTimeIndex":
        start = int(start)
        end = int(end)
        if not (0 <= start <= end <= self.periods):
            raise IndexError(f"islice [{start}, {end}) out of range for size {self.periods}")
        return UniformDateTimeIndex(
            int(self.frequency.advance(self._anchor_nanos, self._offset + start)),
            end - start,
            self.frequency,
            _anchor=(self._anchor_nanos, self._offset + start),
        )

    def to_string(self) -> str:
        if self._offset or self._anchor_nanos != self.start_nanos:
            return (
                f"uniform,{self._anchor_nanos},{self.periods},"
                f"offset {self._offset},{self.frequency.to_string()}"
            )
        return f"uniform,{self.start_nanos},{self.periods},{self.frequency.to_string()}"


class IrregularDateTimeIndex(DateTimeIndex):
    """Arbitrary sorted instants (int64 nanos); binary-search lookups."""

    def __init__(self, instants: Iterable[DateTimeLike]):
        arr = to_nanos_array(instants)
        if arr.ndim != 1:
            raise ValueError("instants must be 1-D")
        if arr.size > 1 and not bool(np.all(arr[1:] > arr[:-1])):
            raise ValueError("instants must be strictly increasing")
        self._instants = arr

    @property
    def size(self) -> int:
        return int(self._instants.size)

    def date_time_at_loc(self, loc: int) -> np.datetime64:
        return nanos_to_datetime64(self._instants[int(loc)])[()]

    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        loc = int(np.searchsorted(self._instants, nanos, side="left"))
        if loc < self.size and self._instants[loc] == nanos:
            return loc
        return -1

    def insertion_loc(self, dt: DateTimeLike) -> int:
        return int(np.searchsorted(self._instants, to_nanos(dt), side="right"))

    def instants(self) -> np.ndarray:
        return self._instants

    def islice(self, start: int, end: int) -> "IrregularDateTimeIndex":
        return IrregularDateTimeIndex(self._instants[int(start) : int(end)])

    def to_string(self) -> str:
        return "irregular," + ",".join(str(int(v)) for v in self._instants)


class HybridDateTimeIndex(DateTimeIndex):
    """Concatenation of sub-indices (e.g. uniform segments around gaps)."""

    def __init__(self, indices: Sequence[DateTimeIndex]):
        if not indices:
            raise ValueError("hybrid index needs at least one sub-index")
        # Flatten nested hybrids: keeps instants identical and makes the
        # to_string/from_string round-trip well-defined (the string codec is
        # a flat ';'-separated list).
        flat: List[DateTimeIndex] = []
        for ix in indices:
            if isinstance(ix, HybridDateTimeIndex):
                flat.extend(ix.indices)
            else:
                flat.append(ix)
        self.indices: List[DateTimeIndex] = flat
        sizes = np.array([ix.size for ix in self.indices], dtype=np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])
        self._firsts = np.array([to_nanos(ix.first) for ix in self.indices], dtype=np.int64)
        self._lasts = np.array([to_nanos(ix.last) for ix in self.indices], dtype=np.int64)
        for i in range(len(self.indices) - 1):
            if self._lasts[i] >= self._firsts[i + 1]:
                raise ValueError("hybrid sub-indices must be disjoint and ordered")
        self._instants_cache: np.ndarray | None = None

    @property
    def size(self) -> int:
        return int(self._offsets[-1])

    def _sub_of(self, loc: int) -> Tuple[int, int]:
        i = int(np.searchsorted(self._offsets, loc, side="right")) - 1
        return i, loc - int(self._offsets[i])

    def date_time_at_loc(self, loc: int) -> np.datetime64:
        loc = int(loc)
        if loc < 0:
            loc += self.size
        i, sub = self._sub_of(loc)
        return self.indices[i].date_time_at_loc(sub)

    def loc_at_datetime(self, dt: DateTimeLike) -> int:
        nanos = to_nanos(dt)
        i = int(np.searchsorted(self._firsts, nanos, side="right")) - 1
        if i < 0 or nanos > self._lasts[i]:
            return -1
        sub = self.indices[i].loc_at_datetime(nanos)
        return -1 if sub < 0 else int(self._offsets[i]) + sub

    def insertion_loc(self, dt: DateTimeLike) -> int:
        return int(np.searchsorted(self.instants(), to_nanos(dt), side="right"))

    def instants(self) -> np.ndarray:
        if self._instants_cache is None:
            self._instants_cache = np.concatenate([ix.instants() for ix in self.indices])
        return self._instants_cache

    def islice(self, start: int, end: int) -> DateTimeIndex:
        start, end = int(start), int(end)
        parts: List[DateTimeIndex] = []
        for i, ix in enumerate(self.indices):
            lo = max(start - int(self._offsets[i]), 0)
            hi = min(end - int(self._offsets[i]), ix.size)
            if lo < hi:
                parts.append(ix.islice(lo, hi))
        if not parts:
            return IrregularDateTimeIndex(np.array([], dtype=np.int64))
        if len(parts) == 1:
            return parts[0]
        return HybridDateTimeIndex(parts)

    def to_string(self) -> str:
        return "hybrid;" + ";".join(ix.to_string() for ix in self.indices)


# ---------------------------------------------------------------------------
# Factories (mirror the upstream companion object)
# ---------------------------------------------------------------------------


def uniform(start: DateTimeLike, periods: int, frequency: Frequency) -> UniformDateTimeIndex:
    return UniformDateTimeIndex(start, periods, frequency)


def uniform_from_interval(
    start: DateTimeLike, end: DateTimeLike, frequency: Frequency
) -> UniformDateTimeIndex:
    n = int(frequency.difference(to_nanos(start), to_nanos(end))) + 1
    return UniformDateTimeIndex(start, n, frequency)


def irregular(instants: Iterable[DateTimeLike]) -> IrregularDateTimeIndex:
    return IrregularDateTimeIndex(instants)


def hybrid(indices: Sequence[DateTimeIndex]) -> HybridDateTimeIndex:
    return HybridDateTimeIndex(indices)


def from_string(s: str) -> DateTimeIndex:
    """Decode an index from its persisted string form (checkpoint format)."""
    if s.startswith("hybrid;"):
        return HybridDateTimeIndex([from_string(p) for p in s[len("hybrid;") :].split(";")])
    kind, _, rest = s.partition(",")
    if kind == "uniform":
        m = re.match(r"(-?\d+),(\d+),(?:offset (-?\d+),)?(.+)", rest)
        if not m:
            raise ValueError(f"bad uniform index string: {s!r}")
        anchor, periods = int(m.group(1)), int(m.group(2))
        offset = int(m.group(3)) if m.group(3) else 0
        freq = frequency_from_string(m.group(4))
        start = int(freq.advance(anchor, offset)) if offset else anchor
        return UniformDateTimeIndex(start, periods, freq, _anchor=(anchor, offset))
    if kind == "irregular":
        return IrregularDateTimeIndex([int(v) for v in rest.split(",") if v])
    raise ValueError(f"unknown index string: {s!r}")


# Convenience aliases matching the reference's Scala naming.
NANOSECOND = NanosecondFrequency
MILLISECOND = MillisecondFrequency
SECOND = SecondFrequency
MINUTE = MinuteFrequency
HOUR = HourFrequency
DAY = DayFrequency
WEEK = WeekFrequency
MONTH = MonthFrequency
YEAR = YearFrequency
BUSINESS_DAY = BusinessDayFrequency
