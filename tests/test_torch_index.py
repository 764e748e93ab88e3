"""The port's ``index`` against the reference's on the same calls.

Each case is a function of an index module that returns what it observed
(instants, locations, strings, slices; or the type of the error it
raised).  It runs once on ``spark_timeseries_tpu.index`` and once on
``spark_timeseries_tpu_torch.index``, and the two observations must be
equal exactly: the index is host metadata in integer nanoseconds, so there
is no tolerance.  The cases mirror ``tests/test_index.py``.
"""

import numpy as np
import pytest

from spark_timeseries_tpu import index as ref_ix
from spark_timeseries_tpu_torch import index as port_ix


def _obs(x):
    """A comparable form of an observation."""
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.tolist())
    if isinstance(x, np.generic):
        return ("scalar", str(x.dtype), x.item())
    if isinstance(x, (list, tuple)):
        return tuple(_obs(v) for v in x)
    if hasattr(x, "to_string") and hasattr(x, "instants"):  # an index
        return ("index", type(x).__name__, x.to_string(),
                x.instants().tolist())
    if hasattr(x, "to_string"):  # a frequency
        return ("freq", type(x).__name__, x.to_string())
    return x


def _run(m, case):
    try:
        return _obs(case(m))
    except Exception as e:  # noqa: BLE001 - the error type is the observation
        return ("raises", type(e).__name__)


def _uniform_daily(m):
    return m.uniform("2020-01-01", 10, m.DayFrequency(1))


CASES = {
    "daily_basic": lambda m: [
        _uniform_daily(m).size, _uniform_daily(m).first,
        _uniform_daily(m).last,
        [_uniform_daily(m).loc_at_datetime(d) for d in
         ("2020-01-05", "2020-01-05T12:00", "2019-12-31", "2020-01-11")]],
    "durations": lambda m: [
        m.uniform("2021-03-01", 50, f).instants()
        for f in (m.DayFrequency(1), m.HourFrequency(1),
                  m.MinuteFrequency(15), m.DayFrequency(3),
                  m.SecondFrequency(30), m.MillisecondFrequency(250),
                  m.NanosecondFrequency(7), m.WeekFrequency(2))],
    "month_clamping": lambda m: m.uniform(
        "2020-01-31", 14, m.MonthFrequency(1)).datetimes(),
    "minute_inverse": lambda m: [
        (ix := m.uniform("2020-06-15T08:30", 100, m.MinuteFrequency(7)))
        .loc_at_datetime(ix.date_time_at_loc(loc))
        for loc in (0, 1, 17, 50, 99, -1)],
    "islice_slice": lambda m: [
        _uniform_daily(m).islice(2, 6),
        _uniform_daily(m).slice("2020-01-03", "2020-01-06"),
        _uniform_daily(m).loc_range("2020-01-02T12:00", "2020-01-07")],
    "islice_out_of_range": lambda m: _uniform_daily(m).islice(4, 11),
    "slice_before_start": lambda m: _uniform_daily(m).slice(
        "2019-01-01", "2019-02-01"),
    "slice_after_end": lambda m: _uniform_daily(m).slice(
        "2021-01-01", "2021-02-01"),
    "vectorized_locs": lambda m: _uniform_daily(m).locs_at_datetimes(
        ["2020-01-02", "2020-01-09", "2020-02-01", "2020-01-01T05:00"]),
    "insertion_loc": lambda m: [
        m.uniform("2020-01-01", 5, m.DayFrequency(1)).insertion_loc(d)
        for d in ("2019-12-25", "2020-01-01", "2020-01-02T12:00",
                  "2020-03-01")],
    "bday_skips_weekends": lambda m: m.uniform(
        "2020-01-03", 5, m.BusinessDayFrequency(1)).datetimes(),
    "bday_200": lambda m: m.uniform(
        "2021-02-01", 200, m.BusinessDayFrequency(1)).instants(),
    "bday_inverse": lambda m: [
        (ix := m.uniform("2021-02-01", 200, m.BusinessDayFrequency(1)))
        .loc_at_datetime(ix.date_time_at_loc(loc))
        for loc in (0, 1, 4, 5, 99, 199)],
    "bday_weekend_absent": lambda m: [
        m.uniform("2020-01-03", 5, m.BusinessDayFrequency(1))
        .loc_at_datetime(d) for d in ("2020-01-04", "2020-01-05")],
    "bday_multi_day_step": lambda m: m.uniform(
        "2020-01-06", 4, m.BusinessDayFrequency(2)).datetimes(),
    "bday_advance_difference": lambda m: [
        (int(f.advance(s, n)), int(f.difference(s, int(f.advance(s, n)))))
        for f in [m.BusinessDayFrequency(1)]
        for s in [m.to_nanos("2020-01-06")] for n in range(-15, 50)],
    "bday_sunday_week": lambda m: [
        (ix := m.uniform("2021-03-07", 7, m.BusinessDayFrequency(1, 6))),
        ix.loc_at_datetime("2021-03-12"), ix.loc_at_datetime("2021-03-13"),
        m.frequency_from_string(ix.frequency.to_string())],
    "bday_bad_week_start": lambda m: m.BusinessDayFrequency(
        1, first_day_of_week=7),
    "bday_true_floor_backward": lambda m: [
        int(m.BusinessDayFrequency(1).difference(
            m.to_nanos("2020-01-07T12:00"), m.to_nanos(d)))
        for d in ("2020-01-06T11:00", "2020-01-07T11:00",
                  "2020-01-07T12:00")],
    "bday_weekend_monotone": lambda m: [
        int(m.BusinessDayFrequency(1).difference(m.to_nanos(a),
                                                 m.to_nanos(b)))
        for a, b in (("2020-01-10T12:00", "2020-01-11T10:00"),
                     ("2020-01-11T10:00", "2020-01-10T12:00"),
                     ("2020-01-11T10:00", "2020-01-12T20:00"),
                     ("2020-01-11T10:00", "2020-01-13T09:00"))]
    + [m.uniform("2020-01-06T12:00", 5, m.BusinessDayFrequency(1))
       .insertion_loc("2020-01-11T10:00")],
    "irregular_basic": lambda m: [
        (ix := m.irregular(["2020-01-01", "2020-01-03", "2020-01-10"])),
        ix.loc_at_datetime("2020-01-03"), ix.loc_at_datetime("2020-01-04"),
        ix.first, ix.last, ix.insertion_loc("2020-01-05")],
    "irregular_slice": lambda m: m.irregular(
        ["2020-01-01", "2020-01-03", "2020-01-10", "2020-02-01"]).slice(
        "2020-01-02", "2020-01-15"),
    "irregular_unsorted": lambda m: m.irregular(
        ["2020-01-03", "2020-01-01"]),
    "irregular_2d": lambda m: m.irregular(
        np.array([[1, 2], [3, 4]], dtype=np.int64)),
    "hybrid_concatenation": lambda m: [
        (h := m.hybrid([_uniform_daily(m).islice(0, 5),
                        m.irregular(["2020-02-01", "2020-02-15"])])),
        h.date_time_at_loc(0), h.date_time_at_loc(5), h.date_time_at_loc(-1),
        [h.loc_at_datetime(d) for d in ("2020-01-03", "2020-02-15",
                                        "2020-01-20")],
        h.insertion_loc("2020-01-20")],
    "hybrid_islice_across": lambda m: m.hybrid([
        m.uniform("2020-01-01", 5, m.DayFrequency(1)),
        m.uniform("2020-03-01", 5, m.DayFrequency(1))]).islice(3, 8),
    "hybrid_overlap": lambda m: m.hybrid([
        m.uniform("2020-01-01", 5, m.DayFrequency(1)),
        m.uniform("2020-01-03", 5, m.DayFrequency(1))]),
    "hybrid_empty_islice": lambda m: m.hybrid([
        m.uniform("2020-01-01", 3, m.DayFrequency(1)),
        m.uniform("2020-03-01", 3, m.DayFrequency(1))]).islice(2, 2),
    "hybrid_nested_flattens": lambda m: [
        len((h := m.hybrid([m.hybrid([
            m.uniform("2020-01-01", 3, m.DayFrequency(1)),
            m.irregular(["2020-02-01", "2020-02-15"])]),
            m.uniform("2020-03-01", 2, m.DayFrequency(1))])).indices), h],
    "hybrid_no_parts": lambda m: m.hybrid([]),
    "month_islice_preserves": lambda m: [
        (ix := m.uniform("2020-01-31", 6, m.MonthFrequency(1))).islice(1, 5),
        ix.slice("2020-02-29", "2020-05-31"),
        [ix.islice(1, 5).loc_at_datetime(ix.islice(1, 5)
                                         .date_time_at_loc(k))
         for k in range(4)]],
    "year_frequency": lambda m: [
        m.YearFrequency(1).advance(m.to_nanos("2020-02-29"), n)
        for n in (1, 4, -1)],
    "month_difference": lambda m: [
        int(m.MonthFrequency(2).difference(m.to_nanos("2020-01-31"),
                                           m.to_nanos(d)))
        for d in ("2020-03-30", "2020-03-31", "2021-07-01", "2019-11-30")],
    "duration_difference": lambda m: [
        int(m.HourFrequency(6).difference(m.to_nanos("2020-01-01"),
                                          m.to_nanos(d)))
        for d in ("2020-01-02", "2020-01-01T23:00", "2019-12-31T23:00")],
    "uniform_from_interval": lambda m: m.uniform_from_interval(
        "2020-01-01", "2020-02-03T05:00", m.DayFrequency(2)),
    "to_nanos_kinds": lambda m: [
        m.to_nanos("2020-01-01T00:00:01"), m.to_nanos(12345),
        m.to_nanos(np.datetime64("2020-01-01", "D")),
        m.to_nanos_array(np.array(["2020-01-01", "2021-01-01"],
                                  dtype="datetime64[D]")),
        m.to_nanos_array([1, 2, 3]), m.to_nanos_array(["2020-01-02"])],
    "locs_hybrid": lambda m: m.hybrid([
        m.uniform("2020-01-01", 5, m.DayFrequency(1)),
        m.irregular(["2020-02-01", "2020-02-15"])]).locs_at_datetimes(
        ["2020-01-02", "2020-02-15", "2020-03-01", "2019-01-01"]),
    "loc_at_or_before_after": lambda m: [
        _uniform_daily(m).loc_at_or_before("2020-01-03T12:00"),
        _uniform_daily(m).loc_at_or_after("2020-01-03T12:00")],
    "frequency_strings": lambda m: [
        m.frequency_from_string(f.to_string()) for f in (
            m.DayFrequency(2), m.HourFrequency(3), m.BusinessDayFrequency(1),
            m.BusinessDayFrequency(3, 5), m.MonthFrequency(6),
            m.YearFrequency(2), m.WeekFrequency(1), m.SecondFrequency(30),
            m.MillisecondFrequency(4), m.NanosecondFrequency(9),
            m.MinuteFrequency(5), m.DurationFrequency(77))],
    "frequency_unknown_string": lambda m: m.frequency_from_string("fortnights 1"),
    "frequency_nonpositive": lambda m: m.DurationFrequency(0),
    "from_string_garbage": lambda m: m.from_string("spiral,1,2"),
    "from_string_bad_uniform": lambda m: m.from_string("uniform,abc"),
    "aliases": lambda m: [m.DAY(1), m.HOUR(2), m.BUSINESS_DAY(1), m.MONTH(3),
                          m.YEAR(1), m.WEEK(1), m.MINUTE(5), m.SECOND(1),
                          m.MILLISECOND(1), m.NANOSECOND(1)],
}

_ROUNDTRIP = {
    "daily": lambda m: _uniform_daily(m),
    "hourly_offset": lambda m: m.uniform("2020-01-01T06:30", 24,
                                         m.HourFrequency(2)),
    "bday": lambda m: m.uniform("2020-01-06", 30, m.BusinessDayFrequency(1)),
    "monthly": lambda m: m.uniform("2020-01-31", 12, m.MonthFrequency(1)),
    "yearly": lambda m: m.uniform("2000-01-01", 5, m.YearFrequency(1)),
    "irregular": lambda m: m.irregular(["2020-01-01", "2020-01-03",
                                        "2020-03-10"]),
    "hybrid": lambda m: m.hybrid([
        m.uniform("2020-01-01", 5, m.DayFrequency(1)),
        m.irregular(["2020-02-01", "2020-02-15"])]),
    "sliced_monthly": lambda m: m.uniform(
        "2020-01-31", 6, m.MonthFrequency(1)).islice(2, 6),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_observations_as_reference(name):
    want = _run(ref_ix, CASES[name])
    got = _run(port_ix, CASES[name])
    assert got == want


@pytest.mark.parametrize("name", sorted(_ROUNDTRIP))
def test_string_forms_read_back_in_both_packages(name):
    ref, port = _ROUNDTRIP[name](ref_ix), _ROUNDTRIP[name](port_ix)
    assert port.to_string() == ref.to_string()
    # an index persisted by either package reads back in the other
    for src, dst in ((ref, port_ix), (port, ref_ix), (port, port_ix)):
        back = dst.from_string(src.to_string())
        np.testing.assert_array_equal(back.instants(), src.instants())
        assert back.to_string() == src.to_string()
    assert port_ix.from_string(port.to_string()) == port


@pytest.mark.parametrize("fdow", range(7))
def test_week_start_matches_reference_and_numpy(fdow):
    mask = [((d - fdow) % 7) < 5 for d in range(7)]
    start_d = np.busday_offset("2021-03-01", 0, roll="forward", weekmask=mask)
    fr = ref_ix.BusinessDayFrequency(1, first_day_of_week=fdow)
    fp = port_ix.BusinessDayFrequency(1, first_day_of_week=fdow)
    start = port_ix.to_nanos(str(start_d))
    ns = np.array([0, 1, 2, 5, 7, 13, 60])
    adv = fp.advance(start, ns)
    np.testing.assert_array_equal(adv, fr.advance(start, ns))
    np.testing.assert_array_equal(
        port_ix.nanos_to_datetime64(adv).astype("datetime64[D]"),
        np.busday_offset(start_d, ns, weekmask=mask))
    np.testing.assert_array_equal(fp.difference(start, adv), ns)


def test_port_frequencies_are_not_reference_frequencies():
    # equality is by type: a copy, not an import, so the two packages'
    # frequencies never compare equal even with the same string
    assert port_ix.DayFrequency(1) != ref_ix.DayFrequency(1)
    assert port_ix.DayFrequency(1) == port_ix.DayFrequency(1)
    assert hash(port_ix.DayFrequency(2)) == hash(port_ix.DayFrequency(2))
