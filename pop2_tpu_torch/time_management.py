"""Calendar, date arithmetic, and the time-flag service.

The port's own copy of the JAX package's ``time_management.py`` (plain
Python, no tensors). Reference: ``source/time_management.F90`` — the time
manager (:1775) advances date/step counters and raises
end-of-day/month/year switches; the time-flag service (``init_time_flag``
:2241, ``check_time_flag`` :2956, ``override_time_flag`` :2821,
``time_to_do`` :3260) lets every output/forcing subsystem schedule itself
by calendar frequency. Both are small host-side classes: the step never
sees the calendar; it only consumes the (leapfrog, avg_ts) flags, the role
the reference's switches play outside the block loops.

Offset/reference dates for flags (has_offset_date) are not rebuilt;
frequencies count from the run start. The 'avgfit' step fitting lives in
``config.TimeConfig.avgfit_params`` with its scheduling in
``model.Model.step_flags``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)
SECONDS_IN_DAY = 86400
FREQ_OPTS = ("never", "nyear", "nmonth", "nday", "nhour", "nsecond",
             "nstep", "once")


def is_leapyear(year: int) -> bool:
    """Gregorian rule (source/time_management.F90 is_leapyear)."""
    return year % 4 == 0 and (year % 100 != 0 or year % 400 == 0)


def days_in_month(year: int, month: int, allow_leapyear: bool) -> int:
    if month == 2 and allow_leapyear and is_leapyear(year):
        return 29
    return DAYS_IN_MONTH[month - 1]


@dataclass
class Calendar:
    """Model calendar, advanced once per step (time_manager,
    source/time_management.F90:1775-2091). All switches describe the step
    that was just taken."""

    dt_seconds: float
    iyear: int = 1
    imonth: int = 1
    iday: int = 1
    allow_leapyear: bool = False
    seconds_this_day: float = 0.0
    nsteps_total: int = 0
    # elapsed whole units since run start (the reference counts from a
    # reference date; with no offset dates only differences matter)
    elapsed_days: int = 0
    elapsed_months: int = 0
    elapsed_years: int = 0
    # switches (reset_switches :2098, set_switches :2139)
    eod: bool = False
    eom: bool = False
    eoy: bool = False
    midnight: bool = False
    newhour: bool = False
    newday: bool = False

    def advance(self, dt_seconds: Optional[float] = None) -> None:
        """One timestep of date arithmetic. ``dt_seconds`` overrides the
        step size (averaging steps advance dtt/2,
        source/time_management.F90:1854-1858)."""
        self.nsteps_total += 1
        hour_before = int(self.seconds_this_day // 3600)
        self.seconds_this_day += (self.dt_seconds if dt_seconds is None
                                  else dt_seconds)
        self.eod = self.eom = self.eoy = False
        self.midnight = self.newday = False

        # round-off guard: treat within half a step of the boundary as on it
        # (the reference adjusts the last step of each day via dt fitting)
        while self.seconds_this_day >= SECONDS_IN_DAY - 1.0e-6:
            self.seconds_this_day -= SECONDS_IN_DAY
            if abs(self.seconds_this_day) < 1.0e-6:
                self.seconds_this_day = 0.0
                self.midnight = True
            self._roll_day()
        self.newhour = (int(self.seconds_this_day // 3600) != hour_before
                        or self.newday)

    def _roll_day(self) -> None:
        self.eod = True
        self.newday = True
        self.elapsed_days += 1
        self.iday += 1
        dim = days_in_month(self.iyear, self.imonth, self.allow_leapyear)
        if self.iday > dim:
            self.iday = 1
            self.imonth += 1
            self.eom = True
            self.elapsed_months += 1
            if self.imonth > 12:
                self.imonth = 1
                self.iyear += 1
                self.eoy = True
                self.elapsed_years += 1

    @property
    def ihour(self) -> int:
        return int(self.seconds_this_day // 3600)

    @property
    def date(self):
        return (self.iyear, self.imonth, self.iday)

    @property
    def elapsed_days_float(self) -> float:
        return self.elapsed_days + self.seconds_this_day / SECONDS_IN_DAY

    @property
    def year_fraction(self) -> float:
        """Decimal year (e.g. 1969.75) from the current model date."""
        diy = sum(days_in_month(self.iyear, mo, self.allow_leapyear)
                  for mo in range(1, 13))
        doy = (sum(days_in_month(self.iyear, mo, self.allow_leapyear)
                   for mo in range(1, self.imonth))
               + (self.iday - 1) + self.seconds_this_day / SECONDS_IN_DAY)
        return self.iyear + doy / diy


@dataclass
class TimeFlag:
    """One schedulable event (init_time_flag,
    source/time_management.F90:2241-2417)."""
    name: str
    freq_opt: str = "never"
    freq: int = 1
    default: bool = False
    owner: str = ""
    done: bool = False
    _override: Optional[bool] = None

    def __post_init__(self):
        if self.freq_opt not in FREQ_OPTS:
            raise ValueError(f"unknown freq_opt {self.freq_opt}")
        if self.freq_opt != "never" and self.freq_opt != "once" \
                and self.freq <= 0:
            raise ValueError(f"freq must be positive for {self.freq_opt}")

    def time_to_do(self, cal: Calendar) -> bool:
        """(time_to_do, source/time_management.F90:3260-3394)."""
        fo, freq = self.freq_opt, self.freq
        if fo == "never":
            return False
        if fo == "once":
            return not self.done
        if fo == "nstep":
            return cal.nsteps_total % freq == 0
        if fo == "nyear":
            return cal.eoy and cal.elapsed_years % freq == 0
        if fo == "nmonth":
            return cal.eom and cal.elapsed_months % freq == 0
        if fo == "nday":
            if not cal.eod:
                return False
            test = cal.elapsed_days if cal.midnight else cal.elapsed_days + 1
            return test % freq == 0
        if fo == "nhour":
            return (cal.newhour
                    and (cal.elapsed_days * 24 + cal.ihour) % freq == 0)
        if fo == "nsecond":
            total = cal.elapsed_days * SECONDS_IN_DAY + cal.seconds_this_day
            return round(total) % freq == 0
        raise AssertionError(fo)

    def check(self, cal: Calendar) -> bool:
        """check_time_flag (:2956) incl. override (:2821)."""
        if self._override is not None:
            return self._override
        value = self.default or self.time_to_do(cal)
        if value and self.freq_opt == "once":
            self.done = True
        return value

    def override(self, value: Optional[bool]) -> None:
        self._override = value


class TimeManager:
    """Calendar + flag registry; owned by the Model
    (replaces the module-level flag table, source/time_management.F90:98)."""

    def __init__(self, dt_seconds: float, start_year: int = 1,
                 start_month: int = 1, start_day: int = 1,
                 allow_leapyear: bool = False):
        self.calendar = Calendar(dt_seconds=dt_seconds, iyear=start_year,
                                 imonth=start_month, iday=start_day,
                                 allow_leapyear=allow_leapyear)
        self._start = (start_year, start_month, start_day)
        self.flags: Dict[str, TimeFlag] = {}

    def init_time_flag(self, name: str, freq_opt: str = "never",
                       freq: int = 1, default: bool = False,
                       owner: str = "") -> TimeFlag:
        if name in self.flags:
            return self.flags[name]  # access semantics (:2424)
        flag = TimeFlag(name=name, freq_opt=freq_opt, freq=freq,
                        default=default, owner=owner)
        self.flags[name] = flag
        return flag

    def check_time_flag(self, name: str) -> bool:
        return self.flags[name].check(self.calendar)

    def override_time_flag(self, name: str, value: Optional[bool]) -> None:
        self.flags[name].override(value)

    def advance(self, dt_seconds: Optional[float] = None) -> None:
        self.calendar.advance(dt_seconds)

    def reset(self) -> None:
        """Rewind the calendar to the run start; registered flags persist
        (matching the reference, where flags live for the whole run)."""
        dt = self.calendar.dt_seconds
        self.calendar = Calendar(
            dt_seconds=dt, iyear=self._start[0], imonth=self._start[1],
            iday=self._start[2], allow_leapyear=self.calendar.allow_leapyear)
        for f in self.flags.values():
            f.done = False
