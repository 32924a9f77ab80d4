"""Readings of the program's own spans and counters
(``mi_fieldcalc_tpu_torch.utils.profiling``): what the newest profiler
session recorded, which is the traced window's.  A program that records
none, as one without ``profiling.recorded``, reads nothing."""

from __future__ import annotations


def recording():
    """The newest session's ``Recording``, or nothing."""
    try:
        from mi_fieldcalc_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()


def spans_ms(name: str, under: str = None):
    """The device time of every span named ``name`` (only those opened
    inside a span named ``under``, where given), ms; nothing where there
    is none."""
    rec = recording()
    if rec is None:
        return None
    by_id = {s.id: s for s in rec.spans}

    def inside(s):
        while s.parent in by_id:
            s = by_id[s.parent]
            if s.name == under:
                return True
        return False

    times = [s.ms for s in rec.spans
             if s.name == name and (under is None or inside(s))]
    return sum(times) if times else None


def per_unit_ms(run, name: str, under: str = None):
    """:func:`spans_ms` over the units of work of the window."""
    total = spans_ms(name, under)
    return None if total is None else total / run.units


def counter(name: str):
    """The session's counter ``name``; nothing where it counted none."""
    rec = recording()
    return None if rec is None else rec.counters.get(name)
