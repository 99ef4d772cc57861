"""What the metric readers share: times per unit from the window, and
shares of a bound from the traced window. Each returns None where the
run has nothing to read."""
from __future__ import annotations

import math
import statistics

from loopsbench import counters


def unit_ms(run):
    """The window's duration over the units completed in it."""
    if not run.units:
        return None
    return run.window_s / len(run.units) * 1e3


def p95_ms(run):
    """The 95th percentile (nearest rank) of the window's unit times: every
    epoch or solve, each from its start to the host read that ends it."""
    if not run.units:
        return None
    ranked = sorted(run.units)
    return ranked[math.ceil(0.95 * len(ranked)) - 1] * 1e3


def roofline_pct(run, counter: str):
    """The least time of the traced window's launches of ``counter`` (the
    frozen formulas' bound of each) over their device time in the
    program's kernel record, in %. None without a trace, or where the
    record does not hold one unit's launches for each unit traced."""
    if run.trace is None or counter not in run.unit_work:
        return None
    launches = [x["device_ms"] for x in run.trace["record"]["launches"]
                if x["counter"] == counter]
    per_unit = run.unit_work[counter]
    if not launches or len(launches) != len(per_unit) * run.trace["units"]:
        return None
    bound = run.trace["units"] * sum(counters.bound_s(w) for w in per_unit)
    return 100.0 * bound / (sum(launches) * 1e-3)


def idle_pct(run):
    """The share of the traced window in which no operation ran on the
    device, in %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def median_us(run, span: str):
    times = run.spans.get(span)
    return statistics.median(times) * 1e6 if times else None
