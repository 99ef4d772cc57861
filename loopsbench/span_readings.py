"""What the readers of the program's spans share: each reads the
``spans`` table of the traced window's kernel record
(``loops_tpu_torch/utils/trace.py`` ``span_table``), and returns None
where the record has none, as before the program opened spans, or where
the span it reads is missing."""
from __future__ import annotations


def record(run):
    """The traced window's kernel record where it holds a ``spans``
    table, else None."""
    if run.trace is None:
        return None
    rec = run.trace["record"]
    return rec if "spans" in rec else None


def roots(spans: dict, names) -> list:
    """The paths that end in one of ``names`` under none of them: each
    subtree of ``names`` once."""
    out = []
    for path in spans:
        parts = path.split("/")
        if parts[-1] in names and not set(parts[:-1]) & set(names):
            out.append(path)
    return out


def device_ms_per_unit(run, name: str):
    """Device ms a unit under the subtrees of span ``name``."""
    rec = record(run)
    if rec is None:
        return None
    paths = roots(rec["spans"], (name,))
    if not paths:
        return None
    return (sum(rec["spans"][p]["device_ms"] for p in paths)
            / run.trace["units"])


def launches_per_unit(run):
    """Launch calls a unit under any program span."""
    rec = record(run)
    if rec is None:
        return None
    return (sum(r["launches"] for p, r in rec["spans"].items()
                if "/" not in p) / run.trace["units"])


def host_wait_pct(run):
    """The card's host wait over the traced window, in %: the idle gaps
    ended by a launch the host had not yet made."""
    rec = record(run)
    if rec is None or rec["host_wait_ms"] is None or rec["window_ms"] <= 0:
        return None
    return 100.0 * rec["host_wait_ms"] / rec["window_ms"]


def op_host_us(run):
    """Host microseconds of the ``spmv`` and ``saxpy`` subtrees over the ``spmv``
    calls: one iteration's launch path, where it runs."""
    rec = record(run)
    if rec is None:
        return None
    spans = rec["spans"]
    paths = roots(spans, ("spmv", "saxpy"))
    calls = sum(spans[p]["calls"] for p in paths
                if p.split("/")[-1] == "spmv")
    if not calls:
        return None
    return 1e3 * sum(spans[p]["host_ms"] for p in paths) / calls
