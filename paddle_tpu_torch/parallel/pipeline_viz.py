"""Pipeline schedule timeline visualizer (counterpart of
paddle_tpu/parallel/pipeline_viz.py; the reference's
fleet/meta_parallel/pp_utils/profiler_helper.py, which merges per-rank
chrome-trace records of the schedule into one `pipeline_profile.json`).
Each schedule of `parallel/pipeline_spmd.py` is a closed-form tick table
of (tick, rank), the JAX scan's, which the port's ranks run slot for slot,
so the timeline is rendered exactly from the schedule model:

    >>> tl = pipeline_timeline("1F1B", n_stages=4, n_micro=8)
    >>> print(render_timeline(tl))
    >>> save_chrome_trace(tl, "pipeline_profile.json")

Every schedule is covered: FThenB, 1F1B, Eager1F1B, VPP, ZBH1 (its one
batched weight pass after the last tick). `timeline_stats` counts slots,
full bubbles and the peak microbatches in flight; chip_smoke.py prints
its bubble share beside the one a rank measures.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["pipeline_timeline", "render_timeline", "timeline_stats",
           "save_chrome_trace"]

SCHEDULES = ("FThenB", "1F1B", "Eager1F1B", "VPP", "ZBH1")


def pipeline_timeline(schedule: str, n_stages: int, n_micro: int,
                      vpp_degree: int = 1) -> Dict:
    """Per-rank, per-tick slot occupancy of a pipeline schedule.

    Returns {"schedule", "n_stages", "n_micro", "vpp_degree", "ranks"}
    where ranks[r] is a list of per-tick dicts with keys:
      "F": microbatch id forwarded this tick (None = forward slot idle)
      "B": microbatch id backwarded this tick (None = idle / n/a)
      "W": True when a deferred weight-grad pass runs (ZBH1, after the
           last tick)
      "chunk": VPP only — the virtual chunk index active this tick

    The tick formulas are exactly the ones the ranks of
    parallel/pipeline_spmd.py run; a mismatch between this module and the
    runtime would be a bug in one of them.
    """
    S, M, V = int(n_stages), int(n_micro), int(vpp_degree)
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}; one of {SCHEDULES}")
    ranks: List[List[dict]] = []

    if schedule == "FThenB":
        # pipeline_forward: T forward ticks, then its backward replays
        # them in reverse
        T = M + S - 1
        for r in range(S):
            row = []
            for t in range(T):
                i = t - r
                row.append({"F": i if 0 <= i < M else None, "B": None})
            for t in range(T - 1, -1, -1):
                i = t - r
                row.append({"F": None, "B": i if 0 <= i < M else None})
            ranks.append(row)
    elif schedule in ("1F1B", "Eager1F1B", "ZBH1"):
        eager = schedule == "Eager1F1B"
        T = M + (4 * S - 4 if eager else 2 * S - 1)
        for r in range(S):
            f_off = 2 * r if eager else r
            b_off = (4 * S - 4 - 2 * r) if eager else (2 * S - 1 - r)
            row = []
            for t in range(T):
                i_f, i_b = t - f_off, t - b_off
                row.append({"F": i_f if 0 <= i_f < M else None,
                            "B": i_b if 0 <= i_b < M else None})
            if schedule == "ZBH1":
                # one batched weight-grad pass after the last tick (all
                # microbatches in one forward and backward —
                # pipeline_zb1f1b docstring)
                row.append({"F": None, "B": None, "W": True})
            ranks.append(row)
    else:  # VPP
        SV = S * V
        T = M * V + S - 1
        for r in range(S):
            row = []
            for t in range(T):
                u = t - r
                if 0 <= u < M * V:
                    g, w = u // SV, u % SV
                    row.append({"F": g * S + (w % S), "B": None,
                                "chunk": w // S})
                else:
                    row.append({"F": None, "B": None, "chunk": None})
            # the backward replays the forward ticks reversed
            for t in range(T - 1, -1, -1):
                u = t - r
                if 0 <= u < M * V:
                    g, w = u // SV, u % SV
                    row.append({"F": None, "B": g * S + (w % S),
                                "chunk": w // S})
                else:
                    row.append({"F": None, "B": None, "chunk": None})
            ranks.append(row)
    return {"schedule": schedule, "n_stages": S, "n_micro": M,
            "vpp_degree": V, "ranks": ranks}


def _cell(slot: dict) -> str:
    if slot.get("W"):
        return " W "
    f, b = slot.get("F"), slot.get("B")
    if f is None and b is None:
        return " · "
    ftxt = f"F{f}" if f is not None else ".."
    btxt = f"B{b}" if b is not None else ".."
    return f"{ftxt}/{btxt}"


def render_timeline(tl: Dict) -> str:
    """ASCII rendering: one row per pp rank, one column per tick. `·` is
    a full bubble; `F3/..` a tick whose backward slot idles."""
    head = (f"{tl['schedule']}  S={tl['n_stages']} M={tl['n_micro']}"
            + (f" V={tl['vpp_degree']}" if tl["schedule"] == "VPP" else ""))
    lines = [head]
    width = max(len(_cell(s)) for row in tl["ranks"] for s in row)
    for r, row in enumerate(tl["ranks"]):
        cells = " ".join(f"{_cell(s):^{width}}" for s in row)
        lines.append(f"rank {r} | {cells}")
    return "\n".join(lines)


def timeline_stats(tl: Dict) -> Dict:
    """Slot accounting per rank: fwd/bwd slots filled, bubbles, peak
    in-flight microbatches (forwarded but not yet backwarded — the
    activation-memory driver the schedules trade against)."""
    out = {"per_rank": [], "total_ticks": len(tl["ranks"][0])}
    for row in tl["ranks"]:
        f_n = sum(1 for s in row if s.get("F") is not None)
        b_n = sum(1 for s in row if s.get("B") is not None)
        w_n = sum(1 for s in row if s.get("W"))
        bubbles = sum(1 for s in row
                      if s.get("F") is None and s.get("B") is None
                      and not s.get("W"))
        in_flight = peak = 0
        for s in row:
            if s.get("F") is not None:
                in_flight += 1
            # peak BETWEEN the slots: the tick's forward input is alive
            # while its backward runs (the buffer must hold both)
            peak = max(peak, in_flight)
            if s.get("B") is not None:
                in_flight -= 1
        out["per_rank"].append({"F": f_n, "B": b_n, "W": w_n,
                                "bubbles": bubbles,
                                "peak_in_flight": peak})
    return out


def save_chrome_trace(tl: Dict, path: str, tick_us: float = 1000.0,
                      stats: Optional[Dict] = None) -> None:
    """Write the timeline as chrome://tracing JSON, one track per pp rank
    — the artifact the reference's profiler_helper.py assembles from
    per-rank log files, produced here from the schedule model. Loadable
    in chrome://tracing or Perfetto alongside the profiler's host trace
    (profiler.Profiler.export)."""
    events = []
    for r, row in enumerate(tl["ranks"]):
        for t, slot in enumerate(row):
            ts = t * tick_us
            for kind in ("F", "B"):
                mb = slot.get(kind)
                if mb is not None:
                    events.append({
                        "name": f"{kind}{mb}", "ph": "X", "ts": ts,
                        "dur": tick_us, "pid": 0, "tid": r,
                        "args": {"microbatch": mb, "slot": kind,
                                 **({"chunk": slot["chunk"]}
                                    if slot.get("chunk") is not None
                                    else {})}})
            if slot.get("W"):
                events.append({"name": "W(batched)", "ph": "X", "ts": ts,
                               "dur": tick_us, "pid": 0, "tid": r,
                               "args": {"slot": "W"}})
    meta = [{"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": f"pipeline {tl['schedule']}"}}]
    meta += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": r,
              "args": {"name": f"pp rank {r}"}}
             for r in range(len(tl["ranks"]))]
    # one writer for every chrome-trace artifact (observability.trace);
    # this module keeps only the schedule -> events assembly
    from ..observability.trace import write_chrome_trace

    write_chrome_trace(meta + events, path,
                       metadata={"stats": stats or timeline_stats(tl)})
