"""The comparison that decides `correct` for a training round.

Both sides report, for the rounds that set-up drives from the seed: each
local step's loss, each leaf's norm of the change of the global weights
after the first round (the update the server's optimizer is handed: the
round's pseudo-gradient) and after the last. Each leaf's gap is
| |d_prog| - |d_ref| | over the larger of |d_ref| and the median leaf's
|d_ref|. `readings` turns them into these numbers:

  loss_gap           max over local steps of |L_prog - L_ref| / |L_ref|
  first_loss_gap     the same of the first local step alone
  delta_gap          the worst leaf's gap of the first round's change
  change_gap         the worst leaf's gap of the change after the last
                     followed round
  delta_gap_median   the median leaf's gap of the first round's change
  change_gap_median  the median leaf's gap after the last round
  delta_gap_moved    the worst leaf's gap of the first round's change
                     among the leaves in which the reference's round
                     moved at least MIN_MOVED elements
  change_gap_moved   the same after the last round

Leaves whose first-step reference gradient is under a thousandth of the
median leaf's are left out of the gaps: they move by round-off alone.
Weights held in bfloat16 move an element only where its update reaches
half a unit of its last place, so a leaf's change norm is carried by the
elements that crossed that line; in a leaf with few of them (a scalar
gate a layer, a vector a head) one element more or less is a gap of
order one. The `_moved` numbers take the worst leaf among those that
the reference moved in at least MIN_MOVED places.
`verdict` holds each number that the cell's limits file names to its
limit; the rest are printed beside them.
"""
from __future__ import annotations

import math
import statistics

NEGLIGIBLE_GRAD = 1e-3
MIN_MOVED = 1000


def leaf_gaps(prog: list, ref: list, counted: list) -> list[float]:
    """Each counted leaf's | |prog| - |ref| | over the larger of its
    |ref| and the median counted leaf's."""
    floor = statistics.median([ref[i] for i in counted])
    return [abs(prog[i] - ref[i]) / max(ref[i], floor, 1e-30)
            for i in counted]


def readings(prog: dict, ref: dict) -> dict:
    """prog: {"losses", "change_norms": [first round's, last round's]};
    ref: the reference's `run_rounds` record. Returns the numbers and
    which leaf set each gap."""
    if len(prog["losses"]) != len(ref["losses"]) or \
            len(prog["change_norms"]) != 2:
        return {k: math.inf for k in (
            "loss_gap", "delta_gap", "change_gap", "delta_gap_median",
            "change_gap_median", "delta_gap_moved", "change_gap_moved")}
    gmed = statistics.median(ref["grad_norms"])
    counted = [i for i, g in enumerate(ref["grad_norms"])
               if g >= NEGLIGIBLE_GRAD * gmed]
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog["losses"], ref["losses"]))
    if not all(math.isfinite(x) for x in prog["losses"]):
        loss_gap = math.inf
    delta = leaf_gaps(prog["change_norms"][0], ref["change_norms"][0],
                      counted)
    change = leaf_gaps(prog["change_norms"][1], ref["change_norms"][-1],
                       counted)
    paths = ref["paths"]
    worst = lambda g: paths[counted[max(range(len(g)), key=g.__getitem__)]]
    moved = [[j for j, i in enumerate(counted) if m[i] >= MIN_MOVED]
             for m in (ref["moved"][0], ref["moved"][-1])]
    worst_moved = lambda g, js: max((g[j] for j in js), default=math.inf)
    return {"loss_gap": loss_gap, "delta_gap": max(delta),
            "change_gap": max(change),
            "first_loss_gap": abs(prog["losses"][0] - ref["losses"][0])
            / abs(ref["losses"][0]),
            "delta_gap_median": statistics.median(delta),
            "change_gap_median": statistics.median(change),
            "delta_gap_moved": worst_moved(delta, moved[0]),
            "change_gap_moved": worst_moved(change, moved[1]),

            "delta_leaf": worst(delta), "change_leaf": worst(change),
            "delta_moved_leaf": paths[counted[max(
                moved[0], key=delta.__getitem__, default=0)]],
            "leaves_moved": [len(js) for js in moved],
            "leaves_counted": len(counted), "leaves": len(paths)}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """Each number that `limits` names against its limit: (all within,
    {name: {"value", "limit"}})."""
    checked = {}
    for name, spec in limits.items():
        v = values.get(name, math.inf)
        checked[name] = {"value": v, "limit": spec["limit"]}
    ok = bool(checked) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checked.values())
    return ok, checked
