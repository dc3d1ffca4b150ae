"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, as numbers that each cell's workload file limits.

Training (``train_numbers``): the first three steps, taken through the
window's own launch path (the eager step before the capture, then two
graph replays), against the plain reference. Two references: the
reference's own three steps from the same weights, rows and draws (the
trajectory), and, for each step, the reference's one step from the state
the program began that step in (the program's own after steps 1 and 2), so
that each replayed step is held to the reference by itself.

The trajectory's numbers:

- ``fwd1_gap``: the first step's forward-only readings on the same
  weights and rows: the largest relative gap of D's BCE (its loss less the
  penalty), and of D's mean score on the real and on the fake rows;
- ``loss1_gap``: the larger |program − reference| / |reference| of D's and
  G's loss in the first step; ``loss_gap``: the same over all three steps;
- ``grad_gap``: the first step's gradient of each leaf of D and G, as the
  optimizer got it, by its norm: the worst leaf's |‖program‖ −
  ‖reference‖| over the larger of the reference leaf's norm and the
  median leaf's of that net; ``grad_median_gap``: the median leaf's;
- ``change_gap`` / ``change_median_gap``: the same measures on the change
  of every leaf of G, D and G's EMA over the three steps.

Step by step, from the same state (step ``s`` = 1, 2, 3; the largest of
the three without the digit):

- ``fwd_step{s}_gap``: as ``fwd1_gap``, on the weights step ``s`` began
  from;
- ``grad_step{s}_gap``: the gradient each optimizer got in step ``s``
  (from its first moment before and after: (m' − beta1·m) / (1 − beta1)),
  each leaf's ‖program − reference‖ over the larger of the reference
  leaf's norm and the median leaf's of its net: the worst leaf of G and D;
  ``grad_step_median_gap``: the median leaf's, of G's or D's, the larger.

Leaves whose reference gradient is under a thousandth of the median
leaf's of their net move under Adam by round-off alone; they are left out
of the gradient's and the change's measures (for the EMA, by G's rule).
Which of the numbers a cell compares, and their limits, its workload file
says (``limits``); the others are printed beside them.

Serving (``image_numbers``): the served uint8 images against the
reference's renders of the same requests.

- ``worst_image_lsb``: the largest mean |difference| of one image, in
  uint8 steps;
- ``mean_lsb``: the mean |difference| over every compared pixel.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Set

import numpy as np
import torch

QUIET = 1e-3  # a leaf's reference gradient under this share of the median leaf's is round-off
NETS = ("g", "d")


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> Set[str]:
    norms = _norms(ref_grad)
    median = statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= QUIET * median}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Optional[Iterable[str]] = None) -> List[float]:
    """Each kept leaf's |‖prog‖ − ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    median = statistics.median(rn.values())
    keys = rn if keep is None else [k for k in rn if k in set(keep)]
    return [abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30) for k in keys]


def diff_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Iterable[str]) -> List[float]:
    """Each kept leaf's ‖prog − ref‖ / max(‖ref‖, the median leaf's ‖ref‖)."""
    rn = _norms(ref)
    median = statistics.median(rn.values())
    keep = set(keep)
    return [float((prog[k].double() - ref[k].double()).norm()) / max(rn[k], median, 1e-30)
            for k in rn if k in keep]


def step_gradient(before: dict, after: dict, net: str, beta1: float) -> Dict[str, torch.Tensor]:
    """The gradient ``net``'s optimizer got in the step from state ``before``
    to ``after`` (``TrainState.snapshot``'s layout)."""
    m0, m1 = before[f"m_{net}"], after[f"m_{net}"]
    return {k: (m1[k] - beta1 * m0[k]) / (1.0 - beta1) for k in m1}


def _change(before: dict, after: dict, net: str) -> Dict[str, torch.Tensor]:
    return {k: after[net][k] - before[net][k] for k in before[net]}


def _fwd(t: dict, lam: float):
    return (t["loss_d"] - lam * t["gp"], t["d_x"], t["d_gz1"])


def _rel(ps, rs) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(ps, rs))


def train_numbers(start: dict, prog: dict, ref: dict, single: List[dict], lam: float,
                  beta1: float) -> Dict[str, float]:
    """``start``: the state before step 1 (``TrainState.snapshot``);
    ``prog`` / ``ref``: the program's and the reference's three steps from
    it, {"states": the state after each step, "telemetry": each step's
    {loss_d, gp, d_x, d_gz1, loss_g}}; ``single[s]``: the reference's one
    step from the state the program began step s + 1 in, in that layout;
    ``lam`` the penalty's weight, ``beta1`` Adam's → the numbers (module
    docstring)."""
    tp, tr = prog["telemetry"], ref["telemetry"]
    losses = [_rel((p["loss_d"], p["loss_g"]), (r["loss_d"], r["loss_g"])) for p, r in zip(tp, tr)]
    first = {net: (step_gradient(start, prog["states"][0], net, beta1),
                   step_gradient(start, ref["states"][0], net, beta1)) for net in NETS}
    keep = {net: moving_leaves(r) for net, (_, r) in first.items()}
    grad = [g for net, (p, r) in first.items() for g in leaf_gaps(p, r, keep[net])]
    change = [g for net in ("g", "d", "ema")
              for g in leaf_gaps(_change(start, prog["states"][-1], net),
                                 _change(start, ref["states"][-1], net),
                                 keep["g" if net == "ema" else net])]
    out = {"fwd1_gap": _rel(_fwd(tp[0], lam), _fwd(tr[0], lam)), "loss1_gap": losses[0],
           "loss_gap": max(losses), "grad_gap": max(grad),
           "grad_median_gap": statistics.median(grad), "change_gap": max(change),
           "change_median_gap": statistics.median(change)}

    befores = [start] + prog["states"][:-1]
    medians = []
    for s, (before, after, one) in enumerate(zip(befores, prog["states"], single), 1):
        r_after = one["states"][0]
        out[f"fwd_step{s}_gap"] = _rel(_fwd(tp[s - 1], lam), _fwd(one["telemetry"][0], lam))
        gaps = []
        for net in NETS:
            gr = step_gradient(before, r_after, net, beta1)
            net_gaps = diff_gaps(step_gradient(before, after, net, beta1), gr, moving_leaves(gr))
            medians.append(statistics.median(net_gaps))
            gaps += net_gaps
        out[f"grad_step{s}_gap"] = max(gaps)
    for name in ("fwd_step", "grad_step"):
        out[f"{name}_gap"] = max(out[f"{name}{s}_gap"] for s in range(1, len(single) + 1))
    out["grad_step_median_gap"] = max(medians)
    return out


def image_numbers(prog: List[np.ndarray], ref: List[np.ndarray]) -> Dict[str, float]:
    """Lists of uint8 (n, S, S, C) arrays, request by request → the two gaps."""
    per_image, total, count = [], 0.0, 0
    for p, r in zip(prog, ref):
        d = np.abs(p.astype(np.int16) - r.astype(np.int16)).reshape(p.shape[0], -1)
        per_image.extend(d.mean(axis=1).tolist())
        total += float(d.sum())
        count += d.size
    return {"worst_image_lsb": max(per_image), "mean_lsb": total / count}
