"""The comparison that decides `correct`: rounds of the timed path, each
held against the plain reference run from the program's own state before
the round (teacher-forced), on the same seed-made weights and inputs.

Per round and session:
  click_off    the oracle's click (slots, clicked map, counters) differs
               from the reference's on the same previous mask: exact, 0;
  roi_off      the zoom-in ROI differs: exact, 0;
  iou_gap      |IoU reported - IoU of the reported mask| (exact, 0);
  prob_excess  the forward's agreement (crop, disks, PPuE, ViT blocks with
               the fused kernels, DMA, neck, head, flip, paste-back): mean
               |p - p_ref| over the ROI, less the same mean between p_ref
               and p_rev, the reference in the configuration's dtype with
               the backbone's sums in reverse order (`reference/vpu.Num`).
               Two sound evaluations in the served dtype part by the
               rounding of every op after the first sum that differs; the
               number is what the program's output lies beyond that.
A cell's numbers are the largest over its checked rounds (sums for the
exact ones); the limits are the cell's (`limits/<cell>.json`).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from benchmark.reference import rounds

SESSION_AXIS = ("image", "prev_probs", "points")
FIELDS = ("image", "gt", "prev_probs", "points", "not_clicked", "roi",
          "has_roi", "num_pos", "num_neg", "click_count", "img_h", "img_w")


def as_batch(state, single: bool) -> Dict[str, torch.Tensor]:
    """A program SessionState (one session, or a batch) as the reference's
    dict of batched tensors (views)."""
    d = dict(zip(FIELDS, state))
    if single:
        d = {k: v if k in SESSION_AXIS else v[None] for k, v in d.items()}
    return d


def limits(cell: str, root: Path) -> Dict[str, float]:
    return json.loads((root / "benchmark" / "limits"
                       / f"{cell}.json").read_text())


@torch.no_grad()
def compare(P, cfg: dict, before: Dict[str, torch.Tensor],
            after: Dict[str, torch.Tensor], iou: torch.Tensor
            ) -> List[Dict[str, float]]:
    """Readings of one round of a batch of B sessions, one dict each."""
    ref = rounds.put_click(before, *rounds.oracle_click(before))
    ref_roi = rounds.update_roi(ref)
    # the forward from the program's own clicks and ROI, so that its gap
    # reads the model even where a click check has failed
    st = dict(before)
    st.update(points=after["points"], roi=after["roi"])
    probs = rounds.forward_round(P, cfg, st)["prev_probs"]
    rev = rounds.forward_round(P, cfg, st, reverse=True)["prev_probs"]
    ref_iou = rounds.iou(before["gt"], after["prev_probs"])
    out = []
    for i in range(before["gt"].shape[0]):
        r0, r1, c0, c1 = (int(v) for v in after["roi"][i])
        p = after["prev_probs"][i, r0:r1 + 1, c0:c1 + 1, 0]
        q = probs[i, r0:r1 + 1, c0:c1 + 1, 0]
        q_rev = rev[i, r0:r1 + 1, c0:c1 + 1, 0]
        click_same = all(bool(torch.equal(ref[k][i], after[k][i])) for k in
                         ("points", "not_clicked", "num_pos", "num_neg",
                          "click_count"))
        out.append({
            "click_off": float(not click_same),
            "roi_off": float(not torch.equal(ref_roi[i], after["roi"][i])),
            "iou_gap": float((iou[i].float() - ref_iou[i]).abs()),
            "prob_excess": float((p - q).abs().mean()
                                 - (q_rev - q).abs().mean()),
        })
    return out


AGGREGATE = {"click_off": sum, "roi_off": sum, "iou_gap": max,
             "prob_excess": max}
HOW = {"click_off": "rounds whose oracle click differs",
       "roi_off": "rounds whose ROI differs",
       "iou_gap": "largest |IoU - IoU of the reported mask|",
       "prob_excess": "largest mean |p - p_ref| over a round's ROI beyond "
                      "the reference's own in another order of sums"}


def verdict(readings: List[Dict[str, float]], lim: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Tuple[float, float, str]]]:
    """(correct, {name: (value, limit, how)}) over every checked round;
    no reading at all is not correct."""
    checks = {}
    for k, agg in AGGREGATE.items():
        if k not in lim:
            continue
        v = agg(r[k] for r in readings) if readings else float("nan")
        checks[k] = (v, lim[k], HOW[k])
    ok = bool(readings) and all(v <= lim for v, lim, _ in checks.values())
    return ok, checks
