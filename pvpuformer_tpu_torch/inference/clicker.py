"""Host-side oracle click generation (pvpuformer_tpu/inference/clicker.py):
a numpy / scipy policy function and the reference-API `Clicker` shim over it.

The click the evaluation loop uses is computed on the device
(`ops/edt.next_click_from_error`, one min-plus launch per click round); this
module is its independent host-side cross-check and keeps code written
against the reference's `Clicker` API working. The policy
(isegm/inference/clicker.py:6-118):

  * the next click is POSITIVE iff the deepest false-negative pixel lies
    further inside its error region than the deepest false-positive pixel
    (strict >, so an all-zero tie yields a negative click);
  * "depth" is the exact L2 euclidean distance transform of the error
    region, the image border counting as region boundary (the region is
    padded by one background pixel before the transform);
  * pixels already clicked are excluded from the argmax; ties break to the
    first pixel in row-major order;
  * ignore-labelled ground-truth pixels belong to neither error region.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Click:
    is_positive: bool
    coords: Tuple[int, int]
    indx: Optional[int] = None

    @property
    def coords_and_indx(self):
        return (*self.coords, self.indx)

    def copy(self, **kwargs) -> "Click":
        return dataclasses.replace(self, **kwargs)


def region_depth(region: np.ndarray, pad_border: bool = True) -> np.ndarray:
    """Exact L2 EDT of a boolean region, image border = region boundary."""
    from scipy import ndimage
    if not pad_border:
        return ndimage.distance_transform_edt(region)
    return ndimage.distance_transform_edt(np.pad(region, 1))[1:-1, 1:-1]


def oracle_click(gt_mask: np.ndarray, pred_mask: np.ndarray,
                 clicked: Optional[np.ndarray] = None,
                 ignore_label: int = -1, pad_border: bool = True) -> Click:
    """Pure next-click policy: (gt, prediction, already-clicked) -> Click.

    `clicked` is an optional boolean (H, W) map of previously clicked
    pixels (excluded from consideration).
    """
    obj = gt_mask == 1
    care = gt_mask != ignore_label
    allowed = None if clicked is None else ~clicked

    def best(region: np.ndarray) -> Tuple[float, int]:
        d = region_depth(region, pad_border)
        if allowed is not None:
            d = d * allowed
        return float(d.max()), int(d.argmax())

    fn_max, fn_at = best(obj & ~pred_mask & care)
    fp_max, fp_at = best(~obj & pred_mask & care)
    is_positive = fn_max > fp_max
    y, x = np.unravel_index(fn_at if is_positive else fp_at, gt_mask.shape)
    return Click(is_positive=bool(is_positive), coords=(int(y), int(x)))


class Clicker:
    """Reference-API shim over `oracle_click`.

    The only state is the click list (plus the gt mask); counts and the
    clicked-pixel map are derived from it on demand, so get/set_state and
    undo are trivially consistent by construction.
    """

    def __init__(self, gt_mask: Optional[np.ndarray] = None,
                 init_clicks: Optional[Sequence[Click]] = None,
                 ignore_label: int = -1, click_indx_offset: int = 0):
        self.gt_mask = None if gt_mask is None else np.asarray(gt_mask)
        self.ignore_label = ignore_label
        self.click_indx_offset = click_indx_offset
        self.clicks_list: List[Click] = []
        for click in init_clicks or ():
            self.add_click(click)

    # -- derived state -----------------------------------------------------

    @property
    def num_pos_clicks(self) -> int:
        return sum(c.is_positive for c in self.clicks_list)

    @property
    def num_neg_clicks(self) -> int:
        return len(self.clicks_list) - self.num_pos_clicks

    def _clicked_map(self) -> Optional[np.ndarray]:
        if self.gt_mask is None:
            return None
        m = np.zeros(self.gt_mask.shape, bool)
        for c in self.clicks_list:
            m[c.coords] = True
        return m

    # -- reference API -----------------------------------------------------

    def make_next_click(self, pred_mask: np.ndarray) -> None:
        assert self.gt_mask is not None
        self.add_click(self._get_next_click(pred_mask))

    def get_clicks(self, clicks_limit: Optional[int] = None) -> List[Click]:
        return self.clicks_list[:clicks_limit]

    def _get_next_click(self, pred_mask: np.ndarray,
                        padding: bool = True) -> Click:
        return oracle_click(self.gt_mask, pred_mask, self._clicked_map(),
                            self.ignore_label, pad_border=padding)

    def add_click(self, click: Click) -> None:
        click.indx = self.click_indx_offset + len(self.clicks_list)
        self.clicks_list.append(click)

    def _remove_last_click(self) -> None:
        self.clicks_list.pop()

    def reset_clicks(self) -> None:
        self.clicks_list = []

    def get_state(self) -> List[Click]:
        return [c.copy() for c in self.clicks_list]

    def set_state(self, state: Sequence[Click]) -> None:
        self.reset_clicks()
        for click in state:
            self.add_click(click)

    def __len__(self) -> int:
        return len(self.clicks_list)
