"""SAM comparison path (pvpuformer_tpu/inference/sam_compat.py).

The reference ships a Segment-Anything evaluation harness
(`isegm/inference/sam_evaluation.py:17-98`, `predictors/sam_base.py:14-227`,
`scripts/evaluate_sammodel.py:1-523`) that wraps facebook's
`segment_anything` predictor in the same clicker loop for side-by-side NoC
numbers. That package is an external comparison dependency, not a part of
the port: this adapter runs it when it is installed and raises ImportError
when it is not. Reachable from the CLI as `python -m
pvpuformer_tpu_torch.evaluate SAM --sam-checkpoint ...`.

Protocol (sam_evaluation.py:49-87): each round the oracle click list is fed
as point_coords / point_labels with `multimask_output=False` and no mask
feedback (the reference's mask_input path is commented out); the mask is
`masks[0]`. `feedback_mask=True` opts into the predictors/sam_base.py
variant that threads the previous low-res logits back via `mask_input`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .clicker import Clicker


def sam_available() -> bool:
    try:
        import segment_anything  # noqa: F401
        return True
    except ImportError:
        return False


def model_type_from_name(name: str, default: str = "vit_b") -> str:
    """evaluate_sammodel.py:134-139: the SAM variant from the checkpoint's
    file name."""
    for t in ("vit_b", "vit_l", "vit_h"):
        if t in str(name):
            return t
    return default


class SamCompatPredictor:
    """The evaluation loop's predictor surface (`set_input`, `next_click`,
    `run_clicks`, `probs`, `clicks`): oracle clicks from the host Clicker,
    masks from a segment_anything SamPredictor. `device`: where a SAM
    model built here from `checkpoint` runs (None: where segment_anything
    builds it, the CPU)."""

    def __init__(self, sam_predictor=None, checkpoint: Optional[str] = None,
                 model_type: Optional[str] = None, multimask: bool = False,
                 feedback_mask: bool = False, device=None):
        if sam_predictor is None:
            if not sam_available():
                raise ImportError(
                    "segment_anything is not installed; the SAM comparison "
                    "path needs it (pip install segment-anything) or pass a "
                    "ready SamPredictor")
            from segment_anything import SamPredictor, sam_model_registry
            model_type = model_type or model_type_from_name(checkpoint or "")
            sam = sam_model_registry[model_type](checkpoint=checkpoint)
            if device is not None:
                sam = sam.to(device)
            sam_predictor = SamPredictor(sam)
        self.sam = sam_predictor
        self.multimask = multimask
        self.feedback_mask = feedback_mask
        self._clicker: Optional[Clicker] = None
        self._logits = None
        self._probs = None

    def set_input(self, image: np.ndarray, gt_mask: np.ndarray) -> None:
        self.sam.set_image(image)
        self._clicker = Clicker(gt_mask=gt_mask)
        self._gt = gt_mask
        self._probs = np.zeros(image.shape[:2], np.float32)
        self._logits = None

    def next_click(self) -> float:
        self._clicker.make_next_click(self._probs > 0.5)
        clicks = self._clicker.get_clicks()
        coords = np.array([[c.coords[1], c.coords[0]] for c in clicks],
                          np.float32)
        labels = np.array([int(c.is_positive) for c in clicks], np.int32)
        masks, scores, logits = self.sam.predict(
            point_coords=coords, point_labels=labels,
            mask_input=self._logits if self.feedback_mask else None,
            multimask_output=self.multimask)
        best = int(np.argmax(scores)) if self.multimask else 0
        self._logits = logits[best][None]
        self._probs = masks[best].astype(np.float32)
        gt = self._gt
        inter = np.logical_and(self._probs > 0.5, gt == 1)[gt != -1].sum()
        union = np.logical_or(self._probs > 0.5, gt == 1)[gt != -1].sum()
        return float(inter / max(union, 1))

    def run_clicks(self, num_clicks: int) -> np.ndarray:
        return np.array([self.next_click() for _ in range(num_clicks)],
                        np.float32)

    @property
    def probs(self) -> np.ndarray:
        return self._probs

    @property
    def clicks(self) -> np.ndarray:
        out = np.full((len(self._clicker), 3), -1.0, np.float32)
        for i, c in enumerate(self._clicker.get_clicks()):
            out[i] = (c.coords[0], c.coords[1], i)
        return out
