"""Headless interactive session controller, the state machine behind every
interactive front end (pvpuformer_tpu/inference/controller.py; reference
interactive_demo/controller.py:10-154):
  * `add_click(x, y, is_positive)` runs one user-click round, keeping a
    snapshot for undo (controller.py:48-52);
  * `undo_click` restores the previous snapshot (controller.py:61-68);
  * `finish_object` freezes the current object into the uint16
    multi-object result mask under a new object id (controller.py:74-87);
  * `set_mask` injects an external init mask (controller.py:89-100);
  * `result_mask` / `current_object_prob` (controller.py:102-120);
  * `get_visualization` renders the blended panel (controller.py:122-154).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
from torch import nn as tnn

from ..nn import quantize_params
from .predictor import PredictorConfig, SessionState


class Click:
    def __init__(self, is_positive: bool, coords):
        self.is_positive = is_positive
        self.coords = tuple(coords)          # (y, x)


class InteractiveController:
    """Session state machine over any predictor with the common surface
    (set_input / user_click / undo_click / state): the fused `Predictor`
    for NoBRS, or a BRS predictor from `brs.get_predictor` (the reference
    app's BRS-mode selector, app.py:95-130). `model` stays a float module,
    which the BRS predictors need; with `int8`, NoBRS runs `int8_model`, a
    quantized copy (`nn.quantize_params`), made on first use when not given
    (a server passes one copy to all its sessions). The session lies on
    `device` (None: the card)."""

    def __init__(self, model: tnn.Module, cfg: PredictorConfig,
                 prob_thresh: float = 0.5, predictor=None,
                 brs_mode: str = "NoBRS", int8: bool = False, device=None,
                 int8_model: Optional[tnn.Module] = None):
        self.model = model
        self.cfg = cfg
        self.prob_thresh = prob_thresh
        self.brs_mode = brs_mode
        self.int8 = int8
        self.device = device
        self.int8_model = int8_model
        self.predictor = predictor or self._build_predictor(brs_mode)
        self.image: Optional[np.ndarray] = None
        self._init_mask: Optional[np.ndarray] = None
        self._result_mask: Optional[np.ndarray] = None
        self._undo: List = []
        self.clicks_list: List[Click] = []
        self.object_count = 0
        self.probs_history: List[np.ndarray] = []

    def _build_predictor(self, brs_mode: str):
        from .brs import get_predictor
        if self.int8 and brs_mode.lower() == "nobrs":
            if self.int8_model is None:
                self.int8_model = quantize_params(self.model,
                                                  dtype=self.cfg.model.dtype)
            return get_predictor(self.int8_model, self.cfg, int8=True,
                                 device=self.device)
        return get_predictor(self.model, self.cfg, brs_mode=brs_mode,
                             device=self.device)

    # ---------------------------------------------------------------- session

    def set_image(self, image: np.ndarray) -> None:
        self.image = image
        self._result_mask = np.zeros(image.shape[:2], np.uint16)
        self.object_count = 0
        self.reset_last_object()

    def set_brs_mode(self, brs_mode: str) -> None:
        """Swap the predictor (the reference app's BRS selector): the
        in-progress object's clicks reset, finished objects stay."""
        if brs_mode == self.brs_mode:
            return
        self.brs_mode = brs_mode
        self.predictor = self._build_predictor(brs_mode)
        if self.image is not None:
            self.reset_last_object()

    def set_net_clicks_limit(self, limit: Optional[int]) -> None:
        """The GUI's network-clicks entry (reference app.py's
        net_clicks_limit; None = no limit): the predictor is rebuilt with
        the new truncation and the in-progress object resets; finished
        objects stay."""
        if limit == self.cfg.net_clicks_limit:
            return
        self.cfg = dataclasses.replace(self.cfg, net_clicks_limit=limit)
        self.predictor = self._build_predictor(self.brs_mode)
        if self.image is not None:
            self.reset_last_object()

    def reset_last_object(self) -> None:
        if self.image is None:
            raise RuntimeError("set_image first")
        h, w = self.image.shape[:2]
        self.predictor.set_input(self.image, np.zeros((h, w), np.float32))
        if self._init_mask is not None:
            st = self.predictor.state
            hc, wc = st.gt.shape
            probs = np.zeros((1, hc, wc, 1), np.float32)
            probs[0, :h, :w, 0] = self._init_mask
            self.predictor.state = st._replace(
                prev_probs=torch.from_numpy(probs).to(st.gt.device))
        self._undo = []
        self.clicks_list = []
        self.probs_history = []

    def set_mask(self, mask: np.ndarray) -> None:
        """An external init mask (controller.py:89-100)."""
        if self.image is None or mask.shape != self.image.shape[:2]:
            raise ValueError("set_mask needs an image and a mask of its "
                             "height and width")
        self._init_mask = mask.astype(np.float32)
        self.reset_last_object()

    # ----------------------------------------------------------------- clicks

    def add_click(self, x: float, y: float, is_positive: bool) -> None:
        self._undo.append((list(self.clicks_list), list(self.probs_history)))
        self.predictor.user_click(y, x, is_positive)
        self.clicks_list.append(Click(is_positive, (y, x)))
        self.probs_history.append(self.current_object_prob.copy())

    def undo_click(self) -> None:
        if self._undo:
            self.predictor.undo_click()
            self.clicks_list, self.probs_history = self._undo.pop()

    # ---------------------------------------------------------------- results

    @property
    def state(self) -> SessionState:
        return self.predictor.state

    @property
    def current_object_prob(self) -> np.ndarray:
        h, w = self.image.shape[:2]
        return self.predictor.state.prev_probs[0, :h, :w, 0].cpu().numpy()

    @property
    def is_incomplete_mask(self) -> bool:
        return len(self.clicks_list) > 0

    def finish_object(self) -> None:
        """controller.py:74-87: freeze the current object into the result
        mask."""
        if not self.probs_history:
            return
        mask = self.current_object_prob > self.prob_thresh
        self.object_count += 1
        self._result_mask[mask] = self.object_count
        self._init_mask = None
        self.reset_last_object()

    @property
    def result_mask(self) -> np.ndarray:
        mask = self._result_mask.copy()
        if self.probs_history:
            mask[self.current_object_prob > self.prob_thresh] = \
                self.object_count + 1
        return mask

    def get_visualization(self, alpha_blend: float = 0.6,
                          click_radius: int = 4) -> Optional[np.ndarray]:
        if self.image is None:
            return None
        from ..utils.vis import draw_with_blend_and_clicks
        return draw_with_blend_and_clicks(
            self.image, mask=self.result_mask, alpha=alpha_blend,
            clicks_list=self.clicks_list, radius=click_radius)
