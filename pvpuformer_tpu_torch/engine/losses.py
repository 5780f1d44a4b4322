"""The training losses of the iterloss path (pvpuformer_tpu/engine/losses.py).

  * normalized_focal_loss = NormalizedFocalLossSigmoid, with the `with_aux`
    diagnostics and the normalizer detached (`detach_delimeter`);
  * dice_loss             = DiceLoss, per-sample form;
  * sigmoid_bce_loss      = SigmoidBinaryCrossEntropyLoss.

Predictions and labels are (B, H, W, C); every loss returns a per-sample (B,)
vector in f32, like the JAX package (the train step means it). The rest of
the JAX module (focal, soft IoU, boundary BCE, error count, CE, accuracy) is
not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _sum_non_batch(x: torch.Tensor) -> torch.Tensor:
    return x.sum(tuple(range(1, x.ndim)))


def normalized_focal_loss(pred_logits: torch.Tensor, label: torch.Tensor,
                          alpha: float = 0.5, gamma: float = 2.0,
                          eps: float = 1e-12, max_mult: float = -1.0,
                          detach_delimeter: bool = True,
                          from_sigmoid: bool = False,
                          ignore_label: float = -1.0,
                          with_aux: bool = False):
    """NormalizedFocalLossSigmoid (losses.py:40-85)."""
    pred_logits = pred_logits.float()
    label = label.float()
    one_hot = label > 0.5
    sw = (label != ignore_label).float()
    pred = pred_logits if from_sigmoid else torch.sigmoid(pred_logits)

    a = torch.where(one_hot, alpha * sw, (1.0 - alpha) * sw)
    pt = torch.where(sw > 0, 1.0 - (label - pred).abs(), 1.0)
    beta = (1.0 - pt) ** gamma

    sw_sum = sw.sum((1, 2), keepdim=True)
    beta_sum = beta.sum((1, 2), keepdim=True)
    mult = sw_sum / (beta_sum + eps)
    if detach_delimeter:
        mult = mult.detach()
    beta = beta * mult
    if max_mult > 0:
        beta = beta.clamp_max(max_mult)

    loss = -a * beta * torch.log((pt + eps).clamp_max(1.0))
    loss = loss * sw
    loss = _sum_non_batch(loss) / (_sum_non_batch(sw) + eps)
    if not with_aux:
        return loss
    ignore_area = _sum_non_batch((label == ignore_label).float())
    aux = {
        "sample_mult": mult.mean(tuple(range(1, mult.ndim))),
        "beta_pmax": beta.reshape(beta.shape[0], -1).amax(1),
        "no_ignore": ignore_area == 0,
    }
    return loss, aux


def sigmoid_bce_loss(pred: torch.Tensor, label: torch.Tensor,
                     from_sigmoid: bool = False,
                     ignore_label: float = -1.0) -> torch.Tensor:
    """SigmoidBinaryCrossEntropyLoss (losses.py:163-176)."""
    pred = pred.float()
    label = label.float().reshape(pred.shape)
    sw = (label != ignore_label).float()
    label = torch.where(sw > 0, label, 0.0)
    if not from_sigmoid:
        loss = (pred.clamp_min(0.0) - pred * label
                + F.softplus(-pred.abs()))
    else:
        eps = 1e-12
        loss = -(torch.log(pred + eps) * label
                 + torch.log(1.0 - pred + eps) * (1.0 - label))
    loss = loss * sw
    return loss.reshape(loss.shape[0], -1).mean(1)


def dice_loss(pred_logits: torch.Tensor, target: torch.Tensor,
              use_sigmoid: bool = True, naive_dice: bool = True,
              eps: float = 1e-3, loss_weight: float = 1.0) -> torch.Tensor:
    """DiceLoss (losses.py:227-363), reduction='none' per-sample form."""
    pred = pred_logits.float()
    if use_sigmoid:
        pred = torch.sigmoid(pred)
    b = pred.shape[0]
    p = pred.reshape(b, -1)
    t = target.float().reshape(b, -1)
    a = (p * t).sum(1)
    if naive_dice:
        d = (2.0 * a + eps) / (p.sum(1) + t.sum(1) + eps)
    else:
        d = 2.0 * a / ((p * p).sum(1) + (t * t).sum(1) + eps)
    return loss_weight * (1.0 - d)
