"""The training losses (pvpuformer_tpu/engine/losses.py, the reference's
`isegm/model/losses.py`).

  * normalized_focal_loss = NormalizedFocalLossSigmoid, with the `with_aux`
    diagnostics and the normalizer detached (`detach_delimeter`);
  * focal_loss            = FocalLoss;
  * soft_iou_loss         = SoftIoU;
  * dice_loss             = DiceLoss, per-sample form;
  * sigmoid_bce_loss      = SigmoidBinaryCrossEntropyLoss;
  * boundary_bce_loss     = BoundaryCrossEntropyLoss, its cv2 L1
    distance-transform boundary as a 4-neighbour erosion test;
  * error_count           = ErrorCount;
  * cross_entropy_loss, accuracy: the mmseg multi-class pair.

Predictions and labels are (B, H, W, C); the iterloss losses return a
per-sample (B,) vector in f32, like the JAX package (the train step means
it); boundary BCE, error count, CE and accuracy return scalars.
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


def focal_loss(pred_logits: torch.Tensor, label: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-9,
               scale: float = 1.0, from_logits: bool = False,
               ignore_label: float = -1.0) -> torch.Tensor:
    """FocalLoss (losses.py:112-133)."""
    pred_logits = pred_logits.float()
    label = label.float()
    one_hot = label > 0.5
    sw = (label != ignore_label).float()
    pred = pred_logits if from_logits else torch.sigmoid(pred_logits)

    a = torch.where(one_hot, alpha * sw, (1.0 - alpha) * sw)
    pt = torch.where(sw > 0, 1.0 - (label - pred).abs(), 1.0)
    beta = (1.0 - pt) ** gamma
    loss = -a * beta * torch.log((pt + eps).clamp_max(1.0)) * sw
    return scale * _sum_non_batch(loss) / (_sum_non_batch(sw) + eps)


def soft_iou_loss(pred: torch.Tensor, label: torch.Tensor,
                  from_sigmoid: bool = False,
                  ignore_label: float = -1.0) -> torch.Tensor:
    """SoftIoU (losses.py:142-152)."""
    pred = pred.float()
    label = label.float().reshape(pred.shape)
    sw = (label != ignore_label).float()
    if not from_sigmoid:
        pred = torch.sigmoid(pred)
    inter = _sum_non_batch(pred * label * sw)
    union = _sum_non_batch(torch.maximum(pred, label) * sw)
    return 1.0 - inter / (union + 1e-8)


def _inner_boundary(mask: torch.Tensor) -> torch.Tensor:
    """Pixels of `mask` with a 4-adjacent background pixel; image borders are
    not background (== cv2.distanceTransform(mask, DIST_L1, 3) == 1 on the
    un-padded array, losses.py:194-195). mask: (..., H, W) bool."""
    m = mask                           # neighbours with edge padding
    up = torch.cat([m[..., :1, :], m[..., :-1, :]], -2)
    dn = torch.cat([m[..., 1:, :], m[..., -1:, :]], -2)
    lf = torch.cat([m[..., :1], m[..., :-1]], -1)
    rt = torch.cat([m[..., 1:], m[..., -1:]], -1)
    return m & ~(up & dn & lf & rt)


def boundary_bce_loss(gt: torch.Tensor, pred_logits: torch.Tensor
                      ) -> torch.Tensor:
    """BoundaryCrossEntropyLoss (losses.py:183-213): BCE-with-logits summed
    over the positive and negative GT boundary bands, each normalized by the
    total element count. gt/pred: (B, H, W, 1). Returns a scalar."""
    gtf = gt.float()
    gmask = gtf[..., 0] > 0.5
    b_pos = _inner_boundary(gmask)[..., None]
    b_neg = _inner_boundary(~gmask)[..., None]
    x = pred_logits.float()
    bce = x.clamp_min(0.0) - x * gtf + F.softplus(-x.abs())
    size = float(gtf.numel())
    return (torch.where(b_pos, bce, 0.0).sum() / size
            + torch.where(b_neg, bce, 0.0).sum() / size)


def error_count(gt: torch.Tensor, pred_logits: torch.Tensor,
                pred_thresh: float = 0.49) -> torch.Tensor:
    """ErrorCount diagnostic (losses.py:216-224): the fraction of
    mispredicted pixels. Returns a scalar."""
    pred = torch.sigmoid(pred_logits.float()) > pred_thresh
    diff = (gt.float() > 0.5) != pred
    return diff.sum() / float(gt.numel())


def cross_entropy_loss(pred_logits: torch.Tensor, label: torch.Tensor,
                       ignore_index: int = 255,
                       class_weight=None) -> torch.Tensor:
    """mmseg-style multi-class CE (transformer_helper/cross_entropy_loss.py:
    199): pred (B, H, W, C) logits, label (B, H, W) int class ids,
    `ignore_index` pixels dropped; mean over valid pixels."""
    valid = label != ignore_index
    lab = torch.where(valid, label, 0).long()
    logp = torch.log_softmax(pred_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, lab[..., None])[..., 0]
    if class_weight is not None:
        nll = nll * torch.as_tensor(class_weight, dtype=torch.float32,
                                    device=nll.device)[lab]
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def accuracy(pred_logits: torch.Tensor, label: torch.Tensor,
             ignore_index: int = 255) -> torch.Tensor:
    """mmseg `accuracy` (transformer_helper/accuracy.py): top-1 pixel
    accuracy over non-ignored pixels, in percent."""
    valid = label != ignore_index
    correct = (pred_logits.argmax(-1) == label) & valid
    return 100.0 * correct.sum() / valid.sum().clamp_min(1)
