"""NoC evaluation loop and metric reporting
(pvpuformer_tpu/inference/evaluation.py), on the port's `Predictor`.

The reference protocol:
  * per (sample, object): up to `max_clicks` rounds of {next click ->
    predict -> IoU}, early stop at `max_iou_thr`
    (isegm/inference/vpu_evaluation.py:35-98);
  * NoC@thr / >=N@thr (isegm/inference/utils.py:90-110), SPC / SPI timing
    (utils.py:11-18), the fixed-width results table (utils.py:136-159).

Without a callback a session runs as `Predictor.run_clicks` (the clicks'
launches queued back to back, one host read of the IoU curve).
"""
from __future__ import annotations

import time
from datetime import timedelta
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .predictor import Predictor


def get_iou(gt_mask: np.ndarray, pred_mask: np.ndarray,
            ignore_label: int = -1) -> float:
    """inference/utils.py:80-87."""
    not_ignore = gt_mask != ignore_label
    obj = gt_mask == 1
    inter = np.logical_and(np.logical_and(pred_mask, obj), not_ignore).sum()
    union = np.logical_and(np.logical_or(pred_mask, obj), not_ignore).sum()
    return inter / union


def evaluate_sample(image: np.ndarray, gt_mask: np.ndarray,
                    predictor: Predictor, max_iou_thr: float,
                    pred_thr: float = 0.49, min_clicks: int = 1,
                    max_clicks: int = 20,
                    callback: Optional[Callable] = None,
                    sample_id=None) -> Tuple[np.ndarray, np.ndarray]:
    """One object's interactive session (vpu_evaluation.py:35-98).

    Returns (ious (K,), final probs (H, W)).

    Without a callback the whole session runs through
    `predictor.run_clicks` (one host read); the curve is then cut at the
    first threshold crossing, which reproduces the reference's early-stop
    loop exactly (the crossing click and every earlier click are identical;
    no metric reads a later click)."""
    predictor.set_input(image, gt_mask)
    if callback is None:
        curve = predictor.run_clicks(max_clicks).astype(np.float32)
        over = np.nonzero(curve[min_clicks - 1:] >= max_iou_thr)[0]
        k = (over[0] + min_clicks) if len(over) else max_clicks
        return curve[:k], predictor.probs

    ious = []
    for click_indx in range(max_clicks):
        iou = predictor.next_click()
        ious.append(iou)
        callback(image, gt_mask, predictor.probs, iou, sample_id,
                 click_indx, predictor.clicks)
        if iou >= max_iou_thr and click_indx + 1 >= min_clicks:
            break
    return np.array(ious, np.float32), predictor.probs


def evaluate_dataset(dataset, predictor: Predictor, max_iou_thr: float,
                     pred_thr: float = 0.49, min_clicks: int = 1,
                     max_clicks: int = 20, callback=None,
                     progress: bool = False) -> Tuple[List[np.ndarray], float]:
    """vpu_evaluation.py:18-32: returns (per-object IoU curves, elapsed s)."""
    all_ious = []
    start = time.time()
    indices = range(len(dataset))
    if progress:
        try:
            from tqdm import tqdm
            indices = tqdm(indices, leave=False)
        except ImportError:
            pass
    for index in indices:
        sample = dataset.get_sample(index)
        for object_id in sample.objects_ids:
            ious, _ = evaluate_sample(sample.image, sample.gt_mask(object_id),
                                      predictor, max_iou_thr=max_iou_thr,
                                      pred_thr=pred_thr, min_clicks=min_clicks,
                                      max_clicks=max_clicks, callback=callback,
                                      sample_id=index)
            all_ious.append(ious)
    return all_ious, time.time() - start


def compute_noc_metric(all_ious: Sequence[np.ndarray], iou_thrs: Sequence[float],
                       max_clicks: int = 20):
    """inference/utils.py:90-110."""
    def _noc(iou_arr, thr):
        vals = iou_arr >= thr
        return np.argmax(vals) + 1 if np.any(vals) else max_clicks

    noc_list, noc_std, over_max = [], [], []
    for thr in iou_thrs:
        scores = np.array([_noc(a, thr) for a in all_ious], dtype=np.int64)
        noc_list.append(scores.mean())
        noc_std.append(scores.std())
        over_max.append(int((scores == max_clicks).sum()))
    return noc_list, noc_std, over_max


def get_time_metrics(all_ious, elapsed: float):
    """inference/utils.py:11-18."""
    n_images = len(all_ious)
    n_clicks = sum(map(len, all_ious))
    return elapsed / max(n_clicks, 1), elapsed / max(n_images, 1)


def mean_iou_per_click(all_ious: Sequence[np.ndarray], max_clicks: int = 20):
    """mIoU@k with curves held at their final value after early stop
    (evaluate_vpumodel.py:266-271 semantics)."""
    padded = np.stack([np.concatenate([a, np.full(max_clicks - len(a), a[-1])])
                       for a in all_ious])
    return padded.mean(axis=0)


def get_results_table(noc_list, over_max_list, brs_type: str, dataset_name: str,
                      mean_spc: float, elapsed: float, n_clicks: int = 20,
                      model_name: Optional[str] = None) -> Tuple[str, str]:
    """inference/utils.py:136-159 fixed-width table."""
    table_header = (f'|{"BRS Type":^13}|{"Dataset":^11}|'
                    f'{"NoC@80%":^9}|{"NoC@85%":^9}|{"NoC@90%":^9}|{"NoC@95%":^9}|'
                    f'{">=" + str(n_clicks) + "@85%":^9}|'
                    f'{">=" + str(n_clicks) + "@90%":^9}|'
                    f'{">=" + str(n_clicks) + "@95%":^9}|'
                    f'{"SPC,s":^7}|{"Time":^9}|')
    row_width = len(table_header)
    header = f'Eval results for model: {model_name}\n' if model_name else ''
    header += '-' * row_width + '\n' + table_header + '\n' + '-' * row_width

    eval_time = str(timedelta(seconds=int(elapsed)))
    row = f'|{brs_type:^13}|{dataset_name:^11}|'
    for i in range(4):
        row += f'{noc_list[i]:^9.2f}|' if len(noc_list) > i else f'{"?":^9}|'
    for i in (1, 2, 3):
        row += f'{over_max_list[i]:^9}|' if len(noc_list) > i else f'{"?":^9}|'
    row += f'{mean_spc:^7.3f}|{eval_time:^9}|'
    return header, row


def merge_shard_pickles(paths: Sequence[str]):
    """Merge the IoU pickles of a sharded evaluation (the CLI's --shard I/N
    --save-ious, one process each) back into per-dataset results, so the
    NoC table of the whole dataset can be reprinted in the reference's
    format (inference/utils.py:136-159).

    Returns {(dataset, mode): {"all_ious": [...], "elapsed": s, "n_clicks"}}
    with curves concatenated in path order and wall-clock summed (hosts run
    concurrently, so the summed SPC is per-host-serialized — an upper
    bound; the table's Time column uses the max over shards instead)."""
    import pickle

    merged: dict = {}
    for path in paths:
        with open(path, "rb") as f:
            d = pickle.load(f)
        key = (d["dataset"], d.get("mode", "NoBRS"))
        m = merged.setdefault(key, {"all_ious": [], "elapsed": 0.0,
                                    "elapsed_max": 0.0, "n_clicks": 0,
                                    "shards": 0})
        m["all_ious"].extend(d["all_ious"])
        m["elapsed"] += d.get("elapsed", 0.0)
        m["elapsed_max"] = max(m["elapsed_max"], d.get("elapsed", 0.0))
        m["n_clicks"] = max(m["n_clicks"], d.get("n_clicks", 0))
        m["shards"] += 1
    return merged
