"""Box utilities: IoU, NMS, YOLO decode, COCO-style mAP (counterpart of
`ecamp_tpu/ops/boxes.py`).

NMS and AP run on the host in numpy (a small N after the confidence
filter; the reference runs them on CPU tensors, Detection/utils/
detection_utils.py:76-135, torchmetrics mAP at Detection/train.py:214-215):
these functions are a copy of the JAX package's numpy ones. The YOLO box
decode runs on the device in torch (`decode_yolo`, replacing
yolo_loss.py:105-134).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def box_iou(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """Pairwise IoU, xyxy, torchvision convention (detection_utils.py:49-73)."""
    area1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(axis=2)
    return inter / (area1[:, None] + area2[None, :] - inter + 1e-16)


def bbox_iou_plus1(box1: np.ndarray, box2: np.ndarray) -> np.ndarray:
    """IoU with the +1 pixel-area convention the reference's NMS uses
    (yolo_loss.py:7-38, called from detection_utils.py:126)."""
    x1 = np.maximum(box1[:, None, 0], box2[None, :, 0])
    y1 = np.maximum(box1[:, None, 1], box2[None, :, 1])
    x2 = np.minimum(box1[:, None, 2], box2[None, :, 2])
    y2 = np.minimum(box1[:, None, 3], box2[None, :, 3])
    inter = np.clip(x2 - x1 + 1, 0, None) * np.clip(y2 - y1 + 1, 0, None)
    a1 = (box1[:, 2] - box1[:, 0] + 1) * (box1[:, 3] - box1[:, 1] + 1)
    a2 = (box2[:, 2] - box2[:, 0] + 1) * (box2[:, 3] - box2[:, 1] + 1)
    return inter / (a1[:, None] + a2[None, :] - inter + 1e-16)


def nms(predictions: np.ndarray, num_classes: int, conf_thres: float = 0.5,
        nms_thres: float = 0.5) -> List[Optional[np.ndarray]]:
    """Per-image class-wise greedy NMS (detection_utils.py:76-135).

    predictions: (B, N, 5+C) with cxcywh + obj_conf + class scores.
    Returns per image an (M, 7) array (x1,y1,x2,y2,conf,cls_conf,cls) or None.
    """
    preds = np.array(predictions, dtype=np.float32, copy=True)
    boxes = np.empty_like(preds[:, :, :4])
    boxes[:, :, 0] = preds[:, :, 0] - preds[:, :, 2] / 2
    boxes[:, :, 1] = preds[:, :, 1] - preds[:, :, 3] / 2
    boxes[:, :, 2] = preds[:, :, 0] + preds[:, :, 2] / 2
    boxes[:, :, 3] = preds[:, :, 1] + preds[:, :, 3] / 2
    preds[:, :, :4] = boxes

    output: List[Optional[np.ndarray]] = [None] * len(preds)
    for i, img_pred in enumerate(preds):
        img_pred = img_pred[img_pred[:, 4] >= conf_thres]
        if img_pred.shape[0] == 0:
            continue
        cls_conf = img_pred[:, 5:5 + num_classes].max(axis=1, keepdims=True)
        cls_pred = img_pred[:, 5:5 + num_classes].argmax(axis=1)[:, None]
        dets = np.concatenate(
            [img_pred[:, :5], cls_conf, cls_pred.astype(np.float32)], axis=1)
        keep_all = []
        for c in np.unique(dets[:, -1]):
            dc = dets[dets[:, -1] == c]
            dc = dc[np.argsort(-dc[:, 4], kind="stable")]
            while dc.shape[0]:
                keep_all.append(dc[0])
                if dc.shape[0] == 1:
                    break
                ious = bbox_iou_plus1(dc[0:1, :4], dc[1:, :4])[0]
                dc = dc[1:][ious < nms_thres]
        if keep_all:
            output[i] = np.stack(keep_all)
    return output


def decode_yolo(logits: torch.Tensor, anchors: Sequence[Tuple[float, float]],
                img_size: int, num_classes: int = 1) -> torch.Tensor:
    """Decode a (B, A*(5+C), H, W) YOLO map to (B, A*H*W, 5+C) boxes in
    image pixels (cxcywh), objectness and class scores, on the logits'
    device, vectorised (replaces yolo_loss.py:105-134's repeat/linspace
    construction)."""
    b, ch, h, w = logits.shape
    a = len(anchors)
    c = ch // a - 5
    pred = logits.reshape(b, a, 5 + c, h, w).permute(0, 1, 3, 4, 2)
    stride_h = img_size / h
    stride_w = img_size / w
    anchors_t = torch.tensor(anchors, dtype=torch.float32,
                             device=logits.device)
    anchor_w = anchors_t[:, 0] / stride_w
    anchor_h = anchors_t[:, 1] / stride_h
    grid_x = torch.arange(w, dtype=torch.float32,
                          device=logits.device)[None, None, None, :]
    grid_y = torch.arange(h, dtype=torch.float32,
                          device=logits.device)[None, None, :, None]
    x = torch.sigmoid(pred[..., 0]) + grid_x
    y = torch.sigmoid(pred[..., 1]) + grid_y
    bw = torch.exp(pred[..., 2]) * anchor_w[None, :, None, None]
    bh = torch.exp(pred[..., 3]) * anchor_h[None, :, None, None]
    conf = torch.sigmoid(pred[..., 4])
    cls = torch.sigmoid(pred[..., 5:])
    boxes = torch.stack([x * stride_w, y * stride_h, bw * stride_w,
                         bh * stride_h], dim=-1)
    out = torch.cat([boxes, conf[..., None], cls], dim=-1)
    return out.reshape(b, a * h * w, 5 + c)


def _coco_ap_single(tp: np.ndarray, conf: np.ndarray, n_gt: int) -> float:
    """101-point interpolated AP (COCO / torchmetrics convention)."""
    if n_gt == 0:
        return float("nan")
    if tp.size == 0:
        return 0.0
    order = np.argsort(-conf, kind="stable")
    tp = tp[order]
    tps = np.cumsum(tp)
    fps = np.cumsum(1 - tp)
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1e-16)
    # precision envelope
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    rec_thrs = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rec_thrs, side="left")
    prec_at = np.where(idx < len(precision),
                       precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(prec_at.mean())


def average_precision(pred_boxes: List[np.ndarray],
                      pred_scores: List[np.ndarray],
                      gt_boxes: List[np.ndarray],
                      iou_thresholds: Sequence[float]) -> float:
    """Single-class COCO-style mAP over IoU thresholds
    (torchmetrics MeanAveragePrecision parity for the RSNA 1-class task,
    Detection/train.py:214-215). Boxes are xyxy."""
    n_gt = sum(len(g) for g in gt_boxes)
    aps = []
    for thr in iou_thresholds:
        all_tp, all_conf = [], []
        for pb, ps, gb in zip(pred_boxes, pred_scores, gt_boxes):
            if len(pb) == 0:
                continue
            order = np.argsort(-ps, kind="stable")
            pb, ps = pb[order], ps[order]
            matched = np.zeros(len(gb), dtype=bool)
            tp = np.zeros(len(pb), dtype=np.float64)
            if len(gb):
                ious = box_iou(pb, gb)
                for di in range(len(pb)):
                    best = -1
                    best_iou = thr
                    for gi in range(len(gb)):
                        if matched[gi]:
                            continue
                        if ious[di, gi] >= best_iou:
                            best_iou = ious[di, gi]
                            best = gi
                    if best >= 0:
                        matched[best] = True
                        tp[di] = 1.0
            all_tp.append(tp)
            all_conf.append(ps)
        tp_cat = np.concatenate(all_tp) if all_tp else np.zeros(0)
        conf_cat = np.concatenate(all_conf) if all_conf else np.zeros(0)
        ap = _coco_ap_single(tp_cat, conf_cat, n_gt)
        if not np.isnan(ap):
            aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0
