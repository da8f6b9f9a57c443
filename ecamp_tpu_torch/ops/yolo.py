"""YOLOv3 loss with vectorised target assignment (counterpart of
`ecamp_tpu/ops/yolo.py`; reference Detection/utils/yolo_loss.py:41-194).

The reference builds targets with a per-(batch, box) Python double loop
on host tensors every step (:136-194); here, as in the JAX package, the
assignment is a batched scatter on the device, inside the step.

Collisions: when two gt boxes of an image land on the same (anchor, cell),
the reference's sequential loop lets the later box overwrite. A scatter
with duplicate indices picks an unspecified winner (JAX's `.at[].set`, and
a CUDA `index_put_` picks one nondeterministically). Here the winner is
fixed: a scatter-amax of the box index gives each (anchor, cell) its
highest-indexed box, and every target is gathered from that box, so the
later box wins on every device, as in the reference's loop.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

# torch.nn.BCELoss clamps each log term at -100
_LOG_CLAMP = -100.0


def _bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Mean BCE of probabilities `p` against `t` in fp32: p clipped to
    [1e-12, 1 - 1e-7] (no gradient outside it), each log term clamped at
    -100, as torch's BCELoss."""
    p = torch.clamp(p.float(), 1e-12, 1.0 - 1e-7)
    t = t.float()
    logp = torch.clamp(torch.log(p), min=_LOG_CLAMP)
    log1mp = torch.clamp(torch.log1p(-p), min=_LOG_CLAMP)
    return torch.mean(-(t * logp + (1.0 - t) * log1mp))


def build_targets(targets: torch.Tensor, anchors: torch.Tensor, grid: int,
                  num_classes: int, ignore_threshold: float = 0.5
                  ) -> Dict[str, torch.Tensor]:
    """Vectorised YOLO target assignment.

    targets: (B, T, 5) rows [cls, cx, cy, w, h] normalised; all-zero rows
    are padding (yolo_loss.py:158). anchors: (A, 2) in grid units.
    Returns fp32 (B, A, G, G) maps (tcls with a trailing C): mask,
    noobj_mask, tx, ty, tw, th, tconf, tcls."""
    targets = targets.float()
    b, t, _ = targets.shape
    a, g = anchors.shape[0], grid
    dev = targets.device

    valid = targets.sum(dim=-1) > 0  # (B, T)
    gx, gy = targets[..., 1] * g, targets[..., 2] * g
    gw, gh = targets[..., 3] * g, targets[..., 4] * g
    # a float -> int cast truncates toward zero, as JAX's astype
    gi = gx.to(torch.int32).clamp(0, g - 1).long()
    gj = gy.to(torch.int32).clamp(0, g - 1).long()

    # anchor IoU with the reference's +1 convention on centred boxes
    # (bbox_iou with x1y1x2y2=False on (0,0,w,h) pairs, yolo_loss.py:169-175)
    aw, ah = anchors[:, 0], anchors[:, 1]
    inter = (torch.minimum(gw[..., None], aw) + 1.0) * \
        (torch.minimum(gh[..., None], ah) + 1.0)
    union = (gw[..., None] + 1.0) * (gh[..., None] + 1.0) + \
        (aw + 1.0) * (ah + 1.0) - inter
    anch_iou = inter / (union + 1e-16)  # (B, T, A)
    best_n = torch.argmax(anch_iou, dim=-1)  # (B, T), first max

    # padding rows go to a trash row (g) that is sliced off
    trash_j = torch.where(valid, gj, torch.full_like(gj, g))
    bi = torch.arange(b, device=dev)[:, None]
    cell = ((bi * a + best_n) * (g + 1) + trash_j) * g + gi  # (B, T)

    # each (anchor, cell)'s winner: its highest box index (-1: none)
    box = torch.arange(t, device=dev).expand(b, t)
    winner = torch.full((b * a * (g + 1) * g,), -1, dtype=torch.long,
                        device=dev)
    winner.scatter_reduce_(0, cell.reshape(-1), box.reshape(-1), "amax")
    winner = winner.view(b, a, g + 1, g)[:, :, :g, :]
    assigned = winner >= 0
    mask = assigned.float()
    src = winner.clamp(min=0).reshape(b, -1)

    def pick(value: torch.Tensor) -> torch.Tensor:
        """(B, T) per-box values -> (B, A, G, G), the winner's, else 0."""
        got = torch.gather(value, 1, src).view(b, a, g, g)
        return torch.where(assigned, got, torch.zeros_like(got))

    best_aw, best_ah = aw[best_n], ah[best_n]
    tx = pick(gx - gi)
    ty = pick(gy - gj)
    tw = pick(torch.log(gw / best_aw + 1e-16))
    th = pick(torch.log(gh / best_ah + 1e-16))

    # noobj: zero every anchor whose IoU with a gt exceeds the threshold
    # at the gt's cell (yolo_loss.py:177); non-ignored entries go to trash
    ignore = (anch_iou > ignore_threshold) & valid[..., None]  # (B, T, A)
    ai = torch.arange(a, device=dev)
    ji = torch.where(ignore, trash_j[..., None],
                     torch.full_like(trash_j[..., None], g))
    idx = ((bi[..., None] * a + ai) * (g + 1) + ji) * g + gi[..., None]
    noobj = torch.ones(b * a * (g + 1) * g, device=dev)
    noobj.scatter_reduce_(0, idx.reshape(-1),
                          torch.zeros(idx.numel(), device=dev), "amin")
    noobj = noobj.view(b, a, g + 1, g)[:, :, :g, :]
    # the assigned cells are no-obj 0 too (explicit, as in the JAX package)
    noobj = torch.minimum(noobj, 1.0 - mask)

    cls_ids = targets[..., 0].to(torch.int32).clamp(0, num_classes - 1)
    onehot = torch.nn.functional.one_hot(cls_ids.long(),
                                         num_classes).float()  # (B, T, C)
    tcls = torch.gather(onehot, 1, src[..., None].expand(-1, -1,
                                                         num_classes))
    tcls = tcls.view(b, a, g, g, num_classes) * mask[..., None]

    return dict(mask=mask, noobj_mask=noobj, tx=tx, ty=ty, tw=tw, th=th,
                tconf=mask, tcls=tcls)


def yolo_loss(logits: torch.Tensor, targets: torch.Tensor,
              anchors: Sequence[Tuple[float, float]], img_size: int,
              num_classes: int = 1, ignore_threshold: float = 0.5,
              lambda_xy: float = 2.5, lambda_wh: float = 2.5,
              lambda_conf: float = 1.0, lambda_cls: float = 1.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-scale YOLO loss (yolo_loss.py:59-104) in fp32.
    logits: (B, A * (5 + C), G, G). Returns (total, parts)."""
    b, ch, h, w = logits.shape
    a = len(anchors)
    c = ch // a - 5
    stride = img_size / h
    scaled = torch.tensor(anchors, dtype=torch.float32,
                          device=logits.device) / stride

    pred = logits.reshape(b, a, 5 + c, h, w).permute(0, 1, 3, 4, 2).float()
    x = torch.sigmoid(pred[..., 0])
    y = torch.sigmoid(pred[..., 1])
    pw, ph = pred[..., 2], pred[..., 3]
    conf = torch.sigmoid(pred[..., 4])
    pcls = torch.sigmoid(pred[..., 5:])

    tt = build_targets(targets, scaled, h, c, ignore_threshold)
    m, noobj = tt["mask"], tt["noobj_mask"]
    loss_x = _bce(x * m, tt["tx"] * m)
    loss_y = _bce(y * m, tt["ty"] * m)
    loss_w = torch.mean(torch.square(pw * m - tt["tw"] * m))
    loss_h = torch.mean(torch.square(ph * m - tt["th"] * m))
    loss_conf = _bce(conf * m, m) + 0.5 * _bce(conf * noobj,
                                               torch.zeros_like(noobj))
    loss_cls = _bce(pcls * m[..., None], tt["tcls"] * m[..., None])
    total = (loss_x + loss_y) * lambda_xy + (loss_w + loss_h) * lambda_wh + \
        loss_conf * lambda_conf + loss_cls * lambda_cls
    return total, dict(x=loss_x, y=loss_y, w=loss_w, h=loss_h,
                       conf=loss_conf, cls=loss_cls)
